"""Reductions the per-layer readers (``layer_metrics/<metric>.py``) share.
Each returns ``None`` where its run holds nothing to read (no traced
slice, no such kernel in it), and the harness then leaves the metric
out; a share is a percentage of its bound or peak."""

from __future__ import annotations

from typing import List, Optional, Tuple

from gpubench.counts import attention as att
from gpubench.counts import model as mdl
from gpubench.counts.peaks import bound_s
from gpubench.harness.records import Records, p90

#: Kernel names (substrings of the profiler's names) of each attention
#: kernel of the port.
B1_FWD = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")
ROPE = "rope_rotate_kernel"
B3 = ("flash_bwd_wgmma_kernel", "flash_bwd_kv_kernel")
BWD_REST = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel",
            "flash_bwd_prep_kernel", "flash_bwd_post_kernel")
B5 = "paged_decode"


def _heads(c) -> Tuple[int, int, int]:
    return c["n_heads"], c["n_kv_heads"], c["d_model"] // c["n_heads"]


def idle_share(rec: Records) -> Optional[float]:
    t = rec.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def serve_mfu(rec: Records) -> Optional[float]:
    """Model FLOPs of every prompt and decode token the slice's calls
    processed (the picked experts only, attention over each token's real
    context) over the slice at the bf16 peak."""
    t = rec.trace
    if t is None or not (rec.decode_contexts or rec.prefills):
        return None
    c = rec.port
    flops = sum(mdl.prefill(c, p) for p in rec.prefills)
    flops += sum(mdl.forward_token(c, ctx) for step in rec.decode_contexts for ctx in step)
    flops += sum(mdl.chunk(c, w, off) for w, off in rec.chunks)
    return 100.0 * flops / t.window_s / rec.peaks["bf16_flops"]


def paged_decode_roofline(rec: Records) -> Optional[float]:
    """B5's time against the least time its work needs: per micro-step and
    layer, the active slots' queries and the K and V of their real
    contexts."""
    t = rec.trace
    if t is None or not rec.decode_contexts:
        return None
    secs = t.time_s(B5)
    if secs <= 0:
        return None
    H, KV, D = _heads(rec.port)
    bound = sum(bound_s(*att.paged_decode(step, H, KV, D), rec.peaks)
                for step in rec.decode_contexts if step)
    return 100.0 * bound * rec.port["n_layers"] / secs


def _clean_until(rec: Records) -> float:
    """The part of the window the profiler did not slow: up to the traced
    slice's start (its per-operation cost and its stop hold up a
    host-bound engine)."""
    return rec.serving.get("clean_until_s", rec.window_s)


def queue_wait_p90_ms(rec: Records) -> Optional[float]:
    """Over the requests due before the traced slice."""
    until = _clean_until(rec)
    waits = [r["admit"] - r["due"] for r in rec.requests
             if r["admit"] is not None and r["due"] < until]
    v = p90(waits)
    return None if v is None else v * 1e3


def ttft_p90_ms(rec: Records) -> Optional[float]:
    """Over the requests due before the traced slice, each from its due
    instant to its first token; one never served in full counts as later
    than every served one."""
    until = _clean_until(rec)
    v = p90([r["ttft_s"] for r in rec.requests if r["due"] < until])
    return None if v is None else v * 1e3


def _flash_split(kernels) -> Tuple[float, float, int, int]:
    """Device seconds of the forward (B1 and its rope rotation) and of the
    backward (B3, B4, their prep and rope rotation), and the count of
    each: a ``rope_rotate`` belongs to the flash kernel that follows
    it."""
    fwd = bwd = 0.0
    n_fwd = n_bwd = 0
    pending: List[float] = []
    for name, s, e in kernels:
        dur = (e - s) / 1e9
        if ROPE in name:
            pending.append(dur)
        elif any(k in name for k in BWD_REST):
            bwd += dur + sum(pending)
            pending = []
        elif any(k in name for k in B3):
            bwd += dur + sum(pending)
            pending = []
            n_bwd += 1
        elif any(k in name for k in B1_FWD):
            fwd += dur + sum(pending)
            pending = []
            n_fwd += 1
    return fwd, bwd, n_fwd, n_bwd


def _train_shape(rec: Records):
    docs = rec.train["docs"]
    tokens = sum(sum(d) for d in docs)
    pairs = sum(att.causal_pairs(d) for d in docs)
    return tokens, pairs


def flash_roofline(rec: Records, backward: bool) -> Optional[float]:
    t = rec.trace
    if t is None or not rec.train:
        return None
    fwd, bwd, n_fwd, n_bwd = _flash_split(t.kernels)
    secs, n = (bwd, n_bwd) if backward else (fwd, n_fwd)
    if secs <= 0 or n == 0:
        return None
    tokens, pairs = _train_shape(rec)
    H, KV, D = _heads(rec.port)
    count = att.flash_bwd if backward else att.flash_fwd
    return 100.0 * n * bound_s(*count(tokens, pairs, H, KV, D), rec.peaks) / secs


def train_mfu(rec: Records) -> Optional[float]:
    t = rec.trace
    if t is None or not rec.train or not rec.train["slice_steps"]:
        return None
    flops = sum(mdl.train_row(rec.port, d) for d in rec.train["docs"])
    return (100.0 * flops * rec.train["slice_steps"] / t.window_s
            / rec.peaks["bf16_flops"])
