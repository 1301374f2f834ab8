"""What the two serving drivers share: the engine on the benchmark's
weights, the warm-up of the cell's shapes, the drain after the window,
the request books, and the check of what was served against the plain
reference."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gpubench.harness import traffic as tr
from gpubench.harness import weights as wts
from gpubench.harness.context import Ctx
from gpubench.harness.records import p90
from gpubench.reference import decoder as ref

clock = time.perf_counter


def port_config(ctx: Ctx):
    from kubeflow_controller_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**ctx.port, dtype=ctx.dtype,
                             **ctx.cell.workload.get("model", {}))


def program_weights(ctx: Ctx, tcfg) -> Dict:
    """The benchmark's weights in the dtype served. Under the control
    ``program_int8``, the program's own int8 serving path, one precision
    below the configuration's bf16: weight-only int8 (``quantize_weight``
    on every projection, an expert at a time for a routed bank) here, and
    an int8 KV pool (:func:`make_engine`)."""
    tree = wts.make(ctx.port, ctx.seed, ctx.device, ctx.dtype)
    if ctx.control != "program_int8":
        return tree
    from kubeflow_controller_tpu_torch.models import generate as gen

    banks = {}
    if ctx.port.get("moe_experts"):
        for name in ("w_gate", "w_up", "w_down"):
            banks[name] = tree["layers"].pop(name)
    out = gen.inference_params(tcfg, tree, quant="int8")
    for name, w in banks.items():
        L, E = w.shape[:2]
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((L, E, 1, w.shape[-1]), dtype=ctx.dtype, device=w.device)
        for i in range(L):
            for e in range(E):
                q[i, e], scale[i, e] = gen.quantize_weight(w[i, e], ctx.dtype)
        out["layers"][name] = (q, scale)
        del w
    banks.clear()
    return out


def make_engine(ctx: Ctx, tcfg, params):
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import ServingEngine

    e = ctx.cell.workload["engine"]
    return ServingEngine(
        tcfg, params, n_slots=e["n_slots"], max_seq=e["max_seq"],
        prefill_mode=e["prefill_mode"], block_size=e["block_size"],
        decode_chunk=e["decode_chunk"], prefix_cache=e.get("prefix_cache", False),
        kv_quant="int8" if ctx.control == "program_int8" else "", clock=clock,
        device=ctx.device)


def warm_up(ctx: Ctx, eng, vocab: int) -> None:
    """Every shape the cell's traffic reaches, one request at a time: the
    longest prompt, and a request whose reserved span is each
    power-of-two page count a decode dispatch can walk (the engine's view
    width), up to the slot's span."""
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import Request

    e = ctx.cell.workload["engine"]
    bs, max_seq = e["block_size"], e["max_seq"]
    lo, hi = ctx.cell.traffic["prompt"]["min"], ctx.cell.traffic["prompt"]["max"]
    new = 4
    spans, pages = [], 1
    while pages * bs < max_seq:
        if pages * bs - new >= lo:
            spans.append(pages * bs)
        pages *= 2
    prompts = [min(hi, s - new) for s in spans] + [hi]
    r = np.random.default_rng(12345)
    for k, p in enumerate(prompts):
        eng.submit(Request(rid=-(k + 1), prompt=r.integers(0, vocab, p).astype(np.int32),
                           max_new_tokens=new))
        while not eng.idle:
            eng.step()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def drain(ctx: Ctx, eng, comps: Dict, want: int, seconds: float) -> float:
    """Step until ``want`` requests have finished or ``seconds`` pass;
    returns when it gave up (the clock)."""
    end = clock() + seconds
    while len(comps) < want and clock() < end:
        if eng.idle:
            break
        for c in eng.step():
            comps[c.rid] = c
    return clock()


def books(reqs: List[tr.Req], due_abs: Dict[int, float], comps: Dict,
          gave_up: float, t0: float) -> Tuple[List[Dict], int]:
    """One row a request: its times from the window's start, and whether
    it was served in full. A request never served in full counts as
    failed and, in the TTFT tail, as later than every served one."""
    rows, failed = [], 0
    for q in reqs:
        c = comps.get(q.rid)
        ok = (c is not None and len(c.tokens) == q.max_new
              and c.first_token_t is not None)
        failed += not ok
        due = due_abs[q.rid]
        first = c.first_token_t if ok else gave_up
        rows.append({
            "rid": q.rid, "ok": ok, "prompt": int(q.prompt.size), "max_new": q.max_new,
            "due": due - t0, "first": first - t0,
            "admit": (c.admit_t - t0) if ok and c.admit_t is not None else None,
            "done": (c.done_t - t0) if ok else None,
            "ttft_s": first - due,
            "tpot_s": c.tpot_s if ok and len(c.tokens) > 1 else None,
        })
    return rows, failed


def tails(rows: List[Dict]) -> Dict[str, float]:
    out = {"ttft_p90_ms": p90([r["ttft_s"] for r in rows]) * 1e3}
    tp = [r["tpot_s"] for r in rows if r["tpot_s"] is not None]
    out["tpot_p90_ms"] = (p90(tp) or 0.0) * 1e3
    return out


def medians(rows: List[Dict]) -> Dict[str, float]:
    """The tails' medians, for the record beside them."""
    import statistics

    tp = [r["tpot_s"] for r in rows if r["tpot_s"] is not None]
    return {"ttft_p50_ms": statistics.median(r["ttft_s"] for r in rows) * 1e3,
            "tpot_p50_ms": statistics.median(tp) * 1e3 if tp else 0.0}


def _gap_readings(g: torch.Tensor) -> Dict[str, float]:
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean()),
            "mismatch_share": float((g > 0).float().mean()),
            "checked_tokens": int(g.numel())}


def check_served(ctx: Ctx, reqs: List[tr.Req], comps: Dict) -> Tuple[Dict, Dict]:
    """The gaps, over a sample of the finished requests drawn from the
    seed (the one with the most served tokens first, until some hundreds
    of tokens), by which a served token's logit lies below the
    reference's best at its position: their widest, their mean and the
    share of tokens with a gap. The reference re-draws the weights from
    the seed and reads nothing the program made.

    Returns the readings compared and, under the control
    ``reference_fp8``, the program's own beside them: the control's
    readings are then those of the token that the reference computed
    with fp8 operands puts first at each of the same positions."""
    done = [q for q in reqs if q.rid in comps and comps[q.rid].tokens]
    want = ctx.cell.workload["check"]["sample_tokens"]
    idx = tr.sample_indices(len(done), [len(comps[q.rid].tokens) for q in done],
                            want, ctx.seed)
    if not idx:
        return {"widest_gap": float("inf"), "mean_gap": float("inf"),
                "mismatch_share": float("inf"), "checked_tokens": 0}, {}
    seqs, plens = [], []
    for i in idx:
        q = done[i]
        toks = np.concatenate([q.prompt, np.asarray(comps[q.rid].tokens, np.int32)])
        seqs.append(torch.from_numpy(toks).long().to(ctx.device))
        plens.append(int(q.prompt.size))
    w = wts.flat(wts.make(ctx.port, ctx.seed, ctx.device, ctx.dtype))
    with ref.exact_fp32():
        logits = ref.served_logits(ctx.port, w, seqs, plens)
        served = _gap_readings(torch.cat([ref.gaps(lg, s[P:])
                                          for lg, s, P in zip(logits, seqs, plens)]))
        if ctx.control != "reference_fp8":
            return served, {}
        with ref.fp8_operands():
            low = ref.served_logits(ctx.port, w, seqs, plens)
    picks = [lo.argmax(-1) for lo in low]
    control = _gap_readings(torch.cat([ref.gaps(lg, p) for lg, p in zip(logits, picks)]))
    return control, served


def settle() -> None:
    """Just before a window opens: collect set-up's garbage and move every
    object alive now out of the collector's reach (``gc.freeze``), so
    that a collection inside the window scans only what the window made."""
    gc.collect()
    gc.freeze()


def free() -> None:
    """Return what the program held to the device once its objects are
    gone."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def memory_peak() -> int:
    return int(torch.cuda.max_memory_allocated()) if torch.cuda.is_available() else 0


def serving_counters(eng, before: Optional[Dict] = None) -> Dict[str, float]:
    s = eng.stats
    now = {"steps": s.steps, "active_slot_steps": s.active_slot_steps,
           "tokens_out": s.tokens_out, "prefix_hit_tokens": s.prefix_hit_tokens,
           "prefix_lookup_tokens": s.prefix_lookup_tokens}
    if before is None:
        return now
    return {k: now[k] - before[k] for k in now}
