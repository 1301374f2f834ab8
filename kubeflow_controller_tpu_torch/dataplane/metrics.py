"""Serving metrics: the engine's aggregate and a JSONL sink.

Counterpart of ``kubeflow_controller_tpu/dataplane/metrics.py``'s
:class:`ServingStats` and :class:`MetricsLogger`, cut to the counters
this slice of the port produces (no prefix cache, migration, host tier
or MoE yet).
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
from kubeflow_controller_tpu_torch.obs.telemetry import Reservoir, registry

# Latency samples retained per series (exact percentiles below this,
# sliding window above).
SAMPLE_CAP = 4096


def percentile(xs: Iterable[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); 0.0 on empty input."""
    s = sorted(xs)
    if not s:
        return 0.0
    idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
    return s[idx]


@dataclass
class ServingStats:
    """Aggregate serving metrics across one engine's lifetime.

    * **TTFT** (time to first token): submit -> first token booked on
      the host. Queue wait counts — that is the latency a caller sees.
    * **TPOT** (time per output token): mean inter-token gap after the
      first token, per request.
    * **slot utilization**: active-slot steps / (steps * n_slots).

    ``submitted == finished + rejected`` once the engine is idle: no
    request is dropped without a Completion or a typed rejection.
    """

    n_slots: int = 0
    submitted: int = 0
    admitted: int = 0
    finished: int = 0
    rejected: int = 0
    tokens_out: int = 0
    steps: int = 0
    active_slot_steps: int = 0
    queue_depth_max: int = 0
    ttfts_s: Reservoir = field(default_factory=lambda: Reservoir(SAMPLE_CAP))
    tpots_s: Reservoir = field(default_factory=lambda: Reservoir(SAMPLE_CAP))
    queue_waits_s: Reservoir = field(
        default_factory=lambda: Reservoir(SAMPLE_CAP))
    finish_reasons: Dict[str, int] = field(default_factory=dict)
    prefill_chunks: int = 0
    pool_blocks_total: int = 0
    pool_blocks_in_use: int = 0
    kv_bytes_per_token: int = 0
    # Speculative decoding: draft tokens sent to the verifier and those
    # that committed (acceptance_rate is their ratio), fused verify
    # dispatches, quanta that took the un-pipelined proposal path (a
    # superset of spec_steps), and committed tokens per slot-step (1..K+1)
    # -> occurrences.
    draft_proposed: int = 0
    draft_accepted: int = 0
    spec_steps: int = 0
    spec_probe_steps: int = 0
    spec_step_tokens_hist: Dict[int, int] = field(default_factory=dict)
    # Sampling: non-greedy generations admitted (forked children
    # included), device page copies copy-on-write forking made (one a
    # child with a partial boundary page), prompt tokens whose KV a
    # forked child reads by reference instead of prefilling again, and
    # vocab entries constrained decoding masked out over all masked
    # tokens.
    sampled_requests: int = 0
    cow_page_copies: int = 0
    fork_shared_tokens: int = 0
    mask_tokens_filtered: int = 0
    # Quantum-progress counter: bumped once per completed step().
    heartbeat: int = 0

    def record(self, completion) -> None:
        self.finished += 1
        reason = getattr(completion, "finish_reason", "")
        self.finish_reasons[reason] = self.finish_reasons.get(reason, 0) + 1
        reg = registry()
        reg.counter("requests_finished", "serving").inc()
        reg.counter(f"finish_{reason or 'none'}", "serving").inc()
        if completion.ttft_s is not None:
            self.ttfts_s.append(completion.ttft_s)
            reg.histogram("ttft_s", "serving").observe(completion.ttft_s)
        if len(completion.tokens) > 1:
            self.tpots_s.append(completion.tpot_s)
            reg.histogram("tpot_s", "serving").observe(completion.tpot_s)

    def record_queue_wait(self, wait_s: float) -> None:
        self.queue_waits_s.append(wait_s)
        registry().histogram("queue_wait_s", "serving").observe(wait_s)

    @property
    def samples_dropped(self) -> int:
        return (self.ttfts_s.dropped + self.tpots_s.dropped
                + self.queue_waits_s.dropped)

    @property
    def slot_utilization(self) -> float:
        denom = self.steps * self.n_slots
        return self.active_slot_steps / denom if denom else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Committed over proposed draft tokens (0.0 before any
        proposal)."""
        if not self.draft_proposed:
            return 0.0
        return self.draft_accepted / self.draft_proposed

    def summary(self, wall_s: float = 0.0) -> Dict[str, float]:
        out = {
            "requests": float(self.finished),
            "tokens_out": float(self.tokens_out),
            "rejected": float(self.rejected),
            "shed": float(self.finish_reasons.get("shed", 0)),
            "deadline_expired": float(
                self.finish_reasons.get("deadline", 0)),
            "ttft_p50_ms": percentile(self.ttfts_s, 50) * 1e3,
            "ttft_p95_ms": percentile(self.ttfts_s, 95) * 1e3,
            "tpot_p50_ms": percentile(self.tpots_s, 50) * 1e3,
            "tpot_p95_ms": percentile(self.tpots_s, 95) * 1e3,
            "queue_wait_p50_ms": percentile(self.queue_waits_s, 50) * 1e3,
            "queue_wait_p95_ms": percentile(self.queue_waits_s, 95) * 1e3,
            "queue_depth_max": float(self.queue_depth_max),
            "slot_utilization": self.slot_utilization,
            "prefill_chunks": float(self.prefill_chunks),
            "pool_blocks_total": float(self.pool_blocks_total),
            "pool_blocks_in_use": float(self.pool_blocks_in_use),
            "kv_bytes_per_token": float(self.kv_bytes_per_token),
            "draft_proposed": float(self.draft_proposed),
            "draft_accepted": float(self.draft_accepted),
            "acceptance_rate": self.acceptance_rate,
            "spec_steps": float(self.spec_steps),
            "spec_probe_steps": float(self.spec_probe_steps),
            "sampled_requests": float(self.sampled_requests),
            "cow_page_copies": float(self.cow_page_copies),
            "fork_shared_tokens": float(self.fork_shared_tokens),
            "mask_tokens_filtered": float(self.mask_tokens_filtered),
            "samples_dropped": float(self.samples_dropped),
            "heartbeat": float(self.heartbeat),
        }
        # The committed-tokens histogram as flat keys spec_step_tokens_1
        # .. spec_step_tokens_{K+1}: one flat record a line.
        for n_tok in sorted(self.spec_step_tokens_hist):
            out[f"spec_step_tokens_{n_tok}"] = float(
                self.spec_step_tokens_hist[n_tok])
        if wall_s > 0:
            out["tokens_per_sec"] = self.tokens_out / wall_s
        return out


class MetricsLogger:
    """Line-buffered JSONL sink: one ``{"ts", "step", ...}`` record per
    ``write``; non-finite floats become ``null``."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)   # line-buffered
        self.path = path

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"ts": round(time.time(), 3), "step": step}
        rec.update({
            k: (fv if math.isfinite(fv := float(v)) else None)
            for k, v in scalars.items()
        })
        self._f.write(json.dumps(rec, allow_nan=False) + "\n")

    def close(self) -> None:
        self._f.close()


def from_context(ctx: ProcessContext) -> Optional[MetricsLogger]:
    """MetricsLogger for this process, or None when the job has no log_dir."""
    if not ctx.log_dir:
        return None
    return MetricsLogger(
        os.path.join(ctx.log_dir, f"metrics-p{ctx.process_id}.jsonl")
    )
