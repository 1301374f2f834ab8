"""Serving metrics: the engine's aggregate and a JSONL sink.

Counterpart of ``kubeflow_controller_tpu/dataplane/metrics.py``'s
:class:`ServingStats` and :class:`MetricsLogger`, with the reference's
summary keys but the jit-cache counts ``prefill_compiles`` and
``admit_cache_size`` (the port compiles no per-shape functions).
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
    # Prefix cache: prompt tokens admission found in cached pages (hit),
    # the share of those whose pages were resident (zero-copy: the page
    # ids enter the slot's table, no byte moves; rehydrated pages moved
    # host -> device bytes), and every prompt token that went through a
    # lookup (the hit rate's denominator).
    prefix_hit_tokens: int = 0
    prefix_zero_copy_tokens: int = 0
    prefix_lookup_tokens: int = 0
    prefill_chunks: int = 0
    pool_blocks_total: int = 0
    pool_blocks_in_use: int = 0
    pool_blocks_resident: int = 0
    kv_bytes_per_token: int = 0
    # Tensor-parallel serving: ``tp`` is the mesh width,
    # ``pool_blocks_per_shard`` the pages each rank's pool holds (all of
    # them: the KVH axis is what splits, not the page axis), and
    # ``kv_hbm_per_device_mb`` the device memory the pool occupies on a
    # rank (1 / tp of the whole pool's).
    tp: int = 1
    pool_blocks_per_shard: int = 0
    kv_hbm_per_device_mb: float = 0.0
    # The engine's analytic traffic model (ServingEngine._traffic_model):
    # device bytes a step reads, per attention phase (the unsuffixed
    # gauge is the decode phase's), and FLOPs a token.
    hbm_bytes_per_step: float = 0.0
    hbm_bytes_per_step_prefill: float = 0.0
    hbm_bytes_per_step_decode: float = 0.0
    hbm_bytes_per_step_verify: float = 0.0
    flops_per_token_per_shard: float = 0.0
    # MoE: the expert bank resident on the device (E at tp=1, E / tp
    # under tp; 0 for a dense model), and the token-x-expert routings of every dispatched
    # forward (each real token a quantum forwards adds top_k, once a
    # forward, not once a layer).
    moe_experts_per_shard: int = 0
    moe_tokens_dispatched: int = 0
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
    # Span counters, synced from the engine's tracer every step (0/0
    # without one).
    spans_recorded: int = 0
    spans_dropped: int = 0
    # Cross-engine KV migration (prefill/decode disaggregation):
    # requests this engine prefilled and handed off, requests it adopted
    # mid-flight, pool pages installed from a payload, the payload bytes
    # this engine exported (counted once fleet-wide, on the export
    # side), and prompt tokens whose pages arrived as pointers because
    # the receiver's trie already held them.
    migrated_in: int = 0
    migrated_out: int = 0
    pages_migrated: int = 0
    migration_bytes: int = 0
    migrated_zero_copy_tokens: int = 0
    # Host tier: pool pages spilled to host memory on eviction (and their
    # payload bytes), admissions that installed at least one spilled page
    # back instead of prefilling it again (and the tokens those pages
    # cover), and the pages the tier holds now.
    spilled_pages: int = 0
    spill_bytes: int = 0
    rehydrate_hits: int = 0
    rehydrate_tokens: int = 0
    host_pages_resident: int = 0
    # Robustness: ``heartbeat`` is the quantum-progress counter the
    # router's watchdog reads, bumped once per completed step() (an
    # injected hang returns before it); ``faults_injected`` the injected
    # faults this engine absorbed; ``migrate_dedups`` re-sent migration
    # payloads this engine turned into no-ops (the lost-ACK guard).
    heartbeat: int = 0
    faults_injected: int = 0
    migrate_dedups: int = 0

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
    def prefix_hit_rate(self) -> float:
        """Share of looked-up prompt tokens served from cached pages (0.0
        without a prefix store or before any admission)."""
        if not self.prefix_lookup_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_lookup_tokens

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
            "cancelled": float(self.finish_reasons.get("cancelled", 0)),
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
            "prefix_hit_tokens": float(self.prefix_hit_tokens),
            "prefix_zero_copy_tokens": float(self.prefix_zero_copy_tokens),
            "prefix_hit_rate": self.prefix_hit_rate,
            "spilled_pages": float(self.spilled_pages),
            "spill_bytes": float(self.spill_bytes),
            "rehydrate_hits": float(self.rehydrate_hits),
            "rehydrate_tokens": float(self.rehydrate_tokens),
            "host_pages_resident": float(self.host_pages_resident),
            "prefill_chunks": float(self.prefill_chunks),
            "pool_blocks_total": float(self.pool_blocks_total),
            "pool_blocks_in_use": float(self.pool_blocks_in_use),
            "pool_blocks_resident": float(self.pool_blocks_resident),
            "kv_bytes_per_token": float(self.kv_bytes_per_token),
            "tp": float(self.tp),
            "pool_blocks_per_shard": float(self.pool_blocks_per_shard),
            "kv_hbm_per_device_mb": float(self.kv_hbm_per_device_mb),
            "hbm_bytes_per_step": float(self.hbm_bytes_per_step),
            "hbm_bytes_per_step_prefill": float(
                self.hbm_bytes_per_step_prefill),
            "hbm_bytes_per_step_decode": float(
                self.hbm_bytes_per_step_decode),
            "hbm_bytes_per_step_verify": float(
                self.hbm_bytes_per_step_verify),
            "flops_per_token_per_shard": float(
                self.flops_per_token_per_shard),
            "moe_experts_per_shard": float(self.moe_experts_per_shard),
            "moe_tokens_dispatched": float(self.moe_tokens_dispatched),
            "draft_proposed": float(self.draft_proposed),
            "draft_accepted": float(self.draft_accepted),
            "acceptance_rate": self.acceptance_rate,
            "spec_steps": float(self.spec_steps),
            "spec_probe_steps": float(self.spec_probe_steps),
            "sampled_requests": float(self.sampled_requests),
            "cow_page_copies": float(self.cow_page_copies),
            "fork_shared_tokens": float(self.fork_shared_tokens),
            "mask_tokens_filtered": float(self.mask_tokens_filtered),
            "migrated_in": float(self.migrated_in),
            "migrated_out": float(self.migrated_out),
            "pages_migrated": float(self.pages_migrated),
            "migration_bytes": float(self.migration_bytes),
            "migrated_zero_copy_tokens": float(
                self.migrated_zero_copy_tokens),
            "spans_recorded": float(self.spans_recorded),
            "spans_dropped": float(self.spans_dropped),
            "samples_dropped": float(self.samples_dropped),
            "heartbeat": float(self.heartbeat),
            "faults_injected": float(self.faults_injected),
            "migrate_dedups": float(self.migrate_dedups),
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
