"""LM batch-inference entrypoint on the GPU.

Counterpart of ``kubeflow_controller_tpu/dataplane/entrypoints/
serve_lm.py``: build a freshly initialised model from a seed (no
weights are downloaded; restoring a checkpoint is not yet ported), read
token-id prompts (JSONL ``{"prompt": [ids...]}`` from ``--input``, or a
synthetic batch), serve them through the continuous-batching engine
(``dataplane/serving_engine.py``: paged KV pool, chunked prefill, fused
decode chunks with on-device retirement, slot reuse), write completions
JSONL to ``--output`` and report TTFT/TPOT/tokens per second.

    python -m kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm \\
        --config llama3_8b --batch 16 --slots 8 --prompt-len 256

Runs on ``cuda``; ``--device cpu`` runs the plain PyTorch versions on
the CPU. The command line takes every option of the JAX entry point's,
with its default (``--attn-impl`` also takes the JAX names ``xla`` and
``pallas``); options whose features this port does not serve yet are
refused with "not yet ported" when they are off that default.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
from kubeflow_controller_tpu_torch.dataplane.entrypoints.lm import (
    CONFIGS, NOT_YET_PORTED, model_config,
)
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("tpujob.serve_lm_torch")

#: serve() keywords of features not ported yet, with the value that means
#: "off". Any other value raises NotImplementedError.
NOT_YET_PORTED_FLAGS = {
    "model_dir": "",
    "quant": "",
    "temperature": 0.0,
    "top_k": 0,
    "top_p": 1.0,
    "n": 1,
    "grammar": "",
    "turns": 1,
    "prefix_cache": False,
    "host_kv_mb": 0.0,
    "speculative": False,
    "tp": 1,
    "trace": "",
    "disagg": False,
    "fault_plan": "",
    "watchdog_stale_s": 0.0,
    "paged": True,
    "draft_k": 4,
    "proposer": "prompt",
    "tp_compute": "gathered",
    "mesh_devices": "",
    "fault_seed": 0,
}
#: The command-line spelling of a keyword where it is not the keyword's,
#: and the choices the JAX entry point's parser gives an option.
_CLI_NAMES = {"mesh_devices": "--mesh"}
_CLI_CHOICES = {"quant": ["", "int8"], "proposer": ["prompt", "radix"],
                "tp_compute": ["gathered", "parallel"]}


def _read_prompts(path: str, vocab: int, batch: int,
                  prompt_len: int) -> np.ndarray:
    """Token-id prompts ``[batch, prompt_len]`` int32 from JSONL, or the
    JAX entry point's synthetic batch (``default_rng(0)``) when ``path``
    is empty. Prompts must share one length, and ids must be in range."""
    if not path:
        rng = np.random.default_rng(0)
        return rng.integers(0, vocab, (batch, prompt_len)).astype(np.int32)
    rows: List[List[int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line)["prompt"])
    if not rows:
        raise ValueError(f"{path}: no prompts")
    lengths = {len(r) for r in rows}
    if len(lengths) != 1:
        raise ValueError(
            f"{path}: prompts must share one length (got {sorted(lengths)})")
    if not lengths.pop():
        raise ValueError(f"{path}: empty prompt")
    arr = np.asarray(rows, np.int64)
    bad = (arr < 0) | (arr >= vocab)
    if bad.any():
        i, j = map(int, np.argwhere(bad)[0])
        raise ValueError(
            f"{path}: prompt {i} token {arr[i, j]} out of range for vocab "
            f"{vocab}")
    return arr.astype(np.int32)


def _load_params(cfg, model_dir: str, seed: int, device):
    """(params, restored_step): a fresh init drawn in the compute dtype
    from ``seed``; restoring a checkpoint is not yet ported."""
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    if model_dir:
        raise NotImplementedError(
            "restoring a checkpoint (model_dir) is not yet ported; the "
            "PyTorch entry point serves a fresh init")
    return tfm.init_params(cfg, seed=seed, device=device, dtype=cfg.dtype), None


def serve(
    ctx: Optional[ProcessContext] = None,
    config: str = "tiny",
    input_file: str = "",
    output_file: str = "",
    batch: int = 8,
    prompt_len: int = 32,
    max_new_tokens: int = 32,
    seed: int = 0,
    slots: int = 0,
    eos_id: Optional[int] = None,
    deadline_s: Optional[float] = None,
    max_queue: Optional[int] = None,
    drain_grace_s: float = 2.0,
    prefill_mode: str = "bucketed",
    block_size: int = 16,
    kv_pool_mb: Optional[float] = None,
    kv_quant: str = "",
    attn_impl: str = "kernel",
    stop=None,
    device: DeviceLike = None,
    **not_yet_ported,
) -> Dict[str, float]:
    """Serve ``batch`` prompts through the engine; returns the summary
    (``tokens_per_sec``, ``ttft_p50_ms``, ``tpot_p50_ms``, ...).

    Two defaults differ from the JAX entry point's on purpose:
    ``attn_impl`` is ``"kernel"`` (the hand-written kernels; the JAX
    default ``"xla"`` is accepted as an alias of ``"gather"``, ``"pallas"``
    of ``"kernel"``), and ``prefill_mode`` is ``"bucketed"``, since exact
    prefill is not yet ported. A job's model dir and a multi-process job
    (``ctx.num_processes > 1``) are refused with "not yet ported".

    ``stop`` (a ``threading.Event``) drains the engine within
    ``drain_grace_s`` and still writes the partial completions.
    Keywords of :data:`NOT_YET_PORTED_FLAGS` are accepted and refused
    unless they hold their "off" value."""
    from kubeflow_controller_tpu_torch.dataplane import metrics as metrics_mod
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Rejected, Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import generate as gen

    for key, value in not_yet_ported.items():
        if key not in NOT_YET_PORTED_FLAGS:
            raise TypeError(f"serve() got an unexpected keyword {key!r}")
        if value != NOT_YET_PORTED_FLAGS[key]:
            raise NotImplementedError(
                f"serve({key}={value!r}) is not yet ported to the PyTorch "
                f"entry point (see ROADMAP.md)")
    ctx = ctx or ProcessContext.from_env()
    if ctx.num_processes > 1:
        raise NotImplementedError(
            f"multi-process serving (num_processes={ctx.num_processes}) is "
            "not yet ported")
    cfg = model_config(config)
    dev = resolve_device(device)
    params, restored_step = _load_params(cfg, ctx.model_dir, seed, dev)
    params = gen.inference_params(cfg, params)
    prompts = _read_prompts(input_file, cfg.vocab_size, batch, prompt_len)
    b, s = prompts.shape
    if input_file and (b, s) != (batch, prompt_len):
        logger.warning(
            "--input %s defines the prompt shape (batch %d, prompt_len %d);"
            " ignoring --batch %d / --prompt-len %d",
            input_file, b, s, batch, prompt_len)

    t0 = time.perf_counter()
    interrupted = False
    n_slots = min(slots, b) if slots > 0 else b
    engine = ServingEngine(
        cfg, params, n_slots=n_slots, max_seq=s + max_new_tokens,
        max_queue=max_queue, prefill_mode=prefill_mode,
        block_size=block_size, kv_hbm_budget_mb=kv_pool_mb,
        kv_quant=kv_quant, attn_impl=attn_impl, device=dev)
    for i in range(b):
        try:
            engine.submit(Request(
                rid=i, prompt=prompts[i], max_new_tokens=max_new_tokens,
                eos_id=eos_id, deadline_s=deadline_s))
        except Rejected as e:
            logger.warning("request %d rejected: %s", i, e.reason)
    # Worst case: every prompt prefills chunkwise, one chunk per step.
    chunks = -(-s // block_size)
    max_steps = b * (max_new_tokens + chunks) + 2 * b + 4
    completions = []
    for _ in range(max_steps):
        if stop is not None and stop.is_set():
            logger.info("stop requested: draining engine (grace %.1fs)",
                        drain_grace_s)
            completions.extend(engine.drain(drain_grace_s))
            interrupted = True
            break
        completions.extend(engine.step())
        if engine.idle:
            break
    if not interrupted and not engine.idle:
        logger.error("engine failed to drain; flushing partials")
        completions.extend(engine.drain(0.0))
    dt = time.perf_counter() - t0
    serving = engine.stats.summary(wall_s=dt)
    completions.sort(key=lambda c: c.rid)

    if output_file:
        with open(output_file, "w") as f:
            for c in completions:
                f.write(json.dumps({
                    "rid": c.rid,
                    "gen": c.gen,
                    "prompt": prompts[c.rid].tolist(),
                    "completion": list(map(int, c.tokens)),
                    "finish_reason": c.finish_reason,
                }) + "\n")
    new_total = sum(len(c.tokens) for c in completions)
    tps = new_total / dt
    logger.info("served %d prompts (%d new tokens total) in %.2fs "
                "(%.0f tok/s) on %s", b, new_total, dt, tps, dev)
    out = {
        "prompts": float(b),
        "new_tokens": float(max_new_tokens),
        "tokens_per_sec": tps,
        "wall_s": dt,
        "restored_step": float(-1 if restored_step is None else restored_step),
        "interrupted": float(interrupted),
    }
    out.update(serving)
    ml = metrics_mod.from_context(ctx)
    if ml is not None:
        ml.write(0, out)
        ml.close()
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="tiny",
                   choices=sorted(CONFIGS) + list(NOT_YET_PORTED))
    p.add_argument("--input", default="",
                   help="JSONL of {\"prompt\": [token ids]}")
    p.add_argument("--output", default="", help="completions JSONL")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the fresh weight init")
    p.add_argument("--slots", type=int, default=0,
                   help="slot-pool size (0 = one slot per request)")
    p.add_argument("--eos-id", type=int, default=-1,
                   help="token id that retires a sequence early (-1 = none)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="per-request latency budget in seconds (0 = none)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="bound the engine FIFO (0 = unbounded)")
    p.add_argument("--drain-grace-s", type=float, default=2.0)
    p.add_argument("--prefill-mode", default="bucketed",
                   choices=["exact", "bucketed"])
    p.add_argument("--block-size", type=int, default=16,
                   help="KV page size in tokens (power of two)")
    p.add_argument("--kv-pool-mb", type=float, default=0.0,
                   help="device-memory budget of the KV pool in MiB "
                        "(0 = one full context per slot)")
    p.add_argument("--kv-quant", default="none", choices=["none", "int8"])
    p.add_argument("--attn-impl", default="kernel",
                   choices=["kernel", "gather", "pallas", "xla"],
                   help="kernel (or pallas) = the hand-written "
                        "paged-attention kernels; gather (or xla) = dense "
                        "view gather + full softmax (oracle)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    for key, off in NOT_YET_PORTED_FLAGS.items():
        if isinstance(off, bool):
            kind = dict(action=argparse.BooleanOptionalAction if off
                        else "store_true")
        else:
            kind = dict(type=type(off))
            if key in _CLI_CHOICES:
                kind["choices"] = _CLI_CHOICES[key]
        p.add_argument(_CLI_NAMES.get(key, "--" + key.replace("_", "-")),
                       dest=key, default=off, help="not yet ported", **kind)
    args = p.parse_args(argv)
    refused = {k: getattr(args, k) for k in NOT_YET_PORTED_FLAGS}
    # SIGTERM drains the engine and still writes the partial completions.
    stop = threading.Event()
    previous = signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        metrics = serve(
            config=args.config, input_file=args.input,
            output_file=args.output, batch=args.batch,
            prompt_len=args.prompt_len, max_new_tokens=args.max_new_tokens,
            seed=args.seed, slots=args.slots,
            eos_id=None if args.eos_id < 0 else args.eos_id,
            deadline_s=args.deadline_s if args.deadline_s > 0 else None,
            max_queue=args.max_queue if args.max_queue > 0 else None,
            drain_grace_s=args.drain_grace_s,
            prefill_mode=args.prefill_mode, block_size=args.block_size,
            kv_pool_mb=args.kv_pool_mb if args.kv_pool_mb > 0 else None,
            kv_quant="" if args.kv_quant == "none" else args.kv_quant,
            attn_impl=args.attn_impl, device=args.device, stop=stop,
            **refused)
    finally:
        signal.signal(signal.SIGTERM, previous)
    return 0 if metrics["prompts"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
