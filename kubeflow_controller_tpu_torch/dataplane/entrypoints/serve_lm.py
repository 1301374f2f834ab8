"""LM batch-inference entrypoint on the GPU.

Counterpart of ``kubeflow_controller_tpu/dataplane/entrypoints/
serve_lm.py``: restore the parameters of the latest checkpoint in
``--model-dir`` (``TPUJOB_MODEL_DIR``; written by the port's ``lm.train``)
or, with none there, build a freshly initialised model from a seed; read
token-id prompts (JSONL ``{"prompt": [ids...]}`` from ``--input``, or a
synthetic batch), serve them through the continuous-batching engine
(``dataplane/serving_engine.py``: paged KV pool, exact or chunked
prefill, fused decode chunks with on-device retirement, slot reuse,
with ``--speculative`` drafts (prompt lookup, or ``--proposer radix``
from the prefix trie) verified in one forward, per-request sampling:
``--temperature``/``--top-k``/``--top-p`` under the seeded key chain,
``--n`` copy-on-write forks and ``--grammar`` masks, and
``--prefix-cache`` with the ``--host-kv-mb`` tier beneath it), write
completions JSONL to ``--output`` and report TTFT/TPOT/tokens per
second. ``--quant int8`` serves weight-only int8 projections (the
checkpoint's or the fresh init's weights quantized once, after they
load). ``--turns N`` serves a multi-turn chat: through the engine with
the prefix cache (each turn submits the whole history), or, without it,
on a contiguous cache (``prefill``, then ``prefill_continue`` a turn,
each reply by ``generate_from_cache``); ``--no-paged`` is accepted
there, and refused by the engine everywhere else, as in the JAX entry
point.

    python -m kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm \\
        --config llama3_8b --batch 16 --slots 8 --prompt-len 256 \\
        --temperature 0.8 --top-k 50 --top-p 0.95 --speculative --draft-k 4

``--tp N`` serves over a tensor-parallel gang of N processes, one a tp
rank, started by the controller's env (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES=N``, ``JAX_PROCESS_ID``): each joins the group
(``dataplane/dist.py:initialize_from_env``), holds its ``1 / N`` of the
weights and of the pool's KV heads, and serves the same requests;
``--tp-compute gathered`` gives the one-device streams bit for bit,
``parallel`` splits every projection (``models/generate.py``). Rank 0
writes the completions and the metrics. A two-rank gang on the CPU:

    for id in 0 1; do JAX_COORDINATOR_ADDRESS=127.0.0.1:29500 \
        JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=$id python -m \
        kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm \
        --config tiny --tp 2 --tp-compute parallel --device cpu & done; wait

``--disagg`` serves through a two-replica fleet in one process
(``dataplane/router.py``): ``prefill-0`` prefills every request and
``decode-0`` decodes it, the KV pages moving between their pools;
``--trace out.json`` writes the Chrome trace of every request's spans
(router and engines on one tracer), flushed on every exit;
``--fault-plan plan.json`` (with ``--fault-seed``) injects the plan's
faults (``dataplane/faults.py``) and ``--watchdog-stale-s`` turns on the
router's progress watchdog (``--disagg`` only):

    python -m kubeflow_controller_tpu_torch.dataplane.entrypoints.serve_lm \
        --config tiny --disagg --trace out.json --fault-plan plan.json \
        --device cpu

Runs on ``cuda``; ``--device cpu`` runs the plain PyTorch versions on
the CPU. The command line takes every option of the JAX entry point's,
with its default (``--attn-impl`` also takes the JAX names ``xla`` and
``pallas``). In a tp gang, ``--disagg`` and ``--fault-plan`` are refused
with "not yet ported".
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
    CONFIGS, model_config,
)
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("tpujob.serve_lm_torch")

#: The fleet counters ``serve(disagg=True)`` copies from the router's
#: summary into its own.
FLEET_SUMMARY_KEYS = (
    "migrations", "pages_migrated", "migration_bytes",
    "migrated_zero_copy_tokens", "spilled_pages", "spill_bytes",
    "rehydrate_hits", "rehydrate_tokens", "host_pages_resident",
    "prefix_pulls", "prefix_pull_pages", "prefix_pull_bytes",
    "faults_injected", "migrate_dedups", "watchdog_strikes",
    "dispatch_timeouts", "migration_timeouts", "deadline_sheds")


class _RelClock:
    """The fault injector's clock: ``perf_counter`` rebased to the first
    fault-site check, so a plan's windows are seconds from when serving
    starts stepping (not since boot, and not spent on the set-up)."""

    t0 = None

    def __call__(self):
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        return now - self.t0


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


def _load_params(cfg, model_dir: str, seed: int, device, quant: str = ""):
    """(params, restored_step): the parameters of the latest checkpoint in
    ``model_dir`` (``dataplane/train.py``'s format), or, with none there
    (a warning) or no ``model_dir``, a fresh init drawn in the compute
    dtype from ``seed`` and restored_step None. A fresh init under
    ``quant="int8"`` comes already quantized, drawn and quantized a
    layer at a time (``generate.init_inference_params``): mixtral_8x7b's
    bf16 tree (~93 GB) does not fit one card, its int8 tree (~47 GB)
    does."""
    from kubeflow_controller_tpu_torch.dataplane import train
    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    if model_dir:
        steps = train.checkpoint_steps(model_dir)
        if steps:
            logger.info("restored params from %s @ step %d", model_dir,
                        steps[-1])
            return train.load_params(model_dir, steps[-1], device), steps[-1]
        logger.warning("%s: no checkpoint found; serving fresh init",
                       model_dir)
    if quant:
        return gen.init_inference_params(cfg, seed, device, quant=quant), None
    return tfm.init_params(cfg, seed=seed, device=device, dtype=cfg.dtype), None


def _device_and_mesh(ctx: ProcessContext, tp: int, mesh_devices: str,
                     device: DeviceLike):
    """``(device, mesh)`` of this process: one device and no mesh at
    ``tp <= 1`` in a one-process job; else the job's group joined
    (``initialize_from_env``), ``tp`` held to its process count, this
    rank's device, and the 1-D tp mesh over the job's ranks (which
    raises the mesh's ``ValueError`` for ``tp > 1`` in one process)."""
    import torch
    import torch.distributed as dist

    from kubeflow_controller_tpu_torch.dataplane import dist as ddist
    from kubeflow_controller_tpu_torch.parallel.mesh import serving_mesh

    if ctx.num_processes > 1:
        if tp != ctx.num_processes:
            raise ValueError(
                f"serve: a job of {ctx.num_processes} processes serves at "
                f"tp={ctx.num_processes}, one process a tp rank (got tp={tp})")
        if not dist.is_initialized():
            ddist.initialize_from_env(device=None if device is None
                                      else str(device))
        ddist.require_process_group(ctx)
    cards = [int(c) for c in mesh_devices.split(",")] if mesh_devices else []
    if cards and len(cards) != tp:
        raise ValueError(
            f"--mesh names {len(cards)} devices for tp={tp}: give one a rank")
    if cards and (device is None or torch.device(device).type == "cuda"):
        device = f"cuda:{cards[ctx.process_id]}"
    dev = resolve_device(ddist.job_device(ctx, device))
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev, serving_mesh(tp, device_type=dev.type)


def serve(
    ctx: Optional[ProcessContext] = None,
    config: str = "tiny",
    model_dir: str = "",
    input_file: str = "",
    output_file: str = "",
    batch: int = 8,
    prompt_len: int = 32,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    n: int = 1,
    seed: int = 0,
    grammar: str = "",
    slots: int = 0,
    eos_id: Optional[int] = None,
    deadline_s: Optional[float] = None,
    max_queue: Optional[int] = None,
    drain_grace_s: float = 2.0,
    prefill_mode: str = "exact",
    block_size: int = 16,
    kv_pool_mb: Optional[float] = None,
    kv_quant: str = "",
    speculative: bool = False,
    draft_k: int = 4,
    proposer: str = "prompt",
    attn_impl: str = "kernel",
    turns: int = 1,
    prefix_cache: bool = False,
    host_kv_mb: float = 0.0,
    quant: str = "",
    paged: bool = True,
    tp: int = 1,
    tp_compute: str = "gathered",
    mesh_devices: str = "",
    trace: str = "",
    disagg: bool = False,
    fault_plan: str = "",
    fault_seed: int = 0,
    watchdog_stale_s: float = 0.0,
    stop=None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Serve ``batch`` prompts through the engine; returns the summary
    (``tokens_per_sec``, ``ttft_p50_ms``, ``tpot_p50_ms``, the spec and
    sampling counters, ``restored_step``: -1 for a fresh init, ...).

    ``temperature``/``top_k``/``top_p`` set the engine's sampling
    defaults and ``seed`` its key chain (and the fresh init's weights);
    ``n > 1`` forks each prompt into ``n`` generations and ``grammar``
    (``json``, ``re:<pattern>``, ``set:<ids>``) masks every draw, through
    one ``SamplingParams`` shared by every request, as in the JAX entry
    point. ``n > 1`` needs the paged pool; ``n`` and ``grammar`` need
    ``turns == 1``.

    ``prefix_cache`` serves through the radix prefix cache (bucketed
    prefill), ``host_kv_mb > 0`` (needs it) spills evicted pages to a
    pinned-host tier, and ``proposer="radix"`` drafts from the trie.
    ``turns > 1`` serves a chat of ``turns`` turns: each turn after the
    first appends a follow-up of ``prompt_len`` tokens from
    ``default_rng(seed + turn)`` to every conversation. With
    ``prefix_cache`` each turn submits the whole history to the engine
    (the previous turns' pages are reused); without it the conversation
    lives in one contiguous cache (``prefill``, ``prefill_continue`` a
    turn, ``generate_from_cache`` a reply, sampled with temperature only,
    under ``fold_in(key(seed), turn)``); that path returns no engine
    stats.

    The parameters come from ``model_dir or ctx.model_dir`` when a
    checkpoint is there, cast as ``inference_params`` casts them. One
    default differs from the JAX entry point's on purpose: ``attn_impl``
    is ``"kernel"`` (the hand-written kernels; the JAX default ``"xla"``,
    the gathered-view oracle, is accepted as an alias of ``"gather"``,
    ``"pallas"`` of ``"kernel"``): the port serves through its kernels
    unless asked for the oracle.

    ``tp > 1`` serves over a tp mesh of that many processes: a job of
    ``ctx.num_processes`` processes joins its group through
    ``initialize_from_env`` and serves at ``tp`` equal to its process
    count (any other ``tp`` is refused); ``tp_compute`` is
    ``"gathered"`` or ``"parallel"``. The head split is checked before
    any weight loads (``generate.check_tp_heads``). Rank ``i`` drives
    ``cuda:<mesh_devices[i]>`` (a comma-separated list of cards), or with
    none given the card training gives it (``dist.local_device``).
    Every rank returns the summary; rank 0 alone writes
    ``output_file`` and the metrics.

    ``quant="int8"`` serves weight-only int8 projections
    (``inference_params(quant="int8")``, after the checkpoint's weights
    are restored). ``paged=False`` is accepted where the reference
    accepts it, on the contiguous multi-turn path; elsewhere the engine
    raises the reference's ``ValueError``, and so does ``n > 1``.

    ``disagg`` serves through a fleet of two engines under one
    :class:`~..router.FleetRouter`: ``prefill-0`` (bucketed prefill
    with the prefix cache, ``prefill_only`` admissions) and ``decode-0``
    (the same engine, fed by KV-page migration); they share the weight
    tensors, each has its own pool. The summary is ``decode-0``'s stats
    with the fleet counters of :data:`FLEET_SUMMARY_KEYS`. ``trace``
    names a Chrome-trace JSON file: the engines (and the router) record
    every request's spans there, flushed on every exit. ``fault_plan``
    names a JSON :class:`~..faults.FaultPlan`, fired by one injector
    (seeded by ``fault_seed``, on ``perf_counter`` rebased to its first
    check) in every engine, tier and the router; its fire counts join
    the summary. ``watchdog_stale_s > 0`` is the router's progress
    watchdog (needs ``disagg``). In a tp gang ``disagg`` and
    ``fault_plan`` raise "not yet ported", and rank 0 alone traces.

    ``stop`` (a ``threading.Event``) drains the engine within
    ``drain_grace_s`` and still writes the partial completions (and
    flushes the trace)."""
    import torch

    from kubeflow_controller_tpu_torch.dataplane import metrics as metrics_mod
    from kubeflow_controller_tpu_torch.dataplane import sampling
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Rejected, Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.dataplane.router import FleetRouter
    from kubeflow_controller_tpu_torch.models import generate as gen
    from kubeflow_controller_tpu_torch.obs.trace import Tracer

    # The reference's checks, in its order, before any weights load.
    tracer = Tracer(path=trace) if trace else None
    injector = None
    if fault_plan:
        from kubeflow_controller_tpu_torch.dataplane import faults

        injector = faults.FaultInjector(
            faults.load_plan(fault_plan), clock=_RelClock(),
            seed=fault_seed, tracer=tracer)
    if watchdog_stale_s < 0:
        raise ValueError(
            f"--watchdog-stale-s must be >= 0 (got {watchdog_stale_s})")
    if watchdog_stale_s > 0 and not disagg:
        raise ValueError(
            "--watchdog-stale-s is the fleet router's progress watchdog "
            "and requires --disagg (the single-engine path has no "
            "router to strike replicas out)")
    if fault_plan and turns > 1:
        raise ValueError(
            "--fault-plan targets the continuous-batching engine "
            "(turns == 1)")
    sampling.SamplingParams(temperature=temperature, top_k=top_k,
                            top_p=top_p, n=n, seed=seed).validate()
    if n > 1 and not paged:
        raise ValueError(
            "n > 1 forks prompt KV pages copy-on-write and requires the "
            "paged block pool (drop --no-paged)")
    if (n > 1 or grammar) and turns > 1:
        raise ValueError(
            "--n / --grammar are single-turn engine features (turns == 1)")
    if disagg and turns > 1:
        raise ValueError("--disagg is a single-turn engine feature")
    if disagg and not paged:
        raise ValueError(
            "--disagg migrates KV pages between engines and requires "
            "the paged block pool (drop --no-paged)")
    if host_kv_mb < 0:
        raise ValueError(f"--host-kv-mb must be >= 0 (got {host_kv_mb})")
    if host_kv_mb > 0 and not prefix_cache:
        raise ValueError(
            "--host-kv-mb spills radix-cache pages to host RAM and "
            "requires --prefix-cache (0 disables the tier)")
    if (top_k > 0 or top_p < 1.0) and turns > 1 and not prefix_cache:
        raise ValueError(
            "top-k/top-p serve through the engine; the contiguous "
            "multi-turn path (--turns without --prefix-cache) supports "
            "temperature only")
    for asked, what in ((disagg, "disagg"), (fault_plan, "fault_plan")):
        if asked and tp > 1:
            raise NotImplementedError(
                f"serve({what}=...) over a tensor-parallel gang is not yet "
                f"ported to the PyTorch entry point (see ROADMAP.md)")
    cfg = model_config(config)
    # The head split is checked before anything loads or joins a group.
    gen.check_tp_heads(cfg, tp, tp_compute)
    if tp > 1 and turns > 1 and not prefix_cache:
        raise ValueError(
            "tp > 1 serves through the continuous-batching engine; "
            "the contiguous multi-turn path (--turns without "
            "--prefix-cache) is single-chip only")
    ctx = ctx or ProcessContext.from_env()
    dev, mesh = _device_and_mesh(ctx, tp, mesh_devices, device)
    rank0 = mesh is None or mesh.rank == 0
    if not rank0:
        tracer = None                # rank 0 writes the trace
    params, restored_step = _load_params(cfg, model_dir or ctx.model_dir,
                                         seed, dev, quant)
    if not gen.weight_quant(params):
        params = gen.inference_params(cfg, params, quant=quant)
    prompts = _read_prompts(input_file, cfg.vocab_size, batch, prompt_len)
    b, s = prompts.shape
    if input_file and (b, s) != (batch, prompt_len):
        logger.warning(
            "--input %s defines the prompt shape (batch %d, prompt_len %d);"
            " ignoring --batch %d / --prompt-len %d",
            input_file, b, s, batch, prompt_len)

    t0 = time.perf_counter()
    interrupted = False
    serving: Dict[str, float] = {}
    n_slots = min(slots, b) if slots > 0 else b
    engine = None
    mode = "bucketed" if prefix_cache else prefill_mode

    def make_engine(pm: str, pc: bool) -> ServingEngine:
        # A conversation of `turns` turns fits a slot.
        return ServingEngine(
            cfg, params, n_slots=n_slots,
            max_seq=max(1, turns) * (s + max_new_tokens),
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            max_queue=max_queue, prefill_mode=pm, prefix_cache=pc,
            block_size=block_size, kv_hbm_budget_mb=kv_pool_mb,
            host_kv_mb=host_kv_mb, kv_quant=kv_quant,
            spec_decode=speculative, draft_k=draft_k, proposer=proposer,
            attn_impl=attn_impl, paged=paged, mesh=mesh,
            tp_compute=tp_compute, tracer=tracer, injector=injector,
            device=dev)

    engines = {}
    if disagg:
        # One prefill and one decode engine, both bucketed with the
        # prefix cache, on the weight tensors they share.
        engines = {"prefill-0": make_engine("bucketed", True),
                   "decode-0": make_engine("bucketed", True)}
        engine = engines["decode-0"]
        params = None
    elif turns <= 1 or prefix_cache:
        engine = make_engine(mode, prefix_cache)
        # The engine holds this rank's chunks; the whole tree goes.
        params = None
    if disagg:
        req_params = _request_params(cfg, temperature, top_k, top_p, n,
                                     seed, grammar, eos_id)
        router = FleetRouter(
            clock=time.perf_counter, block_size=block_size, tracer=tracer,
            injector=injector,
            watchdog_stale_s=(watchdog_stale_s if watchdog_stale_s > 0
                              else None))
        router.add_replica("prefill-0", engines["prefill-0"], role="prefill")
        router.add_replica("decode-0", engines["decode-0"], role="decode")
        for i in range(b):
            router.submit(Request(
                rid=i, prompt=prompts[i], max_new_tokens=max_new_tokens,
                eos_id=eos_id, deadline_s=deadline_s, params=req_params))
        # Every request may prefill its whole prompt chunkwise.
        chunks = -(-s // block_size)
        max_steps = 2 * (b * n * (max_new_tokens + chunks) + 2 * b * n + 4)
        completions = []
        for _ in range(max_steps):
            if stop is not None and stop.is_set():
                logger.info("stop requested: draining fleet (grace %.1fs)",
                            drain_grace_s)
                for e in engines.values():
                    completions.extend(e.drain(drain_grace_s))
                interrupted = True
                break
            completions.extend(router.step())
            if router.idle:
                break
        if not interrupted and not router.idle:
            logger.error("fleet failed to drain; flushing partials")
            for e in engines.values():
                completions.extend(e.drain(0.0))
        dt = time.perf_counter() - t0
        # The decode engine's stats carry the tokens; the migration and
        # fault counters come from the fleet (both engines and the
        # router).
        serving = engine.stats.summary(wall_s=dt)
        fleet = router.fleet_summary()
        for k in FLEET_SUMMARY_KEYS:
            serving[k] = fleet[k]
        completions.sort(key=lambda c: (c.rid, c.gen))
        rows = [(c.rid, c.gen, list(map(int, c.tokens)), c.finish_reason)
                for c in completions]
    elif turns <= 1:
        req_params = _request_params(cfg, temperature, top_k, top_p, n,
                                     seed, grammar, eos_id)
        for i in range(b):
            try:
                engine.submit(Request(
                    rid=i, prompt=prompts[i], max_new_tokens=max_new_tokens,
                    eos_id=eos_id, deadline_s=deadline_s, params=req_params))
            except Rejected as e:
                logger.warning("request %d rejected: %s", i, e.reason)
        # Worst case: every prompt prefills chunkwise, one chunk per step
        # (a small pool can force it every wave).
        chunks = -(-s // block_size) if mode != "exact" else 1
        max_steps = b * n * (max_new_tokens + chunks) + 2 * b * n + 4
        completions = []
        for _ in range(max_steps):
            if stop is not None and engine.agreed_flag(stop.is_set()):
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
        completions.sort(key=lambda c: (c.rid, c.gen))
        rows = [(c.rid, c.gen, list(map(int, c.tokens)), c.finish_reason)
                for c in completions]
    elif prefix_cache:
        # Multi-turn through the engine: every turn submits the whole
        # conversation so far. Turn N's retirement published its prompt
        # and reply pages, so turn N+1's admission puts them in its table
        # and prefills only the follow-up.
        history = [list(map(int, prompts[i])) for i in range(b)]
        tok_rows: List[List[int]] = [[] for _ in range(b)]
        reasons = ["length"] * b
        for turn in range(turns):
            if turn:
                follow_up = np.random.default_rng(seed + turn).integers(
                    0, cfg.vocab_size, (b, s))
                for i in range(b):
                    history[i].extend(map(int, follow_up[i]))
            comps = engine.run([
                Request(rid=turn * b + i,
                        prompt=np.asarray(history[i], np.int32),
                        max_new_tokens=max_new_tokens, eos_id=eos_id)
                for i in range(b)])
            comps.sort(key=lambda c: c.rid)
            for i, c in enumerate(comps):
                history[i].extend(c.tokens)
                tok_rows[i].extend(c.tokens)
                reasons[i] = c.finish_reason
        dt = time.perf_counter() - t0
        serving = engine.stats.summary(wall_s=dt)
        logger.info(
            "multi-turn prefix reuse: hit rate %.2f (%d/%d prompt tokens "
            "from cached blocks)", engine.stats.prefix_hit_rate,
            engine.stats.prefix_hit_tokens, engine.stats.prefix_lookup_tokens)
        rows = [(i, 0, tok_rows[i], reasons[i]) for i in range(b)]
    else:
        # Multi-turn on one contiguous cache: turn 1 block-prefills it,
        # each later turn extends it in one forward (prefill_continue),
        # and each reply decodes into it (generate_from_cache hands back
        # the decoded state, so no reply is encoded again).
        from kubeflow_controller_tpu_torch.ops import prng

        cache = gen.init_kv_cache(cfg, b, turns * (s + max_new_tokens),
                                  device=dev)
        toks_d = torch.from_numpy(prompts).to(dev)
        logits, cache = gen.prefill(cfg, params, toks_d, cache)
        rng = (prng.prng_key(torch.tensor(seed, dtype=torch.int32))
               if temperature > 0 else None)
        replies = []
        for turn in range(turns):
            if turn:
                follow_up = np.random.default_rng(seed + turn).integers(
                    0, cfg.vocab_size, (b, s)).astype(np.int32)
                logits, cache = gen.prefill_continue(
                    cfg, params, torch.from_numpy(follow_up).to(dev), cache)
            toks, logits, cache = gen.generate_from_cache(
                cfg, params, logits, cache, max_new_tokens,
                temperature=temperature,
                # A distinct key chain each turn.
                rng=None if rng is None else prng.fold_in(
                    rng, torch.tensor(turn)),
                return_state=True)
            replies.append(toks.cpu().numpy())
        toks = np.concatenate(replies, axis=1)
        dt = time.perf_counter() - t0
        rows = [(i, 0, toks[i].tolist(), "length") for i in range(b)]

    if output_file and rank0:
        with open(output_file, "w") as f:
            for rid, g, completion, reason in rows:
                f.write(json.dumps({
                    "rid": rid,
                    "gen": g,
                    "prompt": prompts[rid].tolist(),
                    "completion": completion,
                    "finish_reason": reason,
                }) + "\n")
    new_total = sum(len(r[2]) for r in rows)
    tps = new_total / dt
    logger.info("served %d prompts (%d new tokens total%s) in %.2fs "
                "(%.0f tok/s) on %s", b, new_total,
                f" across {turns} turns" if turns > 1 else "", dt, tps, dev)
    if speculative and engine is not None:
        logger.info("speculative: %d/%d draft tokens accepted (%.2f) over "
                    "%d verify steps", engine.stats.draft_accepted,
                    engine.stats.draft_proposed,
                    engine.stats.acceptance_rate, engine.stats.spec_steps)
    out = {
        "prompts": float(b),
        "new_tokens": float(max_new_tokens),
        "tokens_per_sec": tps,
        "wall_s": dt,
        "restored_step": float(-1 if restored_step is None else restored_step),
        "interrupted": float(interrupted),
    }
    out.update(serving)
    if tracer is not None:
        # Idempotent: a drain already flushed through the engine; this
        # covers the normal exit.
        tracer.flush()
        out["spans_recorded"] = float(tracer.spans_recorded)
        out["spans_dropped"] = float(tracer.spans_dropped)
    if injector is not None:
        # The fault ledger in the same summary: fires per (site, kind).
        out.update(injector.summary())
    ml = metrics_mod.from_context(ctx) if rank0 else None
    if ml is not None:
        ml.write(0, out)
        ml.close()
    return out


def _request_params(cfg, temperature, top_k, top_p, n, seed, grammar,
                    eos_id):
    """One params object for every request (None without ``n > 1`` or a
    grammar): draws are keyed by (seed, gen, position), and a mask keeps
    its automaton state in the slot."""
    from kubeflow_controller_tpu_torch.dataplane import sampling

    if n <= 1 and not grammar:
        return None
    return sampling.SamplingParams(
        temperature=temperature, top_k=top_k, top_p=top_p, n=n, seed=seed,
        logit_mask=(sampling.make_mask(grammar, cfg.vocab_size, eos_id=eos_id)
                    if grammar else None))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="tiny",
                   choices=sorted(CONFIGS))
    p.add_argument("--model-dir", default="",
                   help="checkpoint dir written by the port's lm.train "
                        "(TPUJOB_MODEL_DIR analog); fresh init when empty")
    p.add_argument("--input", default="",
                   help="JSONL of {\"prompt\": [token ids]}")
    p.add_argument("--output", default="", help="completions JSONL")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="int8 = weight-only int8 serving weights")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="softmax temperature (0 = greedy argmax; > 0 "
                        "samples reproducibly from the per-request "
                        "seeded key chain)")
    p.add_argument("--top-k", type=int, default=0,
                   help="keep only the k highest-probability tokens "
                        "before sampling (0 = no top-k filter)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling: keep the smallest probability "
                        "mass >= p before sampling (1.0 = no filter)")
    p.add_argument("--n", type=int, default=1,
                   help="parallel generations per prompt: the prompt is "
                        "prefilled ONCE, then forked into n slots that "
                        "share its KV pages copy-on-write; completions "
                        "carry a 'gen' index (requires the paged pool)")
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed (token i of generation g draws "
                        "from fold_in(fold_in(key(seed), g), i)) and the "
                        "seed of the fresh weight init")
    p.add_argument("--grammar", default="",
                   help="constrained decoding spec: 'json', "
                        "'re:<pattern>' or 'set:<id,id,...>'; every "
                        "emitted token keeps the output a valid prefix")
    p.add_argument("--slots", type=int, default=0,
                   help="slot-pool size (0 = one slot per request)")
    p.add_argument("--eos-id", type=int, default=-1,
                   help="token id that retires a sequence early (-1 = none)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="per-request latency budget in seconds (0 = none)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="bound the engine FIFO (0 = unbounded)")
    p.add_argument("--drain-grace-s", type=float, default=2.0)
    p.add_argument("--prefill-mode", default="exact",
                   choices=["exact", "bucketed"],
                   help="exact = one forward over the whole prompt at "
                        "admission; bucketed = block_size chunks "
                        "interleaved with decode")
    p.add_argument("--block-size", type=int, default=16,
                   help="KV page size in tokens (power of two)")
    p.add_argument("--kv-pool-mb", type=float, default=0.0,
                   help="device-memory budget of the KV pool in MiB "
                        "(0 = one full context per slot)")
    p.add_argument("--kv-quant", default="none", choices=["none", "int8"])
    p.add_argument("--speculative", action="store_true",
                   help="speculative decoding: model-free drafts verified "
                        "in one forward; greedy outputs equal plain decode")
    p.add_argument("--draft-k", type=int, default=4,
                   help="max draft tokens proposed per slot per step "
                        "(adaptive K shrinks below this on rejection)")
    p.add_argument("--proposer", default="prompt", choices=["prompt", "radix"],
                   help="draft source: prompt = n-gram lookup in the "
                        "request's own context; radix = walk the "
                        "--prefix-cache trie (requires --prefix-cache)")
    p.add_argument("--turns", type=int, default=1,
                   help="multi-turn chat: each turn after the first appends "
                        "a follow-up prompt to every conversation; with "
                        "--prefix-cache through the engine (each turn "
                        "reuses the previous turns' pages), else on a "
                        "contiguous cache (prefill_continue a turn)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="radix-trie prefix reuse over the KV block pool "
                        "(implies bucketed prefill)")
    p.add_argument("--host-kv-mb", type=float, default=0.0,
                   help="pinned-host budget in MiB of the KV tier beneath "
                        "the prefix cache (requires --prefix-cache): "
                        "evicted pages spill there and come back on the "
                        "next hit, bit for bit; 0 disables the tier")
    p.add_argument("--attn-impl", default="kernel",
                   choices=["kernel", "gather", "pallas", "xla"],
                   help="kernel (or pallas) = the hand-written "
                        "paged-attention kernels; gather (or xla) = dense "
                        "view gather + full softmax (oracle)")
    p.add_argument("--paged", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-paged serves the contiguous multi-turn path "
                        "(--turns > 1 without --prefix-cache); the engine "
                        "serves from the paged pool only")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel serving over a gang of --tp "
                        "processes from the controller's env (one a tp "
                        "rank): each holds 1/tp of the weights and of the "
                        "pool's KV heads (requires n_kv_heads %% tp == 0)")
    p.add_argument("--tp-compute", default="gathered",
                   choices=["gathered", "parallel"],
                   help="gathered = each layer's weights gathered where it "
                        "runs (greedy streams bit for bit tp=1's); "
                        "parallel = column/row-parallel projections, one "
                        "tp sum a block (logits within "
                        "generate.tp_parallel_tolerance; requires d_ff %% "
                        "tp == 0 for a dense config)")
    p.add_argument("--mesh", dest="mesh_devices", default="",
                   help="comma-separated cards of the tp ranks (rank i "
                        "drives cuda:<i-th>); default: the card training "
                        "gives each rank")
    p.add_argument("--disagg", action="store_true",
                   help="prefill/decode disaggregation: serve through a "
                        "two-replica fleet in this process (one prefill "
                        "and one decode engine) that moves each "
                        "request's KV pages between them")
    p.add_argument("--trace", default="",
                   help="write a Chrome-trace-event JSON of every "
                        "request's spans to this path (Perfetto, "
                        "chrome://tracing); empty = no tracing")
    p.add_argument("--fault-plan", default="",
                   help="JSON FaultPlan of deterministic fault injection "
                        "(crash/hang/slow/drop_migration/tier_io_error/"
                        "refuse_admit specs on the serving clock); "
                        "empty = no injection")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed of probabilistic fault specs (prob < 1): "
                        "the same plan, seed and clock fire the same "
                        "faults")
    p.add_argument("--watchdog-stale-s", type=float, default=0.0,
                   help="the fleet's progress watchdog (--disagg only): "
                        "strike a replica whose quantum heartbeat stalls "
                        "this many seconds while it holds work; 0 "
                        "disables")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.tp > 1:
        from kubeflow_controller_tpu_torch.models import generate as gen

        try:
            gen.check_tp_heads(model_config(args.config), args.tp,
                               args.tp_compute)
        except ValueError as e:
            p.error(str(e))
    # The reference's checks of the sampling flags, through argparse
    # (usage and exit 2), before anything loads.
    from kubeflow_controller_tpu_torch.dataplane.sampling import (
        SamplingParams, make_mask,
    )
    try:
        SamplingParams(temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p, n=args.n, seed=args.seed).validate()
        if args.grammar:
            make_mask(args.grammar, model_config(args.config).vocab_size)
    except ValueError as e:
        p.error(str(e))
    if args.n > 1 and not args.paged:
        p.error("--n > 1 forks prompt KV pages copy-on-write and "
                "requires the paged pool (drop --no-paged)")
    if (args.n > 1 or args.grammar) and args.turns > 1:
        p.error("--n / --grammar are single-turn engine features "
                "(use --turns 1)")
    if args.host_kv_mb < 0:
        p.error(f"--host-kv-mb must be >= 0 (got {args.host_kv_mb})")
    if args.host_kv_mb > 0 and not args.prefix_cache:
        p.error("--host-kv-mb spills radix-cache pages to host RAM and "
                "requires --prefix-cache (0 disables the tier)")
    if args.watchdog_stale_s < 0:
        p.error(f"--watchdog-stale-s must be >= 0 "
                f"(got {args.watchdog_stale_s})")
    if args.watchdog_stale_s > 0 and not args.disagg:
        p.error("--watchdog-stale-s is the fleet router's progress "
                "watchdog and requires --disagg")
    if args.fault_plan:
        if args.turns > 1:
            p.error("--fault-plan targets the continuous-batching "
                    "engine (use --turns 1)")
        # A typo'd kind or site fails here, with the schema's message,
        # before anything loads.
        from kubeflow_controller_tpu_torch.dataplane import faults
        try:
            faults.load_plan(args.fault_plan)
        except (OSError, ValueError, KeyError, TypeError) as e:
            p.error(f"--fault-plan {args.fault_plan}: {e}")
    # SIGTERM drains the engine and still writes the partial completions.
    stop = threading.Event()
    previous = signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        metrics = serve(
            config=args.config, input_file=args.input,
            output_file=args.output, batch=args.batch,
            prompt_len=args.prompt_len, max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, n=args.n, grammar=args.grammar,
            model_dir=args.model_dir, seed=args.seed, slots=args.slots,
            eos_id=None if args.eos_id < 0 else args.eos_id,
            deadline_s=args.deadline_s if args.deadline_s > 0 else None,
            max_queue=args.max_queue if args.max_queue > 0 else None,
            drain_grace_s=args.drain_grace_s,
            prefill_mode=args.prefill_mode, block_size=args.block_size,
            kv_pool_mb=args.kv_pool_mb if args.kv_pool_mb > 0 else None,
            kv_quant="" if args.kv_quant == "none" else args.kv_quant,
            speculative=args.speculative, draft_k=args.draft_k,
            proposer=args.proposer, turns=args.turns,
            prefix_cache=args.prefix_cache, host_kv_mb=args.host_kv_mb,
            attn_impl=args.attn_impl, quant=args.quant, paged=args.paged,
            tp=args.tp, tp_compute=args.tp_compute,
            mesh_devices=args.mesh_devices, trace=args.trace,
            disagg=args.disagg, fault_plan=args.fault_plan,
            fault_seed=args.fault_seed,
            watchdog_stale_s=args.watchdog_stale_s, device=args.device,
            stop=stop)
    finally:
        signal.signal(signal.SIGTERM, previous)
    from kubeflow_controller_tpu_torch.dataplane.dist import destroy

    destroy()             # leave the job's process group, if any
    return 0 if metrics["prompts"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
