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
    CONFIGS, model_config,
)
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("tpujob.serve_lm_torch")

#: Configurations lm.train trains that serve() refuses: llama3_70b's
#: weights fit no one card, and serving over tp is not yet ported.
NOT_SERVED = ("llama3_70b",)

#: serve() keywords of features not ported yet, with the value that means
#: "off". Any other value raises NotImplementedError.
NOT_YET_PORTED_FLAGS = {
    "tp": 1,
    "trace": "",
    "disagg": False,
    "fault_plan": "",
    "watchdog_stale_s": 0.0,
    "tp_compute": "gathered",
    "mesh_devices": "",
    "fault_seed": 0,
}
#: The command-line spelling of a keyword where it is not the keyword's,
#: and the choices the JAX entry point's parser gives an option.
_CLI_NAMES = {"mesh_devices": "--mesh"}
_CLI_CHOICES = {"tp_compute": ["gathered", "parallel"]}


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
    stop=None,
    device: DeviceLike = None,
    **not_yet_ported,
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
    unless asked for the oracle. A multi-process job
    (``ctx.num_processes > 1``) is refused with "not yet ported".

    ``quant="int8"`` serves weight-only int8 projections
    (``inference_params(quant="int8")``, after the checkpoint's weights
    are restored). ``paged=False`` is accepted where the reference
    accepts it, on the contiguous multi-turn path; elsewhere the engine
    raises the reference's ``ValueError``, and so does ``n > 1``.

    ``stop`` (a ``threading.Event``) drains the engine within
    ``drain_grace_s`` and still writes the partial completions.
    Keywords of :data:`NOT_YET_PORTED_FLAGS` are accepted and refused
    unless they hold their "off" value."""
    import torch

    from kubeflow_controller_tpu_torch.dataplane import metrics as metrics_mod
    from kubeflow_controller_tpu_torch.dataplane import sampling
    from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
        Rejected, Request, ServingEngine,
    )
    from kubeflow_controller_tpu_torch.models import generate as gen

    # The reference's sampling checks come first, before the refusals of
    # what is not ported and before any weights load.
    sampling.SamplingParams(temperature=temperature, top_k=top_k,
                            top_p=top_p, n=n, seed=seed).validate()
    if n > 1 and not paged:
        raise ValueError(
            "n > 1 forks prompt KV pages copy-on-write and requires the "
            "paged block pool (drop --no-paged)")
    if (n > 1 or grammar) and turns > 1:
        raise ValueError(
            "--n / --grammar are single-turn engine features (turns == 1)")
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
    if config in NOT_SERVED:
        raise NotImplementedError(
            f"serving config {config!r} is not yet ported (it needs "
            "tensor-parallel serving)")
    cfg = model_config(config)
    dev = resolve_device(device)
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
    if turns <= 1 or prefix_cache:
        # A conversation of `turns` turns fits a slot.
        engine = ServingEngine(
            cfg, params, n_slots=n_slots,
            max_seq=max(1, turns) * (s + max_new_tokens),
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            max_queue=max_queue, prefill_mode=mode, prefix_cache=prefix_cache,
            block_size=block_size, kv_hbm_budget_mb=kv_pool_mb,
            host_kv_mb=host_kv_mb, kv_quant=kv_quant,
            spec_decode=speculative, draft_k=draft_k, proposer=proposer,
            attn_impl=attn_impl, paged=paged, device=dev)
    if turns <= 1:
        # One params object for every request: draws are keyed by (seed,
        # gen, position), and a mask keeps its automaton state in the slot.
        req_params = None
        if n > 1 or grammar:
            req_params = sampling.SamplingParams(
                temperature=temperature, top_k=top_k, top_p=top_p, n=n,
                seed=seed,
                logit_mask=(sampling.make_mask(grammar, cfg.vocab_size,
                                               eos_id=eos_id)
                            if grammar else None))
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

    if output_file:
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
    ml = metrics_mod.from_context(ctx)
    if ml is not None:
        ml.write(0, out)
        ml.close()
    return out


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
    refused = {k: getattr(args, k) for k in NOT_YET_PORTED_FLAGS}
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
            device=args.device, stop=stop,
            **refused)
    finally:
        signal.signal(signal.SIGTERM, previous)
    return 0 if metrics["prompts"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
