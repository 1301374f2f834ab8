"""Causal-LM pretraining entry point, and the model table.

Counterpart of ``kubeflow_controller_tpu/dataplane/entrypoints/lm.py``:
the configurations by name (``CONFIGS``: the JAX table's, with
``bench.py``'s flagship decoder as ``"flagship"``), the token
streams (:func:`synthetic_lm`, byte for byte the JAX
package's, and :func:`token_bin_lm`), and :func:`train`, which runs the
decoder through ``TrainLoop`` over the job's mesh (``mesh_config``: dp,
fsdp, ep, sp and tp; one device for a single-process job):

    python -m kubeflow_controller_tpu_torch.dataplane.entrypoints.lm \\
        --config tiny --total-steps 20 --seq-len 128 --device cpu

Runs on ``cuda`` unless ``device="cpu"``. ``quant`` runs the linear
projections in int8 (``"int8"``: the composed path; ``"int8_fused"``,
from Python only as in the JAX package: the fused kernel where its
shapes allow) and ``opt8bit`` keeps AdamW's moments in 8 bits
(``--quant int8 --opt8`` on the command line). It trains into
``model_dir or ctx.model_dir`` (a TPUJob's ``TPUJOB_MODEL_DIR``) as the
JAX entry point does: resuming from the latest checkpoint there, saving
every ``checkpoint_every`` steps and at the end (``dataplane/train.py``;
the format is the port's own, not orbax's). A multi-process job
(``ctx.num_processes > 1``) needs its process group up
(``dist.initialize_from_env``, which :func:`main` calls); each process
drives ``cuda:{process_id % device_count}``. A gang of two on the CPU
(and the same with ``JAX_PROCESS_ID=1``)::

    JAX_COORDINATOR_ADDRESS=127.0.0.1:29500 JAX_NUM_PROCESSES=2 \\
    JAX_PROCESS_ID=0 python -m \\
        kubeflow_controller_tpu_torch.dataplane.entrypoints.lm \\
        --fsdp 2 --device cpu

Under ``sp > 1`` (``--sp``) or ``attn="ring"`` (``--attn ring``) the
sequence is split over sp (``shard_seq``, as the JAX entry point sets
it): ring attention rotates the K/V blocks between the sp ranks, the
other attention paths gather q/k/v over sp. ``MeshConfig(ep=...)``
shards a MoE model's experts (no CLI flag, as in the JAX package);
int8 projections, MoE layers and 8-bit AdamW train over every axis.
Pipeline parallelism has no flag here, as in the JAX package: a train
step calls
``next_token_loss(pp_microbatches=M)`` on parameters placed by
``param_specs(cfg, pp=True)`` (``models/transformer.py``). The command
line takes every option of the JAX entry point's, with the same
defaults.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, Iterator, Optional

import numpy as np

from kubeflow_controller_tpu_torch.dataplane import metrics as metrics_sink
from kubeflow_controller_tpu_torch.dataplane.dist import (
    ProcessContext, destroy, initialize_from_env, job_device,
    require_process_group,
)
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.models import transformer as tfm
from kubeflow_controller_tpu_torch.parallel.mesh import (
    MeshConfig, data_shards, mesh_for_context, row_source, use_mesh,
)

logger = logging.getLogger("tpujob.lm_torch")

CONFIGS = {
    "tiny": tfm.tiny_config,
    "tiny_moe": tfm.tiny_moe_config,
    "llama3_8b": tfm.llama3_8b_config,
    "mixtral_8x7b": tfm.mixtral_8x7b_config,
    # Trains over a mesh; serving it waits for tensor-parallel serving
    # (serve_lm.NOT_SERVED).
    "llama3_70b": tfm.llama3_70b_config,
    # bench.py's flagship decoder, which the JAX table does not name.
    "flagship": tfm.flagship_config,
}


def synthetic_lm(
    vocab_size: int, batch_size: int, seq_len: int, seed: int = 0,
    pack: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic repeating-pattern token stream, the JAX package's
    draw for draw (``numpy.random.default_rng(seed)``): rows of ``seq_len
    + 1`` tokens ``(start + i) % vocab``.

    ``pack=True`` emits packed rows: several variable-length documents
    per row with ``segment_ids`` (id 0 = tail padding)."""
    rng = np.random.default_rng(seed)
    while True:
        if not pack:
            start = rng.integers(0, vocab_size, (batch_size, 1))
            toks = (start + np.arange(seq_len + 1)) % vocab_size
            yield {"tokens": toks.astype(np.int32)}
            continue
        if seq_len < 32:
            raise ValueError("pack=True needs seq_len >= 32 (documents are "
                             "at least 8 tokens; shorter rows would be "
                             "mostly or entirely padding)")
        toks = np.zeros((batch_size, seq_len + 1), np.int32)
        segs = np.zeros((batch_size, seq_len + 1), np.int32)
        for b in range(batch_size):
            pos, seg = 0, 1
            while pos < seq_len + 1:
                doc_len = min(
                    int(rng.integers(max(8, seq_len // 4), seq_len)),
                    seq_len + 1 - pos,
                )
                if doc_len < 8:   # short tail: leave as padding
                    break
                start = int(rng.integers(0, vocab_size))
                toks[b, pos:pos + doc_len] = (
                    start + np.arange(doc_len)
                ) % vocab_size
                segs[b, pos:pos + doc_len] = seg
                pos += doc_len
                seg += 1
        yield {"tokens": toks, "segment_ids": segs}


def token_bin_lm(
    path: str, batch_size: int, seq_len: int, seed: int = 0,
    vocab_size: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Pretraining stream over a flat binary file of token ids (uint16,
    or the dtype a companion ``<path>.meta.json`` names): ``batch_size``
    random ``seq_len + 1`` crops per batch, memmapped, drawn as the JAX
    package draws them. The file's size and vocab are checked before the
    first batch, and every batch's ids against ``vocab_size``."""
    meta = {}
    mpath = path + ".meta.json"
    if os.path.exists(mpath):
        with open(mpath) as f:
            meta = json.load(f)
    dtype = np.dtype(meta.get("dtype", "uint16"))
    data = np.memmap(path, dtype=dtype, mode="r")
    if len(data) < seq_len + 2:
        raise ValueError(
            f"{path}: {len(data)} tokens < seq_len+2 ({seq_len + 2})"
        )
    if vocab_size is not None and meta.get("vocab_size") is not None:
        if int(meta["vocab_size"]) > vocab_size:
            raise ValueError(
                f"{path}: corpus vocab {meta['vocab_size']} exceeds model "
                f"vocab {vocab_size} (tokenizer mismatch)"
            )
    rng = np.random.default_rng(seed)
    span = seq_len + 1
    n_starts = len(data) - span

    def stream() -> Iterator[Dict[str, np.ndarray]]:
        while True:
            idx = rng.integers(0, n_starts + 1, (batch_size,))
            toks = np.stack([np.asarray(data[i:i + span]) for i in idx])
            if vocab_size is not None:
                mx = int(toks.max())
                if mx >= vocab_size:
                    raise ValueError(
                        f"{path}: token id {mx} out of range for model "
                        f"vocab {vocab_size} (tokenizer mismatch)"
                    )
            yield {"tokens": toks.astype(np.int32)}

    return stream()


def model_config(config: str, **overrides) -> tfm.TransformerConfig:
    """The named configuration with ``overrides``."""
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r} (have {sorted(CONFIGS)})")
    return CONFIGS[config](**overrides)


def train(
    ctx: Optional[ProcessContext] = None,
    config: str = "tiny",
    total_steps: int = 100,
    per_data_shard_batch: int = 4,
    seq_len: int = 512,
    learning_rate: float = 3e-4,
    mesh_config: Optional[MeshConfig] = None,
    attn: str = "auto",
    model_dir: str = "",
    checkpoint_every: int = 0,
    keep_checkpoints: int = 3,
    pack: bool = False,
    quant: str = "",
    grad_accum: int = 1,
    data_file: str = "",
    opt8bit: bool = False,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Train ``config`` up to step ``total_steps`` over the mesh of
    ``mesh_config`` (default: pure dp over the job's ranks), into and
    from ``model_dir or ctx.model_dir`` when set (``checkpoint_every``
    and ``keep_checkpoints`` as in ``TrainLoopConfig``); returns the last
    logged metrics (``loss``, ``step``, ``tokens_per_sec``, ``accuracy``,
    ``perplexity``; the global batch's), ``final_step`` and
    ``start_step`` (the restored step, 0 on a fresh start). The global
    batch is ``per_data_shard_batch`` times the mesh's data shards."""
    from kubeflow_controller_tpu_torch.dataplane.train import (
        TrainLoop, TrainLoopConfig, device_prefetch,
    )
    from kubeflow_controller_tpu_torch.optim import make_optimizer

    ctx = ctx or ProcessContext.from_env()
    mesh_config = mesh_config or MeshConfig()
    require_process_group(ctx)
    dev = resolve_device(job_device(ctx, device))
    mesh = mesh_for_context(ctx, mesh_config, device_type=dev.type)
    cfg = model_config(config, max_seq=max(seq_len, 128), attn_impl=attn,
                       shard_seq=(attn == "ring" or mesh.shape["sp"] > 1),
                       quant=quant)
    with use_mesh(mesh):
        tfm.check_mesh(cfg)
    mlog = metrics_sink.from_context(ctx)
    global_batch = per_data_shard_batch * data_shards(mesh)
    loop = TrainLoop(
        init_fn=tfm.make_init_fn(cfg),
        loss_fn=tfm.make_loss_fn(cfg),
        optimizer=make_optimizer(learning_rate, total_steps, opt8bit),
        config=TrainLoopConfig(total_steps=total_steps,
                               log_every=max(1, total_steps // 10),
                               checkpoint_every=checkpoint_every,
                               keep_checkpoints=keep_checkpoints,
                               grad_accum=grad_accum),
        model_dir=model_dir or ctx.model_dir,
        device=dev,
        mesh=mesh,
        param_shardings=tfm.param_specs(cfg),
    )
    # A real corpus when given (data_file, or train.bin in the job's
    # data dir), the synthetic stream otherwise; pack opts out of the
    # auto-detection, and an explicit corpus with pack is an error.
    if not data_file and ctx.data_dir and not pack:
        cand = os.path.join(ctx.data_dir, "train.bin")
        if os.path.exists(cand):
            data_file = cand
    if data_file:
        if pack:
            raise ValueError("--pack is for the synthetic stream; a "
                             "token-bin corpus is already contiguous text")
        # Seeded by process as the JAX package seeds it, but every rank
        # of one data shard (its tp and sp ranks) takes the seed of the
        # shard's first rank, so that they hold the same rows.
        seed = row_source(mesh)
        stream = token_bin_lm(data_file, global_batch, seq_len,
                              seed=seed, vocab_size=cfg.vocab_size)
        logger.info("training on %s (shard seed %d)", data_file, seed)
    else:
        stream = synthetic_lm(cfg.vocab_size, global_batch, seq_len, pack=pack)
    # Every rank draws the global batch and keeps its rows.
    data = device_prefetch(stream, loop.device,
                           rows=loop.local_rows(global_batch))
    last: Dict[str, float] = {}

    def on_metrics(m):
        if mlog:
            mlog.write(m.step, {"loss": m.loss,
                                "steps_per_sec": m.steps_per_sec, **m.extras})
        tps = m.steps_per_sec * global_batch * seq_len
        last.update({"loss": m.loss, "step": m.step, "tokens_per_sec": tps,
                     **m.extras})
        logger.info("step %d loss %.4f ppl %.1f (%.0f tok/s)%s", m.step, m.loss,
                    m.extras.get("perplexity", float("nan")), tps,
                    (f" moe_aux {m.extras['moe_aux']:.4f} drop "
                     f"{m.extras['moe_drop_rate']:.4f}"
                     if "moe_aux" in m.extras else ""))

    try:
        state = loop.run(data, on_metrics=on_metrics)
    finally:
        if mlog:
            mlog.close()
    last["final_step"] = int(state.step)
    last["start_step"] = loop.start_step
    return last


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="tiny",
                   choices=sorted(CONFIGS))
    p.add_argument("--total-steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=4,
                   help="per-data-shard batch size")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--attn", default="auto",
                   choices=["auto", "xla", "flash", "ring"])
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--pack", action="store_true",
                   help="packed documents per row (segment_ids; id 0 = pad)")
    p.add_argument("--quant", default="", choices=["", "int8"])
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches per optimizer step (batch must divide)")
    p.add_argument("--opt8", action="store_true")
    p.add_argument("--data", default="",
                   help="tokenised corpus: flat binary of token ids "
                        "(uint16/uint32, optional <path>.meta.json); "
                        "defaults to $TPUJOB_DATA_DIR/train.bin if present")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    ctx = initialize_from_env(device=args.device)
    metrics = train(
        ctx,
        config=args.config, total_steps=args.total_steps,
        per_data_shard_batch=args.batch, seq_len=args.seq_len,
        learning_rate=args.lr, attn=args.attn, pack=args.pack,
        quant=args.quant, grad_accum=args.grad_accum, data_file=args.data,
        opt8bit=args.opt8,
        mesh_config=MeshConfig(fsdp=args.fsdp, sp=args.sp, tp=args.tp),
        device=args.device,
    )
    destroy()             # leave the job's process group, if any
    return 0 if metrics.get("final_step", 0) > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
