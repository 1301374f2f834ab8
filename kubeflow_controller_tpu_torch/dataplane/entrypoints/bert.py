"""BERT-base masked-LM pretraining entry point.

Counterpart of ``kubeflow_controller_tpu/dataplane/entrypoints/bert.py``:
``models/bert.py`` trained through ``TrainLoop`` by AdamW (weight decay
0.01 on every leaf) under the warmup-cosine schedule, on the synthetic
MLM stream, reporting ``tokens_per_sec``:

    python -m kubeflow_controller_tpu_torch.dataplane.entrypoints.bert \\
        --seq-len 512 --batch 8 --total-steps 4

``--attn auto`` takes the flash kernels (B1 forward, B2 fused backward)
for bf16 rows of at least 256 tokens; ``--quant int8`` runs the encoder's
projections in int8. Runs on ``cuda`` unless ``device="cpu"``. A
multi-process job (its process group up through
``dist.initialize_from_env``, which :func:`main` calls) trains over the
mesh of ``mesh_config`` (dp and fsdp; ``param_specs`` places the
parameters); tensor parallelism is refused with "not yet ported".
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional

from kubeflow_controller_tpu_torch.dataplane import metrics as metrics_sink
from kubeflow_controller_tpu_torch.dataplane.dist import (
    ProcessContext, destroy, initialize_from_env, job_device,
    require_process_group,
)
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.models import bert
from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig, data_shards, make_mesh

logger = logging.getLogger("tpujob.bert_torch")


def train(
    ctx: Optional[ProcessContext] = None,
    total_steps: int = 100,
    per_data_shard_batch: int = 8,
    seq_len: int = 128,
    learning_rate: float = 1e-4,
    model_dir: str = "",
    checkpoint_every: int = 0,
    cfg: Optional[bert.BertConfig] = None,
    mesh_config=None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Train ``cfg`` (BERT-base, ``max_seq = max(seq_len, 128)``, by
    default) up to ``total_steps`` on the synthetic MLM stream; returns
    the last logged metrics (``loss``, ``step``, ``tokens_per_sec``,
    ``mlm_accuracy``) and ``final_step``."""
    from kubeflow_controller_tpu_torch.dataplane.train import (
        TrainLoop, TrainLoopConfig, device_prefetch,
    )
    from kubeflow_controller_tpu_torch.optim import (
        AdamW, warmup_cosine_decay_schedule,
    )

    ctx = ctx or ProcessContext.from_env()
    mesh_config = mesh_config or MeshConfig()
    if mesh_config.tp > 1:
        raise NotImplementedError(
            f"BERT over tp={mesh_config.tp} is not yet ported (dp and fsdp are)")
    require_process_group(ctx)
    dev = resolve_device(job_device(ctx, device))
    mesh = make_mesh(mesh_config, device_type=dev.type)
    mlog = metrics_sink.from_context(ctx)
    global_batch = per_data_shard_batch * data_shards(mesh)
    cfg = cfg or bert.bert_base_config(max_seq=max(seq_len, 128))
    loop = TrainLoop(
        init_fn=bert.make_init_fn(cfg),
        loss_fn=bert.make_loss_fn(cfg),
        optimizer=AdamW(warmup_cosine_decay_schedule(
            0.0, learning_rate, min(100, total_steps // 10 + 1), total_steps),
            weight_decay=0.01),
        config=TrainLoopConfig(
            total_steps=total_steps,
            log_every=max(1, total_steps // 10),
            checkpoint_every=checkpoint_every,
        ),
        model_dir=model_dir or ctx.model_dir,
        device=dev,
        mesh=mesh,
        param_shardings=bert.param_specs(cfg),
    )
    stream = bert.synthetic_mlm_batch(cfg, global_batch, seq_len)
    last: Dict[str, float] = {}

    def on_metrics(m):
        if mlog:
            mlog.write(m.step, {"loss": m.loss,
                                "steps_per_sec": m.steps_per_sec, **m.extras})
        tps = m.steps_per_sec * global_batch * seq_len
        last.update({"loss": m.loss, "step": m.step, "tokens_per_sec": tps,
                     **m.extras})
        logger.info("step %d mlm_loss %.4f acc %.3f (%.0f tok/s)", m.step,
                    m.loss, m.extras.get("mlm_accuracy", float("nan")), tps)

    try:
        state = loop.run(device_prefetch(stream, loop.device,
                                         rows=loop.local_rows(global_batch)),
                         on_metrics=on_metrics)
    finally:
        if mlog:
            mlog.close()
    last["final_step"] = int(state.step)
    return last


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--total-steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8,
                   help="per-data-shard batch size")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--attn", default="auto", choices=["auto", "xla", "flash"])
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="int8 encoder projections")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    metrics = train(
        initialize_from_env(device=args.device), total_steps=args.total_steps,
        per_data_shard_batch=args.batch, seq_len=args.seq_len,
        learning_rate=args.lr,
        cfg=bert.bert_base_config(max_seq=max(args.seq_len, 128),
                                  attn_impl=args.attn, quant=args.quant),
        device=args.device)
    destroy()             # leave the job's process group, if any
    return 0 if metrics.get("final_step", 0) > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
