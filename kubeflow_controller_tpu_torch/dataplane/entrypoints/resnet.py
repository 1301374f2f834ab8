"""ResNet-50 ImageNet training entry point.

Counterpart of ``kubeflow_controller_tpu/dataplane/entrypoints/
resnet.py``: ``models/resnet.py`` trained through a stateful
``TrainLoop`` (BatchNorm statistics as model state) by SGD with Nesterov
momentum 0.9 under the warmup-cosine schedule, on the synthetic
ImageNet stream with uint8 images on the wire. It reports the
reference's metrics, ``images_per_sec`` and ``images_per_sec_per_chip``
(per card: one card a rank):

    python -m kubeflow_controller_tpu_torch.dataplane.entrypoints.resnet \\
        --total-steps 8

Runs on ``cuda`` unless ``device="cpu"``. A multi-process job (its
process group up through ``dist.initialize_from_env``, which
:func:`main` calls) trains over every rank, as the JAX package's
``make_mesh(MeshConfig())``: ``per_chip_batch`` rows a rank, BatchNorm's
statistics over the global batch, parameters placed by the fsdp
heuristic (which leaves them whole at fsdp 1).
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
from kubeflow_controller_tpu_torch.models import resnet
from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig, data_shards, make_mesh
from kubeflow_controller_tpu_torch.parallel.sharding import infer_param_sharding

logger = logging.getLogger("tpujob.resnet_torch")


def train(
    ctx: Optional[ProcessContext] = None,
    total_steps: int = 100,
    per_chip_batch: int = 128,
    image_size: int = resnet.IMAGE_SIZE,
    learning_rate: float = 0.1,
    model_dir: str = "",
    checkpoint_every: int = 0,
    model: Optional[resnet.ResNet] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Train ``model`` (ResNet-50 by default) up to ``total_steps``;
    returns the last logged metrics (``loss``, ``step``, ``accuracy``,
    ``images_per_sec``, ``images_per_sec_per_chip``) and
    ``final_step``."""
    from kubeflow_controller_tpu_torch.dataplane.train import (
        TrainLoop, TrainLoopConfig, device_prefetch,
    )
    from kubeflow_controller_tpu_torch.optim import (
        SGD, warmup_cosine_decay_schedule,
    )

    ctx = ctx or ProcessContext.from_env()
    require_process_group(ctx)
    dev = resolve_device(job_device(ctx, device))
    mlog = metrics_sink.from_context(ctx)
    mesh = make_mesh(MeshConfig(), device_type=dev.type)
    global_batch = per_chip_batch * data_shards(mesh)
    model = model or resnet.resnet50()
    tx = SGD(warmup_cosine_decay_schedule(
        0.0, learning_rate, min(500, total_steps // 10 + 1), total_steps),
        momentum=0.9, nesterov=True)
    loop = TrainLoop(
        init_fn=resnet.make_init_fn(model),
        loss_fn=resnet.make_loss_fn(model),
        optimizer=tx,
        config=TrainLoopConfig(
            total_steps=total_steps,
            log_every=max(1, total_steps // 10),
            checkpoint_every=checkpoint_every,
        ),
        model_dir=model_dir or ctx.model_dir,
        stateful=True,
        device=dev,
        mesh=mesh,
        param_shardings=lambda params: infer_param_sharding(
            params, mesh, reference_axes=resnet.flax_axes),
    )
    data = device_prefetch(
        resnet.synthetic_imagenet(global_batch, image_size, model.num_classes,
                                  uint8=True),
        loop.device, rows=loop.local_rows(global_batch))
    last: Dict[str, float] = {}

    def on_metrics(m):
        if mlog:
            mlog.write(m.step, {"loss": m.loss,
                                "steps_per_sec": m.steps_per_sec, **m.extras})
        ips = m.steps_per_sec * global_batch
        last.update({"loss": m.loss, "step": m.step, "images_per_sec": ips,
                     "images_per_sec_per_chip": ips / mesh.size, **m.extras})
        logger.info("step %d loss %.4f acc %.3f (%.1f img/s, %.1f img/s/card)",
                    m.step, m.loss, m.extras.get("accuracy", float("nan")), ips,
                    ips / mesh.size)

    try:
        state = loop.run(data, on_metrics=on_metrics)
    finally:
        if mlog:
            mlog.close()
    last["final_step"] = int(state.step)
    return last


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--total-steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=128, help="per-card batch")
    p.add_argument("--image-size", type=int, default=resnet.IMAGE_SIZE)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    metrics = train(initialize_from_env(device=args.device),
                    total_steps=args.total_steps,
                    per_chip_batch=args.batch, image_size=args.image_size,
                    device=args.device)
    destroy()             # leave the job's process group, if any
    return 0 if metrics.get("final_step", 0) > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
