"""ResNet-50 ImageNet training entry point on one GPU.

Counterpart of ``kubeflow_controller_tpu/dataplane/entrypoints/
resnet.py``: ``models/resnet.py`` trained through a stateful
``TrainLoop`` (BatchNorm statistics as model state) by SGD with Nesterov
momentum 0.9 under the warmup-cosine schedule, on the synthetic
ImageNet stream with uint8 images on the wire. It reports the
reference's metrics, ``images_per_sec`` and ``images_per_sec_per_chip``
(here per card: one card):

    python -m kubeflow_controller_tpu_torch.dataplane.entrypoints.resnet \\
        --total-steps 8

Runs on ``cuda`` unless ``device="cpu"``; a multi-process job is refused
with "not yet ported".
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional

from kubeflow_controller_tpu_torch.dataplane import metrics as metrics_sink
from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
from kubeflow_controller_tpu_torch.device import DeviceLike
from kubeflow_controller_tpu_torch.models import resnet

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
    if ctx.num_processes > 1:
        raise NotImplementedError(
            f"multi-process training (num_processes={ctx.num_processes}) "
            "is not yet ported")
    mlog = metrics_sink.from_context(ctx)
    global_batch = per_chip_batch
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
        device=device,
    )
    data = device_prefetch(
        resnet.synthetic_imagenet(global_batch, image_size, model.num_classes,
                                  uint8=True),
        loop.device)
    last: Dict[str, float] = {}

    def on_metrics(m):
        if mlog:
            mlog.write(m.step, {"loss": m.loss,
                                "steps_per_sec": m.steps_per_sec, **m.extras})
        ips = m.steps_per_sec * global_batch
        last.update({"loss": m.loss, "step": m.step, "images_per_sec": ips,
                     "images_per_sec_per_chip": ips, **m.extras})
        logger.info("step %d loss %.4f acc %.3f (%.1f img/s on one card)",
                    m.step, m.loss, m.extras.get("accuracy", float("nan")), ips)

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
    metrics = train(ProcessContext.from_env(), total_steps=args.total_steps,
                    per_chip_batch=args.batch, image_size=args.image_size,
                    device=args.device)
    return 0 if metrics.get("final_step", 0) > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
