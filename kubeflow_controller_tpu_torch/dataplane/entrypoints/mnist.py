"""MNIST training entry point.

Counterpart of ``kubeflow_controller_tpu/dataplane/entrypoints/mnist.py``:
the MLP (``models/mnist.py``) trained by Adam through ``TrainLoop``, with
a held-out evaluation every ``total_steps // 5`` steps, on the canonical
MNIST idx files of ``data_dir`` (the job's ``TPUJOB_DATA_DIR``) when
they are there, and on the synthetic teacher task otherwise:

    python -m kubeflow_controller_tpu_torch.dataplane.entrypoints.mnist \\
        --device cpu

On real data it also reports ``test_accuracy`` over the whole test split.
Runs on ``cuda`` unless ``device="cpu"``. A multi-process job
(``ctx.num_processes > 1``, its process group up through
``dist.initialize_from_env``, which :func:`main` calls) trains pure dp
over every rank, as the JAX package's ``make_mesh(MeshConfig())``: the
batch rounds up to a multiple of the data shards.
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional

import torch

from kubeflow_controller_tpu_torch.dataplane import metrics as metrics_sink
from kubeflow_controller_tpu_torch.dataplane.dist import (
    ProcessContext, destroy, initialize_from_env, job_device,
    require_process_group,
)
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.models import mnist
from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig, data_shards, make_mesh

logger = logging.getLogger("tpujob.mnist_torch")


def train(
    ctx: Optional[ProcessContext] = None,
    total_steps: int = 200,
    batch_size: int = 100,
    learning_rate: float = 0.01,
    hidden: int = mnist.HIDDEN_UNITS,
    model_dir: str = "",
    checkpoint_every: int = 0,
    data_dir: str = "",
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Train the MLP up to ``total_steps``; returns the last logged
    metrics (``loss``, ``step``, ``accuracy``, ``val_cross_entropy``,
    ``val_accuracy``), ``final_step`` and, on real data,
    ``test_accuracy``."""
    from kubeflow_controller_tpu_torch.dataplane.train import (
        TrainLoop, TrainLoopConfig, device_prefetch,
    )
    from kubeflow_controller_tpu_torch.optim import adam

    ctx = ctx or ProcessContext.from_env()
    require_process_group(ctx)
    dev = resolve_device(job_device(ctx, device))
    data_dir = data_dir or ctx.data_dir
    mlog = metrics_sink.from_context(ctx)
    mesh = make_mesh(MeshConfig(), device_type=dev.type)   # pure dp
    n_data = data_shards(mesh)
    if batch_size % n_data:
        # The reference's default 100 does not divide every mesh: round
        # up so that every rank gets equal work.
        batch_size = -(-batch_size // n_data) * n_data
        logger.info("rounded batch size up to %d (mesh has %d data shards)",
                    batch_size, n_data)
    model = mnist.MnistMLP(hidden=hidden)
    loop = TrainLoop(
        init_fn=mnist.make_init_fn(model),
        loss_fn=mnist.make_loss_fn(model),
        optimizer=adam(learning_rate),
        config=TrainLoopConfig(
            total_steps=total_steps,
            log_every=max(1, total_steps // 5),
            checkpoint_every=checkpoint_every,
            eval_every=max(1, total_steps // 5),
        ),
        model_dir=model_dir or ctx.model_dir,
        eval_fn=mnist.make_eval_fn(model),
        device=dev,
        mesh=mesh,
    )
    last: Dict[str, float] = {}

    def on_metrics(m):
        if mlog:
            mlog.write(m.step, {"loss": m.loss,
                                "steps_per_sec": m.steps_per_sec, **m.extras})
        last.update({"loss": m.loss, "step": m.step, **m.extras})
        logger.info(
            "step %d loss %.4f acc %.3f val_xent %.4f val_acc %.3f "
            "(%.1f steps/s)", m.step, m.loss,
            m.extras.get("accuracy", float("nan")),
            m.extras.get("val_cross_entropy", float("nan")),
            m.extras.get("val_accuracy", float("nan")), m.steps_per_sec)

    real = mnist.has_idx_data(data_dir)
    test_images = test_labels = None
    if real:
        ds = mnist.mnist_from_data_dir(data_dir)
        logger.info("training on real idx data from %s (%d train samples)",
                    data_dir, len(ds["train_images"]))
        train_iter = mnist.idx_batches(
            ds["train_images"], ds["train_labels"], batch_size)
        test_images, test_labels = ds.get("test_images"), ds.get("test_labels")
        if test_images is None or test_labels is None:
            # A partial test split cannot be evaluated: train without it.
            test_images = test_labels = None
        eval_iter = (
            mnist.idx_batches(test_images, test_labels, batch_size, seed=1)
            if test_images is not None and len(test_images) >= batch_size
            else None)
    else:
        train_iter = mnist.synthetic_mnist(batch_size)
        eval_iter = mnist.synthetic_mnist(batch_size, seed=1)   # held out

    try:
        rows = loop.local_rows(batch_size)
        state = loop.run(device_prefetch(train_iter, loop.device, rows=rows),
                         on_metrics=on_metrics, eval_iter=eval_iter)
    finally:
        if mlog:
            mlog.close()
    last["final_step"] = int(state.step)
    if real and test_images is not None:
        # Whole-test-set accuracy, the reference's headline number.
        with torch.no_grad():
            logits = model.apply(state.params,
                                 torch.from_numpy(test_images).to(loop.device))
            labels = torch.from_numpy(test_labels).to(loop.device)
            last["test_accuracy"] = float(
                (logits.argmax(-1) == labels).float().mean())
        logger.info("test accuracy over %d held-out samples: %.4f",
                    len(test_labels), last["test_accuracy"])
    return last


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    metrics = train(initialize_from_env(device=args.device), device=args.device)
    # Success: the controller marks the job Succeeded on exit 0.
    destroy()             # leave the job's process group, if any
    return 0 if metrics.get("accuracy", 0.0) > 0.5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
