"""The train loop on one device.

Counterpart of ``kubeflow_controller_tpu/dataplane/train.py``: the
parameter tree and its optimizer state live on one device; each step
runs the loss's forward and backward (over ``grad_accum`` microbatches,
gradients averaged) and one optimizer update, in place. Host batches
reach the card through :func:`device_prefetch` (a producer thread
pins them; each copy is ``non_blocking``). Like the JAX loop, it reads
device values only at log points, so steps queue on the card between
them.

Checkpoints: with a ``model_dir``, :meth:`TrainLoop.run` resumes from
the latest checkpoint there, saves every ``checkpoint_every`` steps and
at the end, and keeps the newest ``keep_checkpoints``. A checkpoint is
the directory ``model_dir/<step>/`` holding ``params.pt`` (the step and
the parameters) and ``opt.pt`` (the optimizer's whole state), written
with ``torch.save`` into a temporary directory that is then renamed, so
a save cut short never leaves a checkpoint that :meth:`restore` would
pick. The JAX package's checkpoints are orbax directories, which this
format does not read; ``convert.py`` carries JAX weights across as numpy
arrays.

Not ported yet, and refused by name: asynchronous saves
(``async_checkpoint``), multi-step dispatch (``steps_per_call > 1``),
periodic evaluation (``eval_fn``), stateful models (``stateful``) and
profiling (``profile_dir``).
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from kubeflow_controller_tpu_torch.convert import tree_leaves, tree_unflatten
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("tpujob.train_torch")


def _producer_stream(make_items, size: int) -> Iterator[Any]:
    """Items of ``make_items()`` produced by a daemon thread, at most
    ``size`` ahead. A producer exception is raised in the consumer; a
    consumer that stops early releases the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    abandoned = threading.Event()

    def producer():
        try:
            for item in make_items():
                while not abandoned.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if abandoned.is_set():
                    return
            q.put(end)
        except BaseException as e:  # raised again in the consumer
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        abandoned.set()


def device_prefetch(data_iter: Iterator[Dict[str, np.ndarray]],
                    device: DeviceLike = None,
                    size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches (dicts of numpy arrays) -> batches on ``device``.
    A producer thread turns each batch into tensors, pinned when the
    device is a card, ``size`` batches ahead of the consumer; the copy to
    the card is ``non_blocking``, so it queues behind the step before it
    instead of stopping the host."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"

    def host_batches():
        for batch in data_iter:
            t = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch.items()}
            yield {k: v.pin_memory() for k, v in t.items()} if pin else t

    for batch in _producer_stream(host_batches, size):
        yield {k: v.to(dev, non_blocking=True) for k, v in batch.items()}


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 20
    # > 1: split each step's batch into this many microbatches, run the
    # forward and backward on each, and apply ONE optimizer update on the
    # mean gradient. The batch's leading dim must divide.
    grad_accum: int = 1
    checkpoint_every: int = 0      # 0 = only at the end (with a model_dir)
    keep_checkpoints: int = 3
    # Not ported yet; any value but these defaults is refused.
    async_checkpoint: bool = False
    steps_per_call: int = 1
    eval_every: int = 0
    profile_dir: str = ""


@dataclass
class StepMetrics:
    step: int
    loss: float
    extras: Dict[str, float] = field(default_factory=dict)
    steps_per_sec: float = 0.0


@dataclass
class TrainState:
    step: int
    params: Any


PARAMS_FILE, OPT_FILE = "params.pt", "opt.pt"


def checkpoint_steps(model_dir: str) -> List[int]:
    """The steps of the complete checkpoints in ``model_dir``, oldest
    first. A temporary directory of a save cut short is not one."""
    if not model_dir or not os.path.isdir(model_dir):
        return []
    return sorted(
        int(name) for name in os.listdir(model_dir)
        if name.isdigit() and os.path.isfile(
            os.path.join(model_dir, name, OPT_FILE)))


def load_params(model_dir: str, step: int, device: DeviceLike = None):
    """The parameters of the checkpoint at ``step`` on ``device``, read
    without the optimizer's state."""
    ckpt = torch.load(os.path.join(model_dir, str(step), PARAMS_FILE),
                      map_location="cpu", mmap=True, weights_only=True)
    dev = resolve_device(device)
    return tree_unflatten(ckpt["params"],
                          [t.to(dev) for t in tree_leaves(ckpt["params"])])


class TrainLoop:
    """Owns the parameters, the optimizer state and the step.

    ``init_fn(seed, device) -> params`` (a nested dict of tensors) and
    ``loss_fn(params, batch) -> (loss, metrics_dict)`` define the model;
    ``optimizer`` has ``init(params)`` and ``update(params, grads)``
    (``optim.AdamW``)."""

    def __init__(
        self,
        init_fn: Callable[[int, torch.device], Any],
        loss_fn: Callable[..., Any],
        optimizer: Any,
        config: Optional[TrainLoopConfig] = None,
        model_dir: str = "",
        seed: int = 0,
        stateful: bool = False,
        eval_fn: Optional[Callable[..., Dict]] = None,
        device: DeviceLike = None,
    ):
        self.config = config or TrainLoopConfig()
        cfg = self.config
        refused = {
            "async_checkpoint": cfg.async_checkpoint,
            "steps_per_call": cfg.steps_per_call != 1,
            "eval_fn": eval_fn is not None or bool(cfg.eval_every),
            "stateful": stateful,
            "profile_dir": bool(cfg.profile_dir),
        }
        for name, on in refused.items():
            if on:
                raise NotImplementedError(f"TrainLoop {name} is not yet ported")
        if cfg.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1 (got {cfg.grad_accum})")
        self.device = resolve_device(device)
        self.model_dir = model_dir
        self.loss_fn = loss_fn
        self.tx = optimizer
        params = init_fn(seed, self.device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        optimizer.init(params)
        self.state = TrainState(step=0, params=params)
        self.start_step = 0        # the step the last run() began at

    def _grads(self, batch):
        params = self.state.params
        loss, metrics = self.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return list(grads), loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (already on the device);
        returns the step's metrics as device scalars (``loss`` and the
        loss function's metrics)."""
        A = self.config.grad_accum
        if A == 1:
            grads, loss, metrics = self._grads(batch)
        else:
            for k, v in batch.items():
                if v.shape[0] % A:
                    raise ValueError(
                        f"global batch {v.shape[0]} not divisible "
                        f"by grad_accum={A}; adjust batch size or "
                        "the accumulation factor")
            micro = [{k: v.chunk(A)[i] for k, v in batch.items()}
                     for i in range(A)]
            grads, losses, metricses = None, [], []
            for mb in micro:
                g, loss, metrics = self._grads(mb)
                grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
                losses.append(loss)
                metricses.append(metrics)
            grads = [g.div_(A) for g in grads]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
            if "perplexity" in metrics:
                # exp(mean CE): the geometric mean of the microbatches'
                # perplexities, as an un-accumulated step reports it.
                metrics["perplexity"] = torch.exp(torch.stack(
                    [torch.log(m["perplexity"]) for m in metricses]).mean())
        self.tx.update(self.state.params, tree_unflatten(self.state.params, grads))
        self.state.step += 1
        return {"loss": loss, **metrics}

    # -- checkpointing -------------------------------------------------------

    def save(self) -> None:
        """Write the state as ``model_dir/<step>/`` (a no-op without a
        model dir, or when that step is saved already, as the reference's
        checkpoint manager skips it): into a temporary directory first,
        renamed when both files are down, then prune all but the newest
        ``keep_checkpoints``."""
        if not self.model_dir:
            return
        step = int(self.state.step)
        final = os.path.join(self.model_dir, str(step))
        if os.path.exists(final):
            return
        os.makedirs(self.model_dir, exist_ok=True)
        for name in os.listdir(self.model_dir):
            if name.startswith(".tmp-"):       # a save cut short earlier
                shutil.rmtree(os.path.join(self.model_dir, name))
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.model_dir)
        params = tree_unflatten(self.state.params, [
            p.detach() for p in tree_leaves(self.state.params)])
        torch.save({"step": step, "params": params},
                   os.path.join(tmp, PARAMS_FILE))
        torch.save(self.tx.state_dict(), os.path.join(tmp, OPT_FILE))
        os.rename(tmp, final)
        for old in checkpoint_steps(self.model_dir)[:-max(1, self.config.keep_checkpoints)]:
            shutil.rmtree(os.path.join(self.model_dir, str(old)))

    def restore(self) -> bool:
        """Resume from the latest checkpoint in ``model_dir``, if any:
        the parameters (in place), the optimizer's state and the step, on
        the loop's device. The path by which a preempted job continues
        instead of starting again at step 0."""
        steps = checkpoint_steps(self.model_dir)
        if not steps:
            return False
        path = os.path.join(self.model_dir, str(steps[-1]))
        ckpt = torch.load(os.path.join(path, PARAMS_FILE),
                          map_location=self.device, weights_only=True)
        with torch.no_grad():
            for p, q in zip(tree_leaves(self.state.params),
                            tree_leaves(ckpt["params"])):
                p.copy_(q)
        self.tx.load_state_dict(torch.load(
            os.path.join(path, OPT_FILE), map_location=self.device,
            weights_only=True))
        self.state.step = int(ckpt["step"])
        logger.info("restored checkpoint at step %d", self.state.step)
        return True

    # -- the loop ---------------------------------------------------------------

    def run(self, data_iter: Iterator[Dict[str, torch.Tensor]],
            on_metrics: Optional[Callable[[StepMetrics], None]] = None) -> TrainState:
        """Resume from ``model_dir`` if it holds a checkpoint, then step
        until ``total_steps``; report every ``log_every`` steps and at the
        last, save every ``checkpoint_every`` steps and at the end.
        ``steps_per_sec`` averages the steps since the last report
        (reading the loss waits for them)."""
        cfg = self.config
        self.restore()
        self.start_step = self.state.step
        t0 = time.perf_counter()
        window = self.state.step
        while self.state.step < cfg.total_steps:
            metrics = self.step(next(data_iter))
            step = self.state.step
            if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                self.save()
            if on_metrics and (step % cfg.log_every == 0 or step == cfg.total_steps):
                scalar = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                on_metrics(StepMetrics(
                    step=step, loss=scalar.pop("loss"), extras=scalar,
                    steps_per_sec=(step - window) / dt if dt > 0 else 0.0))
                t0 = time.perf_counter()
                window = step
        self.save()
        return self.state
