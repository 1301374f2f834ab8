"""The train loop on one device.

Counterpart of ``kubeflow_controller_tpu/dataplane/train.py``: the
parameter tree and its optimizer state live on one device; each step
runs the loss's forward and backward (over ``grad_accum`` microbatches,
gradients averaged) and one optimizer update, in place. Host batches
reach the card through :func:`device_prefetch` (a producer thread
pins them; each copy is ``non_blocking``). Like the JAX loop, it reads
device values only at log points, so steps queue on the card between
them.

Not ported yet, and refused by name: checkpointing (``model_dir``,
``checkpoint_every``: orbax restore has no counterpart here), multi-step
dispatch (``steps_per_call > 1``), periodic evaluation (``eval_fn``),
stateful models (``stateful``) and profiling (``profile_dir``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional

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
    # Not ported yet; any value but these defaults is refused.
    checkpoint_every: int = 0
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
            "model_dir": bool(model_dir),
            "checkpoint_every": bool(cfg.checkpoint_every),
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
        self.loss_fn = loss_fn
        self.tx = optimizer
        params = init_fn(seed, self.device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        optimizer.init(params)
        self.state = TrainState(step=0, params=params)

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

    def run(self, data_iter: Iterator[Dict[str, torch.Tensor]],
            on_metrics: Optional[Callable[[StepMetrics], None]] = None) -> TrainState:
        """Step until ``total_steps``; report every ``log_every`` steps and
        at the last. ``steps_per_sec`` averages the steps since the last
        report (reading the loss waits for them)."""
        cfg = self.config
        t0 = time.perf_counter()
        window = self.state.step
        while self.state.step < cfg.total_steps:
            metrics = self.step(next(data_iter))
            step = self.state.step
            if on_metrics and (step % cfg.log_every == 0 or step == cfg.total_steps):
                scalar = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                on_metrics(StepMetrics(
                    step=step, loss=scalar.pop("loss"), extras=scalar,
                    steps_per_sec=(step - window) / dt if dt > 0 else 0.0))
                t0 = time.perf_counter()
                window = step
        return self.state
