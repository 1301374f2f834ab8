"""The train loop on one device.

Counterpart of ``kubeflow_controller_tpu/dataplane/train.py``: the
parameter tree and its optimizer state live on one device; each step
runs the loss's forward and backward (over ``grad_accum`` microbatches,
gradients averaged) and one optimizer update, in place. Host batches
reach the card through :func:`device_prefetch` (a producer thread
pins them; each copy is ``non_blocking``). Like the JAX loop, it reads
device values only at log points, so steps queue on the card between
them.

Stateful models (``stateful=True``, e.g. BatchNorm's running
statistics): ``init_fn`` returns ``(params, model_state)`` and
``loss_fn(params, model_state, batch)`` returns ``(loss, (metrics,
new_model_state))``; the new state replaces the old after the step, and
under ``grad_accum`` it threads through the microbatches in order.
Periodic evaluation: ``eval_fn(params, batch)`` (``(params, model_state,
batch)`` when stateful) returns metrics; :meth:`TrainLoop.evaluate`
averages them over ``eval_batches`` batches, and :meth:`TrainLoop.run`
evaluates every ``eval_every`` steps and reports them as ``val_*``.

Checkpoints: with a ``model_dir``, :meth:`TrainLoop.run` resumes from
the latest checkpoint there, saves every ``checkpoint_every`` steps and
at the end, and keeps the newest ``keep_checkpoints``. A checkpoint is
the directory ``model_dir/<step>/`` holding ``params.pt`` (the step, the
parameters and the model state) and ``opt.pt`` (the optimizer's whole
state), written with ``torch.save`` into a temporary directory that is
then renamed, so a save cut short never leaves a checkpoint that
:meth:`restore` would pick. The JAX package's checkpoints are orbax
directories, which this format does not read; ``convert.py`` carries
JAX weights across as numpy arrays.

``async_checkpoint``: a periodic save copies the state to the host
synchronously (the next step updates the parameters in place) and writes
it in a background thread; the final save waits for it. Multi-step
dispatch (``steps_per_call = K > 1``): each item of the data iterator is
a ``[K, ...]`` chunk (``device_prefetch(chunk=K, yield_chunks=True)``),
trimmed to the steps that remain, stepped through in one call; its
metrics come back stacked ``[K]`` and are averaged at the log sites, and
the checkpoint, eval and log cadences land on K-step boundaries.
Profiling: with ``profile_dir``, a ``torch.profiler`` trace of steps
``[profile_start, profile_start + profile_steps)`` is written there as
``*.pt.trace.json``.
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


def _host_stack(arrays: List[np.ndarray], pin: bool) -> torch.Tensor:
    """``np.stack(arrays)`` written straight into a fresh ``[n, ...]``
    host tensor, pinned when ``pin``: one copy of each batch."""
    first = np.asarray(arrays[0])
    dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
    buf = torch.empty((len(arrays), *first.shape), dtype=dtype, pin_memory=pin)
    np.stack(arrays, out=buf.numpy())
    return buf


def device_prefetch(data_iter: Iterator[Dict[str, np.ndarray]],
                    device: DeviceLike = None, size: int = 2,
                    chunk: int = 1,
                    yield_chunks: bool = False) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches (dicts of numpy arrays) -> batches on ``device``.
    A producer thread stacks up to ``chunk`` batches into host tensors
    (one copy, pinned when the device is a card), ``size`` chunks ahead
    of the consumer; each chunk's copy to the card is ONE
    ``non_blocking`` transfer, so it queues behind the step before it
    instead of stopping the host. Yields the chunk's batches one by one, or, with
    ``yield_chunks``, the whole ``[n, ...]`` chunk (the input of
    ``TrainLoopConfig.steps_per_call``). A finite stream's last, partial
    chunk is yielded too."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    data_iter = iter(data_iter)

    def host_chunks():
        while True:
            batches = []
            for _ in range(chunk):
                try:
                    batches.append(next(data_iter))
                except StopIteration:
                    break
            if not batches:
                return
            yield {k: _host_stack([b[k] for b in batches], pin)
                   for k in batches[0]}
            if len(batches) < chunk:
                return

    for stack in _producer_stream(host_chunks, size):
        stack = {k: v.to(dev, non_blocking=True) for k, v in stack.items()}
        if yield_chunks:
            yield stack
        else:
            for i in range(next(iter(stack.values())).shape[0]):
                yield {k: v[i] for k, v in stack.items()}


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
    # Every eval_every steps (0 = never), run eval_fn over eval_batches
    # batches of the eval stream and report the means as val_* metrics.
    eval_every: int = 0
    eval_batches: int = 1
    # True: a periodic save copies the state to the host and writes it
    # in a background thread (the final save always waits).
    async_checkpoint: bool = False
    # > 1: each data item is a [K, ...] chunk of K steps' batches, stepped
    # through in one call; cadences land on K-step boundaries.
    steps_per_call: int = 1
    # When set, write a torch.profiler trace of steps [profile_start,
    # profile_start + profile_steps) into this directory.
    profile_dir: str = ""
    profile_start: int = 10
    profile_steps: int = 5


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
    # Non-trainable model state (BatchNorm statistics), updated by the
    # loss function rather than the optimizer; empty when unused.
    model_state: Any = field(default_factory=dict)


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
    """Owns the parameters, the model state, the optimizer state and the
    step.

    ``init_fn(seed, device) -> params`` (a nested dict of tensors) and
    ``loss_fn(params, batch) -> (loss, metrics_dict)`` define the model
    (with ``stateful``: ``init_fn -> (params, model_state)`` and
    ``loss_fn(params, model_state, batch) -> (loss, (metrics,
    new_model_state))``); ``optimizer`` has ``init(params)`` and
    ``update(params, grads)`` (``optim.AdamW``, ``optim.SGD``)."""

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
        if cfg.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1 (got {cfg.grad_accum})")
        if cfg.steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1 (got {cfg.steps_per_call})")
        self.device = resolve_device(device)
        self.model_dir = model_dir
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.stateful = stateful
        self.tx = optimizer
        init_out = init_fn(seed, self.device)
        params, model_state = init_out if stateful else (init_out, {})
        for p in tree_leaves(params):
            p.requires_grad_(True)
        optimizer.init(params)
        self.state = TrainState(step=0, params=params, model_state=model_state)
        self.start_step = 0        # the step the last run() began at
        self.last_eval: Dict[str, float] = {}
        self._saver: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None

    def _grads(self, batch, model_state):
        """Gradients, loss and metrics of one (micro)batch, and the model
        state after it (``model_state`` itself when not stateful)."""
        params = self.state.params
        if self.stateful:
            loss, (metrics, model_state) = self.loss_fn(params, model_state, batch)
            model_state = tree_unflatten(model_state, [
                t.detach() for t in tree_leaves(model_state)])
        else:
            loss, metrics = self.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return (list(grads), loss.detach(),
                {k: v.detach() for k, v in metrics.items()}, model_state)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (already on the device);
        returns the step's metrics as device scalars (``loss`` and the
        loss function's metrics)."""
        A = self.config.grad_accum
        model_state = self.state.model_state
        if A == 1:
            grads, loss, metrics, model_state = self._grads(batch, model_state)
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
                # The model state threads through the microbatches in
                # order, as it would across real steps.
                g, loss, metrics, model_state = self._grads(mb, model_state)
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
        self.state.model_state = model_state
        self.state.step += 1
        return {"loss": loss, **metrics}

    def steps(self, chunk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step per leading index of the ``[K, ...]`` ``chunk``, in
        order; returns each metric stacked ``[K]``."""
        n = next(iter(chunk.values())).shape[0]
        out = [self.step({k: v[i] for k, v in chunk.items()}) for i in range(n)]
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

    def _on_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v))).to(self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def evaluate(self, eval_iter: Iterator[Any], batches: int = 1) -> Dict[str, float]:
        """``eval_fn`` over ``batches`` batches of ``eval_iter`` (numpy or
        tensors); the mean of each metric. Sums on the device and reads
        once at the end."""
        if self.eval_fn is None:
            raise ValueError("TrainLoop built without eval_fn")
        acc: Dict[str, torch.Tensor] = {}
        for _ in range(batches):
            batch = self._on_device(next(eval_iter))
            if self.stateful:
                out = self.eval_fn(self.state.params, self.state.model_state, batch)
            else:
                out = self.eval_fn(self.state.params, batch)
            for k, v in out.items():
                acc[k] = v if k not in acc else acc[k] + v
        return {k: float(v) / batches for k, v in acc.items()}

    # -- checkpointing -------------------------------------------------------

    def save(self, wait: bool = True) -> None:
        """Write the state as ``model_dir/<step>/`` (a no-op without a
        model dir, or when that step is saved already, as the reference's
        checkpoint manager skips it): into a temporary directory first,
        renamed when both files are down, then prune all but the newest
        ``keep_checkpoints``. ``wait=False`` copies the state to the host
        now and writes it in a background thread; any save first waits
        for the one before it."""
        self.wait_for_save()
        if not self.model_dir:
            return
        step = int(self.state.step)
        if os.path.exists(os.path.join(self.model_dir, str(step))):
            return
        params = tree_unflatten(self.state.params, [
            p.detach() for p in tree_leaves(self.state.params)])
        payload = ({"step": step, "params": params,
                    "model_state": self.state.model_state},
                   self.tx.state_dict())
        if wait:
            self._write(step, payload)
            return
        # The optimizer updates the parameters and its state in place:
        # the background thread writes a host copy taken now.
        payload = _to_host(payload)
        self._saver = threading.Thread(
            target=self._write_async, args=(step, payload), daemon=True)
        self._saver.start()

    def wait_for_save(self) -> None:
        """Wait for the background save in flight, if any; raise its
        error here."""
        if self._saver is not None:
            self._saver.join()
            self._saver = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise err

    def _write_async(self, step: int, payload) -> None:
        try:
            self._write(step, payload)
        except BaseException as e:  # raised again by wait_for_save
            self._save_error = e

    def _write(self, step: int, payload) -> None:
        final = os.path.join(self.model_dir, str(step))
        os.makedirs(self.model_dir, exist_ok=True)
        for name in os.listdir(self.model_dir):
            if name.startswith(".tmp-"):       # a save cut short earlier
                shutil.rmtree(os.path.join(self.model_dir, name))
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.model_dir)
        torch.save(payload[0], os.path.join(tmp, PARAMS_FILE))
        torch.save(payload[1], os.path.join(tmp, OPT_FILE))
        os.rename(tmp, final)
        for old in checkpoint_steps(self.model_dir)[:-max(1, self.config.keep_checkpoints)]:
            shutil.rmtree(os.path.join(self.model_dir, str(old)))

    def restore(self) -> bool:
        """Resume from the latest checkpoint in ``model_dir``, if any:
        the parameters (in place), the model state, the optimizer's state
        and the step, on the loop's device. The path by which a preempted job continues
        instead of starting again at step 0."""
        self.wait_for_save()
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
        self.state.model_state = ckpt.get("model_state", {})
        self.tx.load_state_dict(torch.load(
            os.path.join(path, OPT_FILE), map_location=self.device,
            weights_only=True))
        self.state.step = int(ckpt["step"])
        logger.info("restored checkpoint at step %d", self.state.step)
        return True

    # -- the loop ---------------------------------------------------------------

    def run(self, data_iter: Iterator[Dict[str, torch.Tensor]],
            on_metrics: Optional[Callable[[StepMetrics], None]] = None,
            eval_iter: Optional[Iterator[Any]] = None) -> TrainState:
        """Resume from ``model_dir`` if it holds a checkpoint, then step
        until ``total_steps``; report every ``log_every`` steps and at the
        last, save every ``checkpoint_every`` steps (in the background
        under ``async_checkpoint``) and at the end, and, with an
        ``eval_fn`` and an ``eval_iter``, evaluate every ``eval_every``
        steps (the latest ``val_*`` metrics ride along in each report's
        extras). Under ``steps_per_call = K`` each data item is a ``[K,
        ...]`` chunk and each cadence fires when a call crosses a multiple
        of it. ``steps_per_sec`` averages the steps since the last report
        (reading the loss waits for them)."""
        cfg = self.config
        self.restore()
        self.start_step = self.state.step
        t0 = time.perf_counter()
        window = self.state.step
        spc = cfg.steps_per_call
        prof = None
        profile_done = False

        def crossed(every: int, before: int, after: int) -> bool:
            """Did (before, after] cross a multiple of ``every``?"""
            return bool(every) and (before // every) != (after // every)

        while self.state.step < cfg.total_steps:
            before = self.state.step
            if (cfg.profile_dir and prof is None and not profile_done
                    and before >= cfg.profile_start):
                prof = _start_profile(self.device)
            if prof is not None and before >= cfg.profile_start + cfg.profile_steps:
                _stop_profile(prof, self.device, cfg.profile_dir,
                              cfg.profile_start, before)
                prof, profile_done = None, True
            batch = next(data_iter)
            if spc > 1:
                take = min(next(iter(batch.values())).shape[0],
                           cfg.total_steps - before)
                metrics = self.steps({k: v[:take] for k, v in batch.items()})
            else:
                metrics = self.step(batch)
            step = self.state.step
            if crossed(cfg.checkpoint_every, before, step):
                self.save(wait=not cfg.async_checkpoint)
            if (self.eval_fn is not None and eval_iter is not None
                    and crossed(cfg.eval_every, before, step)):
                self.last_eval = {
                    f"val_{k}": v for k, v in
                    self.evaluate(eval_iter, cfg.eval_batches).items()}
            if on_metrics and (crossed(cfg.log_every, before, step)
                               or step == cfg.total_steps):
                # Multi-step metrics come back stacked [K]: their mean.
                scalar = {k: float(v.float().mean()) for k, v in metrics.items()}
                scalar.update(self.last_eval)
                dt = time.perf_counter() - t0
                on_metrics(StepMetrics(
                    step=step, loss=scalar.pop("loss"), extras=scalar,
                    steps_per_sec=(step - window) / dt if dt > 0 else 0.0))
                t0 = time.perf_counter()
                window = step
        if prof is not None:         # the loop ended inside the window
            _stop_profile(prof, self.device, cfg.profile_dir,
                          cfg.profile_start, self.state.step)
        self.save()
        return self.state


def _to_host(tree):
    """A copy of ``tree`` (dicts, lists, tuples of tensors and plain
    values) with every tensor copied to host memory."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _start_profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, device: torch.device, profile_dir: str,
                  first: int, end: int) -> None:
    """Wait for the profiled steps, stop the profiler and write its trace
    as ``profile_dir/steps_<first>_<end>.pt.trace.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"steps_{first}_{end}.pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info("profile of steps [%d, %d) written to %s", first, end, path)
