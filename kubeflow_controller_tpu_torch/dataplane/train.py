"""The train loop, on one device or over a mesh of ranks.

Counterpart of ``kubeflow_controller_tpu/dataplane/train.py``: each step
runs the loss's forward and backward (over ``grad_accum`` microbatches,
gradients averaged) and one optimizer update, in place.

Over a mesh (``parallel/mesh.py``, one rank a device) every rank holds
its chunk of each parameter as ``param_shardings`` places it (the fsdp
heuristic ``infer_param_sharding`` when none are given), and the
optimizer's state for that chunk (moments live where their parameter
lives; 8-bit AdamW's per-row statistics are the whole leaf's,
:meth:`~ops.optim8.AdamW8bit.place`). A step gathers each parameter's
compute view (``parallel/sharding.py``: whole but for the dimensions
the model consumes in place: tp shards, a stage's layers, an expert
chunk), runs
the loss on this rank's rows of the global batch (:meth:`TrainLoop.
local_rows`, the counterpart of ``host_to_global``; sp and pp ranks
hold the same rows), reduces each gradient over the loss ranks
(``LOSS_AXES``: data, sp and pp) to this rank's chunk, and reports the
loss and metrics as means over the loss ranks: the global batch's, as
the JAX loop logs them. Host batches
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
:meth:`restore` would pick. Over a mesh every rank gathers the whole
state and the mesh's first rank writes it, in the one-device layout;
every rank restores the whole state and keeps its chunks, so a
checkpoint resumes at another world size and serves on one card. The JAX package's checkpoints are orbax
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

import torch.distributed as dist

from kubeflow_controller_tpu_torch.convert import tree_leaves, tree_unflatten
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.parallel import sharding
from kubeflow_controller_tpu_torch.parallel.mesh import (
    AXES, LOSS_AXES, Mesh, MeshConfig, batch_rows, make_mesh, use_mesh,
)

logger = logging.getLogger("tpujob.train_torch")


def _producer_stream(make_items, size: int) -> Iterator[Any]:
    """Items of ``make_items()`` produced by a daemon thread, at most
    ``size`` ahead. A producer exception is raised in the consumer. A
    consumer that stops early releases the producer and waits for it to
    end: the producer may be inside torch or numpy making the next item,
    and a thread left running there while the interpreter shuts down
    aborts the process ("terminate called without an active
    exception")."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    abandoned = threading.Event()

    def put(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in make_items():
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # raised again in the consumer
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
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
        thread.join()


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
                    yield_chunks: bool = False,
                    rows: Optional[np.ndarray] = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches (dicts of numpy arrays) -> batches on ``device``.
    A producer thread stacks up to ``chunk`` batches into host tensors
    (one copy, pinned when the device is a card), ``size`` chunks ahead
    of the consumer; each chunk's copy to the card is ONE
    ``non_blocking`` transfer, so it queues behind the step before it
    instead of stopping the host. Yields the chunk's batches one by one, or, with
    ``yield_chunks``, the whole ``[n, ...]`` chunk (the input of
    ``TrainLoopConfig.steps_per_call``). A finite stream's last, partial
    chunk is yielded too. ``rows`` keeps only those rows of each host
    batch (this rank's, ``TrainLoop.local_rows``)."""
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
            if rows is not None:
                batches = [{k: np.asarray(v)[rows] for k, v in b.items()}
                           for b in batches]
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
    ``update(params, grads)`` (``optim.AdamW``, ``optim.SGD``).

    ``mesh`` (default: the whole world, pure dp; one rank without a
    process group) and ``param_shardings`` (a tree of specs, or a
    function of the initial parameters returning one) place the state;
    the loss runs under ``use_mesh(mesh)``. Batches given to :meth:`step`
    are this rank's rows of the global batch. A step computes with each
    parameter's compute view (``sharding.gather_for_compute``); when
    ``loss_fn.gathers_params`` is true (the decoder's, BERT's) it hands
    the loss the chunks of the leaves a view would gather instead, and
    the model gathers each where it uses it, a layer at a time
    (``sharding.gathered_in_model``)."""

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
        mesh: Optional[Mesh] = None,
        param_shardings: Any = None,
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
        self.mesh = mesh if mesh is not None else make_mesh(
            MeshConfig(), device_type=self.device.type)
        if self.mesh.coords is None:
            raise ValueError(f"rank {self.mesh.rank} is not in {self.mesh}")
        # Collectives run only over a mesh of more than one rank.
        self.distributed = self.mesh.size > 1
        init_out = init_fn(seed, self.device)
        params, model_state = init_out if stateful else (init_out, {})
        specs = (param_shardings(params) if callable(param_shardings)
                 else param_shardings)
        if specs is None:
            specs = sharding.infer_param_sharding(params, self.mesh)
        self.param_shardings = specs
        self._specs = sharding.spec_leaves(specs)
        self._full_shapes = [tuple(p.shape) for p in tree_leaves(params)]
        # The leaves the model gathers itself: their gradients arrive
        # reduced to the chunk.
        self._in_model = [
            self.distributed and getattr(loss_fn, "gathers_params", False)
            and sharding.needs_gather(s, self.mesh, len(shape))
            for s, shape in zip(self._specs, self._full_shapes)]
        if self.distributed:
            params = sharding.shard_params(params, specs, self.mesh)
            self._place_optimizer()
        else:
            for p in tree_leaves(params):
                p.requires_grad_(True)
        optimizer.init(params)
        self.state = TrainState(step=0, params=params, model_state=model_state)
        self.start_step = 0        # the step the last run() began at
        self.last_eval: Dict[str, float] = {}
        self._saver: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None

    def _place_optimizer(self) -> None:
        """Tell an optimizer with per-row statistics (8-bit AdamW) each
        leaf's whole size and the group that splits its last axis."""
        place = getattr(self.tx, "place", None)
        if place is None:
            return
        groups = []
        for s, shape in zip(self._specs, self._full_shapes):
            axes = sharding.effective(s, self.mesh, len(shape))
            groups.append(self.mesh.group(*axes[-1]) if shape and axes[-1] else None)
        place([int(np.prod(shape)) for shape in self._full_shapes], groups)

    def local_rows(self, global_batch: int) -> Optional[np.ndarray]:
        """This rank's rows of a ``global_batch``-row batch
        (``parallel.mesh.batch_rows`` at the loop's ``grad_accum``), or
        ``None`` (every row) on one rank."""
        if not self.distributed:
            return None
        return batch_rows(self.mesh, global_batch, self.config.grad_accum)

    def _views(self) -> List[torch.Tensor]:
        """The parameters the loss computes with: the parameters
        themselves on one rank, else each one's gathered compute view
        (a leaf of its own)."""
        leaves = tree_leaves(self.state.params)
        if not self.distributed:
            return leaves
        with torch.no_grad():
            return [sharding.gather_for_compute(p, s, self.mesh).requires_grad_(True)
                    for p, s in zip(leaves, self._specs)]

    def _step_views(self) -> List[torch.Tensor]:
        """The leaves a step differentiates: each parameter's compute
        view, or, for one the model gathers itself, its chunk."""
        if not any(self._in_model):
            return self._views()
        leaves = tree_leaves(self.state.params)
        with torch.no_grad():
            return [(p.detach() if own else sharding.gather_for_compute(p, s, self.mesh)
                     ).requires_grad_(True)
                    for p, s, own in zip(leaves, self._specs, self._in_model)]

    def _loss_mean(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric's mean over the loss ranks (``LOSS_AXES``: the data
        ranks, the sp ranks' slices of the sequence and the pp stages;
        perplexity's geometric mean: exp of the mean cross entropy)."""
        group = self.mesh.group(*LOSS_AXES)
        if group is None:
            return values
        keys = list(values)
        stack = torch.stack([
            torch.log(values[k].float()) if k == "perplexity" else values[k].float()
            for k in keys])
        dist.all_reduce(stack, group=group)
        stack = stack / self.mesh.axis_size(*LOSS_AXES)
        return {k: torch.exp(v) if k == "perplexity" else v
                for k, v in zip(keys, stack.unbind())}

    def _grads(self, views, batch, model_state):
        """Gradients (of ``views``), loss and metrics of one (micro)batch,
        and the model state after it (``model_state`` itself when not
        stateful)."""
        params = tree_unflatten(self.state.params, views)
        if self.stateful:
            loss, (metrics, model_state) = self.loss_fn(params, model_state, batch)
            model_state = tree_unflatten(model_state, [
                t.detach() for t in tree_leaves(model_state)])
        else:
            loss, metrics = self.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, views)
        return (list(grads), loss.detach(),
                {k: v.detach() for k, v in metrics.items()}, model_state)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (this rank's rows, already on
        the device); returns the step's metrics as device scalars
        (``loss`` and the loss function's metrics; over a mesh, their
        means over the loss ranks)."""
        with use_mesh(self.mesh):
            return self._step(batch)

    def _step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        views = self._step_views()
        own = [(v, s) for v, s, o in zip(views, self._specs, self._in_model) if o]
        with sharding.gathered_in_model([v for v, _ in own], [s for _, s in own],
                                        self.mesh):
            grads, loss, metrics, model_state = self._accumulate(views, batch)
        del views, own
        if self.distributed:
            # A leaf at a time, each replacing its unreduced gradient:
            # the step holds both forms of one leaf's gradient at most.
            for i, (s, mine) in enumerate(zip(self._specs, self._in_model)):
                if not mine:
                    grads[i] = sharding.reduce_grad(grads[i], s, self.mesh)
            metrics = self._loss_mean({"loss": loss, **metrics})
            loss = metrics.pop("loss")
        self.tx.update(self.state.params, tree_unflatten(self.state.params, grads))
        self.state.model_state = model_state
        self.state.step += 1
        return {"loss": loss, **metrics}

    def _accumulate(self, views, batch):
        """Gradients, loss, metrics and model state of one step's batch,
        over its ``grad_accum`` microbatches."""
        A = self.config.grad_accum
        model_state = self.state.model_state
        if A == 1:
            grads, loss, metrics, model_state = self._grads(views, batch, model_state)
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
                g, loss, metrics, model_state = self._grads(views, mb, model_state)
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
        return grads, loss, metrics, model_state

    def steps(self, chunk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step per leading index of the ``[K, ...]`` ``chunk``, in
        order; returns each metric stacked ``[K]``."""
        n = next(iter(chunk.values())).shape[0]
        out = [self.step({k: v[i] for k, v in chunk.items()}) for i in range(n)]
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

    def _on_device(self, batch) -> Dict[str, torch.Tensor]:
        """A global host batch -> this rank's rows of it on the device."""
        rows = None
        if self.distributed:
            rows = batch_rows(self.mesh, len(next(iter(batch.values()))))
        out = {}
        for k, v in batch.items():
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
            if rows is not None:
                v = v[torch.from_numpy(rows)]
            out[k] = v.to(self.device)
        return out

    @torch.no_grad()
    def evaluate(self, eval_iter: Iterator[Any], batches: int = 1) -> Dict[str, float]:
        """``eval_fn`` over ``batches`` global batches of ``eval_iter``
        (numpy or tensors; over a mesh each rank evaluates its rows); the
        mean of each metric. Sums on the device and reads once at the
        end."""
        if self.eval_fn is None:
            raise ValueError("TrainLoop built without eval_fn")
        acc: Dict[str, torch.Tensor] = {}
        with use_mesh(self.mesh):
            params = tree_unflatten(self.state.params, self._views())
            for _ in range(batches):
                batch = self._on_device(next(eval_iter))
                if self.stateful:
                    out = self.eval_fn(params, self.state.model_state, batch)
                else:
                    out = self.eval_fn(params, batch)
                for k, v in out.items():
                    acc[k] = v if k not in acc else acc[k] + v
            acc = self._loss_mean(acc)
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
        if self._agree(os.path.exists(os.path.join(self.model_dir, str(step)))):
            return
        params, opt = self._whole_state()
        payload = ({"step": step, "params": params,
                    "model_state": self.state.model_state}, opt)
        if wait:
            if self._writer():
                self._write(step, payload)
            self._barrier()     # the other ranks see the checkpoint
            return
        if not self._writer():
            return
        # The optimizer updates the parameters and its state in place:
        # the background thread writes a host copy taken now.
        payload = _to_host(payload)
        self._saver = threading.Thread(
            target=self._write_async, args=(step, payload), daemon=True)
        self._saver.start()

    def _mesh_group(self):
        return self.mesh.group(*AXES)

    def _writer(self) -> bool:
        """Whether this rank writes checkpoints: the mesh's first."""
        return self.mesh.rank == int(self.mesh.devices.flat[0])

    def _barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self._mesh_group())

    def _agree(self, value: int) -> int:
        """The largest of the mesh's ranks' ``value``s (so that every
        rank takes the same branch)."""
        if not self.distributed:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._mesh_group())
        return int(t.item())

    def _whole_state(self):
        """The whole parameters and optimizer state (gathered from every
        rank's chunks over a mesh), detached."""
        leaves = tree_leaves(self.state.params)
        opt = self.tx.state_dict()
        if not self.distributed:
            return tree_unflatten(self.state.params, [p.detach() for p in leaves]), opt
        params = tree_unflatten(self.state.params, [
            sharding.gather_full(p.detach(), s, self.mesh)
            for p, s in zip(leaves, self._specs)])
        return params, self._map_opt_state(
            opt, [p.shape for p in leaves],
            lambda v, spec: sharding.gather_full(v, spec, self.mesh))

    def _shard_opt_state(self, opt):
        """A whole optimizer state (from a checkpoint) -> this rank's."""
        if not self.distributed:
            return opt
        return self._map_opt_state(
            opt, self._full_shapes,
            lambda v, spec: sharding.local_shard(v, spec, self.mesh))

    def _map_opt_state(self, opt, shapes, fn):
        """``opt`` (a ``state_dict``) with ``fn(tensor, spec)`` applied to
        each of its per-parameter tensors, the spec by
        ``sharding.moment_spec`` from the parameters' ``shapes`` (chunks'
        or whole): a ``torch.optim`` state (AdamW, SGD) under ``"opt"``,
        or 8-bit AdamW's per-leaf ``"m"`` and ``"v"`` (codes and
        statistics)."""
        if "opt" in opt:
            inner = opt["opt"]
            specs = sharding.opt_state_specs(inner["state"], shapes, self._specs)
            inner = dict(inner, state={
                i: {k: fn(v, specs[i][k]) if isinstance(v, torch.Tensor) and v.ndim > 0
                    else v for k, v in st.items()}
                for i, st in inner["state"].items()})
            return dict(opt, opt=inner)
        if "m" in opt and "v" in opt:
            return dict(opt, **{key: [
                {k: fn(v, sharding.moment_spec(v.shape, shape, s)) for k, v in leaf.items()}
                for leaf, shape, s in zip(opt[key], shapes, self._specs)]
                for key in ("m", "v")})
        return opt

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
        self._barrier()
        steps = checkpoint_steps(self.model_dir)
        latest = self._agree(steps[-1] if steps else -1)
        if latest < 0:
            return False
        path = os.path.join(self.model_dir, str(latest))
        ckpt = torch.load(os.path.join(path, PARAMS_FILE),
                          map_location=self.device, weights_only=True)
        with torch.no_grad():
            for p, q, s in zip(tree_leaves(self.state.params),
                               tree_leaves(ckpt["params"]), self._specs):
                p.copy_(sharding.local_shard(q, s, self.mesh)
                        if self.distributed else q)
        self.state.model_state = ckpt.get("model_state", {})
        self.tx.load_state_dict(self._shard_opt_state(torch.load(
            os.path.join(path, OPT_FILE), map_location=self.device,
            weights_only=True)))
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
