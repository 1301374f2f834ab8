"""Parameter sharding: logical axis names -> mesh axes -> local shards.

Counterpart of ``kubeflow_controller_tpu/parallel/sharding.py``. A
parameter's placement is a :class:`P` (a ``PartitionSpec``-like tuple:
per dimension ``None``, a mesh axis, or a tuple of mesh axes), the same
value the JAX package writes; :func:`placements` turns one into
``torch.distributed`` ``DTensor`` placements. Each rank stores its
chunk of every parameter (:func:`shard_params`, :func:`local_shard`).

A train step runs on *compute views* (:func:`gather_for_compute`):
every sharded dimension is all-gathered except one sharded over ``tp``
alone, which the tensor-parallel layers consume in place (Megatron's
column- and row-parallel weights, the vocab-parallel head), the
leading layer axis of a stacked leaf sharded over ``pp``, whose block
of layers is this pipeline stage's, and an expert bank's expert axis
sharded over ``ep``, whose experts are this rank's. The gradient of a
view is this rank's part of the gradient of the mean of the loss
ranks' losses (``mesh.LOSS_AXES``: data, sp and pp), whole over tp;
:func:`reduce_grad` sums it over the loss ranks that hold the leaf
whole — reduce-scattered over fsdp where a dimension is fsdp-sharded,
not over pp for a stage's layers, not over ep for an expert chunk
(``mesh.grad_sum_axes``) — keeps this rank's chunk and divides by the
number of loss ranks. :func:`gather_full` rebuilds a whole
parameter, over pp too. A checkpoint gathers nothing: each rank writes
the chunks it is the first to hold (:func:`chunk_writers`), and a
restore at any world size reads each rank's region of a leaf
(:func:`chunk_box`) from the chunks that overlap it (:func:`fill_box`).

A model that reads its parameters through :func:`view` (and its
stacked ``[L, ...]`` layer leaves through :func:`layers`) lets the
train loop hand it the chunks instead (:func:`gathered_in_model`): each
is then gathered where it is used, one layer at a time, and its
gradient is reduced to the chunk's in the backward, so that a step
never holds every parameter, or every gradient, whole. Under a layer's
checkpoint the gather runs again in the recompute, so the layer's
gathered weights live only while it runs.

Default rules, as the JAX package's:

    "embed"   -> tp      (vocab/feature-parallel embedding)
    "heads"   -> tp      (attention heads across tensor group)
    "mlp"     -> tp      (ffn hidden across tensor group)
    "fsdp"    -> fsdp    (any axis marked for fully-sharded storage)
    None      -> replicated
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kubeflow_controller_tpu_torch.convert import tree_leaves, tree_unflatten
from kubeflow_controller_tpu_torch.parallel.collectives import gather_dim, reduce_scatter_dim
from kubeflow_controller_tpu_torch.parallel.mesh import AXES, LOSS_AXES, Mesh, grad_sum_axes


class P(tuple):
    """A ``PartitionSpec``: one entry per leading dimension (``None``,
    an axis name, or a tuple of axis names); missing trailing entries
    are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


DEFAULT_RULES: Dict[str, Optional[str]] = {
    "embed": "tp",
    "vocab": "tp",
    "heads": "tp",
    "mlp": "tp",
    "kv": None,
    "fsdp": "fsdp",
    "seq": "sp",
    "batch": "dp",
}


def logical_to_mesh(logical_axes: Sequence[Optional[str]],
                    rules: Optional[Dict[str, Optional[str]]] = None) -> P:
    rules = rules or DEFAULT_RULES
    return P(*(rules.get(ax) if ax is not None else None for ax in logical_axes))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def effective(spec: Optional[Sequence], mesh: Mesh, ndim: int) -> List[Tuple[str, ...]]:
    """Per dimension, the mesh axes of more than one rank that shard it
    (in mesh order: an entry naming axes out of mesh order is refused)."""
    entries = list(spec or ()) + [None] * (ndim - len(spec or ()))
    out = []
    for e in entries[:ndim]:
        axes = _entry_axes(e)
        if list(axes) != sorted(axes, key=AXES.index):
            raise NotImplementedError(
                f"spec entry {e!r} names axes out of mesh order {AXES}")
        out.append(tuple(a for a in axes if mesh.shape[a] > 1))
    return out


def placements(spec: Optional[Sequence], mesh: Mesh, ndim: int) -> list:
    """``DTensor`` placements of a ``ndim``-dimensional tensor placed by
    ``spec``, one per mesh axis: ``Shard(d)`` where the axis splits
    dimension ``d`` (two axes on one dimension nest in mesh order, as
    the spec's tuple does), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    entries = list(spec or ()) + [None] * (ndim - len(spec or ()))
    out = []
    for axis in AXES:
        dims = [d for d, e in enumerate(entries[:ndim]) if axis in _entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    effective(spec, mesh, ndim)          # refuses out-of-order entries
    return out


def infer_param_sharding(
    params: Any, mesh: Mesh,
    rules: Optional[Dict[str, Optional[str]]] = None,
    fsdp_min_size: int = 2 ** 16,
    reference_axes: Optional[Callable[[torch.Tensor], Optional[Sequence[int]]]] = None,
) -> Any:
    """Heuristic specs for unannotated trees (MNIST, ResNet): a leaf of
    2+ dimensions and at least ``fsdp_min_size`` elements has its
    largest dimension divisible by fsdp sharded over fsdp (the first
    such on ties); everything else is replicated. ``reference_axes(t)``
    may give the order of ``t``'s dimensions in the JAX package's
    layout (ResNet's OIHW kernels are HWIO there), so that ties break
    as they break there."""
    fsdp = mesh.shape["fsdp"]

    def spec_for(p: torch.Tensor) -> P:
        if fsdp > 1 and p.ndim >= 2 and p.numel() >= fsdp_min_size:
            order = list((reference_axes and reference_axes(p)) or range(p.ndim))
            for i in sorted(order, key=lambda i: -p.shape[i]):
                if p.shape[i] % fsdp == 0:
                    axes: list = [None] * p.ndim
                    axes[i] = "fsdp"
                    return P(*axes)
        return P()

    return tree_unflatten(params, [spec_for(p) for p in tree_leaves(params)])


def _chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(
            f"dimension {dim} of shape {tuple(t.shape)} does not divide "
            f"into {n} shards")
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def local_shard(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's chunk of the whole tensor ``t`` (a copy)."""
    for d, axes in enumerate(effective(spec, mesh, t.ndim)):
        if axes:
            t = _chunk(t, d, mesh.axis_size(*axes), mesh.axis_index(*axes))
    return t.contiguous().clone()


Box = Tuple[Tuple[int, int], ...]


def chunk_box(shape: Sequence[int], spec, mesh: Mesh,
              coords: Optional[Dict[str, int]] = None) -> Box:
    """Per dimension, the ``[lo, hi)`` bounds of the chunk of a whole
    tensor of ``shape`` placed by ``spec`` that the rank at ``coords``
    (default: this rank) holds: :func:`local_shard`'s chunk."""
    coords = mesh.coords if coords is None else coords
    box = []
    for d, axes in enumerate(effective(spec, mesh, len(shape))):
        n = mesh.axis_size(*axes)
        if shape[d] % n:
            raise ValueError(f"dimension {d} of shape {tuple(shape)} does not "
                             f"divide into {n} shards")
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
        size = shape[d] // n
        box.append((idx * size, (idx + 1) * size))
    return tuple(box)


def chunk_writers(shape: Sequence[int], spec, mesh: Mesh) -> List[Tuple[int, Box]]:
    """Each distinct chunk of a leaf once, as ``(rank, box)``: the rank
    whose coordinate is 0 on every axis that does not shard the leaf
    writes it (for a replicated leaf, the mesh's first rank)."""
    sharding = {a for axes in effective(spec, mesh, len(shape)) for a in axes}
    out = []
    for idx in np.ndindex(*mesh.devices.shape):
        coords = dict(zip(AXES, idx))
        if not any(coords[a] for a in AXES if a not in sharding):
            out.append((int(mesh.devices[idx]), chunk_box(shape, spec, mesh, coords)))
    return out


def whole_shape(shape: Sequence[int], spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of the whole tensor whose chunk, placed by ``spec``, has
    ``shape``."""
    return tuple(n * mesh.axis_size(*axes)
                 for n, axes in zip(shape, effective(spec, mesh, len(shape))))


def fill_box(out: torch.Tensor, box: Box,
             pieces: Sequence[Tuple[Box, Callable[[], torch.Tensor]]]) -> torch.Tensor:
    """Write into ``out`` (the region ``box`` of a whole tensor) the parts
    of ``pieces`` that overlap it. Each piece is a region of the same
    whole tensor and a function giving its values (a chunk of a
    checkpoint, read only if it overlaps); together they must cover
    ``box``. Returns ``out``."""
    covered = 0
    for pbox, load in pieces:
        lo = [max(a[0], b[0]) for a, b in zip(box, pbox)]
        hi = [min(a[1], b[1]) for a, b in zip(box, pbox)]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        dst, src = out, load()
        for d, (l, h) in enumerate(zip(lo, hi)):
            dst = dst.narrow(d, l - box[d][0], h - l)
            src = src.narrow(d, l - pbox[d][0], h - l)
        dst.copy_(src)
        covered += math.prod(h - l for l, h in zip(lo, hi))
    if covered != out.numel():
        raise ValueError(f"the pieces cover {covered} of the {out.numel()} "
                         f"elements of region {box}")
    return out


def shard_params(params: Any, specs: Any, mesh: Mesh) -> Any:
    """The tree of this rank's chunks of ``params`` placed by ``specs``
    (a tree of the same structure)."""
    return tree_unflatten(params, [
        local_shard(p, s, mesh) for p, s in
        zip(tree_leaves(params), spec_leaves(specs))])


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (a spec is a
    leaf, not a subtree)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [specs]


def _tp_local(spec, ndim: int) -> List[bool]:
    """Per dimension, whether the spec shards it over tp, pp or ep alone
    (the dimensions a compute view keeps as this rank's: a tp shard, a
    stage's layers, an expert bank's experts)."""
    entries = list(spec or ()) + [None] * (ndim - len(spec or ()))
    return [_entry_axes(e) in (("tp",), ("pp",), ("ep",)) for e in entries[:ndim]]


def _gather_dims(t: torch.Tensor, spec, mesh: Mesh, keep_tp: bool) -> torch.Tensor:
    local = _tp_local(spec, t.ndim)
    for d, axes in enumerate(effective(spec, mesh, t.ndim)):
        if axes and not (keep_tp and local[d]):
            t = gather_dim(t, d, mesh.group(*axes), mesh.axis_size(*axes))
    return t.contiguous()


def gather_for_compute(local: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The tensor a step computes with: every sharded dimension
    gathered, but one sharded over ``tp`` alone, over ``pp`` alone (a
    stage's layers) or over ``ep`` alone (the experts of this rank, which
    the all-to-all brings every ep rank's tokens to) stays this
    rank's."""
    return _gather_dims(local, spec, mesh, keep_tp=True)


def gather_full(local: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor, from every rank's chunk."""
    return _gather_dims(local, spec, mesh, keep_tp=False)


def reduce_grad(grad: torch.Tensor, spec, mesh: Mesh,
                stage: bool = False) -> torch.Tensor:
    """The gradient of this rank's chunk from the gradient of its compute
    view: summed over the loss ranks (reduce-scattered along a dimension
    whose spec leads with fsdp, all-reduced over the other loss axes but
    pp where the leaf is a stage's layers: a layer axis sharded over pp,
    or ``stage``, one layer of such a leaf; and but ep where an expert
    axis is sharded over ep, whose gradient the all-to-all's backward
    has summed over the ep ranks' tokens), narrowed to the chunk, and
    divided by the number of loss ranks (``mesh.LOSS_AXES``), ep
    included."""
    scattered = expert = False
    narrow = []
    local = _tp_local(spec, grad.ndim)
    for d, axes in enumerate(effective(spec, mesh, grad.ndim)):
        if axes == ("pp",):
            stage = True
        if axes == ("ep",):
            expert = True
        if not axes or local[d]:
            continue
        if axes[0] == "fsdp" and not scattered:
            grad = reduce_scatter_dim(grad, d, mesh.group("fsdp"), mesh.shape["fsdp"])
            scattered = True
            axes = axes[1:]
        if axes:
            narrow.append((d, axes))
    group = mesh.group(*grad_sum_axes(scattered, stage, expert))
    if group is not None:
        grad = grad.contiguous()
        dist.all_reduce(grad, group=group)
    for d, axes in narrow:
        grad = _chunk(grad, d, mesh.axis_size(*axes), mesh.axis_index(*axes))
    n = mesh.axis_size(*LOSS_AXES)
    return (grad / n if n > 1 else grad).contiguous()


def is_sharded(spec, mesh: Mesh, ndim: int) -> bool:
    return any(effective(spec, mesh, ndim))


def needs_gather(spec, mesh: Mesh, ndim: int) -> bool:
    """Whether a compute view gathers anything of the leaf (a dimension
    sharded over more than tp, pp or ep alone)."""
    local = _tp_local(spec, ndim)
    return any(axes and not local[d]
               for d, axes in enumerate(effective(spec, mesh, ndim)))


class _GatherView(torch.autograd.Function):
    """A chunk -> its compute view; backward: the view's gradient -> the
    chunk's (:func:`reduce_grad`)."""

    @staticmethod
    def forward(ctx, chunk, spec, mesh, stage):
        ctx.spec, ctx.mesh, ctx.stage = spec, mesh, stage
        return gather_for_compute(chunk, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_grad(g, ctx.spec, ctx.mesh, ctx.stage), None, None, None


def _view_shape(chunk: torch.Tensor, spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of ``gather_for_compute(chunk, spec, mesh)``."""
    shape, local = list(chunk.shape), _tp_local(spec, chunk.ndim)
    for d, axes in enumerate(effective(spec, mesh, chunk.ndim)):
        if axes and not local[d]:
            shape[d] *= mesh.axis_size(*axes)
    return tuple(shape)


class _Pending(torch.autograd.Function):
    """A chunk -> a stand-in of its compute view's shape (no storage),
    which every use of the view hangs from (:class:`_GatherUse`);
    backward: the uses' gradients, summed by autograd -> the chunk's
    (:func:`reduce_grad`), once."""

    @staticmethod
    def forward(ctx, chunk, spec, mesh, stage):
        ctx.spec, ctx.mesh, ctx.stage = spec, mesh, stage
        return chunk.new_zeros(()).expand(_view_shape(chunk, spec, mesh))

    @staticmethod
    def backward(ctx, g):
        return reduce_grad(g, ctx.spec, ctx.mesh, ctx.stage), None, None, None


class _GatherUse(torch.autograd.Function):
    """One use of a chunk's compute view, gathered here; backward: the
    view's gradient, unreduced, to the chunk's :class:`_Pending`."""

    @staticmethod
    def forward(ctx, pending, chunk, spec, mesh):
        return gather_for_compute(chunk, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


# id(chunk) -> (chunk, spec, mesh, stage, pending) of the chunks a model
# gathers itself (``stage``: one layer of a stage's pp-sharded stack;
# ``pending``: its :class:`_Pending` when its gradient is reduced once
# for every use), innermost gathered_in_model block last.
_IN_MODEL: List[Dict[int, Tuple[torch.Tensor, Any, Mesh, bool, Optional[torch.Tensor]]]] = []


@contextlib.contextmanager
def gathered_in_model(chunks: Sequence[torch.Tensor], specs: Sequence[Any],
                      mesh: Mesh) -> Iterator[None]:
    """Inside the block (the forward and the backward of a step),
    :func:`view` of one of ``chunks`` gathers its compute view where the
    model uses it, and the view's gradient reaches the chunk reduced:
    the gradient ``reduce_grad`` would give."""
    _IN_MODEL.append({id(t): (t, s, mesh, False, None) for t, s in zip(chunks, specs)})
    try:
        yield
    finally:
        _IN_MODEL.pop()


def _registered(t: torch.Tensor):
    entry = _IN_MODEL[-1].get(id(t)) if _IN_MODEL else None
    return entry if entry is not None and entry[0] is t else None


def view(t):
    """The parameter (or tree of them) a model computes with: ``t``
    itself, or for a chunk of a :func:`gathered_in_model` block its
    compute view, gathered here."""
    if isinstance(t, dict):
        return {k: view(v) for k, v in t.items()}
    entry = _registered(t)
    if entry is None:
        return t
    _, spec, mesh, stage, pending = entry
    if pending is not None:
        return _GatherUse.apply(pending, t.detach(), spec, mesh)
    return _GatherView.apply(t, spec, mesh, stage)


def layers(t: torch.Tensor, once: bool = False) -> Tuple[torch.Tensor, ...]:
    """``t.unbind(0)``, a stacked leaf's per-layer slices (under pp, this
    stage's layers); a chunk's slices are registered with a layer's spec
    (the leading entry dropped), so that :func:`view` gathers one layer
    at a time. ``once``: a slice's view may be used many times (the
    pipeline runs a stage's layers on every tick), and its gradient is
    reduced once, when every use has handed back its part; until then
    autograd holds the sum, of the view's shape."""
    parts = t.unbind(0)
    entry = _registered(t)
    if entry is not None:
        _, spec, mesh, _, _ = entry
        spec = list(spec or ())
        if spec and spec[0] not in (None, "pp"):
            raise NotImplementedError(
                f"a stacked leaf sharded along its layer axis ({spec[0]!r})")
        stage = bool(spec) and spec[0] == "pp" and mesh.shape["pp"] > 1
        for part in parts:
            lspec = P(*spec[1:])
            pending = _Pending.apply(part, lspec, mesh, stage) if once else None
            _IN_MODEL[-1][id(part)] = (part, lspec, mesh, stage, pending)
    return parts


def moment_spec(shape: Sequence[int], param_shape: Sequence[int], spec) -> P:
    """Where an optimizer state tensor of ``shape`` lives, for a
    parameter of ``param_shape`` (both chunks' shapes, or both whole)
    placed by ``spec``: one of the parameter's shape (Adam's moments,
    SGD's momentum, 8-bit AdamW's codes) where the parameter lives; one
    of its per-row statistics (the parameter's shape with a last axis of
    1: 8-bit AdamW's scales and log ranges, the whole leaf's over its
    last axis) where its rows live; anything else (a step count)
    replicated."""
    shape, param_shape = tuple(shape), tuple(param_shape)
    if shape == param_shape:
        return spec
    n = len(shape)
    if n and n == len(param_shape) and shape[:-1] == param_shape[:-1] and shape[-1] == 1:
        rows = (list(spec or ()) + [None] * n)[:n - 1]
        if any(e is not None for e in rows):
            return P(*rows, None)
    return P()


def opt_state_specs(opt_state: Dict[Any, Dict[str, Any]],
                    shapes: Sequence[Tuple[int, ...]],
                    specs: Sequence[Any]) -> Dict[Any, Dict[str, Any]]:
    """Specs for a ``torch.optim`` ``state_dict()["state"]`` (per
    parameter index, a dict of tensors) whose parameters have ``shapes``
    (their chunks' or their whole shapes) and ``specs``, by
    :func:`moment_spec`. The counterpart of ``opt_state_shardings``."""
    out = {}
    for i, st in opt_state.items():
        shape, s = tuple(shapes[int(i)]), specs[int(i)]
        out[i] = {k: (moment_spec(v.shape, shape, s)
                      if isinstance(v, torch.Tensor) and v.ndim > 0 else P())
                  for k, v in st.items()}
    return out
