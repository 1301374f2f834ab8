"""The collectives the layers call, over the ambient mesh's groups.

The JAX package gets these from GSPMD; here they are explicit, and each
is the identity when the ambient mesh (``mesh.use_mesh``) has one rank
on the axes it reduces over, or when there is no ambient mesh:

* :func:`tp_copy` and :func:`tp_sum` are Megatron's ``f`` and ``g``:
  ``tp_copy`` enters a tensor-parallel region (identity forward,
  gradient summed over tp backward), ``tp_sum`` leaves one (partial
  sums added over tp forward, identity backward: the gradient of a
  replicated output is already whole on every rank);
* :func:`axis_sum` sums over mesh axes in both directions, as JAX's
  ``psum`` transposes to a ``psum``: :func:`data_sum` over the data
  axes (BatchNorm's statistics over the global batch: each rank's loss
  depends on every rank's rows through them), and the pipeline's masked
  sum over pp (``parallel/pipeline.py``);
* :func:`masked_denominator` turns a per-rank count into the mean
  count over the loss ranks (:data:`~parallel.mesh.LOSS_AXES`), so that
  a masked mean whose ranks hold different counts averages to the
  global batch's masked mean (the train loop averages the ranks' losses
  and gradients);
* :func:`tp_max` and :func:`tp_gather` read values across tp without
  gradients (the vocab-parallel loss's max and argmax);
* :func:`ring_shift` is JAX's ``ppermute`` by a fixed offset around a
  mesh axis (ring attention's K/V rotation, the pipeline's hand-off to
  the next stage); its backward is the reverse shift;
* :func:`seq_gather` all-gathers the sequence over sp; its backward
  reduce-scatters, since each rank holds only its slice of the output's
  gradient;
* :func:`tp_concat` joins the tp ranks' shards of a column-parallel
  output (Megatron's gather: backward keeps this rank's slice of a
  gradient that is whole on every tp rank);
* :func:`all_to_all` sends each ep rank's dispatched tokens to the ep
  ranks that hold their experts and, with ``inverse``, the experts'
  outputs back (the exchange GSPMD derives from the JAX package's
  ``P("ep", ...)`` constraint); the backward is the other direction;
* :func:`axes_group` names the group over some mesh axes, for the int8
  scales of a contraction those axes split (``ops/quant.py``).

Point-to-point transfers go through ``dist.batch_isend_irecv`` and the
all-to-all through ``dist.all_to_all_single``. Gloo sends and receives
host memory only, so on gloo a CUDA tensor is staged through pinned
host buffers for both (:func:`p2p_transport` names the route); the
compute stays on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from kubeflow_controller_tpu_torch.parallel.mesh import (
    DATA_AXES, LOSS_AXES, current_mesh,
)


def _group(*axes: str) -> Tuple[Optional[object], int]:
    mesh = current_mesh()
    if mesh is None or mesh.axis_size(*axes) == 1:
        return None, 1
    return mesh.group(*axes), mesh.axis_size(*axes)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _TpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def axes_group(*axes: str) -> Tuple[Optional[object], int]:
    """The ambient mesh's group over ``axes`` and its size: ``(None, 1)``
    off a mesh or where those axes hold one rank."""
    return _group(*axes)


def tp_size() -> int:
    return _group("tp")[1]


def tp_index() -> int:
    mesh = current_mesh()
    return 0 if mesh is None or mesh.shape["tp"] == 1 else mesh.coords["tp"]


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    group, n = _group("tp")
    return x if n == 1 else _TpCopy.apply(x, group)


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    group, n = _group("tp")
    return x if n == 1 else _TpSum.apply(x, group)


def axis_sum(x: torch.Tensor, *axes: str) -> torch.Tensor:
    """``x`` summed over the ranks of ``axes``; the backward sums the
    gradient over them too."""
    group, n = _group(*axes)
    return x if n == 1 else _DataSum.apply(x, group)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    return axis_sum(x, *DATA_AXES)


def data_shards() -> int:
    return _group(*DATA_AXES)[1]


def masked_denominator(count: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """``max(Σ counts, floor) / n`` over the n loss ranks (no gradient):
    ``local_sum / masked_denominator(local_count)`` averaged over the
    ranks is ``Σ sums / max(Σ counts, floor)``, the global batch's
    masked mean (pp ranks count the same tokens, which the mean over
    them undoes). One rank: ``count.clamp_min(floor)``."""
    group, n = _group(*LOSS_AXES)
    if n == 1:
        return count.clamp_min(floor)
    return _all_reduce(count.detach().float(), group).clamp_min(floor) / n


def tp_max(x: torch.Tensor) -> torch.Tensor:
    group, n = _group("tp")
    x = x.detach()
    return x if n == 1 else _all_reduce(x, group, dist.ReduceOp.MAX)


def tp_gather(x: torch.Tensor) -> torch.Tensor:
    """``[tp, *x.shape]``: every tp rank's ``x`` in rank order (no
    gradient)."""
    group, n = _group("tp")
    x = x.detach().contiguous()
    if n == 1:
        return x[None]
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return torch.stack(out)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether :func:`_p2p` stages ``x`` through pinned host memory: a
    CUDA tensor on gloo, which sends and receives host memory only."""
    return x.is_cuda and str(dist.get_backend(group)) == "gloo"


def p2p_transport(x: torch.Tensor, group) -> str:
    """How :func:`ring_shift` and :func:`all_to_all` move ``x`` over
    ``group``: the backend's own send and receive or all-to-all, or
    through pinned host memory (:func:`_staged`)."""
    backend = str(dist.get_backend(group))
    return f"{backend} via pinned host memory" if _staged(x, group) else backend


def _p2p(x: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``x`` to group rank ``dst``; return what group rank ``src``
    sends (of ``x``'s shape and dtype)."""
    staged = _staged(x, group)
    buf = x.detach().contiguous()
    if staged:
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        buf = host.copy_(buf)
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device) if staged else out


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return _p2p(x, (i + offset) % n, (i - offset) % n, group)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return _shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.offset), None, None


def ring_shift(x: torch.Tensor, axis: str, offset: int) -> torch.Tensor:
    """JAX's ``ppermute`` with ``perm = [(j, (j + offset) % n)]`` over
    mesh axis ``axis``: each rank sends ``x`` to the rank ``offset``
    along the axis and returns what the rank ``-offset`` along it sent
    (ring attention's ``offset=-1``: receive from the right-hand
    neighbour). The backward is the reverse shift, JAX's transpose of a
    ``ppermute``. The identity on an axis of one rank."""
    group, n = _group(axis)
    return x if n == 1 else _Shift.apply(x, group, offset)


def gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` joined along ``dim`` in rank order."""
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum of the ``n`` ranks' ``x``, this rank's chunk along ``dim``."""
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return gather_dim(x, dim, group, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n).contiguous(), None, None, None


def seq_gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The sp ranks' slices of ``x`` along ``dim`` joined in rank order
    (the whole sequence); the backward reduce-scatters the gradient,
    each rank keeping its slice's sum over the ranks."""
    group, n = _group("sp")
    return x if n == 1 else _SeqGather.apply(x, dim, group, n)


class _TpConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, i):
        ctx.n, ctx.i = n, i
        return gather_dim(x, x.ndim - 1, group, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, -1)[ctx.i].contiguous(), None, None, None


def tp_concat(x: torch.Tensor) -> torch.Tensor:
    """The tp ranks' shards of ``x``'s last dimension joined in rank
    order; the backward keeps this rank's slice of the gradient (whole
    and the same on every tp rank, as what follows runs replicated)."""
    group, n = _group("tp")
    return x if n == 1 else _TpConcat.apply(x, group, n, tp_index())


def _all_to_all_single(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_to_all_single``: ``x``'s dim 0 cut into the group's n
    equal chunks, chunk j sent to group rank j; the chunks received, in
    rank order along dim 0. Staged through pinned host memory where
    :func:`_staged` says so."""
    staged = _staged(x, group)
    buf = x.detach().contiguous()
    if staged:
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        buf = host.copy_(buf)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.to(x.device) if staged else out


def _exchange(x: torch.Tensor, group, n: int, inverse: bool) -> torch.Tensor:
    """Forward: ``[E, G, cap, D]`` (every expert's slots of this rank's
    groups) -> ``[E/n, n G, cap, D]`` (this rank's experts' slots of the
    n ranks' groups, rank by rank). Inverse: back."""
    if not inverse:
        e, g = x.shape[:2]
        out = _all_to_all_single(x, group)                    # [n E/n, G, ...]
        out = out.reshape(n, e // n, g, *x.shape[2:]).transpose(0, 1)
        return out.reshape(e // n, n * g, *x.shape[2:])
    e_loc, ng = x.shape[:2]
    y = x.reshape(e_loc, n, ng // n, *x.shape[2:]).transpose(0, 1)
    return _all_to_all_single(y.reshape(n * e_loc, ng // n, *x.shape[2:]), group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, inverse):
        ctx.group, ctx.n, ctx.inverse = group, n, inverse
        return _exchange(x, group, n, inverse)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.n, not ctx.inverse), None, None, None


def all_to_all(x: torch.Tensor, axis: str = "ep", inverse: bool = False) -> torch.Tensor:
    """The expert exchange over mesh axis ``axis`` (n ranks). Forward:
    ``x [E, G, cap, D]``, this rank's groups dispatched to every expert,
    becomes ``[E/n, n G, cap, D]``: the slots of the n ranks' groups
    (rank order) for this rank's ``E/n`` experts, the layout of the JAX
    package's ``P("ep", ("dp", "fsdp"))``. ``inverse``: the experts'
    outputs back to the ranks whose groups they are. The backward of each
    direction is the other. The identity on an axis of one rank."""
    group, n = _group(axis)
    return x if n == 1 else _AllToAll.apply(x, group, n, inverse)
