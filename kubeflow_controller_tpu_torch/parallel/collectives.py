"""The collectives the layers call, over the ambient mesh's groups.

The JAX package gets these from GSPMD; here they are explicit, and each
is the identity when the ambient mesh (``mesh.use_mesh``) has one rank
on the axes it reduces over, or when there is no ambient mesh:

* :func:`tp_copy` and :func:`tp_sum` are Megatron's ``f`` and ``g``:
  ``tp_copy`` enters a tensor-parallel region (identity forward,
  gradient summed over tp backward), ``tp_sum`` leaves one (partial
  sums added over tp forward, identity backward: the gradient of a
  replicated output is already whole on every rank);
* :func:`data_sum` sums over the data axes in both directions
  (BatchNorm's statistics over the global batch: each rank's loss
  depends on every rank's rows through them);
* :func:`masked_denominator` turns a per-rank count into the mean
  count over the data ranks, so that a masked mean whose ranks hold
  different counts averages to the global batch's masked mean (the
  train loop averages the ranks' losses and gradients);
* :func:`tp_max` and :func:`tp_gather` read values across tp without
  gradients (the vocab-parallel loss's max and argmax).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from kubeflow_controller_tpu_torch.parallel.mesh import DATA_AXES, current_mesh


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


def data_sum(x: torch.Tensor) -> torch.Tensor:
    group, n = _group(*DATA_AXES)
    return x if n == 1 else _DataSum.apply(x, group)


def data_shards() -> int:
    return _group(*DATA_AXES)[1]


def masked_denominator(count: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """``max(Σ counts, floor) / n`` over the n data ranks (no gradient):
    ``local_sum / masked_denominator(local_count)`` averaged over the
    ranks is ``Σ sums / max(Σ counts, floor)``, the global batch's
    masked mean. One rank: ``count.clamp_min(floor)``."""
    group, n = _group(*DATA_AXES)
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
