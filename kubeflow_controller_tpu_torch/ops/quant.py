"""Int8 quantized matmul for training: the composed path.

Counterpart of ``kubeflow_controller_tpu/ops/quant.py``. Every linear
projection ``y[m, n] = x[m, k] @ w[k, n]`` runs on int8 operands the AQT
way, forward and both gradients:

- x is quantized per row (scale over its contraction axis k) and w per
  column, so the scales factor out of the dot and the int32 sum
  dequantizes exactly: ``y = (qx @ qw) * sx[:, None] * sw[None, :]``;
- the scales are dynamic (abs-max of the live tensor / 127), the codes
  ``round`` half to even and clipped to ±127;
- the backward is the straight-through estimator, its two products
  quantized the same way (``dx = g @ w.T``, ``dw = x.T @ g``).

The int8 product is ``torch._int_mm`` (int8 x int8 -> exact int32), as
the JAX package leaves it to XLA's ``lax.dot`` outside any kernel.
``maybe_quant_dot`` routes ``quant="int8_fused"`` to the fused kernel of
``ops/quant_fused.py`` for the shapes it tiles, and here otherwise.

Over a mesh each rank holds a piece of the logical product, and a scale
is the abs-max over the whole of its contraction axis, as the JAX
package's, which runs on the global arrays under GSPMD: a :class:`Split`
names the groups that split the rows (the token axis: the data axes, and
sp where the sequence is split), the contraction ``k`` (a row-parallel
projection's tp) and the columns ``n`` (a column-parallel projection's
tp). Each product's abs-maxes are all-reduced with MAX over the group
that splits its contraction (the forward's over ``k``, dx's over ``n``,
dw's over the rows), and the fp32 partial products of a split
contraction are summed over its group before any cast (the forward over
``k``, dx over ``n``); dw's partials are summed with the rest of the
gradient (``parallel/sharding.py:reduce_grad``). Without a mesh, or where
those axes hold one rank, nothing is reduced and no collective runs.
:class:`Projections` applies this to a layer's column- and row-parallel
projections.

The JAX package's ``INT8_SAVE_NAMES`` (names its remat policy saves) has
no counterpart: the port's per-layer checkpoint saves nothing inside the
layer and recomputes the codes in the backward's re-forward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_controller_tpu_torch.parallel.collectives import (
    axes_group, tp_copy, tp_sum,
)
from kubeflow_controller_tpu_torch.parallel.mesh import DATA_AXES

# The reference divides the abs-max by 127.0 (``quant.py:45``), and the
# JAX package trains under ``jax.jit``, where XLA rewrites a division by
# a constant into a multiplication by its fp32 reciprocal: one ulp apart
# from a true division for some rows. The port multiplies by the same
# fp32 constant, so its scales and codes are the jitted reference's bit
# for bit.
INV_127 = float(np.float32(1) / np.float32(127))

_Group = Tuple[Optional[object], int]


class Split(NamedTuple):
    """The process groups (with their sizes) that split a projection's
    ``[m, k] @ [k, n]`` over the ambient mesh: ``rows`` its token axis
    m, ``k`` its contraction, ``n`` its columns; ``(None, 1)`` where the
    axis is whole on this rank."""

    rows: _Group = (None, 1)
    k: _Group = (None, 1)
    n: _Group = (None, 1)


def split(rows: Sequence[str] = DATA_AXES, k: Sequence[str] = (),
          n: Sequence[str] = ()) -> Split:
    """The :class:`Split` of the ambient mesh's axes ``rows``, ``k`` and
    ``n`` (by default the tokens split over the data axes, as a batch's
    rows are; off a mesh, nothing)."""
    return Split(axes_group(*rows), axes_group(*k), axes_group(*n))


def _symmetric_scales(x: torch.Tensor, axis: int, group=None) -> torch.Tensor:
    """Per-slice symmetric fp32 scale so ``x / scale`` fits [-127, 127];
    ``axis`` is the contraction axis being reduced away, its abs-max the
    largest over ``group`` (the ranks holding the rest of that axis)."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax.clamp_min(1e-30) * INV_127


def _quantize(x: torch.Tensor, axis: int, group=None):
    """``x -> (int8 codes, fp32 scales)``: an IEEE division by the scale,
    ``round`` half to even, clip to ±127."""
    x = x.float()
    scale = _symmetric_scales(x, axis, group)
    q = torch.round(x / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _psum(y: torch.Tensor, group) -> torch.Tensor:
    """``y`` (a fresh fp32 partial product) summed over ``group``."""
    if group is not None:
        dist.all_reduce(y, group=group)
    return y
def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``[m, k] @ [k, n]`` -> exact int32 ``[m, n]``.

    ``torch._int_mm`` on the card takes a row-major lhs with more than 16
    rows and k, n multiples of 8; other shapes are zero-padded up to
    that, which leaves every sum unchanged. The rhs goes in column-major
    (a copy only when it is not): with a row-major rhs cuBLASLt falls back
    to a kernel about 5-7x slower on the H100 (chip_smoke.py's int8
    phase times both)."""
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k or pad_n:
        a = F.pad(a, (0, pad_k, 0, pad_m))
        b = F.pad(b, (0, pad_n, 0, pad_k))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


def _int8_matmul_raw(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """``[m, k] @ [k, n]`` with both operands dynamically int8-quantized;
    fp32 out, dequantized as ``acc * sx * sw`` in that order. With
    ``group``, this rank's part of a contraction split over it: the
    scales are the whole contraction's, the product this part's."""
    qx, sx = _quantize(x, axis=1, group=group)     # [m, k], [m, 1]
    qw, sw = _quantize(w, axis=0, group=group)     # [k, n], [1, n]
    return _int_mm(qx, qw).float() * sx * sw


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sp):
        ctx.save_for_backward(x, w)
        ctx.split = sp
        k = x.shape[-1]
        y = _psum(_int8_matmul_raw(x.reshape(-1, k), w, sp.k[0]), sp.k[0])
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        sp = ctx.split
        k, n = w.shape
        g2 = g.reshape(-1, n).float()
        x2 = x.reshape(-1, k).float()
        # dx = g @ w.T ; dw = x.T @ g, each quantized like the forward.
        dx = _psum(_int8_matmul_raw(g2, w.float().T, sp.n[0]), sp.n[0])
        dw = _int8_matmul_raw(x2.T, g2, sp.rows[0])
        return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype), None


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                sp: Optional[Split] = None) -> torch.Tensor:
    """Quantized ``x @ w`` with STE gradients, both gradient products
    int8 too. x: ``[..., k]`` (leading dims flattened), w: ``[k, n]``;
    fp32 out; dx in x's dtype, dw in w's. ``sp`` (default
    :func:`split`: the rows split over the ambient mesh's data axes)
    says which groups hold the rest of the logical product."""
    return _Int8Matmul.apply(x, w, split() if sp is None else sp)


def maybe_quant_dot(x: torch.Tensor, w: torch.Tensor, quant: str,
                    sp: Optional[Split] = None) -> torch.Tensor:
    """The transformer's linear-projection primitive, in x's dtype:

    - ``"int8"``: the composed path above;
    - ``"int8_fused"``: the fused kernel (``ops/quant_fused.py``) where
      ``fusable`` admits the logical shape (m, k and n times the sizes
      of the groups that split them, as the JAX package judges the
      global arrays), the composed path otherwise;
    - ``""``: the plain product of the local operands (Megatron's f and
      g around it are the caller's: :class:`Projections`).

    ``sp``: as :func:`int8_matmul`'s.
    """
    if quant not in ("int8", "int8_fused"):
        return x @ w
    sp = split() if sp is None else sp
    if quant == "int8_fused":
        from kubeflow_controller_tpu_torch.ops.quant_fused import (
            fusable, fused_int8_matmul,
        )

        m = x.numel() // x.shape[-1]
        if fusable(m * sp.rows[1], x.shape[-1] * sp.k[1], w.shape[-1] * sp.n[1]):
            return fused_int8_matmul(x, w, sp).to(x.dtype)
    return int8_matmul(x, w, sp).to(x.dtype)


class Projections:
    """A layer's linear projections in ``quant``'s arithmetic and
    ``dtype``, over the ambient mesh's tp axis as Megatron's column- and
    row-parallel layers, the tokens split over the mesh axes ``rows``.

    - :meth:`enter` starts a column-parallel region on an input every
      tp rank holds whole: Megatron's f (``tp_copy``) for the plain
      product, whose backward sums the input's gradient over tp once for
      every projection that reads it; an int8 product sums its own dx
      over tp, in fp32 before its cast, so the input enters as it is.
    - :meth:`column`: ``w``'s columns are this rank's tp shard.
    - :meth:`row`: ``w``'s rows (the contraction) are; the output is
      summed over tp (g, ``tp_sum``, for the plain product; the int8
      product sums its fp32 partials itself).
    """

    def __init__(self, quant: str, dtype: torch.dtype,
                 rows: Sequence[str] = DATA_AXES):
        self.quant, self.dtype = quant, dtype
        self.int8 = quant in ("int8", "int8_fused")
        self._column = split(rows, n=("tp",))
        self._row = split(rows, k=("tp",))

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.int8 else tp_copy(h)

    def column(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return maybe_quant_dot(a, w.to(self.dtype), self.quant, self._column)

    def row(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = maybe_quant_dot(a, w.to(self.dtype), self.quant, self._row)
        return y if self.int8 else tp_sum(y)
