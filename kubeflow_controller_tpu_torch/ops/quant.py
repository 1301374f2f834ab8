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

The JAX package's ``INT8_SAVE_NAMES`` (names its remat policy saves) has
no counterpart: the port's per-layer checkpoint saves nothing inside the
layer and recomputes the codes in the backward's re-forward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The reference divides the abs-max by 127.0 (``quant.py:45``), and the
# JAX package trains under ``jax.jit``, where XLA rewrites a division by
# a constant into a multiplication by its fp32 reciprocal: one ulp apart
# from a true division for some rows. The port multiplies by the same
# fp32 constant, so its scales and codes are the jitted reference's bit
# for bit.
INV_127 = float(np.float32(1) / np.float32(127))


def _symmetric_scales(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-slice symmetric fp32 scale so ``x / scale`` fits [-127, 127];
    ``axis`` is the contraction axis being reduced away."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    return amax.clamp_min(1e-30) * INV_127


def _quantize(x: torch.Tensor, axis: int):
    """``x -> (int8 codes, fp32 scales)``: an IEEE division by the scale,
    ``round`` half to even, clip to ±127."""
    x = x.float()
    scale = _symmetric_scales(x, axis)
    q = torch.round(x / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


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


def _int8_matmul_raw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[m, k] @ [k, n]`` with both operands dynamically int8-quantized;
    fp32 out, dequantized as ``acc * sx * sw`` in that order."""
    qx, sx = _quantize(x, axis=1)     # [m, k], [m, 1]
    qw, sw = _quantize(w, axis=0)     # [k, n], [1, n]
    return _int_mm(qx, qw).float() * sx * sw


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        k = x.shape[-1]
        y = _int8_matmul_raw(x.reshape(-1, k), w)
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, n = w.shape
        g2 = g.reshape(-1, n).float()
        x2 = x.reshape(-1, k).float()
        # dx = g @ w.T ; dw = x.T @ g, each quantized like the forward.
        dx = _int8_matmul_raw(g2, w.float().T)
        dw = _int8_matmul_raw(x2.T, g2)
        return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantized ``x @ w`` with STE gradients, both gradient products
    int8 too. x: ``[..., k]`` (leading dims flattened), w: ``[k, n]``;
    fp32 out; dx in x's dtype, dw in w's."""
    return _Int8Matmul.apply(x, w)


def maybe_quant_dot(x: torch.Tensor, w: torch.Tensor, quant: str) -> torch.Tensor:
    """The transformer's linear-projection primitive, in x's dtype:

    - ``"int8"``: the composed path above;
    - ``"int8_fused"``: the fused kernel (``ops/quant_fused.py``) where
      ``fusable`` admits the shape, the composed path otherwise;
    - ``""``: the plain product.
    """
    if quant == "int8_fused":
        from kubeflow_controller_tpu_torch.ops.quant_fused import (
            fusable, fused_int8_matmul,
        )

        m = x.numel() // x.shape[-1]
        if fusable(m, x.shape[-1], w.shape[-1]):
            return fused_int8_matmul(x, w).to(x.dtype)
        return int8_matmul(x, w).to(x.dtype)
    if quant == "int8":
        return int8_matmul(x, w).to(x.dtype)
    return x @ w
