"""Fused dynamic-int8 matmul: the lhs quantized inside the kernel.

Counterpart of ``kubeflow_controller_tpu/ops/quant_pallas.py``.
:func:`fused_int8_matmul_2d` computes ``[m, k] @ [k, n] -> bf16``: the
lhs is cast to bf16 and quantized per row inside the kernel
(``csrc/int8_matmul.cu``, which replaces ``_kernel_v2``); the rhs is
cast to fp32 and quantized per column outside it, in plain PyTorch, as
the JAX package quantizes it with XLA ops; the int32 sum is dequantized
by the row and column scales in fp32 and rounded to bf16 once. On CUDA
tensors the kernel runs, on CPU tensors its plain version
(:func:`fused_int8_matmul_2d_plain`); any other device, or a shape
:func:`fusable` refuses, raises.

:func:`fused_int8_matmul` is the differentiable form (STE gradients).
Its forward launches the kernel; in the backward, dx runs the kernel on
``(g, w.T)`` when ``fusable`` admits that orientation and the composed
int8 path (``ops/quant.py``) otherwise, and dw always runs the composed
int8 path (its contraction is the token axis). The JAX package's
docstring says dw runs unquantized; its backward runs the composed int8
path, and so does this one.

``_pick_blocks`` and ``fusable`` are the JAX package's, copied: they
decide which calls take the kernel, so that both packages route every
projection the same way. The Hopper kernel's tiles are its own.

``LAUNCHES`` counts kernel launches; the wrapper adds one where it
launches and nowhere else.
"""

from __future__ import annotations

from typing import Dict

import torch

from kubeflow_controller_tpu_torch.ops.quant import (
    _int8_matmul_raw, _int_mm, _quantize,
)

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"int8_matmul": 0}

#: The kernel's output tile and k step (``csrc/int8_matmul.cu``).
TILE_M, TILE_N, TILE_K = 128, 128, 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _pick_blocks(m: int, k: int, n: int):
    """The JAX package's ``(bm, bn)``: the largest blocks that divide
    ``(m, n)`` under its VMEM budget for this ``k``."""
    def best(size, want):
        want = min(want, size)
        while size % want:
            want //= 2
        return max(want, 1)

    if k <= 1024:
        bm_want, bn_want = 512, 1024
    elif k <= 2048:
        bm_want, bn_want = 256, 1024
    else:
        bm_want, bn_want = 128, 512
    return best(m, bm_want), best(n, bn_want)


def fusable(m: int, k: int, n: int) -> bool:
    """The shapes the JAX package sends to its kernel: k at most 4096 and
    a multiple of 128, and both output dims tiled by 128-multiple
    blocks."""
    if k > 4096 or k % 128:
        return False
    bm, bn = _pick_blocks(m, k, n)
    return bm % 128 == 0 and bn % 128 == 0


def _fused_plain(a: torch.Tensor, qb: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic: bf16 ``a [m, k]`` quantized per row, the
    exact int32 product with ``qb [k, n]``, ``acc * sa * sb`` in fp32,
    rounded to bf16."""
    qa, sa = _quantize(a, axis=1)
    return (_int_mm(qa, qb).float() * sa * sb).to(torch.bfloat16)


def fused_int8_matmul_2d_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`fused_int8_matmul_2d` in plain PyTorch, any shape."""
    qb, sb = _quantize(b.float(), axis=0)
    return _fused_plain(a.to(torch.bfloat16), qb, sb)


def _launch(a: torch.Tensor, qb: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on ``a`` bf16 ``[m, k]``, ``qb`` int8
    ``[k, n]`` and ``sb`` fp32 ``[1, n]``, all contiguous on one card."""
    from kubeflow_controller_tpu_torch.ops import _build

    m, k = a.shape
    n = qb.shape[1]
    if m % TILE_M or n % TILE_N or k % TILE_K:
        raise ValueError(f"int8_matmul: [{m}, {k}] @ [{k}, {n}] is not tiled by "
                         f"({TILE_M}, {TILE_N}, {TILE_K})")
    for t in (a, qb, sb):
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int8_matmul: operands must be contiguous, 16-byte "
                             "aligned and on one device")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    rc = _build.load().kfc_int8_matmul(
        a.data_ptr(), qb.data_ptr(), sb.data_ptr(), out.data_ptr(), m, k, n,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc}")
    LAUNCHES["int8_matmul"] += 1
    return out


def fused_int8_matmul_2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[m, k] @ [k, n] -> bf16`` with dynamic int8 quantization: the
    kernel on CUDA tensors, the plain version on CPU tensors. Raises on
    any other device and on a shape :func:`fusable` refuses."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if not fusable(m, k, n):
        raise ValueError(f"int8_matmul: [{m}, {k}] @ [{k}, {n}] is not fusable")
    if a.device.type == "cpu":
        return fused_int8_matmul_2d_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise RuntimeError(
            "int8_matmul runs its CUDA kernel on cuda tensors and its plain "
            f"version on cpu tensors (got {a.device} and {b.device})")
    qb, sb = _quantize(b.float(), axis=0)
    return _launch(a.to(torch.bfloat16).contiguous(), qb.contiguous(),
                   sb.contiguous())


class _FusedInt8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        k = x.shape[-1]
        y = fused_int8_matmul_2d(x.reshape(-1, k), w)
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, n = w.shape
        g2 = g.reshape(-1, n)
        x2 = x.reshape(-1, k)
        # dx contracts over n: its own shape decides its route.
        if fusable(g2.shape[0], n, k):
            dx = fused_int8_matmul_2d(g2, w.float().T)
        else:
            dx = _int8_matmul_raw(g2.float(), w.float().T)
        dw = _int8_matmul_raw(x2.float().T, g2)
        return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


def fused_int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantized ``x @ w`` (STE gradients) through the fused kernel. x:
    ``[..., k]`` (leading dims flattened), w: ``[k, n]``; bf16 out, dx in
    x's dtype, dw in w's."""
    return _FusedInt8Matmul.apply(x, w)
