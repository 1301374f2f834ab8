"""Fused dynamic-int8 matmul: the lhs quantized on the card by a kernel.

Counterpart of ``kubeflow_controller_tpu/ops/quant_pallas.py``.
:func:`fused_int8_matmul_2d` computes ``[m, k] @ [k, n] -> bf16``: the
lhs is cast to bf16 and quantized per row by a prepass kernel, once
(``quantize_rows_kernel``); the rhs is cast to fp32 and quantized per
column outside the kernels, in plain PyTorch, as the JAX package
quantizes it with XLA ops; a pure int8 GEMM kernel sums the products in
int32, dequantizes by the row and column scales in fp32 and rounds to
bf16 once (``int8_gemm_kernel``; both in ``csrc/int8_matmul.cu``,
together they replace ``_kernel_v2``). On CUDA tensors the kernels run,
on CPU tensors their plain versions (:func:`quantize_rows_plain`,
:func:`fused_int8_matmul_2d_plain`); any other device, or a shape
:func:`fusable` refuses, raises.

The GEMM takes both operands contiguous along the contraction: the lhs
codes ``[m, k]`` and the rhs codes as ``[n, k]`` (the int8 tensor cores
read no transposed operand). :func:`rhs_codes` produces them: the same
codes as ``_quantize(b, axis=0)``, transposed. For the forward that is
one int8 copy; for dx, whose rhs is ``w.T``, it is ``w``'s own layout
and no copy.

:func:`fused_int8_matmul` is the differentiable form (STE gradients).
Its forward launches the kernels; in the backward, dx runs them on
``(g, w.T)`` when ``fusable`` admits that orientation and the composed
int8 path (``ops/quant.py``) otherwise, and dw always runs the composed
int8 path (its contraction is the token axis). The JAX package's
docstring says dw runs unquantized; its backward runs the composed int8
path, and so does this one.

``_pick_blocks`` and ``fusable`` are the JAX package's, copied: they
decide which calls take the kernel, so that both packages route every
projection the same way. The Hopper kernel's tiles are its own.

``LAUNCHES`` counts kernel launches by kernel; a wrapper adds one where
it launches and nowhere else.
"""

from __future__ import annotations

from typing import Dict

import torch

from kubeflow_controller_tpu_torch.ops.quant import (
    _int8_matmul_raw, _int_mm, _quantize,
)

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"int8_quantize_rows": 0, "int8_matmul": 0}

#: The GEMM kernel's output tile and k step (``csrc/int8_matmul.cu``).
TILE_M, TILE_N, TILE_K = 128, 128, 128


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


def quantize_rows_plain(a: torch.Tensor):
    """The prepass kernel's arithmetic: ``a [m, k]`` -> ``(codes int8
    [m, k], scales fp32 [m, 1])``, each row by its own abs-max."""
    return _quantize(a, axis=1)


def rhs_codes(b: torch.Tensor):
    """``b [k, n]`` quantized per column, as the GEMM kernel reads it:
    ``(codes int8 [n, k] contiguous, scales fp32 [1, n])``. The codes
    are ``_quantize(b, axis=0)``'s, transposed; when ``b`` is the
    transposed view of a contiguous ``[n, k]`` tensor nothing is
    copied."""
    qb, sb = _quantize(b.float(), axis=0)
    return qb.t().contiguous(), sb.contiguous()


def _fused_plain(a: torch.Tensor, qbt: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic: bf16 ``a [m, k]`` quantized per row, the
    exact int32 product with the rhs codes ``qbt [n, k]``, ``acc * sa *
    sb`` in fp32, rounded to bf16."""
    qa, sa = quantize_rows_plain(a)
    return (_int_mm(qa, qbt.t()).float() * sa * sb).to(torch.bfloat16)


def fused_int8_matmul_2d_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`fused_int8_matmul_2d` in plain PyTorch, any shape."""
    qbt, sb = rhs_codes(b)
    return _fused_plain(a.to(torch.bfloat16), qbt, sb)


def _check_operands(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous, 16-byte "
                             "aligned and on one device")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def quantize_rows(a: torch.Tensor):
    """``a`` bf16 ``[m, k]`` -> ``(codes int8 [m, k], scales fp32 [m,
    1])``: the prepass kernel on a CUDA tensor (one launch),
    :func:`quantize_rows_plain` on a CPU tensor."""
    if a.device.type == "cpu":
        return quantize_rows_plain(a)
    from kubeflow_controller_tpu_torch.ops import _build

    m, k = a.shape
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 or k % 16:
        raise ValueError("int8_quantize_rows takes a bfloat16 cuda tensor "
                         f"with k a multiple of 16 (got {a.dtype}, {a.device}, k={k})")
    _check_operands("int8_quantize_rows", a)
    qa = torch.empty((m, k), dtype=torch.int8, device=a.device)
    sa = torch.empty((m, 1), dtype=torch.float32, device=a.device)
    rc = _build.load().kfc_int8_quantize_rows(
        a.data_ptr(), qa.data_ptr(), sa.data_ptr(), m, k,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "int8_quantize_rows")
    LAUNCHES["int8_quantize_rows"] += 1
    return qa, sa


def _launch(a: torch.Tensor, qbt: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """The two kernels on ``a`` bf16 ``[m, k]``, the rhs codes ``qbt``
    int8 ``[n, k]`` and ``sb`` fp32 ``[1, n]``, all contiguous on one
    card: the rows' codes and scales go through scratch to the GEMM."""
    from kubeflow_controller_tpu_torch.ops import _build

    m, k = a.shape
    n = qbt.shape[0]
    if m % TILE_M or n % TILE_N or k % TILE_K or qbt.shape[1] != k:
        raise ValueError(f"int8_matmul: [{m}, {k}] @ [{k}, {n}] is not tiled by "
                         f"({TILE_M}, {TILE_N}, {TILE_K})")
    _check_operands("int8_matmul", a, qbt, sb)
    qa, sa = quantize_rows(a)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    rc = _build.load().kfc_int8_matmul(
        qa.data_ptr(), qbt.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        out.data_ptr(), m, k, n,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    return out


def fused_int8_matmul_2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[m, k] @ [k, n] -> bf16`` with dynamic int8 quantization: the
    kernels on CUDA tensors, the plain version on CPU tensors. Raises on
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
    qbt, sb = rhs_codes(b)
    return _launch(a.to(torch.bfloat16).contiguous(), qbt, sb)


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
