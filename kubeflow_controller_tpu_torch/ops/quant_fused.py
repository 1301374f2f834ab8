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

Over a mesh (``ops/quant.py``'s :class:`~ops.quant.Split`), a product
whose contraction is split over a group (a row-parallel projection's
forward, a column-parallel one's dx over tp) takes the kernels' second
entry: the caller computes the row scales of the whole contraction (the
abs-max all-reduced with MAX over the group) and the prepass only
quantizes with them (``quantize_rows_scaled``; its plain version is
:func:`quantize_rows_plain` given the scales), the rhs codes take the
whole contraction's column scales the same way, and the GEMM writes its
dequantized partial product in fp32 (``int8_matmul_f32``), which is
summed over the group before the one rounding to bf16: the global
product's value, as the JAX package's kernel computes it on the gathered
operands under GSPMD, with no bf16 rounding a rank.

``_pick_blocks`` and ``fusable`` are the JAX package's, copied: they
decide which calls take the kernel, so that both packages route every
projection the same way; the caller judges the logical shapes (each
dimension times the size of the group that splits it). The Hopper
kernel's tiles are its own.

``LAUNCHES`` counts kernel launches by kernel entry; a wrapper adds one
where it launches and nowhere else.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from kubeflow_controller_tpu_torch.ops.quant import (
    Split, _int8_matmul_raw, _int_mm, _psum, _quantize, _symmetric_scales, split,
)

#: Kernel launches since the last :func:`reset_launches`: the row
#: prepass and the GEMM, and their entries for a split contraction
#: (scales from the caller; fp32 partials out).
LAUNCHES: Dict[str, int] = {"int8_quantize_rows": 0, "int8_matmul": 0,
                            "int8_quantize_rows_scaled": 0, "int8_matmul_f32": 0}

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


def quantize_rows_plain(a: torch.Tensor, scales: Optional[torch.Tensor] = None):
    """The prepass kernel's arithmetic: ``a [m, k]`` -> ``(codes int8
    [m, k], scales fp32 [m, 1])``, each row by its own abs-max, or, with
    ``scales`` (fp32 ``[m, 1]``, the scales-in entry's), by those."""
    if scales is None:
        return _quantize(a, axis=1)
    q = torch.round(a.float() / scales).clamp_(-127, 127).to(torch.int8)
    return q, scales


def rhs_codes(b: torch.Tensor, group=None):
    """``b [k, n]`` quantized per column, as the GEMM kernel reads it:
    ``(codes int8 [n, k] contiguous, scales fp32 [1, n])``. The codes
    are ``_quantize(b, axis=0, group)``'s, transposed; when ``b`` is the
    transposed view of a contiguous ``[n, k]`` tensor nothing is
    copied."""
    qb, sb = _quantize(b.float(), axis=0, group=group)
    return qb.t().contiguous(), sb.contiguous()


def _fused_plain(a: torch.Tensor, qbt: torch.Tensor, sb: torch.Tensor,
                 sa: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' arithmetic: bf16 ``a [m, k]`` quantized per row (by
    its own abs-max, or by the scales ``sa``), the exact int32 product
    with the rhs codes ``qbt [n, k]``, ``acc * sa * sb`` in fp32, rounded
    to bf16 (or, given ``sa``, left in fp32: the split entries)."""
    qa, sa_used = quantize_rows_plain(a, sa)
    y = _int_mm(qa, qbt.t()).float() * sa_used * sb
    return y if sa is not None else y.to(torch.bfloat16)


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
    _check_rows("int8_quantize_rows", a)
    qa = torch.empty(a.shape, dtype=torch.int8, device=a.device)
    sa = torch.empty((a.shape[0], 1), dtype=torch.float32, device=a.device)
    from kubeflow_controller_tpu_torch.ops import _build

    rc = _build.load().kfc_int8_quantize_rows(
        a.data_ptr(), qa.data_ptr(), sa.data_ptr(), a.shape[0], a.shape[1],
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "int8_quantize_rows")
    LAUNCHES["int8_quantize_rows"] += 1
    return qa, sa


def quantize_rows_scaled(a: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """``a`` bf16 ``[m, k]`` quantized by the caller's row scales ``sa``
    (fp32 ``[m, 1]``: a split contraction's, the abs-max all-reduced over
    its group) -> codes int8 ``[m, k]``: the prepass kernel's scales-in
    entry on a CUDA tensor (one launch), :func:`quantize_rows_plain` on a
    CPU tensor."""
    if a.device.type == "cpu":
        return quantize_rows_plain(a, sa)[0]
    _check_rows("int8_quantize_rows_scaled", a)
    if sa.dtype != torch.float32 or tuple(sa.shape) != (a.shape[0], 1):
        raise ValueError(f"int8_quantize_rows_scaled: scales {sa.dtype} "
                         f"{tuple(sa.shape)} for {tuple(a.shape)} rows")
    _check_operands("int8_quantize_rows_scaled", a, sa)
    qa = torch.empty(a.shape, dtype=torch.int8, device=a.device)
    from kubeflow_controller_tpu_torch.ops import _build

    rc = _build.load().kfc_int8_quantize_rows_scaled(
        a.data_ptr(), sa.data_ptr(), qa.data_ptr(), a.shape[0], a.shape[1],
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "int8_quantize_rows_scaled")
    LAUNCHES["int8_quantize_rows_scaled"] += 1
    return qa


def _check_rows(name: str, a: torch.Tensor) -> None:
    k = a.shape[1]
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 or k % 16:
        raise ValueError(f"{name} takes a bfloat16 cuda tensor with k a "
                         f"multiple of 16 (got {a.dtype}, {a.device}, k={k})")
    _check_operands(name, a)


def _launch(a: torch.Tensor, qbt: torch.Tensor, sb: torch.Tensor,
            sa: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The two kernels on ``a`` bf16 ``[m, k]``, the rhs codes ``qbt``
    int8 ``[n, k]`` and ``sb`` fp32 ``[1, n]``, all contiguous on one
    card: the rows' codes and scales go through scratch to the GEMM,
    which rounds its output to bf16. With ``sa`` (fp32 ``[m, 1]``) the
    split entries: the prepass quantizes by those scales and the GEMM
    writes its fp32 product."""
    from kubeflow_controller_tpu_torch.ops import _build

    m, k = a.shape
    n = qbt.shape[0]
    if m % TILE_M or n % TILE_N or k % TILE_K or qbt.shape[1] != k:
        raise ValueError(f"int8_matmul: [{m}, {k}] @ [{k}, {n}] is not tiled by "
                         f"({TILE_M}, {TILE_N}, {TILE_K})")
    _check_operands("int8_matmul", a, qbt, sb)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if sa is None:
        qa, sa = quantize_rows(a)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
        rc = _build.load().kfc_int8_matmul(
            qa.data_ptr(), qbt.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            out.data_ptr(), m, k, n, stream)
        _raise_on(rc, "int8_matmul")
        LAUNCHES["int8_matmul"] += 1
        return out
    qa = quantize_rows_scaled(a, sa)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = _build.load().kfc_int8_matmul_f32(
        qa.data_ptr(), qbt.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        out.data_ptr(), m, k, n, stream)
    _raise_on(rc, "int8_matmul_f32")
    LAUNCHES["int8_matmul_f32"] += 1
    return out


def _on_device(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise RuntimeError(
            "int8_matmul runs its CUDA kernel on cuda tensors and its plain "
            f"version on cpu tensors (got {a.device} and {b.device})")


def _fused_2d(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """``[m, k] @ [k, n] -> bf16``: the kernels on CUDA tensors, the plain
    version on CPU tensors, no shape gate. With ``group``, this rank's
    part of a contraction split over it: the whole contraction's row and
    column scales, the fp32 partials summed over the group, then one
    rounding to bf16."""
    a = a.to(torch.bfloat16)
    cpu = a.device.type == "cpu"
    if not cpu:
        _on_device(a, b)
    if group is None:
        if cpu:
            return fused_int8_matmul_2d_plain(a, b)
        qbt, sb = rhs_codes(b)
        return _launch(a.contiguous(), qbt, sb)
    sa = _symmetric_scales(a.float(), 1, group)
    qbt, sb = rhs_codes(b, group)
    y = _fused_plain(a, qbt, sb, sa) if cpu else _launch(a.contiguous(), qbt, sb, sa)
    return _psum(y, group).to(torch.bfloat16)


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
    return _fused_2d(a, b)


class _FusedInt8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sp):
        ctx.save_for_backward(x, w)
        ctx.split = sp
        k = x.shape[-1]
        y = _fused_2d(x.reshape(-1, k), w, sp.k[0])
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        sp = ctx.split
        k, n = w.shape
        g2 = g.reshape(-1, n)
        x2 = x.reshape(-1, k)
        # dx contracts over n: its own logical shape decides its route.
        if fusable(g2.shape[0] * sp.rows[1], n * sp.n[1], k * sp.k[1]):
            dx = _fused_2d(g2, w.float().T, sp.n[0])
        else:
            dx = _psum(_int8_matmul_raw(g2.float(), w.float().T, sp.n[0]), sp.n[0])
        dw = _int8_matmul_raw(x2.float().T, g2, sp.rows[0])
        return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype), None


def fused_int8_matmul(x: torch.Tensor, w: torch.Tensor,
                      sp: Optional[Split] = None) -> torch.Tensor:
    """Quantized ``x @ w`` (STE gradients) through the fused kernel. x:
    ``[..., k]`` (leading dims flattened), w: ``[k, n]``; bf16 out, dx in
    x's dtype, dw in w's. ``sp``: as ``ops.quant.int8_matmul``'s (the
    caller has judged the logical shape ``fusable``)."""
    return _FusedInt8Matmul.apply(x, w, split() if sp is None else sp)
