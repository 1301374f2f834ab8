"""Flash attention for training: the forward and its three backward kernels.

Counterpart of ``kubeflow_controller_tpu/ops/flash_attention.py``. Four
entry points, each a hand-written CUDA kernel (``csrc/flash_attention.cu``)
on CUDA tensors and its plain PyTorch version on CPU tensors:

* :func:`flash_fwd` — ``softmax(QKᵀ/√d + mask)·V`` and the row
  log-sum-exp ``lse [B, H, S]`` (replaces ``_fwd_kernel``). At head_dim
  64 and 128 (``WGMMA_HEAD_DIMS``) it is two launches: :func:`rope_rotate`
  rotates Q and K once into scratch (only with rope tables), then the
  forward kernel on plain bf16 tiles; at every other head_dim one kernel
  that rotates both on load;
* :func:`flash_bwd_fused` — dq, dk and dv from one score recompute
  (replaces ``_bwd_fused_kernel``). At head_dim 64 and 128 four launches:
  :func:`rope_rotate` (with rope tables), :func:`flash_bwd_prep` (delta
  and the zeroed dq scratch), the warpgroup kernel on plain bf16 tiles,
  and :func:`flash_bwd_post` (dq counter-rotated and cast); at every
  other head_dim one kernel that rotates on load;
* :func:`flash_bwd_dkdv` — the two-pass backward's first pass, dk and dv
  (replaces ``_bwd_dkdv_kernel``);
* :func:`flash_bwd_dq` — its second pass, dq (replaces
  ``_bwd_dq_kernel``). At head_dim 64 and 128 each of the two is
  :func:`rope_rotate` (with rope tables) and a warpgroup kernel on plain
  bf16 tiles that counter-rotates its output (dk, resp. dq) in its
  epilogue; at every other head_dim one kernel that rotates on load.
  :func:`flash_bwd_two_pass` runs both passes as the backward does: one
  rope prepass for the two, delta from :func:`flash_bwd_prep` (which then
  writes no dq scratch).

Layouts are the public ``[B, S, H, D]`` ("BSHD") of :func:`flash_mha`
throughout: q and o ``[B, S, H, D]``, k and v ``[B, S, KVH, D]`` (query
head ``h`` reads KV head ``h // (H // KVH)``), segment ids ``[B, S]``
int, rope tables ``(C, S)`` ``[B, S, D]`` fp32 from
:func:`rope_full_tables`. The mask is causal and/or by segment id (row
``i`` sees column ``j`` iff ``seg[i] == seg[j]``); masked scores take the
finite ``NEG_INF`` as the TPU kernel does. With rope tables, q and k are
rotated in fp32 and cast back to their dtype before the products, and
dq and dk are counter-rotated (``-S``) in fp32 before their cast.

:func:`flash_mha` wraps them in a ``torch.autograd.Function``. Its
backward takes the fused kernel when the JAX package's block rule gives
one tile (``S // block == 1`` for both blocks, ``flash_attention.py:1081``)
and the two-pass kernels (:func:`flash_bwd_two_pass`) otherwise, so the
same ``S`` and blocks take the same route in both packages. The blocks choose nothing else here: Hopper
tiles are the kernels' own.

Each kernel entry is an operator (``torch.ops.kfc.rope_rotate``,
``flash_fwd``, ``flash_bwd_prep``, ``flash_bwd_fused``,
``flash_bwd_post``, ``flash_bwd_kv``, ``flash_bwd_dq``;
``ops/_library.py``): the dispatcher launches the kernel on CUDA
tensors, runs its plain version on CPU tensors and, on fake tensors,
allocates what the kernel's wrapper allocates. The entry points compose
the operators the same way on every device, so the CPU runs the plain
version of each kernel in the kernels' order (bit for bit the whole-row
plain versions above). ``LAUNCHES`` counts kernel launches per kernel;
each operator's CUDA implementation adds one where it launches and
nowhere else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from kubeflow_controller_tpu_torch.ops._library import define

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024

RopeTables = Optional[Tuple[torch.Tensor, torch.Tensor]]

#: Kernel launches since the last :func:`reset_launches`, by kernel.
LAUNCHES: Dict[str, int] = {
    "rope_rotate": 0, "flash_fwd": 0, "flash_bwd_prep": 0,
    "flash_bwd_fused": 0, "flash_bwd_post": 0, "flash_bwd_dkdv": 0,
    "flash_bwd_dq": 0,
}

#: The head dims the warpgroup forward and backward kernels are built
#: for; there Q and K are rotated by the prepass. ``kfc_flash_fwd``,
#: ``kfc_flash_bwd_kv`` and ``kfc_flash_bwd_dq`` pick their kernel by the
#: same rule.
WGMMA_HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _choose_block(s: int, requested: int, lane_aligned: bool = False) -> int:
    """Largest block <= requested that tiles the sequence exactly — the
    JAX package's rule, kept so that the same ``S`` and blocks choose the
    same backward here (and are refused where the JAX package refuses
    them)."""
    requested = min(requested, s)
    quantum = 128 if lane_aligned else 8
    if lane_aligned and requested < quantum:
        requested = min(quantum, s)
    if s % requested == 0 and (requested % quantum == 0 or requested == s):
        return requested
    for b in range(requested, quantum - 1, -1):
        if s % b == 0 and b % quantum == 0:
            return b
    if lane_aligned and s % 8 == 0 and s <= requested:
        return s
    raise ValueError(
        f"flash attention: seq_len {s} has no block divisor that is a "
        f"multiple of {quantum}; pad the sequence or use the XLA "
        "attention path"
    )


def single_tile(s: int, block_q: int, block_k: int, has_segments: bool) -> bool:
    """True when the JAX package runs the fused single-tile backward."""
    bq = _choose_block(s, block_q, lane_aligned=has_segments)
    bk = _choose_block(s, block_k, lane_aligned=has_segments)
    return s // bq == 1 and s // bk == 1


def rope_full_tables(
    positions: torch.Tensor, d: int, theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions ``[B, S]`` int -> ``(C, S)`` ``[B, S, d]`` fp32:
    ``C = [cos | cos]``, ``S = [-sin | sin]`` with angles
    ``pos * theta^(-2i/d)`` (halves convention), so that
    ``rot(x) = x * C + roll(x, d/2) * S``."""
    freqs = theta ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d)
    ang = positions[..., None].float() * freqs
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([c, c], -1), torch.cat([-s, s], -1)


def _rope_rot(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x [B, S, H, D]`` rotated by tables ``[B, S, D]`` in fp32, cast
    back to ``x.dtype``. Passing ``-s`` applies the inverse (transpose)."""
    x32 = x.float()
    rolled = torch.roll(x32, x.shape[-1] // 2, dims=-1)
    return (x32 * c[:, :, None] + rolled * s[:, :, None]).to(x.dtype)


# -- plain PyTorch versions ---------------------------------------------------

def _visible(s: int, segment_ids, causal: bool, device) -> Optional[torch.Tensor]:
    """Boolean ``[B or 1, 1, S, S]`` mask (rows = queries), or None."""
    mask = None
    if causal:
        idx = torch.arange(s, device=device)
        mask = (idx[:, None] >= idx[None, :])[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        same = (seg[:, :, None] == seg[:, None, :])[:, None]
        mask = same if mask is None else mask & same
    return mask


def _rotated(q, k, rope_tables):
    if rope_tables is None:
        return q, k
    c, s = rope_tables
    return _rope_rot(q, c, s), _rope_rot(k, c, s)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Grouped-query attention: ``[B, S, KVH, D]`` -> ``[B, S, KVH *
    n_rep, D]``, query head ``h`` reading KV head ``h // n_rep``."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _bhsd(x: torch.Tensor, rep: int = 1) -> torch.Tensor:
    """BSHD -> BHSD, KV heads repeated ``rep`` times for GQA."""
    return _repeat_kv(x, rep).transpose(1, 2)


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    rope_tables: RopeTables = None, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic over whole rows: fp32 scores of
    the (rotated) inputs, ``NEG_INF`` masking, probabilities cast to
    ``v.dtype`` before the value product, ``l`` floored at 1e-30. Returns
    ``(o [B, S, H, D] in q.dtype, lse [B, H, S] fp32)``."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    qr, kr = _rotated(q, k, rope_tables)
    sc = (_bhsd(qr).float() @ _bhsd(kr, rep).float().transpose(-1, -2)) * d ** -0.5
    mask = _visible(s, segment_ids, causal, q.device)
    if mask is not None:
        sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = p.to(v.dtype).float() @ _bhsd(v, rep).float()
    o = (acc / l_safe).to(q.dtype).transpose(1, 2).contiguous()
    return o, (m + torch.log(l_safe))[..., 0]


def _bwd_terms(q, k, v, do, lse, delta, segment_ids, rope_tables, causal):
    """Shared score recompute of the backward kernels: the rotated q and
    (repeated) k, p = exp(s - lse), and ds = p * (do·vᵀ - delta) * scale,
    all ``[B, H, S, S]`` fp32 (rows = queries)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    scale = d ** -0.5
    qr, kr = _rotated(q, k, rope_tables)
    qh, kh = _bhsd(qr), _bhsd(kr, rep)
    sc = (qh.float() @ kh.float().transpose(-1, -2)) * scale
    mask = _visible(s, segment_ids, causal, q.device)
    if mask is not None:
        sc = torch.where(mask, sc, NEG_INF)
    p = torch.exp(sc - lse[..., None])
    dp = _bhsd(do).float() @ _bhsd(v, rep).float().transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    return qh, kh, p, ds


def _fold(x: torch.Tensor, kv_h: int) -> torch.Tensor:
    """fp32 ``[B, H, S, D]`` per query head -> ``[B, S, KVH, D]`` summed
    over each KV head's query-head group."""
    b, h, s, d = x.shape
    return x.reshape(b, kv_h, h // kv_h, s, d).sum(2).transpose(1, 2)


def _counter_rotate(x_bhsd: torch.Tensor, rope_tables) -> torch.Tensor:
    """fp32 ``[B, H, S, D]`` gradient in rotation space -> the
    un-rotated input's, still fp32."""
    if rope_tables is None:
        return x_bhsd
    c, s = rope_tables
    return _rope_rot(x_bhsd.transpose(1, 2), c, -s).transpose(1, 2)


def _dkdv_from(qh, p, ds, do, rope_tables, k, v):
    dt = do.dtype
    kv_h = k.shape[2]
    dv = p.to(dt).float().transpose(-1, -2) @ _bhsd(do).float()
    dk = ds.to(qh.dtype).float().transpose(-1, -2) @ qh.float()
    dk = _counter_rotate(dk, rope_tables)
    return (_fold(dk, kv_h).to(k.dtype).contiguous(),
            _fold(dv, kv_h).to(v.dtype).contiguous())


def _dq_from(kh, ds, rope_tables, q):
    dq = ds.to(kh.dtype).float() @ kh.float()
    return _counter_rotate(dq, rope_tables).transpose(1, 2).to(q.dtype).contiguous()


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO · O)`` in fp32, ``[B, H, S]`` (``flash_attention.py:1141``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_post_plain(dq_acc: torch.Tensor, rope_tables,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """fp32 ``[B, S, H, D]`` dq in rotation space -> dq in ``dtype``:
    counter-rotated (``-S``) in fp32 and cast once."""
    if rope_tables is not None:
        dq_acc = _rope_rot(dq_acc, rope_tables[0], -rope_tables[1])
    return dq_acc.to(dtype)


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, segment_ids=None,
                         rope_tables=None, causal=True):
    """Pass 1 of the two-pass backward: ``(dk, dv)`` in k's/v's layout
    and dtype, query-head groups summed in fp32."""
    qh, _, p, ds = _bwd_terms(q, k, v, do, lse, delta, segment_ids,
                              rope_tables, causal)
    return _dkdv_from(qh, p, ds, do, rope_tables, k, v)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, segment_ids=None,
                       rope_tables=None, causal=True):
    """Pass 2 of the two-pass backward: dq in q's layout and dtype."""
    _, kh, _, ds = _bwd_terms(q, k, v, do, lse, delta, segment_ids,
                              rope_tables, causal)
    return _dq_from(kh, ds, rope_tables, q)


def flash_bwd_dkdv_rotated_plain(qr, kr, v, do, lse, delta, segment_ids=None,
                                 rope_tables=None, causal=True):
    """The dk/dv pass as its warpgroup kernel computes it: ``qr`` and
    ``kr`` already rotated (:func:`rope_rotate`), the score recompute on
    them with no tables, dk counter-rotated in fp32 (by ``rope_tables``)
    before the group fold and the cast. Bit for bit
    :func:`flash_bwd_dkdv_plain` on the unrotated q and k."""
    qh, _, p, ds = _bwd_terms(qr, kr, v, do, lse, delta, segment_ids, None,
                              causal)
    return _dkdv_from(qh, p, ds, do, rope_tables, kr, v)


def flash_bwd_dq_rotated_plain(qr, kr, v, do, lse, delta, segment_ids=None,
                               rope_tables=None, causal=True):
    """The dq pass as its warpgroup kernel computes it: ``qr`` and ``kr``
    already rotated, fp32 dq counter-rotated before the cast. Bit for bit
    :func:`flash_bwd_dq_plain` on the unrotated q and k."""
    _, kh, _, ds = _bwd_terms(qr, kr, v, do, lse, delta, segment_ids, None,
                              causal)
    return _dq_from(kh, ds, rope_tables, qr)


def flash_bwd_fused_plain(q, k, v, o, lse, do, segment_ids=None,
                          rope_tables=None, causal=True):
    """The single-tile backward: ``(dq, dk, dv)`` from one score
    recompute, ``delta`` from ``o``."""
    qh, kh, p, ds = _bwd_terms(q, k, v, do, lse, attention_delta(o, do),
                               segment_ids, rope_tables, causal)
    dk, dv = _dkdv_from(qh, p, ds, do, rope_tables, k, v)
    return _dq_from(kh, ds, rope_tables, q), dk, dv


# -- the kernels as operators ----------------------------------------------------
#
# One operator per kernel entry (``ops/_library.py``): the CUDA
# implementation launches the kernel, the CPU one is its plain version,
# the fake allocates the CUDA implementation's outputs. The entry points
# below compose them the same way on every device.

def _check(name, q, k, v, *rest, segment_ids=None, rope_tables=None):
    """Validate the operands of a kernel launch; returns the pointers of
    the optional segment ids and rope tables (None when absent) and the
    contiguous int32 segment ids to keep alive across the launch."""
    dev = q.device
    b, s, h, d = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the flash kernels take bfloat16 (got {q.dtype})")
    if d % 16 or d > 256:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 16, <= 256")
    kv_h = k.shape[2]
    if k.shape != (b, s, kv_h, d) or v.shape != k.shape or h % kv_h:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    for t in (q, k, v, *rest):
        if t.device != dev:
            raise RuntimeError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise RuntimeError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must start 16-byte aligned "
                             "(the kernels move 16 bytes at a time)")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k and v must share one dtype")
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(device=dev, dtype=torch.int32).contiguous()
        if seg.shape != (b, s):
            raise ValueError(f"{name}: segment_ids must be [B, S]")
    c_ptr = s_ptr = None
    if rope_tables is not None:
        c, st = rope_tables
        for t in (c, st):
            if (t.shape != (b, s, d) or t.dtype != torch.float32
                    or t.device != dev or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError(f"{name}: rope tables must be contiguous, "
                                 f"16-byte aligned float32 [B, S, D] on {dev}")
        c_ptr, s_ptr = c.data_ptr(), st.data_ptr()
    return seg, (None if seg is None else seg.data_ptr()), c_ptr, s_ptr


def _check_residuals(name, lse, delta, shape):
    for t in (lse, delta):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be float32 [B, H, S]")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _tables(c, s) -> RopeTables:
    return None if c is None else (c, s)


def _lse_like(q: torch.Tensor) -> torch.Tensor:
    b, s, h, _ = q.shape
    return q.new_empty((b, h, s), dtype=torch.float32)


def _rope_rotate_cuda(q, k, c, st):
    from kubeflow_controller_tpu_torch.ops import _build

    _check("rope_rotate", q, k, k, rope_tables=(c, st))   # k also stands in for v
    b, s, h, d = q.shape
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    rc = _build.load().kfc_rope_rotate(
        q.data_ptr(), k.data_ptr(), c.data_ptr(), st.data_ptr(),
        q_out.data_ptr(), k_out.data_ptr(), b * s, h, k.shape[2], d,
        _stream(q.device))
    _raise_on(rc, "rope_rotate")
    LAUNCHES["rope_rotate"] += 1
    return q_out, k_out


_rope_rotate_op = define(
    "rope_rotate(Tensor q, Tensor k, Tensor c, Tensor s) -> (Tensor, Tensor)",
    cpu=lambda q, k, c, st: (_rope_rot(q, c, st), _rope_rot(k, c, st)),
    cuda=_rope_rotate_cuda,
    fake=lambda q, k, c, st: (torch.empty_like(q), torch.empty_like(k)))


def _prep_cpu(o, do, scratch):
    return attention_delta(o, do), (
        torch.zeros(o.shape, dtype=torch.float32) if scratch else o.new_empty((0,), dtype=torch.float32))


def _prep_cuda(o, do, scratch):
    from kubeflow_controller_tpu_torch.ops import _build

    b, s, h, d = o.shape
    _check("flash_bwd_prep", o, do, do)
    if d not in WGMMA_HEAD_DIMS or do.shape != o.shape:
        raise ValueError(f"flash_bwd_prep: o and do [B, S, H, D] with D in "
                         f"{WGMMA_HEAD_DIMS} (got {tuple(o.shape)}, {tuple(do.shape)})")
    delta = _lse_like(o)
    dq_acc = o.new_empty(o.shape if scratch else (0,), dtype=torch.float32)
    rc = _build.load().kfc_flash_bwd_prep(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(),
        dq_acc.data_ptr() if scratch else None, b, s, h, d, _stream(o.device))
    _raise_on(rc, "flash_bwd_prep")
    LAUNCHES["flash_bwd_prep"] += 1
    return delta, dq_acc


_prep_op = define(
    "flash_bwd_prep(Tensor o, Tensor dout, bool scratch) -> (Tensor, Tensor)",
    cpu=_prep_cpu, cuda=_prep_cuda,
    fake=lambda o, do, scratch: (
        _lse_like(o), o.new_empty(o.shape if scratch else (0,), dtype=torch.float32)))


def _post_cuda(dq_acc, c, st, dtype):
    from kubeflow_controller_tpu_torch.ops import _build

    b, s, h, d = dq_acc.shape
    if (dq_acc.dtype != torch.float32 or not dq_acc.is_contiguous() or d % 16
            or dtype != torch.bfloat16):
        raise ValueError("flash_bwd_post: dq_acc must be contiguous float32 "
                         "[B, S, H, D], D a multiple of 16, and dq bfloat16")
    c_p = s_p = None
    if c is not None:
        for t in (c, st):
            if (t.shape != (b, s, d) or t.dtype != torch.float32
                    or t.device != dq_acc.device or not t.is_contiguous()):
                raise ValueError("flash_bwd_post: rope tables must be contiguous "
                                 f"float32 [B, S, D] on {dq_acc.device}")
        c_p, s_p = c.data_ptr(), st.data_ptr()
    dq = torch.empty(dq_acc.shape, dtype=torch.bfloat16, device=dq_acc.device)
    rc = _build.load().kfc_flash_bwd_post(
        dq_acc.data_ptr(), c_p, s_p, dq.data_ptr(), b * s, h, d,
        _stream(dq_acc.device))
    _raise_on(rc, "flash_bwd_post")
    LAUNCHES["flash_bwd_post"] += 1
    return dq


_post_op = define(
    "flash_bwd_post(Tensor dq_acc, Tensor? c, Tensor? s, ScalarType dtype) -> Tensor",
    cpu=lambda dq_acc, c, st, dtype: flash_bwd_post_plain(dq_acc, _tables(c, st), dtype),
    cuda=_post_cuda,
    fake=lambda dq_acc, c, st, dtype: dq_acc.new_empty(dq_acc.shape, dtype=dtype))


def _fwd_cuda(q, k, v, segment_ids, c, st, causal):
    from kubeflow_controller_tpu_torch.ops import _build

    seg, seg_p, c_p, s_p = _check("flash_fwd", q, k, v, segment_ids=segment_ids,
                                  rope_tables=_tables(c, st))
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = _lse_like(q)
    rc = _build.load().kfc_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_p, c_p, s_p,
        o.data_ptr(), lse.data_ptr(), b, s, h, k.shape[2], d,
        float(d ** -0.5), int(causal), _stream(q.device))
    _raise_on(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


_fwd_op = define(
    "flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? segment_ids, Tensor? c, "
    "Tensor? s, bool causal) -> (Tensor, Tensor)",
    cpu=lambda q, k, v, seg, c, st, causal: flash_fwd_plain(
        q, k, v, seg, _tables(c, st), causal),
    cuda=_fwd_cuda,
    fake=lambda q, k, v, seg, c, st, causal: (torch.empty_like(q), _lse_like(q)))


def _kv_plain(q, k, v, do, lse, delta, segment_ids, c, st, dq_acc, causal):
    """The dk/dv kernels' arithmetic: at head_dim 64 and 128 q and k come
    rotated (the tables only counter-rotate dk), at the others they are
    rotated here; with ``dq_acc`` also each query's dq, in rotation
    space, added into it (the fused kernels)."""
    rope = _tables(c, st)
    on_load = None if q.shape[-1] in WGMMA_HEAD_DIMS else rope
    qh, kh, p, ds = _bwd_terms(q, k, v, do, lse, delta, segment_ids, on_load, causal)
    if dq_acc is not None:
        dq_acc.add_((ds.to(kh.dtype).float() @ kh.float()).transpose(1, 2))
    return _dkdv_from(qh, p, ds, do, rope, k, v)


def _kv_cuda(name, q, k, v, do, lse, delta, segment_ids, c, st, dq_acc, causal):
    """One launch of the dk/dv kernel (``name``: the fused wgmma kernel,
    or the dk/dv kernel, which with ``dq_acc`` also adds every tile's dq
    into it)."""
    from kubeflow_controller_tpu_torch.ops import _build

    seg, seg_p, c_p, s_p = _check(name, q, k, v, do, lse, delta,
                                  segment_ids=segment_ids, rope_tables=_tables(c, st))
    b, s, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do must match q")
    _check_residuals(name, lse, delta, (b, h, s))
    if dq_acc is not None and (dq_acc.shape != q.shape or dq_acc.dtype != torch.float32
                               or not dq_acc.is_contiguous()):
        raise ValueError(f"{name}: dq_acc must be contiguous float32 [B, S, H, D]")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    entry = (_build.load().kfc_flash_bwd_fused if name == "flash_bwd_fused"
             else _build.load().kfc_flash_bwd_kv)
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_p, c_p, s_p, dk.data_ptr(),
        dv.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
        b, s, h, k.shape[2], d, float(d ** -0.5), int(causal), _stream(q.device))
    _raise_on(rc, name)
    LAUNCHES["flash_bwd_fused" if dq_acc is not None else "flash_bwd_dkdv"] += 1
    return dk, dv


def _kv_fake(q, k, v, do, lse, delta, seg, c, st, dq_acc, causal):
    return torch.empty_like(k), torch.empty_like(v)


_BWD_ARGS = ("Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor delta, "
             "Tensor? segment_ids, Tensor? c, Tensor? s")
_fused_op = define(
    f"flash_bwd_fused({_BWD_ARGS}, Tensor(a!) dq_acc, bool causal) -> (Tensor, Tensor)",
    cpu=_kv_plain,
    cuda=lambda *a: _kv_cuda("flash_bwd_fused", *a),
    fake=_kv_fake)
_kv_op = define(
    f"flash_bwd_kv({_BWD_ARGS}, Tensor(a!)? dq_acc, bool causal) -> (Tensor, Tensor)",
    cpu=_kv_plain,
    cuda=lambda *a: _kv_cuda("flash_bwd_kv", *a),
    fake=_kv_fake)


def _dq_plain(q, k, v, do, lse, delta, segment_ids, c, st, causal):
    """The dq kernel's arithmetic (q and k rotated as :func:`_kv_plain`
    takes them)."""
    rope = _tables(c, st)
    on_load = None if q.shape[-1] in WGMMA_HEAD_DIMS else rope
    _, kh, _, ds = _bwd_terms(q, k, v, do, lse, delta, segment_ids, on_load, causal)
    return _dq_from(kh, ds, rope, q)


def _dq_cuda(q, k, v, do, lse, delta, segment_ids, c, st, causal):
    from kubeflow_controller_tpu_torch.ops import _build

    seg, seg_p, c_p, s_p = _check("flash_bwd_dq", q, k, v, do, lse, delta,
                                  segment_ids=segment_ids, rope_tables=_tables(c, st))
    b, s, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash_bwd_dq: do must match q")
    _check_residuals("flash_bwd_dq", lse, delta, (b, h, s))
    dq = torch.empty_like(q)
    rc = _build.load().kfc_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_p, c_p, s_p, dq.data_ptr(),
        b, s, h, k.shape[2], d, float(d ** -0.5), int(causal), _stream(q.device))
    _raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


_dq_op = define(
    f"flash_bwd_dq({_BWD_ARGS}, bool causal) -> Tensor",
    cpu=_dq_plain, cuda=_dq_cuda,
    fake=lambda q, k, v, do, lse, delta, seg, c, st, causal: torch.empty_like(q))


# -- entry points -------------------------------------------------------------
#
# Each runs the same operators on every device; the dispatcher runs the
# kernels on CUDA tensors and their plain versions on CPU tensors, and
# any other device raises there.

def _rotated_for_kernels(q, k, rope_tables):
    """q and k as the warpgroup kernels take them: rotated by the prepass
    at head_dim 64 and 128 when there are tables, else as they are (the
    other kernels rotate on load)."""
    if rope_tables is None or q.shape[-1] not in WGMMA_HEAD_DIMS:
        return q, k
    return rope_rotate(q, k, rope_tables)


def rope_rotate(q: torch.Tensor, k: torch.Tensor, rope_tables):
    """``(q, k)`` rotated by the tables, each in its dtype: the prepass
    kernel on CUDA tensors (one launch for both), :func:`_rope_rot` on
    CPU tensors. Both round like ``_rope_rot``: two fp32 products, their
    sum, one cast."""
    c, st = rope_tables
    return _rope_rotate_op(q, k, c, st)


def flash_bwd_prep(o: torch.Tensor, do: torch.Tensor, scratch: bool = True):
    """``(delta [B, H, S] fp32, dq scratch [B, S, H, D] fp32 zeros)``: the
    backward's prepass kernel on CUDA tensors (one launch for both),
    :func:`attention_delta` and ``torch.zeros`` on CPU tensors. With
    ``scratch=False`` (the two-pass backward) the scratch is None and the
    kernel writes delta alone."""
    delta, dq_acc = _prep_op(o, do, scratch)
    return delta, (dq_acc if scratch else None)


def flash_bwd_post(dq_acc: torch.Tensor, rope_tables: RopeTables,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """dq from the fused backward's fp32 scratch: the postprocess kernel
    on CUDA tensors (bf16 only), :func:`flash_bwd_post_plain` on CPU
    tensors (the same roundings: bit for bit)."""
    c, st = rope_tables if rope_tables is not None else (None, None)
    return _post_op(dq_acc, c, st, dtype)


def flash_fwd(q, k, v, segment_ids=None, rope_tables: RopeTables = None,
              causal: bool = True):
    """``(o [B, S, H, D], lse [B, H, S] fp32)``: the forward kernel on
    CUDA tensors, :func:`flash_fwd_plain` on CPU tensors. At head_dim 64
    and 128 the rope prepass rotates q and k first."""
    if rope_tables is not None and q.shape[-1] in WGMMA_HEAD_DIMS:
        q, k = rope_rotate(q, k, rope_tables)
        rope_tables = None
    c, st = rope_tables if rope_tables is not None else (None, None)
    return _fwd_op(q, k, v, segment_ids, c, st, causal)


def flash_bwd_fused(q, k, v, o, lse, do, segment_ids=None,
                    rope_tables: RopeTables = None, causal: bool = True):
    """``(dq, dk, dv)`` from one score recompute. At head_dim 64 and 128:
    the rope prepass, the delta and scratch prepass, the warpgroup kernel
    (dk, dv; dq into the scratch by 16-byte reductions) and the dq
    postprocess; at the others delta eagerly, the dk/dv kernel adding dq
    into a zeroed scratch, and the postprocess's plain version. On CUDA,
    dq tiles from different k-tiles meet in the fp32 scratch through
    atomic adds, so dq's fp32 sums run in a launch-dependent order before
    the one counter-rotation and cast (dk and dv are deterministic)."""
    c, st = rope_tables if rope_tables is not None else (None, None)
    if q.shape[-1] in WGMMA_HEAD_DIMS:
        qr, kr = _rotated_for_kernels(q, k, rope_tables)
        delta, dq_acc = flash_bwd_prep(o, do)
        dk, dv = _fused_op(qr, kr, v, do, lse, delta, segment_ids, c, st, dq_acc, causal)
        return flash_bwd_post(dq_acc, rope_tables, q.dtype), dk, dv
    delta = attention_delta(o, do)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = _kv_op(q, k, v, do, lse, delta, segment_ids, c, st, dq_acc, causal)
    return flash_bwd_post_plain(dq_acc, rope_tables, q.dtype), dk, dv


def flash_bwd_dkdv(q, k, v, do, lse, delta, segment_ids=None,
                   rope_tables: RopeTables = None, causal: bool = True):
    """``(dk, dv)``, each KV head's query-head group summed inside the
    kernel (at head_dim 64 and 128 after the rope prepass)."""
    c, st = rope_tables if rope_tables is not None else (None, None)
    qr, kr = _rotated_for_kernels(q, k, rope_tables)
    return _kv_op(qr, kr, v, do, lse, delta, segment_ids, c, st, None, causal)


def flash_bwd_dq(q, k, v, do, lse, delta, segment_ids=None,
                 rope_tables: RopeTables = None, causal: bool = True):
    """dq, one block per (q-tile, head, batch), no atomics (at head_dim 64
    and 128 after the rope prepass)."""
    c, st = rope_tables if rope_tables is not None else (None, None)
    qr, kr = _rotated_for_kernels(q, k, rope_tables)
    return _dq_op(qr, kr, v, do, lse, delta, segment_ids, c, st, causal)


def flash_bwd_two_pass(q, k, v, o, lse, do, segment_ids=None,
                       rope_tables: RopeTables = None, causal: bool = True):
    """``(dq, dk, dv)`` by the two-pass backward, as :func:`flash_mha`'s
    backward runs it when the block rule gives more than one tile: one
    rope prepass for both passes (at head_dim 64 and 128), delta from the
    prepass kernel (no scratch; at the other head dims eagerly), the
    dk/dv pass, the dq pass."""
    c, st = rope_tables if rope_tables is not None else (None, None)
    qr, kr = _rotated_for_kernels(q, k, rope_tables)
    if q.shape[-1] in WGMMA_HEAD_DIMS:
        delta, _ = flash_bwd_prep(o, do, scratch=False)
    else:
        delta = attention_delta(o, do)
    dk, dv = _kv_op(qr, kr, v, do, lse, delta, segment_ids, c, st, None, causal)
    dq = _dq_op(qr, kr, v, do, lse, delta, segment_ids, c, st, causal)
    return dq, dk, dv


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels take it (a
    copy only when it is not). A fake tensor (a traced step's) has no
    address: it stays as it is."""
    t = t.contiguous()
    if isinstance(t, FakeTensor):
        return t
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, rope_c, rope_s, causal, fused):
        rope = None if rope_c is None else (rope_c, rope_s)
        o, lse = flash_fwd(q, k, v, segment_ids, rope, causal)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids, rope_c, rope_s)
        ctx.causal, ctx.fused = causal, fused
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg, rope_c, rope_s = ctx.saved_tensors
        rope = None if rope_c is None else (rope_c, rope_s)
        do = _dense(do)
        if ctx.fused:
            dq, dk, dv = flash_bwd_fused(q, k, v, o, lse, do, seg, rope,
                                         ctx.causal)
        else:
            dq, dk, dv = flash_bwd_two_pass(q, k, v, o, lse, do, seg, rope,
                                            ctx.causal)
        # Segment ids are integers and the rope tables functions of
        # integer positions: no gradients.
        return dq, dk, dv, None, None, None, None, None


def flash_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    rope_tables: RopeTables = None,
) -> torch.Tensor:
    """Flash attention, ``[B, S, H, D]`` in and out, differentiable in q,
    k and v. ``rope_tables`` (from :func:`rope_full_tables`) rotates q
    and k inside the kernels; ``block_q``/``block_k`` (default 1024)
    choose the backward route as the JAX package's blocks do."""
    block_q = DEFAULT_BLOCK_Q if block_q is None else block_q
    block_k = DEFAULT_BLOCK_K if block_k is None else block_k
    fused = single_tile(q.shape[1], block_q, block_k, segment_ids is not None)
    rope_c, rope_s = rope_tables if rope_tables is not None else (None, None)
    return _FlashAttention.apply(
        _dense(q), _dense(k), _dense(v), segment_ids, rope_c, rope_s, causal,
        fused)
