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
  ``_bwd_dq_kernel``).

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
and the two-pass kernels otherwise, so the same ``S`` and blocks take the
same route in both packages. The blocks choose nothing else here: Hopper
tiles are the kernels' own.

``LAUNCHES`` counts kernel launches per kernel; each wrapper adds one
where it launches and nowhere else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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

#: The head dims the warpgroup forward and fused backward kernels are
#: built for; there Q and K are rotated by the prepass. ``kfc_flash_fwd``
#: picks its kernel by the same rule.
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


def flash_bwd_post_plain(dq_acc: torch.Tensor, rope_tables) -> torch.Tensor:
    """fp32 ``[B, S, H, D]`` dq in rotation space -> bf16 dq: counter-rotated
    (``-S``) in fp32 and cast once."""
    if rope_tables is not None:
        dq_acc = _rope_rot(dq_acc, rope_tables[0], -rope_tables[1])
    return dq_acc.to(torch.bfloat16)


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


def flash_bwd_fused_plain(q, k, v, o, lse, do, segment_ids=None,
                          rope_tables=None, causal=True):
    """The single-tile backward: ``(dq, dk, dv)`` from one score
    recompute, ``delta`` from ``o``."""
    qh, kh, p, ds = _bwd_terms(q, k, v, do, lse, attention_delta(o, do),
                               segment_ids, rope_tables, causal)
    dk, dv = _dkdv_from(qh, p, ds, do, rope_tables, k, v)
    return _dq_from(kh, ds, rope_tables, q), dk, dv


# -- kernel launches ----------------------------------------------------------

def _check(name, q, k, v, *rest, segment_ids=None, rope_tables=None):
    """Validate the operands of a kernel launch; returns the pointers of
    the optional segment ids and rope tables (None when absent) and the
    contiguous int32 segment ids to keep alive across the launch."""
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"{name} runs its CUDA kernel on cuda tensors and its plain "
            f"version on cpu tensors (got {dev})")
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


def rope_rotate(q: torch.Tensor, k: torch.Tensor, rope_tables):
    """``(q, k)`` rotated by the tables, each in its dtype: the prepass
    kernel on CUDA tensors (one launch for both), :func:`_rope_rot` on
    CPU tensors. Both round like ``_rope_rot``: two fp32 products, their
    sum, one cast."""
    c, st = rope_tables
    if q.device.type == "cpu":
        return _rope_rot(q, c, st), _rope_rot(k, c, st)
    from kubeflow_controller_tpu_torch.ops import _build

    _check("rope_rotate", q, k, k, rope_tables=rope_tables)   # k also stands in for v
    b, s, h, d = q.shape
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    rc = _build.load().kfc_rope_rotate(
        q.data_ptr(), k.data_ptr(), c.data_ptr(), st.data_ptr(),
        q_out.data_ptr(), k_out.data_ptr(), b * s, h, k.shape[2], d,
        _stream(q.device))
    _raise_on(rc, "rope_rotate")
    LAUNCHES["rope_rotate"] += 1
    return q_out, k_out


def flash_bwd_prep(o: torch.Tensor, do: torch.Tensor):
    """``(delta [B, H, S] fp32, dq scratch [B, S, H, D] fp32 zeros)``: the
    fused backward's prepass kernel on CUDA tensors (one launch for
    both), :func:`attention_delta` and ``torch.zeros`` on CPU tensors."""
    b, s, h, d = o.shape
    if o.device.type == "cpu":
        return attention_delta(o, do), torch.zeros(o.shape, dtype=torch.float32)
    from kubeflow_controller_tpu_torch.ops import _build

    _check("flash_bwd_prep", o, do, do)
    if d not in WGMMA_HEAD_DIMS or do.shape != o.shape:
        raise ValueError(f"flash_bwd_prep: o and do [B, S, H, D] with D in "
                         f"{WGMMA_HEAD_DIMS} (got {tuple(o.shape)}, {tuple(do.shape)})")
    delta = torch.empty((b, h, s), dtype=torch.float32, device=o.device)
    dq_acc = torch.empty(o.shape, dtype=torch.float32, device=o.device)
    rc = _build.load().kfc_flash_bwd_prep(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
        b, s, h, d, _stream(o.device))
    _raise_on(rc, "flash_bwd_prep")
    LAUNCHES["flash_bwd_prep"] += 1
    return delta, dq_acc


def flash_bwd_post(dq_acc: torch.Tensor, rope_tables: RopeTables) -> torch.Tensor:
    """bf16 dq from the fused backward's fp32 scratch: the postprocess
    kernel on CUDA tensors, :func:`flash_bwd_post_plain` on CPU tensors
    (the same roundings: bit for bit)."""
    if dq_acc.device.type == "cpu":
        return flash_bwd_post_plain(dq_acc, rope_tables)
    from kubeflow_controller_tpu_torch.ops import _build

    b, s, h, d = dq_acc.shape
    if dq_acc.dtype != torch.float32 or not dq_acc.is_contiguous() or d % 16:
        raise ValueError("flash_bwd_post: dq_acc must be contiguous float32 "
                         "[B, S, H, D], D a multiple of 16")
    c_p = s_p = None
    if rope_tables is not None:
        c, st = rope_tables
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


def _fwd_kernel(q, k, v, segment_ids, rope_tables, causal):
    from kubeflow_controller_tpu_torch.ops import _build

    seg, seg_p, c_p, s_p = _check("flash_fwd", q, k, v, segment_ids=segment_ids,
                                  rope_tables=rope_tables)
    b, s, h, d = q.shape
    if rope_tables is not None and d in WGMMA_HEAD_DIMS:
        q, k = rope_rotate(q, k, rope_tables)
        c_p = s_p = None
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rc = _build.load().kfc_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_p, c_p, s_p,
        o.data_ptr(), lse.data_ptr(), b, s, h, k.shape[2], d,
        float(d ** -0.5), int(causal), _stream(q.device))
    _raise_on(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_kv_kernel(name, q, k, v, do, lse, delta, segment_ids, rope_tables,
                   causal, dq_acc):
    """One launch of the dk/dv kernel; with ``dq_acc`` (fp32 ``[B, S, H,
    D]`` zeros) it is the fused kernel and also adds every tile's dq
    into ``dq_acc``, still in rotation space."""
    from kubeflow_controller_tpu_torch.ops import _build

    seg, seg_p, c_p, s_p = _check(name, q, k, v, do, lse, delta,
                                  segment_ids=segment_ids,
                                  rope_tables=rope_tables)
    b, s, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do must match q")
    _check_residuals(name, lse, delta, (b, h, s))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _build.load().kfc_flash_bwd_kv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_p, c_p, s_p, dk.data_ptr(),
        dv.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
        b, s, h, k.shape[2], d, float(d ** -0.5), int(causal),
        _stream(q.device))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return dk, dv


def _bwd_fused_wgmma(q, k, v, o, lse, do, segment_ids, rope_tables, causal):
    """The fused backward at head_dim 64 and 128: rope prepass, delta and
    scratch prepass, the warpgroup kernel (dk, dv; dq into the scratch by
    16-byte reductions, in a launch-dependent order), dq postprocess."""
    from kubeflow_controller_tpu_torch.ops import _build

    name = "flash_bwd_fused"
    seg, seg_p, c_p, s_p = _check(name, q, k, v, o, do, lse,
                                  segment_ids=segment_ids,
                                  rope_tables=rope_tables)
    b, s, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
        raise ValueError(f"{name}: o and do must match q")
    qr, kr = rope_rotate(q, k, rope_tables) if rope_tables is not None else (q, k)
    delta, dq_acc = flash_bwd_prep(o, do)
    _check_residuals(name, lse, delta, (b, h, s))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _build.load().kfc_flash_bwd_fused(
        qr.data_ptr(), kr.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_p, c_p, s_p, dk.data_ptr(),
        dv.data_ptr(), dq_acc.data_ptr(), b, s, h, k.shape[2], d,
        float(d ** -0.5), int(causal), _stream(q.device))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return flash_bwd_post(dq_acc, rope_tables), dk, dv


def _dq_kernel(q, k, v, do, lse, delta, segment_ids, rope_tables, causal):
    from kubeflow_controller_tpu_torch.ops import _build

    seg, seg_p, c_p, s_p = _check("flash_bwd_dq", q, k, v, do, lse, delta,
                                  segment_ids=segment_ids,
                                  rope_tables=rope_tables)
    b, s, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash_bwd_dq: do must match q")
    _check_residuals("flash_bwd_dq", lse, delta, (b, h, s))
    dq = torch.empty_like(q)
    rc = _build.load().kfc_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_p, c_p, s_p, dq.data_ptr(),
        b, s, h, k.shape[2], d, float(d ** -0.5), int(causal),
        _stream(q.device))
    _raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


# -- entry points -------------------------------------------------------------

def flash_fwd(q, k, v, segment_ids=None, rope_tables: RopeTables = None,
              causal: bool = True):
    """``(o [B, S, H, D], lse [B, H, S] fp32)``: the forward kernel on
    CUDA tensors, :func:`flash_fwd_plain` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, segment_ids, rope_tables, causal)
    return _fwd_kernel(q, k, v, segment_ids, rope_tables, causal)


def flash_bwd_fused(q, k, v, o, lse, do, segment_ids=None,
                    rope_tables: RopeTables = None, causal: bool = True):
    """``(dq, dk, dv)`` from one score recompute. On CUDA, dq tiles from
    different k-tiles meet in an fp32 scratch through atomic adds, so
    dq's fp32 sums run in a launch-dependent order before the one
    counter-rotation and cast (dk and dv are deterministic)."""
    if q.device.type == "cpu":
        return flash_bwd_fused_plain(q, k, v, o, lse, do, segment_ids,
                                     rope_tables, causal)
    if q.shape[-1] in WGMMA_HEAD_DIMS:
        return _bwd_fused_wgmma(q, k, v, o, lse, do, segment_ids, rope_tables,
                                causal)
    delta = attention_delta(o, do)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = _bwd_kv_kernel("flash_bwd_fused", q, k, v, do, lse, delta,
                            segment_ids, rope_tables, causal, dq_acc)
    return flash_bwd_post_plain(dq_acc, rope_tables), dk, dv


def flash_bwd_dkdv(q, k, v, do, lse, delta, segment_ids=None,
                   rope_tables: RopeTables = None, causal: bool = True):
    """``(dk, dv)``, each KV head's query-head group summed inside the
    kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, segment_ids,
                                    rope_tables, causal)
    return _bwd_kv_kernel("flash_bwd_dkdv", q, k, v, do, lse, delta,
                          segment_ids, rope_tables, causal, None)


def flash_bwd_dq(q, k, v, do, lse, delta, segment_ids=None,
                 rope_tables: RopeTables = None, causal: bool = True):
    """dq, one block per (batch, head, q-tile), no atomics."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, segment_ids,
                                  rope_tables, causal)
    return _dq_kernel(q, k, v, do, lse, delta, segment_ids, rope_tables,
                      causal)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels take it (a
    copy only when it is not)."""
    t = t.contiguous()
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
            delta = attention_delta(o, do)
            dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, seg, rope,
                                    ctx.causal)
            dq = flash_bwd_dq(q, k, v, do, lse, delta, seg, rope, ctx.causal)
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
