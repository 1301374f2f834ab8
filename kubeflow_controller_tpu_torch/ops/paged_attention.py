"""Paged attention for the serving engine: decode, chunk prefill, verify.

Counterpart of ``kubeflow_controller_tpu/ops/paged_attention_pallas.py``.
Each entry point computes what the Pallas kernel computes: a
flash-style online softmax that walks a slot's block table page by page
and reads the pool's pages in place, so the dense ``[B, S, KVH, D]``
view of the gather path (``ops/attention.py:paged_kv_view``) never
exists; int8 pools dequantize inside the page load.

* :func:`paged_attention_decode` — one query group per slot at its own
  position, columns ``<= pos[b]``.
* :func:`paged_attention_prefill` — a width-W chunk of ONE slot: the
  chunk's own fresh K/V as an intra-chunk causal tile, then the slot's
  cached columns ``< offset``.
* :func:`paged_attention_verify` — the same chunk attention for a batch
  of slots, cached columns ``< pos[b]``.

Where the work runs is decided by the tensors alone: a CPU tensor runs
the plain PyTorch version (``*_plain``, which repeats the kernel's
page-by-page arithmetic and is what the CPU tests hold against the JAX
package); a CUDA tensor launches the hand-written CUDA kernel
(``csrc/paged_attention.cu``) or raises. There is no fallback from the
kernel to the plain version.

``LAUNCHES`` counts kernel launches per kernel (``paged_decode``,
``paged_chunk``): each wrapper adds one where it launches, and nowhere
else, so a run can show that its main path went through the kernels.

Chunk and decode attention with bf16 queries at head_dim 64 and 128
(``MMA_HEAD_DIMS``; decode also needs ``rep <= MAX_DECODE_REP``) launch
the tensor-core kernels, which split each (slot, KV head)'s walk into
parts (:func:`chunk_parts`, :func:`decode_parts`) and walk only the
visible columns (``< min(pos[b], nb * bs)`` for a chunk, ``<= pos[b]``
for decode); every other call launches the first kernels. The parts
merge inside the launch through counters and scratch held per (device,
stream) (:func:`_stream_buffers`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

MASK_VALUE = -1e30

#: Kernel launches since the last :func:`reset_launches`, by kernel.
LAUNCHES: Dict[str, int] = {"paged_decode": 0, "paged_chunk": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Head dims of the tensor-core chunk and decode kernels (bf16 queries).
MMA_HEAD_DIMS = (64, 128)
TILE_COLS = 16        # pool columns of one tile of those kernels
ROWS_PER_BLOCK = 64   # query rows (position, rep pairs) of one chunk block
MAX_PARTS = 64        # chunk: part 0 (the intra-chunk tile) and 63 runs of pool tiles
TARGET_BLOCKS = 264   # two blocks for each of the H100's 132 SMs
DECODE_WARPS = 4      # warps of a decode block; warp w walks every 4th tile of its part
MAX_DECODE_REP = 16   # query rows of one decode warp's mma tile

# Merge counters and split-partial scratch of the tensor-core kernels, one
# pair per (device, stream), grown when a launch needs more. The chunk
# and the decode kernel share a stream's pair: launches on one stream run
# one after another, so the two never use it at once, and each kernel's
# last block resets its own counters, so the counters are all zero
# between launches. Two streams never share a pair: kernels on two
# streams may run at once.
_STREAM_BUFFERS: Dict[Tuple[torch.device, int],
                      Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pages_to_walk(width: Optional[int], bs: int, mb: int) -> int:
    """``nb = min(ceil(min(width, mb*bs) / bs), mb)``, at least 1 — the
    occupancy cap on the table walk, exactly as the Pallas wrappers
    compute it (it fixes both the bytes read and the reduction order)."""
    span = mb * bs if width is None else min(width, mb * bs)
    return min(max(1, -(-span // bs)), mb)


def chunk_parts(groups: int, cols: int) -> tuple:
    """``(parts, tiles_per_part)`` of the tensor-core chunk kernel for
    ``groups`` = slots x KV heads x row groups and ``cols`` pool columns
    to cover: part 0 is the intra-chunk tile, the others split the
    ``ceil(cols / 16)`` tiles into equal runs, as many as bring the grid
    to ``TARGET_BLOCKS`` (at most ``MAX_PARTS`` in all)."""
    tiles = -(-cols // TILE_COLS)
    if tiles == 0:
        return 1, 1
    want = max(1, -(-TARGET_BLOCKS // groups) - 1)
    runs = min(tiles, want, MAX_PARTS - 1)
    per = -(-tiles // runs)
    return 1 + -(-tiles // per), per


def decode_parts(groups: int, cols: int) -> tuple:
    """``(parts, tiles_per_part)`` of the tensor-core decode kernel for
    ``groups`` = slots x KV heads and ``cols`` columns to cover (the width
    cap: decode's ``pos`` is on the device): the ``ceil(cols / 16)`` tiles
    in equal runs, as many as bring the grid to ``TARGET_BLOCKS``
    (at most ``MAX_PARTS``), each of at least ``DECODE_WARPS`` tiles (one
    for each warp of a block)."""
    tiles = max(1, -(-cols // TILE_COLS))
    runs = min(max(1, -(-TARGET_BLOCKS // groups)), MAX_PARTS)
    per = max(DECODE_WARPS, -(-tiles // runs))
    return -(-tiles // per), per


def decode_uses_mma(dtype: torch.dtype, rep: int, head_dim: int) -> bool:
    """Whether a decode of ``rep`` query rows per KV head at ``head_dim``
    in queries of ``dtype`` takes the tensor-core kernel
    (``kfc_paged_decode``'s rule)."""
    return (dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS
            and rep <= MAX_DECODE_REP)


# -- plain PyTorch versions ---------------------------------------------------

def _online_update(m, l, acc, s, v):
    """One flash-softmax accumulator update: scores ``s`` [..., R, C] and
    values ``v`` [..., C, D] (fp32 throughout)."""
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = alpha * l + p.sum(-1, keepdim=True)
    acc = acc * alpha + p @ v
    return m_new, l, acc


def _page_tiles(k_pool, v_pool, k_scale, v_scale, ids):
    """The pool pages ``ids`` [B] as fp32 per-head tiles [B, G, bs, D],
    int8 pages multiplied by their per-(token, head) scale."""
    k = k_pool[ids].float()                   # [B, bs, G, D]
    v = v_pool[ids].float()
    if k_scale is not None:
        k = k * k_scale[ids].float()[..., None]
        v = v * v_scale[ids].float()[..., None]
    return k.transpose(1, 2), v.transpose(1, 2)


def paged_attention_decode_plain(
    q: torch.Tensor,               # [B, G, rep, D]
    k_pool: torch.Tensor,          # [n_pages, bs, G, D]
    v_pool: torch.Tensor,
    tables: torch.Tensor,          # [B, mb] page ids (n_blocks = sentinel)
    pos: torch.Tensor,             # [B] column of this step's token
    *,
    k_scale: Optional[torch.Tensor] = None,   # [n_pages, bs, G] f32
    v_scale: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
    sm_scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The decode kernel's arithmetic in plain PyTorch: the same pages in
    the same order, fp32 scores and online-softmax accumulators."""
    b, g, rep, hd = q.shape
    bs = k_pool.shape[1]
    nb = pages_to_walk(width, bs, tables.shape[1])
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    ids = tables[:, :nb].long().clamp(0, k_pool.shape[0] - 1)
    qf = q.float()
    m = torch.full((b, g, rep, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, g, rep, 1), device=q.device)
    acc = torch.zeros((b, g, rep, hd), device=q.device)
    cols = torch.arange(bs, device=q.device)
    p_b = pos.long()[:, None, None, None]
    for j in range(nb):
        k, v = _page_tiles(k_pool, v_pool, k_scale, v_scale, ids[:, j])
        s = (qf @ k.transpose(-1, -2)) * sm_scale          # [B, G, rep, bs]
        s = torch.where(j * bs + cols <= p_b, s, MASK_VALUE)
        m, l, acc = _online_update(m, l, acc, s, v)
    return (acc / l).to(out_dtype or q.dtype)


def paged_chunk_attention_plain(
    q: torch.Tensor,               # [B, W, G, rep, D]
    k_new: torch.Tensor,           # [B, W, G, D]
    v_new: torch.Tensor,
    k_pool: torch.Tensor,          # [n_pages, bs, G, D]
    v_pool: torch.Tensor,
    tables: torch.Tensor,          # [B, mb]
    pos: torch.Tensor,             # [B] cached columns < pos visible
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
    sm_scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The chunk kernel's arithmetic in plain PyTorch: the intra-chunk
    causal tile first (row r is chunk position r // rep and sees chunk
    columns <= r // rep), then the pool pages."""
    b, w, g, rep, hd = q.shape
    bs = k_pool.shape[1]
    nb = pages_to_walk(width, bs, tables.shape[1])
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    ids = tables[:, :nb].long().clamp(0, k_pool.shape[0] - 1)
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(b, g, w * rep, hd)
    m = torch.full((b, g, w * rep, 1), float("-inf"), device=dev)
    l = torch.zeros((b, g, w * rep, 1), device=dev)
    acc = torch.zeros((b, g, w * rep, hd), device=dev)
    kn = k_new.float().transpose(1, 2)                     # [B, G, W, D]
    vn = v_new.float().transpose(1, 2)
    s = (qf @ kn.transpose(-1, -2)) * sm_scale             # [B, G, W*rep, W]
    rows = torch.arange(w * rep, device=dev)[:, None] // rep
    s = torch.where(torch.arange(w, device=dev)[None, :] <= rows, s,
                    MASK_VALUE)
    m, l, acc = _online_update(m, l, acc, s, vn)
    cols = torch.arange(bs, device=dev)
    p_b = pos.long()[:, None, None, None]
    for j in range(nb):
        k, v = _page_tiles(k_pool, v_pool, k_scale, v_scale, ids[:, j])
        s = (qf @ k.transpose(-1, -2)) * sm_scale          # [B, G, W*rep, bs]
        s = torch.where(j * bs + cols < p_b, s, MASK_VALUE)
        m, l, acc = _online_update(m, l, acc, s, v)
    out = (acc / l).to(out_dtype or q.dtype)
    return out.reshape(b, g, w, rep, hd).permute(0, 2, 1, 3, 4)


# -- kernel launches ----------------------------------------------------------

def _meta(t: Optional[torch.Tensor]):
    return None if t is None else (t.shape, t.dtype)


def _pool_check(q_dtype, k_pool, v_pool, k_scale, v_scale) -> bool:
    """Validate the pool operands, each given as ``(shape, dtype)`` (the
    scales may be None), against the query's dtype; returns whether the
    pools are int8."""
    if q_dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention takes float32 or bfloat16 "
                        f"queries (got {q_dtype})")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together")
    want = torch.int8 if quantized else q_dtype
    for name, (_, dtype) in (("k_pool", k_pool), ("v_pool", v_pool)):
        if dtype != want:
            raise TypeError(f"{name} must be {want} (got {dtype})")
    for name, m in (("k_scale", k_scale), ("v_scale", v_scale)):
        if m is not None and (m[1] != torch.float32 or m[0] != k_pool[0][:-1]):
            raise TypeError(f"{name} must be float32 {tuple(k_pool[0][:-1])}")
    if k_pool[0] != v_pool[0]:
        raise ValueError("k_pool and v_pool shapes differ")
    return quantized


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(
            f"paged attention runs its CUDA kernel on cuda tensors and "
            f"its plain version on cpu tensors (got {dev})")
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise RuntimeError("paged attention operands on different devices")
        if not t.is_contiguous():
            raise RuntimeError("paged attention operands must be contiguous")


def _stream(dev) -> int:
    """The current stream of ``dev`` (a CUDA device with its index), as
    the ``cudaStream_t`` handle the kernels launch on."""
    return torch.cuda.current_stream(dev).cuda_stream


def _i32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous int32, without a copy when it already is."""
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _stream_buffers(dev: torch.device, stream: int, n_counters: int,
                    n_floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge counters (int32, zero) and the fp32 split-partial scratch
    of stream ``stream`` on ``dev``, at least ``n_counters`` and
    ``n_floats`` long: allocated at a key's first use and grown when a
    launch needs more, else the same tensors every call."""
    key = (dev, stream)
    bufs = _STREAM_BUFFERS.get(key)
    if bufs is not None and bufs[0].numel() >= n_counters \
            and bufs[1].numel() >= n_floats:
        return bufs
    counters, scratch = bufs if bufs is not None else (None, None)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 64), dtype=torch.int32, device=dev)
    if scratch is None or scratch.numel() < n_floats:
        scratch = torch.empty(max(n_floats, 1 << 16), dtype=torch.float32, device=dev)
    bufs = _STREAM_BUFFERS[key] = (counters, scratch)
    return bufs


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


class _DecodeDims(ctypes.Structure):
    """``KfcDecodeDims`` of ``csrc/paged_attention.cu``."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "G", "rep", "D", "bs", "mb", "nb", "last_page", "parts",
        "tiles_per_part")]
        + [("sm_scale", ctypes.c_float), ("q_dtype", ctypes.c_int),
           ("quantized", ctypes.c_int)])


@functools.lru_cache(maxsize=256)
def _decode_plan(q_shape, q_dtype, k_pool, v_pool, k_scale, v_scale,
                 tables_shape, pos_shape, width, sm_scale, out_dtype, tp=1):
    """A decode launch's shape-only work, once per configuration: the
    operands' checks (the pools and scales given as ``(shape, dtype)``),
    then ``kfc_paged_decode``'s shape arguments (the struct, kept alive
    here, and its address), the fp32 scratch the split needs (0 with one
    part) and the byte offset of its (m, l) pairs. The split is planned
    for ``tp`` times the heads (:func:`paged_attention_decode`)."""
    b, g, rep, hd = q_shape
    n_pages, bs, g_pool, hd_pool = k_pool[0]
    if (g_pool, hd_pool) != (g, hd) or tables_shape[0] != b or pos_shape != (b,):
        raise ValueError("paged_attention_decode: inconsistent shapes")
    if out_dtype not in (None, q_dtype):
        raise TypeError("the decode kernel writes the query's dtype")
    quantized = _pool_check(q_dtype, k_pool, v_pool, k_scale, v_scale)
    mb = tables_shape[1]
    nb = pages_to_walk(width, bs, mb)
    parts, per = 1, 1
    if decode_uses_mma(q_dtype, rep, hd):
        parts, per = decode_parts(b * g * tp, nb * bs)
    # The partial accumulators [B*G*parts, rep, D], then their (m, l) pairs
    # [B*G*parts, rep, 2].
    n_acc = b * g * parts * rep * hd if parts > 1 else 0
    n_floats = n_acc + b * g * parts * rep * 2 if parts > 1 else 0
    dims = _DecodeDims(b, g, rep, hd, bs, mb, nb, n_pages - 1, parts, per,
                       hd ** -0.5 if sm_scale is None else sm_scale,
                       _DTYPE_CODES[q_dtype], int(quantized))
    return dims, ctypes.addressof(dims), n_floats, 4 * n_acc


def _decode_kernel(q, k_pool, v_pool, tables, pos, k_scale, v_scale,
                   width, sm_scale, out_dtype, tp=1):
    from kubeflow_controller_tpu_torch.ops import _build

    if not q.is_contiguous():
        q = q.contiguous()
    tables, pos = _i32(tables), _i32(pos)
    _check_cuda(q, k_pool, v_pool, tables, pos, k_scale, v_scale)
    dims, dims_p, n_floats, ml_offset = _decode_plan(
        q.shape, q.dtype, _meta(k_pool), _meta(v_pool), _meta(k_scale),
        _meta(v_scale), tables.shape, pos.shape, width, sm_scale, out_dtype, tp)
    dev = q.device
    stream = _stream(dev)
    acc_p = ml_p = cnt_p = None
    if n_floats:
        counters, scratch = _stream_buffers(dev, stream, dims.B * dims.G, n_floats)
        acc_p = scratch.data_ptr()
        ml_p, cnt_p = acc_p + ml_offset, counters.data_ptr()
    out = torch.empty_like(q)
    rc = _build.load().kfc_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), tables.data_ptr(), pos.data_ptr(), out.data_ptr(), acc_p,
        ml_p, cnt_p, dims_p, stream)
    _raise_on(rc, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return out


def _chunk_kernel(q, k_new, v_new, k_pool, v_pool, tables, pos, k_scale,
                  v_scale, width, sm_scale, out_dtype, offset=None, tp=1):
    """One chunk-kernel launch. With ``offset`` (the prefill's host
    integer; ``pos`` None) every slot is at that position and the grid is
    sized by its live columns; else by the width cap, and parts past a
    slot's ``pos`` exit at once. The split is planned for ``tp`` times
    the heads (:func:`paged_attention_decode`)."""
    from kubeflow_controller_tpu_torch.ops import _build

    b, w, g, rep, hd = q.shape
    n_pages, bs, g_pool, hd_pool = k_pool.shape
    mma = q.dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS
    if pos is None and not mma:
        pos = torch.full((b,), int(offset), dtype=torch.int32, device=q.device)
    tables = _i32(tables)
    pos = None if pos is None else _i32(pos)
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    _check_cuda(q, k_new, v_new, k_pool, v_pool, tables, pos, k_scale,
                v_scale)
    if ((g_pool, hd_pool) != (g, hd) or k_new.shape != (b, w, g, hd)
            or v_new.shape != k_new.shape or tables.shape[0] != b
            or (pos is not None and pos.shape != (b,))):
        raise ValueError("paged chunk attention: inconsistent shapes")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("k_new/v_new must have the query's dtype")
    if out_dtype not in (None, q.dtype):
        raise TypeError("the chunk kernel writes the query's dtype")
    quantized = _pool_check(q.dtype, _meta(k_pool), _meta(v_pool), _meta(k_scale),
                            _meta(v_scale))
    mb = tables.shape[1]
    nb = pages_to_walk(width, bs, mb)
    out = torch.empty_like(q)
    stream = _stream(q.device)
    parts, per, acc_p, ml_p, cnt_p = 1, 1, None, None, None
    if mma:
        span = nb * bs if offset is None else min(max(int(offset), 0), nb * bs)
        groups = b * g * -(-(w * rep) // ROWS_PER_BLOCK)
        parts, per = chunk_parts(groups * tp, span)
        if parts > 1:
            # The partial accumulators [groups * parts, 64, D], then their
            # (m, l) pairs [groups * parts, 64, 2].
            n_acc = groups * parts * ROWS_PER_BLOCK * hd
            counters, scratch = _stream_buffers(
                q.device, stream, groups,
                n_acc + groups * parts * ROWS_PER_BLOCK * 2)
            acc_p = scratch.data_ptr()
            ml_p, cnt_p = acc_p + 4 * n_acc, counters.data_ptr()
    rc = _build.load().kfc_paged_chunk(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), tables.data_ptr(),
        None if pos is None else pos.data_ptr(), out.data_ptr(), acc_p, ml_p,
        cnt_p, b, w, g, rep, hd, bs, mb, nb, n_pages - 1, parts, per,
        0 if offset is None else int(offset),
        float(hd ** -0.5 if sm_scale is None else sm_scale),
        _DTYPE_CODES[q.dtype], int(quantized), stream)
    _raise_on(rc, "paged_chunk")
    LAUNCHES["paged_chunk"] += 1
    return out


# -- entry points -------------------------------------------------------------

def paged_attention_decode(
    q: torch.Tensor,               # [B, G, rep, D] post-rope query groups
    k_pool: torch.Tensor,          # [n_pages, bs, G, D] one layer's pool
    v_pool: torch.Tensor,
    tables: torch.Tensor,          # [B, mb] page ids (n_blocks = sentinel)
    pos: torch.Tensor,             # [B] column of this step's token
    *,
    k_scale: Optional[torch.Tensor] = None,   # [n_pages, bs, G] f32
    v_scale: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
    sm_scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
    tp: int = 1,
) -> torch.Tensor:
    """softmax(q·K/√d)·V over each slot's table-resolved pages, masked
    to columns ``<= pos[b]``; ``width`` caps the pages walked. Returns
    ``[B, G, rep, D]``.

    ``tp``: the G heads are one tp rank's share of ``tp * G`` (serving
    over a tp mesh). The tensor-core kernels then split each head's
    columns into the parts they would at ``tp * G`` heads, so that a
    head's reduction order, and its bits, are the same at any tp."""
    if q.device.type == "cpu":
        return paged_attention_decode_plain(
            q, k_pool, v_pool, tables, pos, k_scale=k_scale,
            v_scale=v_scale, width=width, sm_scale=sm_scale,
            out_dtype=out_dtype)
    return _decode_kernel(q, k_pool, v_pool, tables, pos, k_scale, v_scale,
                          width, sm_scale, out_dtype, tp)


def paged_attention_verify(
    q: torch.Tensor,               # [B, W, G, rep, D] post-rope window queries
    k_new: torch.Tensor,           # [B, W, G, D] the window's post-rope K
    v_new: torch.Tensor,
    k_pool: torch.Tensor,          # [n_pages, bs, G, D] one layer's pool
    v_pool: torch.Tensor,
    tables: torch.Tensor,          # [B, mb]
    pos: torch.Tensor,             # [B] each row's cached length
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
    sm_scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
    tp: int = 1,
) -> torch.Tensor:
    """Chunk attention for a batch of slots: each slot's W rows attend
    its cached columns ``< pos[b]`` plus the intra-window causal tile.
    Returns ``[B, W, G, rep, D]``. ``tp``: see
    :func:`paged_attention_decode`."""
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(
            q, k_new, v_new, k_pool, v_pool, tables, pos, k_scale=k_scale,
            v_scale=v_scale, width=width, sm_scale=sm_scale,
            out_dtype=out_dtype)
    return _chunk_kernel(q, k_new, v_new, k_pool, v_pool, tables, pos,
                         k_scale, v_scale, width, sm_scale, out_dtype, tp=tp)


def paged_attention_prefill(
    q: torch.Tensor,               # [W, G, rep, D] post-rope chunk queries
    k_new: torch.Tensor,           # [W, G, D] the chunk's post-rope K
    v_new: torch.Tensor,
    k_pool: torch.Tensor,          # [n_pages, bs, G, D] one layer's pool
    v_pool: torch.Tensor,
    table_row: torch.Tensor,       # [mb] the slot's page ids
    offset: int,                   # absolute chunk start position
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
    sm_scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
    tp: int = 1,
) -> torch.Tensor:
    """Chunk-prefill attention for ONE slot: W rows attend the slot's
    cached columns ``< offset`` plus the intra-chunk causal tile. The
    chunk's K/V scatter into the pool stays with the caller, after the
    layer. Returns ``[W, G, rep, D]``. On CUDA the kernel's grid is sized
    by the offset's live pages (a host integer: no device read). ``tp``:
    see :func:`paged_attention_decode`."""
    if q.device.type == "cpu":
        pos = torch.full((1,), int(offset), dtype=torch.int32)
        return paged_chunk_attention_plain(
            q[None], k_new[None], v_new[None], k_pool, v_pool,
            table_row[None], pos, k_scale=k_scale, v_scale=v_scale,
            width=width, sm_scale=sm_scale, out_dtype=out_dtype)[0]
    return _chunk_kernel(q[None], k_new[None], v_new[None], k_pool, v_pool,
                         table_row[None], None, k_scale, v_scale, width,
                         sm_scale, out_dtype, offset=int(offset), tp=tp)[0]
