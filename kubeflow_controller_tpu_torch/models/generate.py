"""Paged-KV decode, prefill and verify for the serving engine (one GPU).

Counterpart of ``kubeflow_controller_tpu/models/generate.py``, single
device (tp=1): the fused block prefill (:func:`prefill` into a
contiguous :class:`KVCache`, :func:`prefill_into_paged` into one slot's
pages), the paged decode step, the chunked prefill and the greedy
speculative verify step (:func:`verify_step_paged`). The pool's ``[L,
n_blocks, bs, KVH, D]`` pages are the only KV storage of the paged
paths; each slot reads and writes them through its row of the block
table (sentinel id ``n_blocks`` = unallocated).

Attention runs one of two ways (``attn_impl``):

* ``"kernel"`` (the default; the JAX engine's ``"pallas"``, accepted as
  an alias): the
  hand-written paged-attention kernels of ``ops/paged_attention.py`` on
  the card, their plain PyTorch versions on the CPU;
* ``"gather"`` (the JAX engine's ``"xla"`` oracle, accepted as an
  alias): gather the dense view
  with ``ops/attention.py:paged_kv_view`` and run a full-row softmax.

The block prefill is not paged: it runs ``ops/attention.py:mha`` over
the whole prompt (the flash kernels for bf16 CUDA prompts that tile,
the dense path otherwise), as the JAX package does.

Where JAX returns a new cache, the port writes the pool in place (it is
most of the device memory a server holds) and returns the same
:class:`PagedKVCache` object with ``length`` advanced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.models.transformer import (
    Params, TransformerConfig, rmsnorm, rope,
)
from kubeflow_controller_tpu_torch.ops import prng
from kubeflow_controller_tpu_torch.ops.attention import mha, paged_kv_view
from kubeflow_controller_tpu_torch.ops.flash_attention import rope_full_tables
from kubeflow_controller_tpu_torch.ops.paged_attention import (
    MASK_VALUE, paged_attention_decode, paged_attention_prefill,
    paged_attention_verify,
)

ATTN_IMPLS = ("kernel", "gather")
#: The JAX engine's names for the same two paths.
ATTN_IMPL_ALIASES = {"pallas": "kernel", "xla": "gather"}


def check_attn_impl(attn_impl: str) -> str:
    """The port's name of ``attn_impl`` (``"pallas"`` is ``"kernel"``,
    ``"xla"`` is ``"gather"``); raises on any other name."""
    attn_impl = ATTN_IMPL_ALIASES.get(attn_impl, attn_impl)
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(
            f"attn_impl must be 'kernel' ('pallas') or 'gather' ('xla') "
            f"(got {attn_impl!r})")
    return attn_impl


def inference_params(
    cfg: TransformerConfig, params: Params, quant: str = "",
) -> Params:
    """Prepare master weights for serving: fp32 tensors cast to the
    compute dtype (others kept), detached from any autograd graph (a
    training loop's parameters require gradients; serving writes them
    into the KV pool in place). ``quant="int8"`` (weight-only int8) is
    not yet ported."""
    if quant:
        raise NotImplementedError(
            f"quant={quant!r} (weight-only int8 serving) is not yet ported")

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        x = x.detach()
        return x.to(cfg.dtype) if x.dtype == torch.float32 else x

    return cast(params)


def _w(lp: Params, name: str, dt: torch.dtype) -> torch.Tensor:
    """A projection weight in the compute dtype."""
    return lp[name].to(dt)


def _head_logits(cfg: TransformerConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """Final-norm'd hidden [B, D] -> fp32 logits [B, vocab]."""
    if params.get("lm_head") is None:
        head = params["embed"].to(cfg.dtype).T
    else:
        head = _w(params, "lm_head", cfg.dtype)
    return (x @ head).float()


# -- the paged pool -----------------------------------------------------------

@dataclass
class PagedKVCache:
    """Block-table-indexed KV for continuous batching.

    ``tables[slot, i]`` is the pool page backing the slot's logical
    columns ``[i*bs, (i+1)*bs)``, or the sentinel ``n_blocks``. int8
    pools carry per-(page row, head) fp32 scales; fp pools carry None.
    """

    k: torch.Tensor                  # [L, n_blocks, bs, KVH, D] dtype | int8
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # [L, n_blocks, bs, KVH] f32 | None
    v_scale: Optional[torch.Tensor]
    tables: torch.Tensor             # [B, max_blocks] int32
    length: torch.Tensor             # [B] int32 valid positions per slot
    active: torch.Tensor             # [B] bool slot is decoding


def init_paged_cache(
    cfg: TransformerConfig, n_slots: int, max_blocks: int, n_blocks: int,
    block_size: int, kv_quant: str = "", device: DeviceLike = None,
) -> PagedKVCache:
    """A zeroed pool of exactly ``n_blocks`` pages (no spare sentinel
    page) plus all-sentinel tables for ``n_slots`` slots."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    if kv_quant == "int8":
        k = torch.zeros(shape, dtype=torch.int8, device=dev)
        v = torch.zeros(shape, dtype=torch.int8, device=dev)
        k_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        v_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    elif kv_quant:
        raise ValueError(f"unknown kv_quant {kv_quant!r} (want '' or 'int8')")
    else:
        k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        k_scale = v_scale = None
    return PagedKVCache(
        k=k, v=v, k_scale=k_scale, v_scale=v_scale,
        tables=torch.full((n_slots, max_blocks), n_blocks,
                          dtype=torch.int32, device=dev),
        length=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        active=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
    )


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with per-(token, head) scales over head_dim
    (``[..., KVH, D] -> int8 same shape + f32 [..., KVH]``). Rounds half
    to even and DIVIDES by the scale, as the JAX package does: a
    multiply by the reciprocal would change some codes."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _pool_write(pool: torch.Tensor, scale: Optional[torch.Tensor],
                layer: Optional[int], blk: torch.Tensor, off: torch.Tensor,
                val: torch.Tensor, valid: torch.Tensor) -> None:
    """Write rows of ``val`` into the pool at page ``blk[i]``, page row
    ``off[i]`` — of one ``layer`` (val ``[N, KVH, D]``), or of every
    layer when ``layer`` is None (val ``[L, N, KVH, D]``) — quantizing
    on write for int8 pools. Rows with ``valid[i]`` False are DROPPED,
    as JAX's ``.at[...].set(mode="drop")`` drops sentinel and
    out-of-span ids.

    PyTorch has no dropping scatter, and selecting the valid rows would
    stop the host until the device catches up. So every row writes, and
    a dropped row is aimed at a location whose final bytes it cannot
    change: the first valid row's location with that row's value, or,
    when no row is valid, its own (clamped) location with the bytes
    already there. Duplicate writes then carry identical bytes, and the
    result does not depend on which one lands last."""
    n_blocks = pool.shape[1]
    n = blk.shape[0]
    blk = blk.long().clamp(0, n_blocks - 1)
    off = off.long()
    rows = torch.arange(n, device=blk.device)
    first = torch.argmax(valid.to(torch.int32))    # first valid row, or 0
    any_valid = valid.any()
    src = torch.where(valid | ~any_valid, rows, first)
    t_blk, t_off = blk[src], off[src]
    if scale is None:
        vals = [(pool, val.to(pool.dtype))]
    else:
        q, s = _kv_quantize(val)
        vals = [(pool, q), (scale, s)]
    for dst, v in vals:
        if layer is None:
            new, old = v[:, src], dst[:, t_blk, t_off]
            dst[:, t_blk, t_off] = torch.where(any_valid, new, old)
        else:
            new, old = v[src], dst[layer, t_blk, t_off]
            dst[layer, t_blk, t_off] = torch.where(any_valid, new, old)


def _occupancy_cap(width: int, view_width: Optional[int]) -> int:
    """The engine's occupancy cap on a slot's page span: the live view
    width, never past the table's full span. One definition for both
    phases and both attention impls."""
    return width if view_width is None else min(view_width, width)


def _capped_kv_views(k_pool, v_pool, tables, width, view_width, k_scale,
                     v_scale, out_dtype):
    """The dense K/V view pair the gather path reads, at the capped
    width, int8 scales applied at gather time."""
    vw = _occupancy_cap(width, view_width)
    k = paged_kv_view(k_pool, tables, vw, scale=k_scale, out_dtype=out_dtype)
    v = paged_kv_view(v_pool, tables, vw, scale=v_scale, out_dtype=out_dtype)
    return k, v


def _layer_params(params: Params, layer: int) -> Params:
    return {k: v[layer] for k, v in params["layers"].items()}


def _ffn(lp: Params, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    gate = F.silu(h @ _w(lp, "w_gate", dt))
    up = h @ _w(lp, "w_up", dt)
    return (gate * up) @ _w(lp, "w_down", dt)


# -- fused block prefill --------------------------------------------------------

@dataclass
class KVCache:
    """A contiguous cache: every row at the same ``length``."""

    k: torch.Tensor          # [L, B, max_seq, KVH, D]
    v: torch.Tensor
    length: int              # valid positions


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  device: DeviceLike = None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=0)


def _block_prefill(
    cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ONE forward pass over the whole prompt ``[B, S]`` from position 0:
    the last position's fp32 logits ``[B, vocab]`` and every layer's K
    (rotated, as the cache keeps it) and V, ``[L, B, S, KVH, D]``.

    Attention runs through :func:`mha` with ``impl="auto"`` (``"xla"``
    when ``cfg.attn_impl == "xla"``): the flash kernels where the JAX
    package's shape rule holds, the dense path on other prompt lengths.
    q and k enter un-rotated with rope tables shared by every layer."""
    b, s = prompt.shape
    dt = cfg.dtype
    hd = cfg.head_dim
    x = params["embed"].to(dt)[prompt.long()]             # [B, S, D]
    positions = torch.arange(s, dtype=torch.int32,
                             device=prompt.device).expand(b, s)
    attn_impl = "xla" if cfg.attn_impl == "xla" else "auto"
    tables = rope_full_tables(positions, hd, cfg.rope_theta)
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ _w(lp, "wq", dt)).reshape(b, s, cfg.n_heads, hd)
        k = (h @ _w(lp, "wk", dt)).reshape(b, s, cfg.n_kv_heads, hd)
        v = (h @ _w(lp, "wv", dt)).reshape(b, s, cfg.n_kv_heads, hd)
        attn = mha(q, k, v, causal=True, impl=attn_impl, rope_tables=tables)
        ks.append(rope(k, positions, cfg.rope_theta))   # rotated for the cache
        vs.append(v)
        x = x + attn.reshape(b, s, -1) @ _w(lp, "wo", dt)
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lp, h2, dt)
    x = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _head_logits(cfg, params, x), torch.stack(ks), torch.stack(vs)


def prefill(
    cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """Fused block prefill into a FRESH cache: one forward over the
    whole prompt ``[B, S]`` (not S decode steps) fills positions
    ``[0, S)``. Returns the last position's fp32 logits ``[B, vocab]``
    and the cache (written in place) with ``length = S``."""
    s = prompt.shape[1]
    if s > cache.k.shape[2]:
        raise ValueError(f"prompt {s} exceeds cache capacity {cache.k.shape[2]}")
    logits, ks, vs = _block_prefill(cfg, params, prompt)
    cache.k[:, :, :s] = ks.to(cache.k.dtype)
    cache.v[:, :, :s] = vs.to(cache.v.dtype)
    cache.length = s
    return logits, cache


# -- decode -------------------------------------------------------------------

def _decode_layer_paged(
    cfg: TransformerConfig, lp: Params, x: torch.Tensor, pos: torch.Tensor,
    layer: int, cache: PagedKVCache, view_width: Optional[int],
    attn_impl: str,
) -> torch.Tensor:
    """One decoder layer for every slot at its own position: row b's new
    k/v land in page ``tables[b, pos[b] // bs]`` at row ``pos[b] % bs``
    (inactive rows and sentinel pages drop the write), THEN the slot
    attends its pages with the mask ``c <= pos[b]``."""
    b = x.shape[0]
    hd = cfg.head_dim
    dt = cfg.dtype
    n_blocks, bs = cache.k.shape[1], cache.k.shape[2]
    mb = cache.tables.shape[1]
    width = mb * bs
    vw = _occupancy_cap(width, view_width)
    g = cfg.n_kv_heads
    rep = cfg.n_heads // g

    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ _w(lp, "wq", dt)).reshape(b, 1, g * rep, hd)
    k = (h @ _w(lp, "wk", dt)).reshape(b, 1, g, hd)
    v = (h @ _w(lp, "wv", dt)).reshape(b, 1, g, hd)
    positions = pos[:, None]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qg = q.reshape(b, 1, g, rep, hd)
    bi = (pos // bs).clamp(0, mb - 1).long()
    blk = cache.tables.gather(1, bi[:, None])[:, 0]
    # Inactive rows drop their write: a retired slot's table row stays on
    # the device until the host's next push, and its pages may already
    # belong to another slot.
    valid = cache.active & (pos < width) & (blk < n_blocks)
    off = pos % bs
    _pool_write(cache.k, cache.k_scale, layer, blk, off, k[:, 0], valid)
    _pool_write(cache.v, cache.v_scale, layer, blk, off, v[:, 0], valid)
    k_scale = None if cache.k_scale is None else cache.k_scale[layer]
    v_scale = None if cache.v_scale is None else cache.v_scale[layer]
    if attn_impl == "kernel":
        attn = paged_attention_decode(
            qg[:, 0], cache.k[layer], cache.v[layer], cache.tables, pos,
            k_scale=k_scale, v_scale=v_scale, width=vw,
            sm_scale=hd ** -0.5, out_dtype=dt)[:, None]   # [B, 1, G, rep, D]
    else:
        k_cache, v_cache = _capped_kv_views(
            cache.k[layer], cache.v[layer], cache.tables, width, view_width,
            k_scale, v_scale, dt)                        # [B, vw, G, D]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                         k_cache.float()) * (hd ** -0.5)
        visible = (torch.arange(vw, device=x.device)[None, :]
                   <= pos[:, None])                      # [B, vw]
        s = torch.where(visible[:, None, None, None, :], s, MASK_VALUE)
        p = torch.softmax(s, dim=-1).to(dt)
        attn = torch.einsum("bgrqk,bkgd->bqgrd", p, v_cache)
    x = x + attn.reshape(b, 1, -1) @ _w(lp, "wo", dt)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _ffn(lp, h, dt)


def decode_step_paged(
    cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
    cache: PagedKVCache, view_width: Optional[int] = None,
    attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, PagedKVCache]:
    """One token for every slot at its own position (``tokens`` [B, 1]).
    Returns fp32 logits [B, vocab] and the cache, whose pool took the new
    k/v in place and whose ``length`` advanced on active slots only.
    ``view_width`` caps the pages attention walks to the engine's live
    occupancy; writes still guard against the full table span."""
    attn_impl = check_attn_impl(attn_impl)
    x = params["embed"].to(cfg.dtype)[tokens.long()]      # [B, 1, D]
    pos = cache.length
    for layer in range(cfg.n_layers):
        x = _decode_layer_paged(cfg, _layer_params(params, layer), x, pos,
                                layer, cache, view_width, attn_impl)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _head_logits(cfg, params, x[:, 0])
    cache.length = torch.where(cache.active, pos + 1, pos)
    return logits, cache


# -- chunked prefill ------------------------------------------------------------

def prefill_chunk_paged(
    cfg: TransformerConfig, params: Params, toks: torch.Tensor,
    cache: PagedKVCache, slot: int, offset: int, n_real: int,
    view_width: Optional[int] = None, attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, PagedKVCache]:
    """One prefill chunk of ONE slot: ``toks`` [1, W] (padded to W, the
    first ``n_real`` real) at absolute positions ``offset + [0, W)``.

    Every layer attends the slot's cached columns ``< offset`` plus the
    chunk's own fresh K/V as a causal tile; the chunk's K/V scatter into
    the slot's pages only after ALL layers (pad columns past the table
    span or on sentinel entries drop). Returns the last real position's
    fp32 logits [1, vocab] and the cache with ``length[slot] = offset +
    n_real``."""
    attn_impl = check_attn_impl(attn_impl)
    if toks.shape[0] != 1:
        raise ValueError(
            f"prefill_chunk_paged refused this call:\n  - toks must carry "
            f"exactly ONE request row — chunked prefill advances a single "
            f"slot per dispatch (got batch {toks.shape[0]})")
    b, w = toks.shape
    dt = cfg.dtype
    hd = cfg.head_dim
    n_blocks, bs = cache.k.shape[1], cache.k.shape[2]
    mb = cache.tables.shape[1]
    width = mb * bs
    vw = _occupancy_cap(width, view_width)
    g = cfg.n_kv_heads
    rep = cfg.n_heads // g
    dev = toks.device
    trow = cache.tables[slot]                              # [mb]
    if attn_impl == "gather":
        kc_all, vc_all = _capped_kv_views(
            cache.k, cache.v, trow, width, view_width, cache.k_scale,
            cache.v_scale, dt)                             # [L, vw, G, D]
        cache_visible = torch.arange(vw, device=dev) < offset
        causal = torch.ones((w, w), dtype=torch.bool, device=dev).tril()

    x = params["embed"].to(dt)[toks.long()]                # [1, W, D]
    positions = offset + torch.arange(w, dtype=torch.int32, device=dev)[None]
    scale = hd ** -0.5
    k_rows, v_rows = [], []
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ _w(lp, "wq", dt)).reshape(b, w, g * rep, hd)
        k = (h @ _w(lp, "wk", dt)).reshape(b, w, g, hd)
        v = (h @ _w(lp, "wv", dt)).reshape(b, w, g, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        qg = q.reshape(b, w, g, rep, hd)
        if attn_impl == "kernel":
            attn = paged_attention_prefill(
                qg[0], k[0], v[0], cache.k[layer], cache.v[layer], trow,
                offset,
                k_scale=None if cache.k_scale is None else cache.k_scale[layer],
                v_scale=None if cache.v_scale is None else cache.v_scale[layer],
                width=vw, sm_scale=scale, out_dtype=dt)[None]
        else:
            kc, vc = kc_all[layer], vc_all[layer]
            s_cache = torch.einsum("bqgrd,kgd->bgrqk", qg.float(),
                                   kc.float()) * scale     # [1,G,rep,W,vw]
            s_cache = torch.where(cache_visible, s_cache, MASK_VALUE)
            s_new = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                 k.float()) * scale        # [1,G,rep,W,W]
            s_new = torch.where(causal, s_new, MASK_VALUE)
            p = torch.softmax(torch.cat([s_cache, s_new], -1), -1).to(dt)
            attn = (torch.einsum("bgrqk,kgd->bqgrd", p[..., :vw], vc)
                    + torch.einsum("bgrqk,bkgd->bqgrd", p[..., vw:], v))
        x = x + attn.reshape(b, w, -1) @ _w(lp, "wo", dt)
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lp, h2, dt)
        k_rows.append(k[0])
        v_rows.append(v[0])

    # Scatter the chunk's k/v at absolute columns offset + [0, W).
    wcols = offset + torch.arange(w, device=dev)
    blk = trow[(wcols // bs).clamp(0, mb - 1)]
    valid = (wcols < width) & (blk < n_blocks)
    woff = wcols % bs
    _pool_write(cache.k, cache.k_scale, None, blk, woff,
                torch.stack(k_rows), valid)
    _pool_write(cache.v, cache.v_scale, None, blk, woff,
                torch.stack(v_rows), valid)
    x_last = x[:, n_real - 1]
    logits = _head_logits(
        cfg, params, rmsnorm(x_last, params["final_norm"], cfg.norm_eps))
    cache.length[slot] = offset + n_real
    return logits, cache


def prefill_into_paged(
    cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
    cache: PagedKVCache, slot: int,
) -> Tuple[torch.Tensor, PagedKVCache]:
    """Block-prefill ONE request's prompt ``[1, S]`` (the fused forward
    of :func:`prefill`: the same logits and KV bytes) and scatter its S
    positions into the pages of slot ``slot``'s table row, quantizing on
    write for int8 pools. Sets ``length[slot] = S`` and ``active[slot] =
    True``; every other slot's pages are untouched. Returns the last
    position's fp32 logits ``[1, vocab]`` and the cache."""
    if prompt.shape[0] != 1:
        raise ValueError(
            f"prefill_into_paged admits one request (got batch "
            f"{prompt.shape[0]})")
    n_blocks, bs = cache.k.shape[1], cache.k.shape[2]
    mb = cache.tables.shape[1]
    s = prompt.shape[1]
    if s > mb * bs:
        raise ValueError(f"prompt {s} exceeds slot capacity {mb * bs}")
    logits, ks, vs = _block_prefill(cfg, params, prompt)
    trow = cache.tables[slot]
    cols = torch.arange(s, device=prompt.device)
    blk = trow[(cols // bs).clamp(0, mb - 1)]
    off = cols % bs
    valid = blk < n_blocks                       # sentinel entries drop
    _pool_write(cache.k, cache.k_scale, None, blk, off, ks[:, 0], valid)
    _pool_write(cache.v, cache.v_scale, None, blk, off, vs[:, 0], valid)
    cache.length[slot] = s
    cache.active[slot] = True
    return logits, cache


# -- speculative verify ---------------------------------------------------

def verify_step_paged(
    cfg: TransformerConfig, params: Params,
    draft: torch.Tensor,        # [B, K] int32 proposed continuations
    draft_len: torch.Tensor,    # [B] int32 in [0, K] valid drafts a row
    logits: torch.Tensor,       # [B, vocab] carried last-position logits
    cache: PagedKVCache,
    eos: torch.Tensor,          # [B] int32 EOS id a row (-1 = none)
    max_commit: torch.Tensor,   # [B] int32 commit cap, >= 1
    view_width: Optional[int] = None,
    attn_impl: str = "kernel",
    sampling: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Verify every slot's window ``[t0 = argmax(logits), draft]`` (W =
    K + 1 positions from ``length[b]``) in ONE forward over the slot's
    pages, and commit the longest argmax-consistent run.

    ``sampling`` (``(temperature, top_k, top_p, seed, gen, pos)``, each
    ``[B]``; see :func:`verify_step_paged_sampled`) draws t0 and the
    per-position predictions instead of taking argmaxes, and adds the
    next committed token to the result.

    Acceptance is the JAX package's: the cumulative prefix of draft
    tokens equal to the previous position's argmax, capped by
    ``draft_len``; ``n = min(1 + accepted, max(max_commit, 1))``; cut
    just after the window's first EOS; ``n = 0`` on inactive rows. Only
    the accepted positions' K/V reach the pool (rejected and padded
    positions drop — rollback is never committing), ``length += n``, and
    the new logits are those at window position ``n - 1``.

    Attention: ``"kernel"`` is ``paged_attention_verify`` (on the card
    the chunk kernel, B6's verify entry), ``"gather"`` the gathered-view
    oracle. Returns ``(window [B, W], n [B], new_logits [B, vocab],
    cache)``; the pool is written in place."""
    attn_impl = check_attn_impl(attn_impl)
    b, k_draft = draft.shape
    w = k_draft + 1
    dt = cfg.dtype
    hd = cfg.head_dim
    n_blocks, bs = cache.k.shape[1], cache.k.shape[2]
    mb = cache.tables.shape[1]
    width = mb * bs
    vw = _occupancy_cap(width, view_width)
    g = cfg.n_kv_heads
    rep = cfg.n_heads // g
    dev = draft.device
    pos0 = cache.length                                    # [B]
    if sampling is None:
        t0 = logits.argmax(-1).to(torch.int32)
    else:
        # Sampled rows draw t0 under the key of the next stream position;
        # greedy rows take the argmax inside sample_step_slots.
        s_temp, s_topk, s_topp, s_seed, s_gen, s_pos = sampling
        t0 = sample_step_slots(logits, s_temp, s_topk, s_topp, s_seed,
                               s_gen, s_pos)
    window = torch.cat([t0[:, None], draft.to(torch.int32)], 1)   # [B, W]
    x = params["embed"].to(dt)[window.long()]              # [B, W, D]
    arange_w = torch.arange(w, dtype=torch.int32, device=dev)
    positions = pos0[:, None] + arange_w[None, :]
    scale = hd ** -0.5
    if attn_impl == "gather":
        kview, vview = _capped_kv_views(
            cache.k, cache.v, cache.tables, width, view_width, cache.k_scale,
            cache.v_scale, dt)                             # [L, B, vw, G, D]
        cache_visible = (torch.arange(vw, device=dev)[None, :]
                         < pos0[:, None])[:, None, None, None, :]
        causal = arange_w[:, None] >= arange_w[None, :]    # [W, W]
    k_rows, v_rows = [], []
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ _w(lp, "wq", dt)).reshape(b, w, g * rep, hd)
        k = (h @ _w(lp, "wk", dt)).reshape(b, w, g, hd)
        v = (h @ _w(lp, "wv", dt)).reshape(b, w, g, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        qg = q.reshape(b, w, g, rep, hd)
        if attn_impl == "kernel":
            attn = paged_attention_verify(
                qg, k, v, cache.k[layer], cache.v[layer], cache.tables, pos0,
                k_scale=None if cache.k_scale is None else cache.k_scale[layer],
                v_scale=None if cache.v_scale is None else cache.v_scale[layer],
                width=vw, sm_scale=scale, out_dtype=dt)    # [B, W, G, rep, D]
        else:
            kc, vc = kview[layer], vview[layer]
            s_cache = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                   kc.float()) * scale     # [B,G,rep,W,vw]
            s_cache = torch.where(cache_visible, s_cache, MASK_VALUE)
            s_new = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                 k.float()) * scale        # [B,G,rep,W,W]
            s_new = torch.where(causal, s_new, MASK_VALUE)
            p = torch.softmax(torch.cat([s_cache, s_new], -1), -1).to(dt)
            attn = (torch.einsum("bgrqk,bkgd->bqgrd", p[..., :vw], vc)
                    + torch.einsum("bgrqk,bkgd->bqgrd", p[..., vw:], v))
        x = x + attn.reshape(b, w, -1) @ _w(lp, "wo", dt)
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lp, h2, dt)
        k_rows.append(k)
        v_rows.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    all_logits = _head_logits(cfg, params, x)              # [B, W, vocab]

    preds = all_logits.argmax(-1).to(torch.int32)          # [B, W]
    if sampling is not None:
        # Speculative sampling with a point-mass draft: sample the
        # filtered target at each window position under that position's
        # key and accept a draft token iff it equals the sample; on a
        # rejection the sample is the correction, carried as next_tok.
        pred_pos = s_pos[:, None] + 1 + arange_w[None, :]
        sampled_preds = _sample_rows_2d(
            all_logits, s_temp, s_topk, s_topp, s_seed, s_gen, pred_pos)
        preds = torch.where((s_temp > 0.0)[:, None], sampled_preds, preds)
    ok = ((window[:, 1:] == preds[:, :-1])
          & (arange_w[None, :k_draft] < draft_len[:, None]))
    acc = torch.cumprod(ok.to(torch.int32), 1).sum(1)
    n = 1 + acc                                            # [B], 1..K+1
    n = torch.minimum(n, max_commit.clamp_min(1))
    is_eos = (window == eos[:, None]) & (eos[:, None] >= 0)
    eos_pos = torch.argmax(is_eos.to(torch.int32), 1)      # first EOS, or 0
    n = torch.where(is_eos.any(1) & (eos_pos < n), eos_pos + 1, n)
    n = torch.where(cache.active, n, 0).to(torch.int32)

    # Commit the accepted positions only: columns length + [0, n) through
    # the slot's table; rejected, padded and inactive positions drop.
    wcols = positions.long()                               # [B, W]
    commit = arange_w[None, :] < n[:, None]
    blk = cache.tables.gather(1, (wcols // bs).clamp(0, mb - 1))
    valid = (commit & (wcols < width) & (blk < n_blocks)).reshape(-1)
    blk, woff = blk.reshape(-1), (wcols % bs).reshape(-1)
    _pool_write(cache.k, cache.k_scale, None, blk, woff,
                torch.stack(k_rows).reshape(cfg.n_layers, b * w, g, hd), valid)
    _pool_write(cache.v, cache.v_scale, None, blk, woff,
                torch.stack(v_rows).reshape(cfg.n_layers, b * w, g, hd), valid)
    idx = (n.long() - 1).clamp(0, k_draft)
    rows = torch.arange(b, device=dev)
    new_logits = all_logits[rows, idx]
    cache.length = pos0 + n
    if sampling is None:
        return window, n, new_logits, cache
    # preds[n - 1] is the draw at stream position pos + n: the next
    # quantum's first sample from new_logits (its argmax on greedy rows).
    return window, n, preds[rows, idx], new_logits, cache


def verify_step_paged_sampled(
    cfg: TransformerConfig, params: Params,
    draft: torch.Tensor,        # [B, K] int32 proposed continuations
    draft_len: torch.Tensor,    # [B] int32 in [0, K] valid drafts a row
    logits: torch.Tensor,       # [B, vocab] carried last-position logits
    cache: PagedKVCache,
    eos: torch.Tensor,          # [B] int32 EOS id a row (-1 = none)
    max_commit: torch.Tensor,   # [B] int32 commit cap, >= 1
    temperature: torch.Tensor,  # [B] f32, <= 0 rows verify greedily
    top_k: torch.Tensor,        # [B] int32
    top_p: torch.Tensor,        # [B] f32
    seed: torch.Tensor,         # [B] int32
    gen: torch.Tensor,          # [B] int32
    pos: torch.Tensor,          # [B] int32 tokens emitted a row
    view_width: Optional[int] = None,
    attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           PagedKVCache]:
    """:func:`verify_step_paged` with per-row sampling: the speculative
    sampling rule for a deterministic draft (accept-with-probability
    ``min(1, p/q)`` for a point-mass ``q`` is "sample the filtered
    target; accept while it equals the draft", and the sample at the
    rejected position is the residual correction). Greedy rows keep the
    argmax-equality rule with the same bits. Keys are
    :func:`_sample_keys`', so acceptance does not depend on the batch.
    Returns ``(window, n, next_tok, new_logits, cache)``: ``next_tok`` is
    the draw the next quantum makes first. One device only (the JAX
    engine's tp > 1 path is not ported)."""
    return verify_step_paged(
        cfg, params, draft, draft_len, logits, cache, eos, max_commit,
        view_width=view_width, attn_impl=attn_impl,
        sampling=(temperature, top_k, top_p, seed, gen, pos))


# -- batched sampling: per-row filters, counter-based per-request keys ---------

def generation_keys(seed: torch.Tensor, gen: torch.Tensor) -> prng.Key:
    """Each generation's key ``fold_in(PRNGKey(seed), gen)``: a function
    of the request's lane alone, so the engine computes it on the host
    when a lane changes."""
    return prng.fold_in(prng.prng_key(seed), gen)


def _sample_keys(seed: torch.Tensor, gen: torch.Tensor,
                 pos: torch.Tensor) -> prng.Key:
    """Per-row keys ``fold_in(fold_in(PRNGKey(seed), gen), pos)``: a
    function of (request seed, generation index, position in the
    generated stream) only, never of the step, the slot or the batch."""
    return prng.fold_in(generation_keys(seed, gen), pos)


def _filter_logits_rows(
    logits: torch.Tensor,       # [B, vocab]
    temperature: torch.Tensor,  # [B] f32, <= 0 rows pass through (greedy)
    top_k: torch.Tensor,        # [B] int32, 0 disables
    top_p: torch.Tensor,        # [B] f32, >= 1 disables
) -> torch.Tensor:
    """Per-row temperature, top-k and top-p, the JAX package's op
    sequence and tie handling (``scaled < kth`` and ``scaled < thresh``
    go to ``-inf``; ties with the cut survive). A row whose knob is off
    passes through that filter bitwise.

    One sort serves both filters: the top-k cut maps the descending
    values to themselves with a ``-inf`` tail, which is exactly the sort
    of the top-k-filtered row that the JAX package sorts again. The
    softmax and the cumulative sum sum in another order than XLA's, so
    the top-p cut can move only on a row whose cumulative mass lies
    within a few ulps of ``top_p``."""
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    v = scaled.shape[-1]
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    sorted_desc = torch.sort(scaled, -1, descending=True).values
    kth = sorted_desc.gather(
        -1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    on_k = (top_k > 0)[:, None]
    scaled = torch.where(on_k & (scaled < kth), neg_inf, scaled)
    sorted2 = torch.where(on_k & (sorted_desc < kth), neg_inf, sorted_desc)
    e = torch.exp(sorted2 - sorted2[:, :1])
    cum = torch.cumsum(e / e.sum(-1, keepdim=True), -1)
    keep_sorted = torch.cat(
        [torch.ones_like(cum[:, :1], dtype=torch.bool),
         cum[:, :-1] < top_p[:, None]], -1)
    thresh = torch.where(keep_sorted, sorted2,
                         torch.tensor(float("inf"), device=logits.device)
                         ).amin(-1, keepdim=True)
    return torch.where((top_p < 1.0)[:, None] & (scaled < thresh),
                       neg_inf, scaled)


def sampling_noise(gen_key: prng.Key, pos: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """The Gumbel noise of each row's draw at ``pos`` under its
    generation key (:func:`generation_keys`, broadcast against pos):
    ``[..., vocab]`` float32. It depends on the key alone, so the engine
    draws a whole chunk's noise in one call."""
    return prng.gumbel_rows(prng.fold_in(gen_key, pos), vocab)


def sample_with_noise(
    logits: torch.Tensor,       # [B, vocab]
    temperature: torch.Tensor,  # [B] f32, <= 0 means greedy for that row
    top_k: torch.Tensor,        # [B] int32
    top_p: torch.Tensor,        # [B] f32
    noise: torch.Tensor,        # [B, vocab] from :func:`sampling_noise`
    mask: Optional[torch.Tensor] = None,   # [B, vocab] bool, True = allowed
) -> torch.Tensor:
    """:func:`sample_step_slots` given each row's Gumbel noise."""
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.tensor(float("-inf"), device=logits.device))
    greedy = logits.argmax(-1)
    filtered = _filter_logits_rows(logits, temperature, top_k, top_p)
    sampled = torch.argmax(noise + filtered, -1)
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)


def sample_step_slots(
    logits: torch.Tensor,       # [B, vocab]
    temperature: torch.Tensor,  # [B] f32, <= 0 means greedy for that row
    top_k: torch.Tensor,        # [B] int32
    top_p: torch.Tensor,        # [B] f32
    seed: torch.Tensor,         # [B] int32 per-request seed
    gen: torch.Tensor,          # [B] int32 generation index
    pos: torch.Tensor,          # [B] int32 position in the generated stream
    mask: Optional[torch.Tensor] = None,   # [B, vocab] bool, True = allowed
) -> torch.Tensor:
    """One token a slot. Greedy rows (``temperature <= 0``) take the
    argmax the greedy engine takes (the first maximum; the same bits), so
    sampled traffic in a batch never moves a greedy row. Sampled rows
    draw ``categorical`` from their filtered logits under the key of
    :func:`_sample_keys`. ``mask`` sends disallowed tokens to ``-inf``
    before both; an all-True row changes nothing."""
    return sample_with_noise(
        logits, temperature, top_k, top_p,
        sampling_noise(generation_keys(seed, gen), pos, logits.shape[-1]),
        mask)


def _sample_rows_2d(
    all_logits: torch.Tensor,   # [B, W, vocab]
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,        # [B]
    top_p: torch.Tensor,        # [B]
    seed: torch.Tensor,         # [B]
    gen: torch.Tensor,          # [B]
    pos: torch.Tensor,          # [B, W] stream position of each column
) -> torch.Tensor:
    """:func:`sample_step_slots` over a ``[B, W]`` window (no mask): each
    position draws under its own key, so the draw at stream position p is
    the draw plain decode would make there."""
    b, w, v = all_logits.shape
    rep = lambda x: x.repeat_interleave(w)  # noqa: E731
    return sample_step_slots(
        all_logits.reshape(b * w, v), rep(temperature), rep(top_k),
        rep(top_p), rep(seed), rep(gen), pos.reshape(-1)).reshape(b, w)


# -- copy-on-write page copy ---------------------------------------------------

def copy_pool_pages(cache: PagedKVCache, src_ids, dst_ids) -> PagedKVCache:
    """Copy whole pool pages ``src -> dst`` in place, on the device: the
    copy-on-write of ``n > 1`` forks. int8 pools copy the int8 payload
    and its scales verbatim (no requantization), so a copied page is the
    bytes of its source. A sentinel (``>= n_blocks``) destination drops
    its write; a sentinel source reads the last page, as JAX's clamped
    gather does."""
    n_blocks = cache.k.shape[1]
    pairs = [(min(int(s), n_blocks - 1), int(d))
             for s, d in zip(src_ids, dst_ids) if 0 <= int(d) < n_blocks]
    if not pairs:
        return cache
    dev = cache.k.device
    src = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=dev)
    dst = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=dev)
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if t is not None:
            t[:, dst] = t[:, src]
    return cache
