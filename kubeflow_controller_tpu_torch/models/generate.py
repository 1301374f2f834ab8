"""Paged-KV decode and chunked prefill for the serving engine (one GPU).

Counterpart of the paged half of ``kubeflow_controller_tpu/models/
generate.py``, single device (tp=1). The pool's ``[L, n_blocks, bs,
KVH, D]`` pages are the only KV storage; each slot reads and writes them
through its row of the block table (sentinel id ``n_blocks`` =
unallocated).

Attention runs one of two ways (``attn_impl``):

* ``"kernel"`` (the default; the JAX engine's ``"pallas"``, accepted as
  an alias): the
  hand-written paged-attention kernels of ``ops/paged_attention.py`` on
  the card, their plain PyTorch versions on the CPU;
* ``"gather"`` (the JAX engine's ``"xla"`` oracle, accepted as an
  alias): gather the dense view
  with ``ops/attention.py:paged_kv_view`` and run a full-row softmax.

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
from kubeflow_controller_tpu_torch.ops.attention import paged_kv_view
from kubeflow_controller_tpu_torch.ops.paged_attention import (
    MASK_VALUE, paged_attention_decode, paged_attention_prefill,
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
    compute dtype (others kept). ``quant="int8"`` (weight-only int8)
    is not yet ported."""
    if quant:
        raise NotImplementedError(
            f"quant={quant!r} (weight-only int8 serving) is not yet ported")

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
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
