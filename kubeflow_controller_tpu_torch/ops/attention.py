"""Multi-head attention dispatch, and the plain table gather.

Counterpart of ``kubeflow_controller_tpu/ops/attention.py``:

* :func:`mha` picks the flash kernels (``ops/flash_attention.py``) on
  CUDA when the JAX package's shape rule holds, and the dense
  :func:`mha_xla` path otherwise — on the CPU always, as the JAX
  package does off a TPU. ``mha_xla`` is also the oracle the flash path
  is held against.
* :func:`paged_kv_view` is the port's ``attn_impl="gather"`` serving
  path and the oracle the paged-attention kernels
  (``ops/paged_attention.py``) are held against.

Layouts are ``[batch, seq, heads, head_dim]`` ("BSHD") throughout.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from kubeflow_controller_tpu_torch.ops.flash_attention import (
    DEFAULT_BLOCK_Q, RopeTables, _choose_block, _repeat_kv, _rope_rot,
    flash_mha,
)


def mha_xla(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense attention: fp32 scores and softmax, ``-inf`` masks,
    probabilities cast to q's dtype before the value product. ``[B, S,
    H, D]`` in and out."""
    *_, h, d = q.shape
    kv_h = k.shape[2]
    if kv_h != h:
        k = _repeat_kv(k, h // kv_h)
        v = _repeat_kv(v, h // kv_h)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_len, k_len = logits.shape[-2], logits.shape[-1]
    if causal:
        mask = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~mask, float("-inf"))
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        logits = logits.masked_fill(~seg, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@functools.lru_cache(None)
def _flash_block_ok(s: int, has_segments: bool = False) -> bool:
    """True iff the sequence tiles into the JAX package's flash blocks of
    at least 128 (with segment ids, by its lane rule)."""
    try:
        return _choose_block(s, DEFAULT_BLOCK_Q, lane_aligned=has_segments) >= 128
    except ValueError:
        return False


def apply_rope_tables(x: torch.Tensor, rope_tables) -> torch.Tensor:
    """Rotate ``[B, S, H, D]`` by fused-rope tables in plain PyTorch —
    the rotation the flash kernels apply on load:
    ``x * C + roll(x, d/2) * S`` in fp32, cast back to x's dtype."""
    return _rope_rot(x, *rope_tables)


def mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    impl: str = "auto",
    rope_tables: RopeTables = None,
) -> torch.Tensor:
    """Attention entry point. ``impl``: auto|xla|flash.

    "auto" takes the flash kernels for bfloat16 CUDA tensors when the JAX
    package's shape rule holds (``q_len == k_len >= 256``, head_dim 64,
    128 or 256, a flash block of at least 128), and the dense path
    otherwise. q and k arrive un-rotated when ``rope_tables`` is given;
    each path applies the same rotation."""
    if impl == "auto":
        s = q.shape[1]
        use_flash = (
            q.is_cuda and q.dtype == torch.bfloat16
            and s == k.shape[1] and s >= 256
            and q.shape[3] in (64, 128, 256)
            and _flash_block_ok(s, segment_ids is not None)
        )
        impl = "flash" if use_flash else "xla"
    if impl == "flash":
        return flash_mha(q, k, v, causal=causal, segment_ids=segment_ids,
                         rope_tables=rope_tables)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (auto|xla|flash)")
    if rope_tables is not None:
        q = apply_rope_tables(q, rope_tables)
        k = apply_rope_tables(k, rope_tables)
    return mha_xla(q, k, v, causal=causal, segment_ids=segment_ids)


def paged_kv_view(
    pool: torch.Tensor,            # [*lead, n_blocks, bs, KVH, D]
    tables: torch.Tensor,          # [*T, mb] int page ids
    width: int,
    scale: Optional[torch.Tensor] = None,   # [*lead, n_blocks, bs, KVH]
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Gather ``[*lead, *T, width, KVH, D]``: the pages ``tables`` names,
    concatenated in table order and cut to ``width`` columns.

    * Only the ``ceil(width / bs)`` leading table entries are read: the
      occupancy cap bounds the gather, not just the slice.
    * Sentinel ids (``>= n_blocks``, the unallocated marker) clamp into
      the last page, as JAX's ``take(mode="clip")`` does; the finite
      garbage they read sits beyond every caller's position mask.
    * int8 pools (``scale`` given) dequantize in fp32 before the cast
      to ``out_dtype``.
    """
    *lead, n_blocks, bsz, kvh, d = pool.shape
    nlead = len(lead)
    nb = -(-width // bsz)
    if nb < tables.shape[-1]:
        tables = tables[..., :nb]
    mb = tables.shape[-1]
    t_lead = tuple(tables.shape[:-1])
    idx = tables.long().clamp(0, n_blocks - 1).reshape(-1)
    view = pool.index_select(nlead, idx).reshape(
        tuple(lead) + t_lead + (mb * bsz, kvh, d))[..., :width, :, :]
    if scale is not None:
        sv = scale.index_select(nlead, idx).reshape(
            tuple(lead) + t_lead + (mb * bsz, kvh))[..., :width, :]
        view = view.float() * sv.float()[..., None]
    if out_dtype is not None:
        view = view.to(out_dtype)
    return view
