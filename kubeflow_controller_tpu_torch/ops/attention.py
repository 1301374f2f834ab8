"""The plain table gather: a dense KV view out of the paged pool.

Counterpart of ``kubeflow_controller_tpu/ops/attention.py:paged_kv_view``.
This is the port's ``attn_impl="gather"`` path and the oracle the
paged-attention kernels (``ops/paged_attention.py``) are held against.
"""

from __future__ import annotations

from typing import Optional

import torch


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
