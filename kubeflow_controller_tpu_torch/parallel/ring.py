"""Ring attention: exact attention over a sequence split across sp.

Counterpart of ``kubeflow_controller_tpu/parallel/ring.py``. Each sp
rank holds its contiguous slice of the sequence (``mesh.seq_slice``);
the K/V blocks go around the ring, one :func:`~parallel.collectives.
ring_shift` a step (receive from the right-hand neighbour, as the JAX
package's ``ppermute`` with ``perm = [(j, (j - 1) % n)]``), while each
rank folds the block it holds into its queries' output with an online
softmax in fp32. The ``S x S`` score matrix never exists: a rank holds
``[S/sp, S/sp]`` scores a step.

Grouped-query form: the K/V that travel are the un-repeated KV heads,
and the block update reads them through grouped einsums, so neither
the transfers nor the step's compute pay the ``h / kv_h`` expansion.
The causal mask is on global positions (``rank * S/sp + i``) and the
segment ids travel with their K/V block.

The block update is plain PyTorch, as the JAX package computes it in
XLA einsums outside any Pallas kernel. Autograd differentiates the
loop; the shift's backward is the reverse shift. The last step's shift
(the blocks back to their owners, whose result the JAX loop discards)
is not issued: every rank skips it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kubeflow_controller_tpu_torch.ops.attention import mha_xla
from kubeflow_controller_tpu_torch.parallel.collectives import ring_shift
from kubeflow_controller_tpu_torch.parallel.mesh import current_mesh

_NEG = -1e30  # finite mask value: keeps the online-softmax statistics NaN-free


def _block_attend(
    q: torch.Tensor,            # [B, Sq, G, R, D] grouped local queries (fp32)
    k: torch.Tensor,            # [B, Sk, G, D] the block held now (un-repeated)
    v: torch.Tensor,            # [B, Sk, G, D]
    q_pos: torch.Tensor,        # [Sq] global positions of the local queries
    k_pos: torch.Tensor,        # [Sk] global positions of the block
    m: torch.Tensor,            # [B, G, R, Sq] running max
    l: torch.Tensor,            # [B, G, R, Sq] running denominator
    o: torch.Tensor,            # [B, Sq, G, R, D] running numerator (fp32)
    causal: bool,
    q_seg: Optional[torch.Tensor],
    k_seg: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring step: the block's scores, masked, folded into ``(m, l,
    o)`` by the online-softmax update."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqgrd,bkgd->bgrqk", q, k) * scale      # [B, G, R, Sq, Sk]
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    else:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    mask = mask[None, None, None]
    if q_seg is not None:
        mask = mask & (q_seg[:, None, None, :, None] == k_seg[:, None, None, None, :])
    s = torch.where(mask, s, _NEG)
    # The output does not depend on the running max (it cancels between
    # o and l), so it is a constant to autograd and its backward keeps
    # no copy of the scores.
    m_new = torch.maximum(m, s.detach().amax(-1))
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
        "bgrqk,bkgd->bqgrd", p, v.float())
    return m_new, l_new, o_new


def _ring_body(q, k, v, seg, causal: bool, index: int, n: int,
               axis_name: str) -> torch.Tensor:
    """This rank's ring loop. q ``[B, Sq, H, D]``, k/v ``[B, Sk, KVH,
    D]`` (its slices), ``seg`` its ``[B, Sq]`` segment ids or None."""
    b, sq, h, d = q.shape
    sk, kv_h = k.shape[1], k.shape[2]
    rep = h // kv_h
    dev = q.device
    qf = q.float().reshape(b, sq, kv_h, rep, d)
    q_pos = index * sq + torch.arange(sq, device=dev)
    m = torch.full((b, kv_h, rep, sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv_h, rep, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, sq, kv_h, rep, d), dtype=torch.float32, device=dev)
    kv, seg_cur = torch.stack([k, v]), seg
    for i in range(n):
        src = (index + i) % n                        # the block held now
        k_pos = src * sk + torch.arange(sk, device=dev)
        m, l, o = _block_attend(qf, kv[0].float(), kv[1], q_pos, k_pos, m, l, o,
                                causal, seg, seg_cur)
        if i + 1 < n:
            kv = ring_shift(kv, axis_name, -1)
            if seg_cur is not None:
                seg_cur = ring_shift(seg_cur, axis_name, -1)
    out = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


def ring_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    axis_name: str = "sp",
) -> torch.Tensor:
    """Exact attention with the sequence split over ``axis_name``.

    ``q [B, S/n, H, D]``, ``k``/``v [B, S/n, KVH, D]`` and
    ``segment_ids [B, S/n]`` are this rank's slices of the sequence (its
    tp heads under tp); returns its queries' output. Without an ambient
    mesh, or with an axis of one rank, this is dense attention
    (``ops/attention.py:mha_xla``) on what it is given, as the JAX
    package falls back off a mesh."""
    mesh = current_mesh()
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        return mha_xla(q, k, v, causal=causal, segment_ids=segment_ids)
    return _ring_body(q, k, v, segment_ids, causal, mesh.coords[axis_name],
                      mesh.shape[axis_name], axis_name)
