"""Operations and bytes of each attention kernel's work, from the shapes
of its inputs: each input byte read once, each output byte written once,
whatever a kernel reads again; the masked work a kernel skips or
computes anyway is not counted. These count a kernel's work, not its
implementation, so a kernel that replaces another is judged against the
same numbers.

All tensors are bf16 (2 bytes) but the fp32 log-sum-exp; ``H`` query
heads and ``KVH`` KV heads of ``D``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

BF16 = 2
F32 = 4


def causal_pairs(doc_lengths: Iterable[int]) -> int:
    """Query-key pairs of causal attention inside each document."""
    return sum(n * (n + 1) // 2 for n in doc_lengths)


def flash_fwd(tokens: int, pairs: int, H: int, KVH: int, D: int) -> Tuple[float, float]:
    """Forward attention (B1 with its rope rotation) over ``tokens``
    positions holding ``pairs`` causal pairs: QK^T and PV, 2 FLOPs a
    multiply-add each. Reads q, k, v and the rope tables' cos and sin
    (fp32, ``tokens x D`` each); writes o."""
    flops = 4.0 * pairs * H * D
    nbytes = (tokens * (2 * H + 2 * KVH) * D * BF16
              + 2 * tokens * D * F32)
    return flops, nbytes


def flash_bwd(tokens: int, pairs: int, H: int, KVH: int, D: int) -> Tuple[float, float]:
    """Backward attention (B3 + B4 with their prep and rope): the four
    products dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q over the
    causal pairs (recomputing QK^T is the kernel's choice, not counted).
    Reads q, k, v, o, dO, the fp32 log-sum-exp and the rope tables;
    writes dq, dk, dv."""
    flops = 8.0 * pairs * H * D
    reads = tokens * (3 * H + 2 * KVH) * D * BF16 + tokens * H * F32 + 2 * tokens * D * F32
    writes = tokens * (H + 2 * KVH) * D * BF16
    return flops, float(reads + writes)


def paged_decode(contexts: Iterable[int], H: int, KVH: int, D: int) -> Tuple[float, float]:
    """One layer of a decode micro-step (B5) over the active slots, slot
    ``b`` attending ``contexts[b]`` cached columns: reads each slot's
    query and the K and V of its columns, writes its output."""
    ctx = list(contexts)
    cols = sum(ctx)
    flops = 4.0 * cols * H * D
    nbytes = cols * 2 * KVH * D * BF16 + len(ctx) * 2 * H * D * BF16
    return flops, float(nbytes)


def paged_chunk(width: int, offset: int, H: int, KVH: int, D: int) -> Tuple[float, float]:
    """One layer of a prefill chunk (B6) of ``width`` real rows at
    ``offset``: each row attends the ``offset`` cached columns and the
    chunk's causal tile. Reads q and the chunk's new K and V, the cached
    K and V; writes o."""
    pairs = width * offset + width * (width + 1) // 2
    flops = 4.0 * pairs * H * D
    nbytes = (width * (2 * H + 2 * KVH) * D + offset * 2 * KVH * D) * BF16
    return flops, float(nbytes)
