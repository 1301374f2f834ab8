"""Model FLOPs of the decoder: the useful work a token costs, whatever
the implementation computes besides (a MoE layer's unpicked experts,
remat's recompute, padding).

``c`` is a configuration's ``port`` sizes. The input embedding is a
lookup and costs nothing; the head is a ``D x V`` product.
"""

from __future__ import annotations

from typing import Dict, Iterable


def matmul_params(c: Dict) -> float:
    """Parameters a token multiplies in one forward: every layer's
    projections (a MoE layer's router and ``top_k`` experts) and the
    head."""
    D, H, KV, F = c["d_model"], c["n_heads"], c["n_kv_heads"], c["d_ff"]
    hd = D // H
    attn = D * (H + 2 * KV) * hd + H * hd * D
    E = c.get("moe_experts", 0)
    ffn = (c["moe_top_k"] * 3 * D * F + D * E) if E else 3 * D * F
    return float(c["n_layers"] * (attn + ffn) + D * c["vocab_size"])


def attn_flops(c: Dict, context: int) -> float:
    """Attention of one query over ``context`` keys in every layer: QK^T
    and PV."""
    return 4.0 * c["n_layers"] * c["n_heads"] * (c["d_model"] // c["n_heads"]) * context


def forward_token(c: Dict, context: int) -> float:
    """One token's forward at a position that sees ``context`` keys."""
    return 2.0 * matmul_params(c) + attn_flops(c, context)


def prefill(c: Dict, prompt: int) -> float:
    """A prompt's forward: position ``i`` sees ``i + 1`` keys."""
    return (2.0 * matmul_params(c) * prompt
            + attn_flops(c, 1) * prompt * (prompt + 1) / 2)


def chunk(c: Dict, width: int, offset: int) -> float:
    """A prefill chunk of ``width`` real tokens at ``offset``."""
    return (2.0 * matmul_params(c) * width
            + attn_flops(c, 1) * (width * offset + width * (width + 1) / 2))


def train_row(c: Dict, docs: Iterable[int]) -> float:
    """One packed row's forward and backward (3x the forward): ``6 N``
    a token plus attention over each document's causal pairs; remat's
    recompute not counted."""
    docs = list(docs)
    tokens = sum(docs)
    pairs = sum(n * (n + 1) / 2 for n in docs)
    return 6.0 * matmul_params(c) * tokens + 3.0 * attn_flops(c, 1) * pairs
