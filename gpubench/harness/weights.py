"""The benchmark's weights: drawn on the device from ``--seed``, leaf by
leaf, in the port's parameter layout (``embed [V, D]``, ``lm_head [D,
V]``, ``final_norm [D]`` and ``layers`` with every layer's weights
stacked on a leading ``[L, ...]`` axis; a MoE layer's banks ``[L, E,
...]`` and its router ``[L, D, E]``).

Each leaf has a ``torch.Generator`` of its own, seeded by ``(seed,
leaf)``, and is drawn in one call in the dtype it is used in: the same
seed gives the same leaf whenever it is drawn again, so the reference
re-draws what it needs after the program's state is freed. The port and
the reference are handed these tensors; neither draws its own.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

#: Leaf order; a leaf's index seeds its generator.
LEAVES = ("embed", "final_norm", "lm_head", "attn_norm", "wq", "wk", "wv",
          "wo", "mlp_norm", "w_router", "w_gate", "w_up", "w_down")
NORMS = ("final_norm", "attn_norm", "mlp_norm")


def shapes(c: Dict) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``{leaf: (shape, fan_in)}`` for a configuration's ``port`` sizes
    (``fan_in`` 0 for a norm, drawn as ones)."""
    V, D, L = c["vocab_size"], c["d_model"], c["n_layers"]
    H, KV, F = c["n_heads"], c["n_kv_heads"], c["d_ff"]
    hd = D // H
    E = c.get("moe_experts", 0)
    out = {
        "embed": ((V, D), D), "final_norm": ((D,), 0), "lm_head": ((D, V), D),
        "attn_norm": ((L, D), 0), "wq": ((L, D, H * hd), D),
        "wk": ((L, D, KV * hd), D), "wv": ((L, D, KV * hd), D),
        "wo": ((L, H * hd, D), H * hd), "mlp_norm": ((L, D), 0),
    }
    if E:
        out.update({"w_router": ((L, D, E), D), "w_gate": ((L, E, D, F), D),
                    "w_up": ((L, E, D, F), D), "w_down": ((L, E, F, D), F)})
    else:
        out.update({"w_gate": ((L, D, F), D), "w_up": ((L, D, F), D),
                    "w_down": ((L, F, D), F)})
    return out


def leaf(c: Dict, name: str, seed: int, device, dtype: torch.dtype) -> torch.Tensor:
    """One leaf as the seed draws it: ones for a norm, else ``N(0, 1) /
    sqrt(fan_in)``; the router always in fp32, as the port keeps it."""
    shape, fan_in = shapes(c)[name]
    if name == "w_router":
        dtype = torch.float32
    if name in NORMS:
        return torch.ones(shape, dtype=dtype, device=device)
    state = np.random.SeedSequence([int(seed) % 2 ** 64, 101, LEAVES.index(name)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(fan_in ** -0.5)


def names(c: Dict) -> Iterator[str]:
    return (n for n in LEAVES if n in shapes(c))


def make(c: Dict, seed: int, device, dtype: torch.dtype) -> Dict:
    """The whole tree in the port's layout."""
    tree: Dict = {"layers": {}}
    for n in names(c):
        t = leaf(c, n, seed, device, dtype)
        if n in ("embed", "final_norm", "lm_head"):
            tree[n] = t
        else:
            tree["layers"][n] = t
    return tree


def flat(tree: Dict) -> Dict[str, torch.Tensor]:
    """``{leaf: tensor}`` of a tree in the port's layout."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update(tree["layers"])
    return out
