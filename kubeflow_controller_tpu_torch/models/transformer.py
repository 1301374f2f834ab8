"""Llama-family decoder: config, presets, init, layer math, and the loss.

Counterpart of ``kubeflow_controller_tpu/models/transformer.py``. The
parameter tree keeps the JAX package's layout so the two packages can be
held against each other: a dict with ``embed [V, D]``, ``final_norm
[D]``, ``lm_head [D, V]`` and ``layers`` holding every layer's weights
stacked on a leading ``[L, ...]`` axis, each projection ``[D_in,
D_out]`` and applied as ``x @ w``.

The training forward (:func:`forward_hidden`, :func:`next_token_loss`;
:func:`forward` adds the head for full-sequence fp32 logits) runs the
decoder on one device: attention through
``ops/attention.py:mha`` (the flash kernels on the card), each layer
under ``torch.utils.checkpoint`` when ``remat`` is true (``"ffn"``:
only the dense FFN's d_ff-wide intermediates are recomputed), and its
linear projections through ``ops/quant.py:maybe_quant_dot`` (bf16, or
int8 under ``quant``). With ``moe_experts > 0`` every layer's FFN is a
routed expert bank (:func:`_moe_ffn`: GShard-style grouped capacity
dispatch).

Over a mesh (``dataplane/train.py``, ``parallel/``), :func:`param_specs`
places the parameters as the JAX package's ``param_specs`` does, and a
layer runs Megatron-style under ``tp`` (``ops/quant.py:Projections``):
q/k/v and gate/up are column-parallel (each rank holds ``n_heads/tp``
query heads and ``n_kv_heads/tp`` KV heads, its local head count read
from the weights' shapes), wo and w_down row-parallel with one
all-reduce after each, and the head vocab-parallel
(:func:`vocab_parallel_nll_and_argmax`). Int8 projections take their
scales over the whole contraction and sum their partials in fp32
(``ops/quant.py``). A MoE layer keeps its routing replicated over tp and
runs each expert's SwiGLU column- and row-parallel; under ``ep`` each
rank holds ``E/ep`` experts, and :func:`_moe_ffn` sends the dispatched
tokens to them and the outputs back (``collectives.all_to_all``), as
GSPMD does for the JAX package's ``P("ep", ...)`` constraint. Masked
means divide by the global batch's count. Under ``sp > 1`` with
``shard_seq`` (or ``attn_impl="ring"``) each sp rank holds its slice of
the sequence (``mesh.seq_slice``): its tokens' embeddings, activations,
targets and loss. Attention then either gathers q/k/v over sp and runs
``mha`` on the whole sequence, keeping this rank's rows (the JAX
package's constraint of q/k/v to ``P(batch, None, "tp", None)``), or,
with ``attn_impl="ring"``, rotates q and k outside and runs
``parallel/ring.py:ring_mha``. A MoE layer gathers its input over sp
and routes the whole sequence on every sp rank, keeping its slice of
the output (the JAX package's groups are runs of the global ``[B·S]``
order, which an sp rank's slice does not hold). :func:`forward_hidden_pp`
runs the layer stack as a GPipe schedule over pp
(``parallel/pipeline.py``), each stage holding its block of layers
(``param_specs(cfg, pp=True)``; dense layers only, as the JAX
package's).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_controller_tpu_torch.convert import tree_leaves
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.ops.attention import mha
from kubeflow_controller_tpu_torch.ops.flash_attention import rope_full_tables
from kubeflow_controller_tpu_torch.ops.quant import Projections
from kubeflow_controller_tpu_torch.parallel.collectives import (
    all_to_all, masked_denominator, seq_gather, tp_concat, tp_copy, tp_gather, tp_index,
    tp_max, tp_size, tp_sum,
)
from kubeflow_controller_tpu_torch.parallel.mesh import DATA_AXES, current_mesh, seq_slice
from kubeflow_controller_tpu_torch.parallel.pipeline import gpipe, pp_stage_count
from kubeflow_controller_tpu_torch.parallel.ring import ring_mha
from kubeflow_controller_tpu_torch.parallel.sharding import P, layers, view

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights
    # True: checkpoint every layer (the backward re-runs its forward);
    # "ffn": keep everything but the dense FFN's four d_ff-wide
    # intermediates (the backward re-runs only the gate and up
    # products; MoE layers take True); False: keep every activation.
    remat: Any = True
    # "" = bf16 matmuls (default). "int8" runs every linear projection
    # (qkv/o, FFN gate/up/down) through the int8 path: dynamic symmetric
    # quantization with STE gradients, all three matmuls per projection
    # quantized (ops/quant.py). "int8_fused" uses the fused in-kernel
    # quantization kernel where shapes allow (ops/quant_fused.py; the JAX
    # package measured it slower than "int8" on the TPU at flagship
    # shapes). Embed, LM head, and attention scores/softmax stay
    # bf16/fp32 in all modes.
    quant: str = ""
    attn_impl: str = "auto"                    # auto|xla|flash|ring
    tie_embeddings: bool = False
    # Split the activations' sequence axis over the mesh's sp axis (each
    # sp rank holds its slice); attn_impl="ring" splits it whatever this
    # says. Without it an sp rank computes the whole sequence.
    shard_seq: bool = False
    # Mixture-of-experts: 0 = dense FFN. When > 0 every layer's FFN is a
    # routed bank of ``moe_experts`` SwiGLU experts, each token sent to
    # its ``moe_top_k`` experts within groups of ``moe_group_size``
    # tokens, at most ``round(top_k * group / E * moe_capacity_factor)``
    # tokens an expert a group (the rest dropped). The load-balance loss
    # is weighted by ``moe_aux_weight``, the router z-loss
    # (mean(logsumexp(router logits)^2)) by ``moe_router_z_weight`` (0
    # disables it). ``moe_dispatch``: "auto" and "einsum" dispatch by
    # one-hot products, "gather" by index gathers (the same values).
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_router_z_weight: float = 0.0
    moe_group_size: int = 1024
    moe_dispatch: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


# -- presets (sizes per the public model cards) ------------------------------

def tiny_config(**kw) -> TransformerConfig:
    """Test-scale config: runs in milliseconds on the CPU."""
    base = TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, remat=False, dtype=torch.float32,
    )
    return base.replace(**kw)


def tiny_moe_config(**kw) -> TransformerConfig:
    base = tiny_config(moe_experts=4, moe_top_k=2, d_ff=64)
    return base.replace(**kw)


def mixtral_8x7b_config(**kw) -> TransformerConfig:
    base = TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq=8192, rope_theta=1e6,
        moe_experts=8, moe_top_k=2,
    )
    return base.replace(**kw)


def flagship_config(**kw) -> TransformerConfig:
    """``bench.py``'s flagship decoder (``bench_flagship``): 16 layers of
    d_model 1024, 8 heads of 128, d_ff 4096, vocab 32768, flash
    attention, every layer rematerialised. Named here so that the LM
    entry point trains it on one card."""
    base = TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=16, n_heads=8, n_kv_heads=8,
        d_ff=4096, max_seq=1024, attn_impl="flash", remat=True)
    return base.replace(**kw)


def llama3_8b_config(**kw) -> TransformerConfig:
    base = TransformerConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq=8192, rope_theta=500000.0,
    )
    return base.replace(**kw)


def llama3_70b_config(**kw) -> TransformerConfig:
    """Llama-3-70B: head_dim 128 and a GQA group of 8 query heads a KV
    head. 70.6 B parameters, 1.13 TB of fp32 AdamW state: it trains over
    a mesh (fsdp and tp), and ``parallel/aot_check.py`` says which."""
    base = TransformerConfig(
        vocab_size=128256, d_model=8192, n_layers=80, n_heads=64,
        n_kv_heads=8, d_ff=28672, max_seq=8192, rope_theta=500000.0,
    )
    return base.replace(**kw)


# -- params ------------------------------------------------------------------

#: The expert banks of a MoE layer: ``w_gate`` and ``w_up`` ``[L, E, D,
#: F]``, ``w_down`` ``[L, E, F, D]``.
MOE_BANKS = ("w_gate", "w_up", "w_down")


def bank_shape(cfg: TransformerConfig, name: str) -> Tuple[Tuple[int, ...], int]:
    """One layer's ``[E, ...]`` shape of expert bank ``name`` and its
    fan-in."""
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
    return ((e, f, d), f) if name == "w_down" else ((e, d, f), d)


def init_bank_layer(
    cfg: TransformerConfig, name: str, layer: int, seed: int = 0,
    device: DeviceLike = None, dtype: torch.dtype = None,
) -> torch.Tensor:
    """Layer ``layer``'s ``[E, ...]`` slice of expert bank ``name`` as
    :func:`init_params` draws it: from a generator of its own, seeded by
    ``(seed, name, layer)``, so that one layer can be drawn without the
    others (``generate.init_inference_params`` streams mixtral_8x7b's
    ~90 GB of bf16 banks into int8 a layer at a time)."""
    dev = resolve_device(device)
    dt = cfg.param_dtype if dtype is None else dtype
    state = np.random.SeedSequence(
        [int(seed) % 2 ** 64, MOE_BANKS.index(name), int(layer)])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    shape, fan_in = bank_shape(cfg, name)
    t = torch.randn(shape, generator=gen, device=dev, dtype=dt)
    return t.mul_(fan_in ** -0.5)


def init_params(
    cfg: TransformerConfig, seed: int = 0, device: DeviceLike = None,
    dtype: torch.dtype = None, banks: bool = True,
) -> Params:
    """Scaled-normal init (``N(0, 1) / sqrt(fan_in)``, norms at 1) drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``.

    Each tensor is drawn directly in ``dtype`` (default
    ``cfg.param_dtype``) and scaled in place: serving llama3_8b passes
    ``dtype=cfg.dtype`` so the ~16 GB of bf16 weights never pass through
    a ~32 GB fp32 copy. A MoE layer's router ``w_router [L, D, E]`` is
    drawn in ``cfg.param_dtype`` whatever ``dtype`` is (routing runs in
    fp32, and serving keeps the router as it is), and its expert banks
    (:data:`MOE_BANKS`) a layer at a time by :func:`init_bank_layer`;
    ``banks=False`` leaves them out. The draws differ from the JAX
    package's ``jax.random`` init; tests that compare the two packages
    carry one package's weights across with ``convert.params_from_numpy``."""
    dev = resolve_device(device)
    dt = cfg.param_dtype if dtype is None else dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    hd = cfg.head_dim
    L = cfg.n_layers

    def normal(shape, fan_in, dtype=dt):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return t.mul_(fan_in ** -0.5)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dt)

    d, f = cfg.d_model, cfg.d_ff
    layers: Params = {
        "attn_norm": ones((L, d)),
        "wq": normal((L, d, cfg.n_heads * hd), d),
        "wk": normal((L, d, cfg.n_kv_heads * hd), d),
        "wv": normal((L, d, cfg.n_kv_heads * hd), d),
        "wo": normal((L, cfg.n_heads * hd, d), cfg.n_heads * hd),
        "mlp_norm": ones((L, d)),
    }
    if cfg.moe_experts:
        layers["w_router"] = normal((L, d, cfg.moe_experts), d, cfg.param_dtype)
        if banks:
            for name in MOE_BANKS:
                shape, _ = bank_shape(cfg, name)
                bank = torch.empty((L, *shape), device=dev, dtype=dt)
                for i in range(L):
                    bank[i] = init_bank_layer(cfg, name, i, seed, dev, dt)
                layers[name] = bank
    else:
        layers.update({
            "w_gate": normal((L, d, f), d),
            "w_up": normal((L, d, f), d),
            "w_down": normal((L, f, d), f),
        })
    params: Params = {
        "embed": normal((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d)
    return params


def param_shapes(cfg: TransformerConfig) -> Params:
    """The shape of every leaf :func:`init_params` draws (with expert
    banks), without drawing them."""
    L, d, f, hd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.head_dim
    layers: Params = {
        "attn_norm": (L, d), "wq": (L, d, cfg.n_heads * hd),
        "wk": (L, d, cfg.n_kv_heads * hd), "wv": (L, d, cfg.n_kv_heads * hd),
        "wo": (L, cfg.n_heads * hd, d), "mlp_norm": (L, d),
    }
    if cfg.moe_experts:
        layers["w_router"] = (L, d, cfg.moe_experts)
        for name in MOE_BANKS:
            layers[name] = (L, *bank_shape(cfg, name)[0])
    else:
        layers.update({"w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d)})
    shapes: Params = {"embed": (cfg.vocab_size, d), "layers": layers,
                      "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def param_specs(cfg: TransformerConfig, pp: bool = False) -> Params:
    """The placement of every parameter (``parallel/sharding.py``), as
    the JAX package's ``param_specs``: column-parallel projections put
    their output dimension on tp, row-parallel ones their input
    dimension, and the other matmul dimension is fsdp-sharded; the
    embedding is d_model-sharded over (fsdp, tp), the head vocab-sharded
    over tp; the expert banks put experts on ep. ``pp=True`` shards the
    stacked layer leaves' leading layer axis over pp: pipeline stage
    ``p`` holds its contiguous block of layers."""
    lead = "pp" if pp else None
    layers = {
        "attn_norm": P(lead, None),
        "wq": P(lead, "fsdp", "tp"),
        "wk": P(lead, "fsdp", "tp"),
        "wv": P(lead, "fsdp", "tp"),
        "wo": P(lead, "tp", "fsdp"),
        "mlp_norm": P(lead, None),
    }
    if cfg.moe_experts:
        layers.update({
            "w_router": P(lead, "fsdp", None),
            "w_gate": P(lead, "ep", "fsdp", "tp"),
            "w_up": P(lead, "ep", "fsdp", "tp"),
            "w_down": P(lead, "ep", "tp", "fsdp"),
        })
    else:
        layers.update({
            "w_gate": P(lead, "fsdp", "tp"),
            "w_up": P(lead, "fsdp", "tp"),
            "w_down": P(lead, "tp", "fsdp"),
        })
    specs: Params = {
        "embed": P(None, ("fsdp", "tp")),
        "layers": layers,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P("fsdp", "tp")
    return specs


def check_mesh(cfg: TransformerConfig) -> None:
    """Refuse a mesh whose axes do not divide what they shard."""
    mesh = current_mesh()
    if mesh is None:
        return
    ep, tp = mesh.shape["ep"], mesh.shape["tp"]
    if cfg.moe_experts and cfg.moe_experts % ep:
        raise ValueError(f"moe_experts={cfg.moe_experts} does not divide over ep={ep}")
    if tp == 1:
        return
    for name, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{name}={n} does not divide over tp={tp}")


# -- layer math --------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Same order as the JAX package: normalise in fp32, cast back to the
    activation dtype, then scale by the weight in that dtype."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last (head_dim) axis, halves convention,
    angles in fp32. x: [B, S, H, D]; positions: [B, S]."""
    d = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[:, :, None].float() * freqs            # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# -- training forward ---------------------------------------------------------

def check_ported(cfg: TransformerConfig) -> None:
    """Refuse the training options this port does not have yet."""
    if cfg.remat not in (True, False, "ffn"):
        raise ValueError(f"remat={cfg.remat!r}: expected True, False or 'ffn'")
    if cfg.attn_impl not in ("auto", "xla", "flash", "ring"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not yet ported (auto|xla|flash|ring)")
    if cfg.quant not in ("", "int8", "int8_fused"):
        raise NotImplementedError(
            f"quant={cfg.quant!r} is not yet ported ('', int8, int8_fused)")
    if cfg.moe_experts and cfg.moe_dispatch not in ("auto", "einsum", "gather"):
        raise ValueError(
            f"moe_dispatch={cfg.moe_dispatch!r}: expected auto|einsum|gather")


# -- the routed FFN ----------------------------------------------------------------

def moe_group(n: int, group_size: int) -> int:
    """The routing group: the largest divisor of the token count ``n``
    not above ``group_size``.

    ``n`` is this rank's token count. The JAX package picks the group
    from the global count ``N = shards * n`` (``shards``: the data axes
    dp, fsdp and ep, which split the batch; sp does not, and a MoE layer
    gathers its input over sp), preferring a group ``g`` with ``(N // g)
    % shards == 0`` so that no group straddles two shards. For a divisor
    ``g`` of ``N`` that is ``g | N / shards = n``, so the aligned
    divisors of ``N`` are exactly the divisors of ``n``, and the largest
    not above ``group_size`` is the same group on every rank: each
    rank's groups are the global groups its rows hold."""
    return max(g for g in range(1, min(group_size, n) + 1) if n % g == 0)


def _moe_ffn(
    cfg: TransformerConfig, lp: Params, h: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style routed FFN with grouped capacity dispatch, as the JAX
    package's ``_moe_ffn``: ``h [B, S, D] -> (out [B, S, D], [aux
    load-balance loss, router z-loss, drop rate])``.

    Tokens route within groups (:func:`moe_group`) in fp32: ``top_k``
    rounds of ``argmax`` (the first maximum on ties) over the
    probabilities not picked yet, each pick's gate its probability (not
    renormalised), its slot the count of earlier tokens of the group
    sent to that expert (``base_count`` carries the kept slots across
    rounds); a pick past ``cap = round(top_k * group / E * cf)`` slots
    is dropped. The expert products run in ``cfg.dtype`` (:func:`_experts`)
    on this rank's experts: over ep the dispatched ``[E, G, cap, D]``
    goes to the ranks that hold each expert and comes back after them
    (``collectives.all_to_all``); off a mesh that is the identity."""
    b, s, d = h.shape
    E = cfg.moe_experts
    n = b * s
    group = moe_group(n, cfg.moe_group_size)
    G = n // group
    x = h.reshape(G, group, d)
    logits = x.float() @ lp["w_router"].float()                # [G, g, E]
    probs = torch.softmax(logits, dim=-1)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    cap = int(max(1, round(cfg.moe_top_k * group / E * cfg.moe_capacity_factor)))

    base_count = torch.zeros((G, E), dtype=torch.int64, device=h.device)
    remaining = probs
    aux_fraction = torch.zeros((), dtype=torch.float32, device=h.device)
    mean_probs = probs.mean(1)
    picks = []       # per round: (choice, gate, pos_tok, keep), each [G, g]
    for _ in range(cfg.moe_top_k):
        choice = remaining.argmax(-1)
        gate = remaining.gather(-1, choice[..., None])[..., 0]
        onehot = F.one_hot(choice, E)                          # [G, g, E]
        pos = onehot.cumsum(1) - 1 + base_count[:, None, :]
        pos_tok = (pos * onehot).sum(-1)
        keep = pos_tok < cap
        picks.append((choice, gate, pos_tok, keep))
        aux_fraction = aux_fraction + E * (
            onehot.float().mean(1) * mean_probs).mean()
        base_count = base_count + (onehot * keep[..., None]).sum(1)
        remaining = remaining * (1 - onehot)

    dispatch = (_moe_dispatch_gather if cfg.moe_dispatch == "gather"
                else _moe_dispatch_einsum)
    xe, out_from = dispatch(cfg, x, picks, G, group, E, cap)   # [E, G, cap, D]
    # Over ep: [E/ep, ep G, cap, D], this rank's experts' slots of the ep
    # ranks' groups, and their outputs back to [E, G, cap, D].
    out_e = all_to_all(_experts(cfg, lp, all_to_all(xe)), inverse=True)
    out = out_from(out_e).reshape(b, s, d)
    kept = torch.stack([k.float() for (_, _, _, k) in picks])
    drop_rate = 1.0 - kept.mean()
    return out, torch.stack([aux_fraction, z_loss, drop_rate])


def _experts(cfg: TransformerConfig, lp: Params, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its slots, ``xe [E', G', cap, D]`` (this
    rank's ``E' = E / ep`` experts) -> ``[E', G', cap, D]``; over tp
    column-parallel (gate/up over F) and row-parallel (down), the routing
    replicated around it. The slots' token axis spans the ep ranks after
    the all-to-all and the dp and fsdp ranks beside them: under
    ``cfg.quant`` each expert's three products are ``maybe_quant_dot``
    calls of their own (``[G' * cap, D] @ [D, F]``: B7 where ``fusable``
    admits the logical shape under ``"int8_fused"``), their scales over
    those axes; empty slots are all-zero rows."""
    dt = cfg.dtype
    proj = Projections(cfg.quant, dt, rows=("dp", "fsdp"))
    if proj.int8:
        e_loc, g, cap, d = xe.shape
        xe2 = xe.reshape(e_loc, g * cap, d)
        outs = []
        for e in range(e_loc):
            gate_h = F.silu(proj.column(xe2[e], lp["w_gate"][e]))
            up_h = proj.column(xe2[e], lp["w_up"][e])
            outs.append(proj.row(gate_h * up_h, lp["w_down"][e]))
        return torch.stack(outs).reshape(e_loc, g, cap, d)
    xe = proj.enter(xe)
    gate_h = F.silu(torch.einsum("egcd,edf->egcf", xe, lp["w_gate"].to(dt)))
    up_h = torch.einsum("egcd,edf->egcf", xe, lp["w_up"].to(dt))
    return tp_sum(torch.einsum("egcf,efd->egcd", gate_h * up_h, lp["w_down"].to(dt)))


def _moe_dispatch_einsum(cfg, x, picks, G, group, E, cap):
    """Dense one-hot dispatch and combine: ``[G, g, E, cap]`` masks
    built from the picks (slots are disjoint across rounds, so summing
    the rounds' outer products is exact), the combine weights in fp32,
    the dispatch mask in ``cfg.dtype``."""
    dt = cfg.dtype
    combine = torch.zeros((G, group, E, cap), dtype=torch.float32, device=x.device)
    dispatch = torch.zeros((G, group, E, cap), dtype=dt, device=x.device)
    for choice, gate, pos_tok, keep in picks:
        # A dropped pick's slot is out of range: its one-hot row is
        # zeroed by ``keep`` (JAX's one_hot gives zeros there).
        slot = (F.one_hot(choice, E).float()[..., None]
                * F.one_hot(pos_tok.clamp(max=cap - 1), cap).float()[..., None, :]
                * keep[..., None, None])
        combine = combine + gate[..., None, None] * slot
        dispatch = dispatch + slot.to(dt)
    xe = torch.einsum("gnec,gnd->egcd", dispatch, x)

    def out_from(out_e):
        return torch.einsum("gnec,egcd->gnd", combine.to(dt), out_e)

    return xe, out_from


def _moe_dispatch_gather(cfg, x, picks, G, group, E, cap):
    """Scatter/gather dispatch: every (expert, slot) holds at most one
    token, so the dispatch is a permutation — each kept token's index is
    written into its slot, the slots gather their tokens, and the combine
    gathers each token's ``top_k`` expert outputs back, scaled by its
    gates. The einsum form's values, without the one-hot products."""
    dt = cfg.dtype
    d = x.shape[-1]
    dev = x.device
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, group)
    tok_idx = torch.arange(group, device=dev)[None, :]
    slot_src = torch.zeros((G, E, cap), dtype=torch.int64, device=dev)
    for choice, _, pos_tok, keep in picks:
        safe_pos = torch.where(keep, pos_tok, cap - 1)
        slot_src = slot_src.index_put(
            (g_idx, choice, safe_pos),
            torch.where(keep, tok_idx + 1, 0).expand(G, group), accumulate=True)
    valid = slot_src > 0
    src = (slot_src - 1).clamp_min(0).reshape(G, E * cap)
    xe = x.gather(1, src[..., None].expand(G, E * cap, d))
    xe = xe * valid.reshape(G, E * cap, 1).to(x.dtype)
    xe = xe.reshape(G, E, cap, d).permute(1, 0, 2, 3)

    def out_from(out_e):
        flat = out_e.permute(1, 0, 2, 3).reshape(G, E * cap, -1)
        out = torch.zeros((G, group, flat.shape[-1]), dtype=dt, device=dev)
        for choice, gate, pos_tok, keep in picks:
            slot = choice * cap + pos_tok.clamp(max=cap - 1)
            picked = flat.gather(1, slot[..., None].expand(G, group, flat.shape[-1]))
            out = out + picked * (gate * keep).to(dt)[..., None]
        return out

    return xe, out_from


# -- the dense FFN under remat="ffn" --------------------------------------------

class _FfnRecompute:
    """What ``remat="ffn"`` keeps of one dense FFN: its input and weights.
    The d_ff-wide intermediates (the gate and up products, the gate's
    SiLU and their product) are dropped after the forward; the backward
    re-runs the gate and up products once, under int8 with their
    quantized copies, as the JAX package's ``save_anything_except_these_
    names`` policy does."""

    def __init__(self, proj, h, wg, wu):
        self.proj, self.h, self.wg, self.wu = proj, h, wg, wu
        self.prod_ptr = self.prod_numel = None    # set once the product exists
        self.graph = None

    def gate_up(self, h, wg, wu):
        return F.silu(self.proj.column(h, wg)) * self.proj.column(h, wu)

    def recompute(self):
        """The product again, once, with its graph back to the inputs."""
        if self.graph is None:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(t.requires_grad)
                       for t in (self.h, self.wg, self.wu)]
                self.graph = (ins, self.gate_up(*ins))
        return self.graph

    def pack(self, t):
        if (self.prod_ptr is not None and t.data_ptr() == self.prod_ptr
                and t.numel() == self.prod_numel):
            return ("prod", t.shape)
        return t

    def unpack(self, saved):
        if isinstance(saved, tuple) and saved and saved[0] == "prod":
            return self.recompute()[1].detach().reshape(saved[1])
        return saved


class _FfnProd(torch.autograd.Function):
    """``silu(h @ wg) * (h @ wu)`` computed without a graph; the backward
    differentiates the recomputed graph of :class:`_FfnRecompute`."""

    @staticmethod
    def forward(ctx, h, wg, wu, rec):
        ctx.rec = rec
        return rec.gate_up(h, wg, wu)

    @staticmethod
    def backward(ctx, g):
        ins, prod = ctx.rec.recompute()
        want = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(prod, want, g))
        ctx.rec.graph = None
        return (*(next(got) if t.requires_grad else None for t in ins), None)


def _ffn_remat(proj: Projections, h, wg, wu, wd):
    """The dense FFN (``proj``'s column-parallel gate and up, row-parallel
    down) with only its input and weights saved: the down product's
    saved operand is a placeholder the backward fills by recomputing the
    gate and up products."""
    rec = _FfnRecompute(proj, h, wg, wu)
    prod = _FfnProd.apply(h, wg, wu, rec)
    rec.prod_ptr, rec.prod_numel = prod.data_ptr(), prod.numel()
    with torch.autograd.graph.saved_tensors_hooks(rec.pack, rec.unpack):
        return proj.row(prod, wd)


class _Attention(NamedTuple):
    """What a layer's attention reads besides q/k/v: the whole rows'
    segment ids and positions, the step's rope tables (``None`` on the
    ring path, which rotates q and k outside), and ``rows``, this sp
    rank's slice of the sequence when the activations are split over sp
    (``None`` when they are whole)."""

    segment_ids: Optional[torch.Tensor]
    positions: torch.Tensor
    rope_tables: Any
    rows: Optional[slice]


def _split_rows(cfg: TransformerConfig, s: int) -> Optional[slice]:
    """This sp rank's slice of an ``s``-position sequence when the
    activations are split over sp (``shard_seq``, or the ring path), else
    ``None``."""
    mesh = current_mesh()
    if mesh is None or mesh.shape["sp"] == 1:
        return None
    if not (cfg.shard_seq or cfg.attn_impl == "ring"):
        return None
    return seq_slice(mesh, s)


def _attention_inputs(cfg: TransformerConfig, positions: torch.Tensor,
                      segment_ids: Optional[torch.Tensor]) -> _Attention:
    """The step's :class:`_Attention` for whole rows ``positions [B, S]``.
    The rope tables are built once and shared by every layer, as the JAX
    package's ``_rope_tables_for`` builds them (none for the ring)."""
    tables = (None if cfg.attn_impl == "ring" else
              rope_full_tables(positions, cfg.head_dim, cfg.rope_theta))
    return _Attention(segment_ids, positions, tables,
                      _split_rows(cfg, positions.shape[1]))


def _attend(cfg: TransformerConfig, q, k, v, att: _Attention) -> torch.Tensor:
    """Causal attention of this rank's queries. The ring path rotates q
    and k by their positions and runs ``ring_mha`` on this rank's slice;
    otherwise a split sequence is gathered over sp for ``mha`` and this
    rank's rows are kept."""
    rows = att.rows
    if cfg.attn_impl == "ring":
        pos, seg = att.positions, att.segment_ids
        if rows is not None:
            pos = pos[:, rows]
            seg = None if seg is None else seg[:, rows]
        return ring_mha(rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta),
                        v, causal=True, segment_ids=seg)
    if rows is not None:
        q, k, v = seq_gather(q), seq_gather(k), seq_gather(v)
    out = mha(q, k, v, causal=True, segment_ids=att.segment_ids,
              impl=cfg.attn_impl, rope_tables=att.rope_tables)
    return out if rows is None else out[:, rows]


def _layer(
    cfg: TransformerConfig, lp: Params, x: torch.Tensor, att: _Attention,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm decoder layer: attention (:func:`_attend`: q/k
    rotated by the step's rope tables inside ``mha``) and the SwiGLU FFN
    (or the routed expert bank), projections in ``cfg.dtype`` through
    ``ops/quant.py:Projections`` (int8 under ``cfg.quant``, the tokens'
    scales over the data axes, and sp where the sequence is split).
    Returns the layer's output and its MoE ``[aux, z_loss, drop_rate]``
    (zeros for a dense layer)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    lp = view(lp)             # over fsdp, this layer's weights gathered here
    # Under tp the weights are this rank's column (q/k/v, gate/up) or
    # row (wo, w_down) shards: the head counts come from their shapes.
    proj = Projections(cfg.quant, cfg.dtype,
                       DATA_AXES if att.rows is None else DATA_AXES + ("sp",))
    h = proj.enter(rmsnorm(x, lp["attn_norm"], cfg.norm_eps))
    q = proj.column(h, lp["wq"]).reshape(b, s, -1, hd)
    k = proj.column(h, lp["wk"]).reshape(b, s, -1, hd)
    v = proj.column(h, lp["wv"]).reshape(b, s, -1, hd)
    attn = _attend(cfg, q, k, v, att)
    x = x + proj.row(attn.reshape(b, s, -1), lp["wo"])
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe_experts:
        # The routing groups are runs of whole rows: under a split
        # sequence, route the sequence gathered over sp and keep this
        # rank's slice (the gather's backward reduce-scatters: each rank's
        # loss reads its slice, and the routing mixes a group's tokens).
        split = att.rows is not None
        down, aux = _moe_ffn(cfg, lp, seq_gather(h) if split else h)
        return x + (down[:, att.rows] if split else down), aux
    aux = torch.zeros(3, dtype=torch.float32, device=x.device)
    h = proj.enter(h)
    if cfg.remat == "ffn":
        return x + _ffn_remat(proj, h, lp["w_gate"], lp["w_up"], lp["w_down"]), aux
    prod = F.silu(proj.column(h, lp["w_gate"])) * proj.column(h, lp["w_up"])
    return x + proj.row(prod, lp["w_down"]), aux


def _embed(cfg: TransformerConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    return view(params["embed"]).to(cfg.dtype)[tokens]


def _embedded(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor],
              segment_ids: Optional[torch.Tensor]):
    """The checks, the embeddings of this rank's tokens (its slice of
    each row when the sequence is split over sp) and the step's
    :class:`_Attention`, built on the whole rows (positions and segment
    ids default to ``arange`` and none)."""
    check_ported(cfg)
    check_mesh(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    att = _attention_inputs(cfg, positions, segment_ids)
    x = _embed(cfg, params, tokens if att.rows is None else tokens[:, att.rows])
    return x, att


def _stacked_layers(cfg: TransformerConfig, params: Params, stages: int = 1,
                    pipelined: bool = False):
    """Each layer's weights (``sharding.layers``: over fsdp each slice is
    gathered inside its layer), this stage's ``n_layers / stages`` under
    pp. ``pipelined``: the layers run on every tick, and each slice's
    gradient is reduced once for all of them."""
    per_layer = {k: layers(v, once=pipelined) for k, v in params["layers"].items()}
    n = len(next(iter(per_layer.values())))
    if n * stages != cfg.n_layers:
        raise ValueError(
            f"this rank holds {n} of {cfg.n_layers} layers over {stages} "
            "pipeline stage(s): a layer stack sharded over pp "
            "(param_specs(cfg, pp=True)) runs through "
            "next_token_loss(pp_microbatches=M)")
    return [{k: v[i] for k, v in per_layer.items()} for i in range(n)]


def forward_hidden(
    cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (final-norm hidden ``[B, S, d_model]``, MoE
    aux ``[load-balance sum, z-loss sum, drop-rate mean]`` over the
    layers; zeros for a dense model). With the sequence split over sp the
    hidden state is this rank's ``[B, S/sp, d_model]`` slice; ``tokens``,
    ``positions`` and ``segment_ids`` are whole rows all the same. The
    rope tables are built once for the step and shared by every layer.
    The stacked layer weights are split with one ``unbind`` per leaf, so
    the backward stacks each leaf's gradient once. A layer runs under a
    checkpoint when ``remat`` is True, or ``"ffn"`` on a MoE model (the
    routing is recomputed in the backward: it is deterministic)."""
    x, att = _embedded(cfg, params, tokens, positions, segment_ids)
    whole = cfg.remat is True or (cfg.remat == "ffn" and cfg.moe_experts)
    auxes = []
    for lp in _stacked_layers(cfg, params):
        if whole:
            x, aux = checkpoint(_layer, cfg, lp, x, att, use_reentrant=False)
        else:
            x, aux = _layer(cfg, lp, x, att)
        auxes.append(aux)
    aux = torch.stack(auxes)                               # [L, 3]
    aux = torch.stack([aux[:, 0].sum(), aux[:, 1].sum(), aux[:, 2].mean()])
    return rmsnorm(x, view(params["final_norm"]), cfg.norm_eps), aux


def forward_hidden_pp(
    cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
    n_microbatches: int,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward_hidden` with the layer stack run as a GPipe
    schedule over the ambient mesh's pp axis (``parallel/pipeline.py``):
    this stage's layers (``param_specs(cfg, pp=True)``) on each of
    ``n_microbatches`` microbatches in turn, handed from stage to stage.
    The embedding, the final norm and the head stay outside the pipeline
    (every stage computes them; stage 0's embeddings feed it). Positions
    and segment ids ride along as the pipeline's extras, each stage
    indexing the microbatch it holds. The stage function runs under a
    checkpoint when ``remat`` is True (``"ffn"``: its FFNs recompute
    their products, as in :func:`forward_hidden`). Over fsdp a stage
    layer's weights are gathered at each use, on every tick, and their
    gradient is reduced once a step. Dense layers only, as the JAX
    package's; needs an ambient mesh, as its ``shard_map`` does."""
    if cfg.moe_experts:
        raise NotImplementedError(
            "pipeline path supports dense layers only (shard experts over "
            "ep instead)")
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            "the pipeline runs over the ambient mesh's pp axis: call it "
            "under parallel.mesh.use_mesh(mesh)")
    x, att = _embedded(cfg, params, tokens, positions, segment_ids)
    stage_layers = _stacked_layers(cfg, params, pp_stage_count(mesh), pipelined=True)

    def stage(stage_layers, x_mb, extra):
        pos, segs = extra
        att_mb = _attention_inputs(cfg, pos, segs)
        for lp in stage_layers:
            x_mb, _ = _layer(cfg, lp, x_mb, att_mb)
        return x_mb

    x = gpipe(stage, stage_layers, x, n_microbatches, remat=cfg.remat is True,
              extras=(att.positions, att.segment_ids))
    return (rmsnorm(x, view(params["final_norm"]), cfg.norm_eps),
            torch.zeros(3, dtype=torch.float32, device=x.device))


def _head(cfg: TransformerConfig, params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    head = view(params["embed"]).T if head is None else view(head)
    return head.to(cfg.dtype)


def _logits(h2: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``h2 [N, D] @ head [D, V]`` as fp32 logits (:class:`_LogitsF32`
    for compute-dtype operands)."""
    return h2 @ head if h2.dtype == torch.float32 else _LogitsF32.apply(h2, head)


def forward(
    cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens ``[B, S]`` -> fp32 logits ``[B, S, vocab]``:
    :func:`forward_hidden`, then the head (``lm_head``, or ``embed.T``
    when tied) in ``cfg.dtype`` with the product accumulated in fp32, as
    the JAX package's ``forward``. Over a mesh every rank returns the
    whole logits, as a JAX global array reads: a hidden state split over
    sp is gathered before the head, and a vocab-parallel head's shards
    are joined over tp."""
    hidden, _ = forward_hidden(cfg, params, tokens, positions, segment_ids)
    if _split_rows(cfg, tokens.shape[1]) is not None:
        hidden = seq_gather(hidden)
    b, s, d = hidden.shape
    h2 = hidden.reshape(b * s, d)
    head = _head(cfg, params)
    if tp_size() > 1 and "lm_head" in params:
        logits = tp_concat(_logits(tp_copy(h2), head))
    else:
        logits = _logits(h2, head)
    return logits.reshape(b, s, -1)


def train_flops_per_token(cfg: TransformerConfig, seq: int) -> float:
    """Model FLOPs per trained token: ``6 * N_active`` matmul FLOPs
    (forward and backward) plus the causal-attention term ``12 * L * H *
    hd * seq / 2`` (the PaLM appendix B convention, as the JAX package
    counts). A MoE layer's active FFN is its ``top_k`` experts and the
    router."""
    if cfg.moe_experts:
        ffn = (cfg.moe_top_k * 3 * cfg.d_model * cfg.d_ff
               + cfg.d_model * cfg.moe_experts)
    else:
        ffn = 3 * cfg.d_model * cfg.d_ff
    n_active = (
        cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        + cfg.n_layers * (
            cfg.d_model * cfg.n_heads * cfg.head_dim * 2
            + cfg.d_model * cfg.n_kv_heads * cfg.head_dim * 2
            + ffn
        )
    )
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * (seq / 2)
    return 6 * n_active + attn


class _LogitsF32(torch.autograd.Function):
    """``hidden [N, D] @ head [D, V]`` from operands in the compute dtype,
    accumulated straight into fp32 logits, as the JAX package's dot with
    ``preferred_element_type=float32`` computes them: the logits never
    pass through the compute dtype. The backward casts the fp32 logit
    gradient to the operands' dtype for its two products, as a TPU's
    default-precision matmul rounds an fp32 operand to bf16."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.is_cuda:
            return torch.mm(h, w, out_dtype=torch.float32)
        return h.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return g @ w.T, h.T @ g


def vocab_parallel_nll_and_argmax(logits: torch.Tensor, targets: torch.Tensor):
    """Per-row NLL and argmax of fp32 ``logits [N, V/tp]``, this rank's
    vocab shard (the rows the same on every tp rank): the log-sum-exp
    from the tp max and the tp sum of the shards' exponentials, the
    target logit from the shard that holds it (a one-hot reduce summed
    over tp, as the JAX package's ``_select_target_logp`` under tp), and
    the argmax as the first global maximum. ``targets``: ``[N]`` global
    vocab ids. Off a tp mesh: the plain log-softmax's."""
    v_loc = logits.shape[-1]
    off = tp_index() * v_loc
    m = tp_max(logits.max(-1).values)
    lse = m + torch.log(tp_sum(torch.exp(logits - m[:, None]).sum(-1)))
    t = targets.reshape(-1).long() - off
    here = (t >= 0) & (t < v_loc)
    picked = logits.gather(-1, t.clamp(0, v_loc - 1)[:, None])[:, 0]
    nll = lse - tp_sum(torch.where(here, picked, torch.zeros_like(picked)))
    local_am = logits.argmax(-1)
    best = tp_gather(logits.gather(-1, local_am[:, None])[:, 0]).argmax(0)
    am = tp_gather(local_am + off).gather(0, best[None])[0]
    return nll, am


def _vocab_parallel_nll_and_argmax(hidden: torch.Tensor, head: torch.Tensor,
                                   targets: torch.Tensor):
    """:func:`_nll_and_argmax` with ``head`` this rank's ``[D, V/tp]``
    vocab shard (:func:`vocab_parallel_nll_and_argmax` on its logits)."""
    b, s, d = hidden.shape
    h2 = tp_copy(hidden.reshape(b * s, d))
    nll, am = vocab_parallel_nll_and_argmax(_logits(h2, head), targets)
    return nll.reshape(b, s), am.reshape(b, s)


def _nll_and_argmax(hidden: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, vocab_parallel: bool = False):
    if vocab_parallel:
        return _vocab_parallel_nll_and_argmax(hidden, head, targets)
    b, s, d = hidden.shape
    h2 = hidden.reshape(b * s, d)
    logits = _logits(h2, head).reshape(b, s, -1)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return nll, logits.argmax(-1)


def _chunked_nll_and_argmax(
    cfg: TransformerConfig, hidden: torch.Tensor, head: torch.Tensor,
    targets: torch.Tensor, chunk: int, vocab_parallel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position NLL and argmax with the vocab projection streamed in
    sequence chunks, each under a checkpoint, so at most one chunk's
    ``[B, chunk, vocab]`` fp32 logits exist at a time."""
    nll, am = [], []
    for lo in range(0, hidden.shape[1], chunk):
        n, a = checkpoint(_nll_and_argmax, hidden[:, lo:lo + chunk], head,
                          targets[:, lo:lo + chunk], vocab_parallel,
                          use_reentrant=False)
        nll.append(n)
        am.append(a)
    return torch.cat(nll, 1), torch.cat(am, 1)


def packed_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-document position ids for a packed batch: positions restart at
    0 at every segment boundary. ``[B, S]`` -> ``[B, S]`` int64."""
    b, s = segment_ids.shape
    idx = torch.arange(s, device=segment_ids.device).expand(b, s)
    is_start = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=segment_ids.device),
         segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - seg_start


def next_token_loss(
    cfg: TransformerConfig, params: Params, batch: Dict[str, torch.Tensor],
    loss_chunk: int = 0, pp_microbatches: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss: predict ``tokens[1:]`` from ``tokens[:-1]``.

    Positions where ``batch["mask"]`` is 0 are ignored. Packed batches
    carry ``batch["segment_ids"]`` (id 0 = padding): attention stays
    inside each document, RoPE restarts per document, and targets that
    cross a boundary or land in padding are excluded. ``loss_chunk > 0``
    streams the vocab projection in chunks (the largest divisor of S not
    above it). Returns ``(loss, {"accuracy", "perplexity"})``; a MoE
    model adds ``moe_aux_weight`` times the load-balance loss (and
    ``moe_router_z_weight`` times the router z-loss) to the loss, and
    reports ``moe_aux`` and ``moe_drop_rate``.

    The vocab projection takes ``cfg.dtype`` operands and accumulates
    fp32 logits, as the JAX package's does. ``pp_microbatches = M > 0``
    runs the layer stack over the mesh's pp axis in M microbatches
    (:func:`forward_hidden_pp`). With the sequence split over sp each
    rank scores its slice of the targets; the mean over the loss ranks is
    the global batch's (``masked_denominator``)."""
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    segs = batch.get("segment_ids")
    seg_in = None if segs is None else segs[:, :-1]
    kw = dict(positions=None if seg_in is None else packed_positions(seg_in),
              segment_ids=seg_in)
    if pp_microbatches:
        hidden, aux = forward_hidden_pp(cfg, params, tokens[:, :-1], pp_microbatches, **kw)
    else:
        hidden, aux = forward_hidden(cfg, params, tokens[:, :-1], **kw)
    s_all = targets.shape[1]
    rows = _split_rows(cfg, s_all)
    if rows is not None:
        targets = targets[:, rows]
    head = _head(cfg, params)
    # Under tp the untied head is this rank's vocab shard.
    vp = tp_size() > 1 and "lm_head" in params
    if loss_chunk:
        # The largest divisor of the whole sequence, as the JAX package
        # picks it; a rank's slice ends on a shorter chunk if need be.
        chunk = max(d for d in range(1, min(loss_chunk, s_all) + 1) if s_all % d == 0)
        nll, am = _chunked_nll_and_argmax(cfg, hidden, head, targets, chunk, vp)
    else:
        nll, am = _nll_and_argmax(hidden, head, targets, vp)
    mask = batch.get("mask")
    mask = None if mask is None else mask[:, 1:].float()
    if segs is not None:
        valid = ((segs[:, 1:] == segs[:, :-1]) & (segs[:, 1:] != 0)).float()
        mask = valid if mask is None else mask * valid
    if mask is not None and rows is not None:
        mask = mask[:, rows]
    hits = (am == targets).float()
    if mask is not None:
        # Over the loss ranks of a mesh (data, sp, pp) their mean loss is the
        # global batch's masked mean: each divides by the mean count.
        denom = masked_denominator(mask.sum())
        loss = (nll * mask).sum() / denom
        acc = (hits * mask).sum() / denom
    else:
        loss = nll.mean()
        acc = hits.mean()
    metrics = {"accuracy": acc, "perplexity": torch.exp(loss)}
    if cfg.moe_experts:
        loss = loss + cfg.moe_aux_weight * aux[0]
        if cfg.moe_router_z_weight:
            loss = loss + cfg.moe_router_z_weight * aux[1]
        metrics["moe_aux"] = aux[0]
        metrics["moe_drop_rate"] = aux[2]
    return loss, metrics


def make_loss_fn(cfg: TransformerConfig, pp_microbatches: int = 0):
    """``loss_fn(params, batch) -> (loss, metrics)`` for ``TrainLoop``; it
    reads every parameter through ``sharding.view`` (``gathers_params``).
    ``pp_microbatches``: the pipelined loss (the JAX package's train
    steps call ``next_token_loss(..., pp_microbatches=M)`` themselves)."""
    def loss_fn(params, batch):
        return next_token_loss(cfg, params, batch, pp_microbatches=pp_microbatches)

    loss_fn.gathers_params = True
    return loss_fn


def make_init_fn(cfg: TransformerConfig):
    """``init_fn(seed, device) -> params`` for ``TrainLoop``."""
    def init_fn(seed, device):
        return init_params(cfg, seed=seed, device=device)

    return init_fn


def count_params(params: Params) -> int:
    return sum(t.numel() for t in tree_leaves(params))
