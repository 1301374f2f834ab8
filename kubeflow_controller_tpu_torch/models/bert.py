"""BERT-base masked-LM pretraining model.

Counterpart of ``kubeflow_controller_tpu/models/bert.py``: the same
parameter tree (``embed``, ``pos_embed``, ``embed_norm``, every layer's
weights stacked on a leading ``[L, ...]`` axis under ``layers``, the MLM
head) and the same arithmetic: post-norm residual blocks, LayerNorm in
fp32 cast back to the compute dtype, tanh-approximated GELU, learned
positions, and an MLM head tied to ``embed`` whose logits accumulate in
fp32. Padding becomes segment ids (1 = real, 0 = pad), so padded tokens
attend only to each other; attention is ``ops/attention.py:mha`` with
``causal=False``, which takes the flash kernels (B1 forward, B2 fused
backward at one tile) on bf16 CUDA tensors at ``S >= 256`` and the dense
path otherwise. The six projections a layer go through
``ops/quant.py:maybe_quant_dot`` (int8 under ``cfg.quant``).

Remat: each layer runs under ``torch.utils.checkpoint`` when
``cfg.remat`` is true, so the backward runs every layer's forward again
(one more B1 launch a layer). The JAX package saves the projections'
outputs (``dots_with_no_batch_dims_saveable``) and so recomputes less.

Over a mesh (``dataplane/train.py``), :func:`param_specs` places the
parameters as the JAX package's do and the loss divides by the scored
positions of the global batch; tensor parallelism is not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.models.transformer import _LogitsF32
from kubeflow_controller_tpu_torch.ops.attention import mha
from kubeflow_controller_tpu_torch.ops.quant import maybe_quant_dot
from kubeflow_controller_tpu_torch.parallel.collectives import (
    masked_denominator, tp_size,
)
from kubeflow_controller_tpu_torch.parallel.sharding import P, layers, view

Params = Dict[str, Any]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    attn_impl: str = "auto"                   # auto|xla|flash
    # "" | "int8" | "int8_fused": the six per-layer projections through
    # ops/quant.py; the MLM head stays in the compute dtype.
    quant: str = ""
    mask_token_id: int = 103                  # [MASK] in the BERT vocab
    mlm_prob: float = 0.15

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def replace(self, **kw) -> "BertConfig":
        return dataclasses.replace(self, **kw)


def bert_base_config(**kw) -> BertConfig:
    return BertConfig().replace(**kw)


def bert_tiny_config(**kw) -> BertConfig:
    base = BertConfig(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
                      d_ff=64, max_seq=64, remat=False, dtype=torch.float32)
    return base.replace(**kw)


def init_params(cfg: BertConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Scaled-normal weights (``N(0, 1) / sqrt(fan_in)``), zero biases,
    unit norms, drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``. The draws differ from ``jax.random``'s; tests carry the
    JAX package's weights across with ``convert.params_from_numpy``."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=pd).mul_(fan_in ** -0.5)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=pd)

    def norm(*lead):
        return {"scale": torch.ones(lead + (D,), device=dev, dtype=pd),
                "bias": zeros(*lead, D)}

    return {
        "embed": normal((cfg.vocab_size, D), D),
        "pos_embed": normal((cfg.max_seq, D), D),
        "embed_norm": norm(),
        "layers": {
            "wq": normal((L, D, D), D), "bq": zeros(L, D),
            "wk": normal((L, D, D), D), "bk": zeros(L, D),
            "wv": normal((L, D, D), D), "bv": zeros(L, D),
            "wo": normal((L, D, D), D), "bo": zeros(L, D),
            "attn_norm": norm(L),
            "w_up": normal((L, D, Fd), D), "b_up": zeros(L, Fd),
            "w_down": normal((L, Fd, D), Fd), "b_down": zeros(L, D),
            "mlp_norm": norm(L),
        },
        "mlm_dense": normal((D, D), D),
        "mlm_bias": zeros(D),
        "mlm_norm": norm(),
        "mlm_out_bias": zeros(cfg.vocab_size),
    }


def layernorm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """Normalize in fp32, cast back to ``x``'s dtype, then scale and
    shift in that dtype (the JAX package's order)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu's default


def param_specs(cfg: BertConfig) -> Params:
    """The placement of every parameter (``parallel/sharding.py``), as
    the JAX package's ``param_specs``. The port trains BERT over the
    data axes (dp, fsdp) only: a mesh with ``tp > 1`` is refused by
    :func:`mlm_loss`."""
    return {
        "embed": P("tp", "fsdp"),
        "pos_embed": P(None, "fsdp"),
        "embed_norm": {"scale": P(None), "bias": P(None)},
        "layers": {
            "wq": P(None, "fsdp", "tp"),
            "bq": P(None, "tp"),
            "wk": P(None, "fsdp", "tp"),
            "bk": P(None, "tp"),
            "wv": P(None, "fsdp", "tp"),
            "bv": P(None, "tp"),
            "wo": P(None, "tp", "fsdp"),
            "bo": P(None, None),
            "attn_norm": {"scale": P(None, None), "bias": P(None, None)},
            "w_up": P(None, "fsdp", "tp"),
            "b_up": P(None, "tp"),
            "w_down": P(None, "tp", "fsdp"),
            "b_down": P(None, None),
            "mlp_norm": {"scale": P(None, None), "bias": P(None, None)},
        },
        "mlm_dense": P("fsdp", "tp"),
        "mlm_bias": P("tp"),
        "mlm_norm": {"scale": P(None), "bias": P(None)},
        "mlm_out_bias": P("tp"),
    }


def _layer(cfg: BertConfig, lp: Params, x: torch.Tensor,
           segs: Optional[torch.Tensor]) -> torch.Tensor:
    b, s, _ = x.shape
    dt, hd = cfg.dtype, cfg.head_dim
    lp = view(lp)             # over fsdp, this layer's weights gathered here

    def dot(a, w):
        return maybe_quant_dot(a, w.to(dt), cfg.quant)

    q = (dot(x, lp["wq"]) + lp["bq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    k = (dot(x, lp["wk"]) + lp["bk"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    v = (dot(x, lp["wv"]) + lp["bv"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    attn = mha(q, k, v, causal=False, segment_ids=segs,
               impl=cfg.attn_impl).reshape(b, s, cfg.d_model)
    x = layernorm(x + dot(attn, lp["wo"]) + lp["bo"].to(dt),
                  lp["attn_norm"], cfg.norm_eps)
    h = _gelu(dot(x, lp["w_up"]) + lp["b_up"].to(dt))
    h = dot(h, lp["w_down"]) + lp["b_down"].to(dt)
    return layernorm(x + h, lp["mlp_norm"], cfg.norm_eps)


def _unbind_layers(tree, n: int):
    """The stacked ``[L, ...]`` layer tree as ``n`` per-layer trees, one
    ``unbind`` a leaf (so the backward stacks each leaf's gradient
    once; ``sharding.layers``: over fsdp, each slice is gathered inside
    its layer)."""
    if isinstance(tree, dict):
        parts = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return layers(tree)


def encode(cfg: BertConfig, params: Params, tokens: torch.Tensor,
           attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens ``[B, S]`` -> hidden ``[B, S, D]``; ``attention_mask``: 1 =
    real, 0 = pad."""
    if cfg.attn_impl not in ("auto", "xla", "flash"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not yet ported (auto|xla|flash)")
    b, s = tokens.shape
    dt = cfg.dtype
    embed = view(params["embed"])
    x = embed.to(dt)[tokens] + view(params["pos_embed"]).to(dt)[None, :s]
    x = layernorm(x, view(params["embed_norm"]), cfg.norm_eps)
    segs = (attention_mask.to(torch.int32)
            if attention_mask is not None else None)
    for lp in _unbind_layers(params["layers"], cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_layer, cfg, lp, x, segs, use_reentrant=False)
        else:
            x = _layer(cfg, lp, x, segs)
    return x


def mlm_logits(cfg: BertConfig, params: Params,
               hidden: torch.Tensor) -> torch.Tensor:
    """The MLM head: dense, GELU, LayerNorm, then the tied ``embed``
    product accumulated straight into fp32 logits, plus the fp32 output
    bias."""
    dt = cfg.dtype
    h = _gelu(hidden @ view(params["mlm_dense"]).to(dt) + view(params["mlm_bias"]).to(dt))
    h = layernorm(h, view(params["mlm_norm"]), cfg.norm_eps)
    b, s, d = h.shape
    head = view(params["embed"]).to(dt).T
    h2 = h.reshape(b * s, d)
    logits = h2 @ head if h2.dtype == torch.float32 else _LogitsF32.apply(h2, head)
    return logits.reshape(b, s, -1) + view(params["mlm_out_bias"]).float()


def mlm_loss(cfg: BertConfig, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: ``tokens`` (with the [MASK]s applied), ``targets``,
    ``mlm_mask`` (1 where a prediction is scored), ``attention_mask``.
    Returns ``(loss, {"mlm_accuracy"})`` over the scored positions."""
    if tp_size() > 1:
        raise NotImplementedError(
            "BERT over a tp > 1 mesh is not yet ported (dp and fsdp are)")
    hidden = encode(cfg, params, batch["tokens"], batch.get("attention_mask"))
    logits = mlm_logits(cfg, params, hidden)
    targets = batch["targets"].long()
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    w = batch["mlm_mask"].float()
    # Over the data ranks of a mesh, the mean of the ranks' losses is the
    # global batch's: each divides by the mean count.
    denom = masked_denominator(w.sum())
    loss = (nll * w).sum() / denom
    acc = ((logits.argmax(-1) == targets) * w).sum() / denom
    return loss, {"mlm_accuracy": acc}


def make_loss_fn(cfg: BertConfig):
    """``loss_fn(params, batch) -> (loss, metrics)`` for ``TrainLoop``; it
    reads every parameter through ``sharding.view`` (``gathers_params``)."""
    def loss_fn(params, batch):
        return mlm_loss(cfg, params, batch)

    loss_fn.gathers_params = True
    return loss_fn


def make_init_fn(cfg: BertConfig):
    """``init_fn(seed, device) -> params`` for ``TrainLoop``."""
    def init_fn(seed, device):
        return init_params(cfg, seed=seed, device=device)

    return init_fn


def synthetic_mlm_batch(cfg: BertConfig, batch_size: int, seq_len: int,
                        seed: int = 0):
    """The JAX package's MLM stream, draw for draw: repeating-pattern
    token rows, 15 % of positions masked (all to [MASK]), no padding."""
    rng = np.random.default_rng(seed)
    while True:
        start = rng.integers(0, cfg.vocab_size - seq_len, (batch_size, 1))
        targets = (start + np.arange(seq_len)) % cfg.vocab_size
        mlm = rng.random((batch_size, seq_len)) < cfg.mlm_prob
        tokens = np.where(mlm, cfg.mask_token_id, targets)
        yield {
            "tokens": tokens.astype(np.int32),
            "targets": targets.astype(np.int32),
            "mlm_mask": mlm.astype(np.int32),
            "attention_mask": np.ones((batch_size, seq_len), np.int32),
        }
