"""Llama-family decoder: config, presets, init, and the shared layer math.

Counterpart of ``kubeflow_controller_tpu/models/transformer.py``. The
parameter tree keeps the JAX package's layout so the two packages can be
held against each other: a dict with ``embed [V, D]``, ``final_norm
[D]``, ``lm_head [D, V]`` and ``layers`` holding every layer's weights
stacked on a leading ``[L, ...]`` axis, each projection ``[D_in,
D_out]`` and applied as ``x @ w``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch

from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device

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
    tie_embeddings: bool = False

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
        d_ff=128, max_seq=128, dtype=torch.float32,
    )
    return base.replace(**kw)


def llama3_8b_config(**kw) -> TransformerConfig:
    base = TransformerConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq=8192, rope_theta=500000.0,
    )
    return base.replace(**kw)


# -- params ------------------------------------------------------------------

def init_params(
    cfg: TransformerConfig, seed: int = 0, device: DeviceLike = None,
    dtype: torch.dtype = None,
) -> Params:
    """Scaled-normal init (``N(0, 1) / sqrt(fan_in)``, norms at 1) drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``.

    Each tensor is drawn directly in ``dtype`` (default
    ``cfg.param_dtype``) and scaled in place: serving llama3_8b passes
    ``dtype=cfg.dtype`` so the ~16 GB of bf16 weights never pass through
    a ~32 GB fp32 copy. The draws differ from the JAX package's
    ``jax.random`` init; tests that compare the two packages carry one
    package's weights across with ``convert.params_from_numpy``."""
    dev = resolve_device(device)
    dt = cfg.param_dtype if dtype is None else dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    hd = cfg.head_dim
    L = cfg.n_layers

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dt)
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
        "w_gate": normal((L, d, f), d),
        "w_up": normal((L, d, f), d),
        "w_down": normal((L, f, d), f),
    }
    params: Params = {
        "embed": normal((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d)
    return params


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
