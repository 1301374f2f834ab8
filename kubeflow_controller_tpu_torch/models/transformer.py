"""Llama-family decoder: config, presets, init, layer math, and the loss.

Counterpart of ``kubeflow_controller_tpu/models/transformer.py``. The
parameter tree keeps the JAX package's layout so the two packages can be
held against each other: a dict with ``embed [V, D]``, ``final_norm
[D]``, ``lm_head [D, V]`` and ``layers`` holding every layer's weights
stacked on a leading ``[L, ...]`` axis, each projection ``[D_in,
D_out]`` and applied as ``x @ w``.

The training forward (:func:`forward_hidden`, :func:`next_token_loss`)
runs the dense decoder on one device: attention through
``ops/attention.py:mha`` (the flash kernels on the card), each layer
under ``torch.utils.checkpoint`` when ``remat`` is true, and its seven
linear projections through ``ops/quant.py:maybe_quant_dot`` (bf16, or
int8 under ``quant``). Not ported yet, and refused by name:
``remat="ffn"``, ``attn_impl="ring"``, mixture-of-experts layers and the
pipeline-parallel stack.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_controller_tpu_torch.convert import tree_leaves
from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.ops.attention import mha
from kubeflow_controller_tpu_torch.ops.flash_attention import rope_full_tables
from kubeflow_controller_tpu_torch.ops.quant import maybe_quant_dot

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
    # False: keep every activation. ("ffn", the JAX package's middle
    # rung, is not ported yet.)
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
    attn_impl: str = "auto"                    # auto|xla|flash
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
        d_ff=128, max_seq=128, remat=False, dtype=torch.float32,
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


# -- training forward ---------------------------------------------------------

def check_ported(cfg: TransformerConfig) -> None:
    """Refuse the training options this port does not have yet."""
    if cfg.remat not in (True, False):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not yet ported (True or False)")
    if cfg.attn_impl not in ("auto", "xla", "flash"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not yet ported (auto|xla|flash)")
    if cfg.quant not in ("", "int8", "int8_fused"):
        raise NotImplementedError(
            f"quant={cfg.quant!r} is not yet ported ('', int8, int8_fused)")


def _layer(
    cfg: TransformerConfig, lp: Params, x: torch.Tensor,
    segment_ids: Optional[torch.Tensor], rope_tables,
) -> torch.Tensor:
    """One pre-norm decoder layer: attention (q/k rotated by the step's
    rope tables inside ``mha``) and the SwiGLU FFN, projections in
    ``cfg.dtype`` through ``maybe_quant_dot`` (int8 under ``cfg.quant``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.dtype

    def dot(a, w):
        return maybe_quant_dot(a, w.to(dt), cfg.quant)

    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = dot(h, lp["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = dot(h, lp["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = dot(h, lp["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    attn = mha(q, k, v, causal=True, segment_ids=segment_ids,
               impl=cfg.attn_impl, rope_tables=rope_tables)
    x = x + dot(attn.reshape(b, s, cfg.n_heads * hd), lp["wo"])
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    prod = F.silu(dot(h, lp["w_gate"])) * dot(h, lp["w_up"])
    return x + dot(prod, lp["w_down"])


def _embed(cfg: TransformerConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"].to(cfg.dtype)[tokens]


def forward_hidden(
    cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens ``[B, S]`` -> final-norm hidden ``[B, S, d_model]``. The
    rope tables are built once for the step and shared by every layer.
    The stacked layer weights are split with one ``unbind`` per leaf, so
    the backward stacks each leaf's gradient once."""
    check_ported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(cfg, params, tokens)
    tables = rope_full_tables(positions, cfg.head_dim, cfg.rope_theta)
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in per_layer.items()}
        if cfg.remat:
            x = checkpoint(_layer, cfg, lp, x, segment_ids, tables,
                           use_reentrant=False)
        else:
            x = _layer(cfg, lp, x, segment_ids, tables)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _head(cfg: TransformerConfig, params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return head.to(cfg.dtype)


def train_flops_per_token(cfg: TransformerConfig, seq: int) -> float:
    """Model FLOPs per trained token: ``6 * N`` matmul FLOPs (forward and
    backward) plus the causal-attention term ``12 * L * H * hd * seq /
    2`` (the PaLM appendix B convention, as the JAX package counts)."""
    n_active = (
        cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        + cfg.n_layers * (
            cfg.d_model * cfg.n_heads * cfg.head_dim * 2
            + cfg.d_model * cfg.n_kv_heads * cfg.head_dim * 2
            + 3 * cfg.d_model * cfg.d_ff
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


def _nll_and_argmax(hidden: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor):
    b, s, d = hidden.shape
    h2 = hidden.reshape(b * s, d)
    logits = (h2 @ head if h2.dtype == torch.float32
              else _LogitsF32.apply(h2, head)).reshape(b, s, -1)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return nll, logits.argmax(-1)


def _chunked_nll_and_argmax(
    cfg: TransformerConfig, hidden: torch.Tensor, head: torch.Tensor,
    targets: torch.Tensor, chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position NLL and argmax with the vocab projection streamed in
    sequence chunks, each under a checkpoint, so at most one chunk's
    ``[B, chunk, vocab]`` fp32 logits exist at a time."""
    nll, am = [], []
    for lo in range(0, hidden.shape[1], chunk):
        n, a = checkpoint(_nll_and_argmax, hidden[:, lo:lo + chunk], head,
                          targets[:, lo:lo + chunk], use_reentrant=False)
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
    above it). Returns ``(loss, {"accuracy", "perplexity"})``.

    The vocab projection takes ``cfg.dtype`` operands and accumulates
    fp32 logits, as the JAX package's does."""
    if pp_microbatches:
        raise NotImplementedError(
            "the pipeline-parallel layer stack is not yet ported")
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    segs = batch.get("segment_ids")
    seg_in = None if segs is None else segs[:, :-1]
    hidden = forward_hidden(
        cfg, params, tokens[:, :-1],
        positions=None if seg_in is None else packed_positions(seg_in),
        segment_ids=seg_in)
    head = _head(cfg, params)
    if loss_chunk:
        s = targets.shape[1]
        chunk = max(d for d in range(1, min(loss_chunk, s) + 1) if s % d == 0)
        nll, am = _chunked_nll_and_argmax(cfg, hidden, head, targets, chunk)
    else:
        nll, am = _nll_and_argmax(hidden, head, targets)
    mask = batch.get("mask")
    mask = None if mask is None else mask[:, 1:].float()
    if segs is not None:
        valid = ((segs[:, 1:] == segs[:, :-1]) & (segs[:, 1:] != 0)).float()
        mask = valid if mask is None else mask * valid
    hits = (am == targets).float()
    if mask is not None:
        denom = mask.sum().clamp_min(1.0)
        loss = (nll * mask).sum() / denom
        acc = (hits * mask).sum() / denom
    else:
        loss = nll.mean()
        acc = hits.mean()
    return loss, {"accuracy": acc, "perplexity": torch.exp(loss)}


def make_loss_fn(cfg: TransformerConfig):
    """``loss_fn(params, batch) -> (loss, metrics)`` for ``TrainLoop``."""
    def loss_fn(params, batch):
        return next_token_loss(cfg, params, batch)

    return loss_fn


def make_init_fn(cfg: TransformerConfig):
    """``init_fn(seed, device) -> params`` for ``TrainLoop``."""
    def init_fn(seed, device):
        return init_params(cfg, seed=seed, device=device)

    return init_fn


def count_params(params: Params) -> int:
    return sum(t.numel() for t in tree_leaves(params))
