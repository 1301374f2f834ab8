"""Paged-KV decode, prefill and verify for the serving engine.

Counterpart of ``kubeflow_controller_tpu/models/generate.py``: the fused
block prefill (:func:`prefill` into a contiguous :class:`KVCache`,
:func:`prefill_into_paged` into one slot's pages), the paged decode
step, the chunked prefill and the greedy speculative verify step
(:func:`verify_step_paged`); the contiguous multi-turn path
(:func:`decode_step`, :func:`prefill_continue`,
:func:`generate_from_cache`, :func:`generate`; one device only, as in
the JAX package); and the page movement under the prefix cache
(:func:`gather_pool_pages` and :func:`install_pool_pages` for the host
tier, :func:`scatter_row_into_pool` for ``register_prefix``). The
pool's ``[L, n_blocks, bs, KVH, D]`` pages are the only KV storage of
the paged paths; each slot reads and writes them through its row of
the block table (sentinel id ``n_blocks`` = unallocated).

Attention runs one of two ways (``attn_impl``):

* ``"kernel"`` (the default; the JAX engine's ``"pallas"``, accepted as
  an alias): the
  hand-written paged-attention kernels of ``ops/paged_attention.py`` on
  the card, their plain PyTorch versions on the CPU;
* ``"gather"`` (the JAX engine's ``"xla"`` oracle, accepted as an
  alias): gather the dense view
  with ``ops/attention.py:paged_kv_view`` and run a full-row softmax.

The block prefill is not paged: it runs ``ops/attention.py:mha`` over
the whole prompt (the flash kernels for bf16 CUDA prompts that tile,
the dense path otherwise), as the JAX package does.

A MoE model routes every path's FFN as the JAX package does on one
device: one token a row (the decode steps) through
:func:`_moe_decode_ffn` (the top-k experts, no capacity), a block of
positions (prefill, chunks, verify windows) through the training FFN
with capacity factor ``E / top_k``, so that no token is dropped.

Tensor parallelism (``mesh``, a ``parallel.mesh.serving_mesh``): one
process a tp rank, each running the same call on its chunks of the
weights (``parallel.sharding.shard_serving_params``) and its ``KVH /
tp`` heads of the pool (``init_paged_cache(tp=...)``); tables, lengths,
activations and logits are whole on every rank. ``tp_compute="gathered"``
gathers each layer's weights where it runs, projects every head, keeps
this rank's head group for attention and gathers the head outputs
before the whole ``wo``: the one-device arithmetic, so greedy streams
are the one-device streams bit for bit. ``"parallel"`` runs Megatron's
column- and row-parallel projections on the chunks in place, with one
tp sum after ``wo`` and one after ``w_down`` (logits within
:func:`tp_parallel_tolerance`). A MoE model's experts split over tp in
both modes and tokens travel to them (:func:`_moe_ep_ffn`, within
:func:`moe_ep_tolerance`). The JAX package's ``psum``, ``all_gather``
and ``all_to_all`` are ``parallel/collectives.py``'s ``tp_sum``,
``gather_dim`` and ``all_to_all(axis="tp")`` over the mesh's tp group.

Where JAX returns a new cache, the port writes the pool in place (it is
most of the device memory a server holds) and returns the same
:class:`PagedKVCache` object with ``length`` advanced.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_controller_tpu_torch.models import transformer as tfm
from kubeflow_controller_tpu_torch.models.transformer import (
    Params, TransformerConfig, rmsnorm, rope,
)
from kubeflow_controller_tpu_torch.ops import prng
from kubeflow_controller_tpu_torch.ops.attention import mha, paged_kv_view
from kubeflow_controller_tpu_torch.ops.flash_attention import rope_full_tables
from kubeflow_controller_tpu_torch.ops.paged_attention import (
    MASK_VALUE, paged_attention_decode, paged_attention_prefill,
    paged_attention_verify,
)
from kubeflow_controller_tpu_torch.parallel import collectives as coll
from kubeflow_controller_tpu_torch.parallel.mesh import Mesh, use_mesh
from kubeflow_controller_tpu_torch.parallel.sharding import P, tp_dims

ATTN_IMPLS = ("kernel", "gather")
#: The JAX engine's names for the same two paths.
ATTN_IMPL_ALIASES = {"pallas": "kernel", "xla": "gather"}


def check_attn_impl(attn_impl: str) -> str:
    """The port's name of ``attn_impl`` (``"pallas"`` is ``"kernel"``,
    ``"xla"`` is ``"gather"``); raises on any other name."""
    attn_impl = ATTN_IMPL_ALIASES.get(attn_impl, attn_impl)
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(
            f"attn_impl must be 'kernel' ('pallas') or 'gather' ('xla') "
            f"(got {attn_impl!r})")
    return attn_impl


#: Projection weights eligible for weight-only int8 serving: matmul
#: operands whose contraction axis is the second-to-last. The embedding
#: (a gather table), the norms and the MoE router stay out.
_QUANT_KEYS = frozenset(
    ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"))


def quantize_weight(x: torch.Tensor, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight-only int8: ``(q int8, scale)`` with one symmetric scale per
    output channel, over the contraction axis -2: ``scale = max(|x|,
    1e-30) / 127`` in fp32, ``q = clip(round(x / scale), -127, 127)``
    (round half to even), the scale stored in ``dtype``. The JAX
    package computes it eagerly, with true divisions, and so does this
    on either device: the 127 is a tensor, because PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead
    (which moves a code now and then)."""
    xf = x.detach().float()
    amax = xf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-30)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.to(dtype)


def inference_params(
    cfg: TransformerConfig, params: Params, quant: str = "",
) -> Params:
    """Prepare master weights for serving: fp32 tensors cast to the
    compute dtype (others kept), detached from any autograd graph (a
    training loop's parameters require gradients; serving writes them
    into the KV pool in place). The MoE router stays as it is.

    ``quant="int8"``: weight-only int8. Each weight of
    :data:`_QUANT_KEYS` becomes a ``(q, scale)`` pair
    (:func:`quantize_weight`), dequantized in the compute dtype where it
    is used (:func:`_w`); activations and the KV pool stay as they are."""
    if quant not in ("", "int8"):
        raise ValueError(f"quant must be '' or 'int8' (got {quant!r})")

    def cast(key, x):
        if isinstance(x, dict):
            return {k: cast(k, v) for k, v in x.items()}
        x = x.detach()
        if key == "w_router":
            return x
        if quant == "int8" and key in _QUANT_KEYS:
            return quantize_weight(x, cfg.dtype)
        return x.to(cfg.dtype) if x.dtype == torch.float32 else x

    return cast(None, params)


def init_inference_params(
    cfg: TransformerConfig, seed: int = 0, device: DeviceLike = None,
    quant: str = "",
) -> Params:
    """A fresh init ready to serve, bit for bit ``inference_params(cfg,
    init_params(cfg, seed, device, dtype=cfg.dtype), quant)``. Under
    ``quant="int8"`` a MoE model's expert banks never exist whole in the
    compute dtype: each bank is drawn a layer at a time
    (``transformer.init_bank_layer``) and quantized an expert at a time
    into the preallocated ``[L, E, ...]`` codes and ``[L, E, 1, ...]``
    scales. (mixtral_8x7b's banks are ~90 GB in bf16, its int8 tree ~47
    GB.) The per-output-channel quantization reduces over one expert's
    contraction axis, so quantizing an expert alone gives the codes and
    scales of the whole bank."""
    dev = resolve_device(device)
    if quant != "int8" or not cfg.moe_experts:
        return inference_params(
            cfg, tfm.init_params(cfg, seed=seed, device=dev, dtype=cfg.dtype),
            quant=quant)
    params = inference_params(
        cfg, tfm.init_params(cfg, seed=seed, device=dev, dtype=cfg.dtype,
                             banks=False), quant=quant)
    layers = params["layers"]
    L, E = cfg.n_layers, cfg.moe_experts
    for name in tfm.MOE_BANKS:
        shape, _ = tfm.bank_shape(cfg, name)
        q = torch.empty((L, *shape), dtype=torch.int8, device=dev)
        scale = torch.empty((L, E, 1, shape[-1]), dtype=cfg.dtype, device=dev)
        for i in range(L):
            w = tfm.init_bank_layer(cfg, name, i, seed, dev, cfg.dtype)
            for e in range(E):
                q[i, e], scale[i, e] = quantize_weight(w[e], cfg.dtype)
            del w
        layers[name] = (q, scale)
    return params


def weight_quant(params: Params) -> str:
    """``"int8"`` when ``params`` holds weight-only int8 projections
    (``inference_params(quant="int8")``), else ``""``."""
    wq = params.get("layers", {}).get("wq")
    return "int8" if isinstance(wq, tuple) else ""


def _w(lp: Params, name: str, dt: torch.dtype) -> torch.Tensor:
    """A projection weight in the compute dtype; a ``(q, scale)`` pair is
    dequantized as ``q.to(dt) * scale.to(dt)``, as the JAX package does."""
    w = lp[name]
    if isinstance(w, tuple):
        q, scale = w
        return q.to(dt) * scale.to(dt)
    return w.to(dt)


def inference_param_specs(cfg: TransformerConfig, quant: str = "") -> Params:
    """The specs of ``inference_params(cfg, ..., quant)``'s tree
    (``transformer.param_specs``), so that int8 serving weights place as
    bf16 ones do: a quantized weight's ``(q, scale)`` pair gets (the
    weight's spec, that spec with the contraction axis, always -2,
    dropped: the scale is size 1 there)."""
    specs = tfm.param_specs(cfg)
    if quant != "int8":
        return specs

    def fix(key, s):
        if isinstance(s, dict):
            return {k: fix(k, v) for k, v in s.items()}
        if key in _QUANT_KEYS:
            parts = tuple(s)
            return (s, P(*parts[:-2], None, parts[-1]))
        return s

    return fix(None, specs)


# -- tensor parallelism -------------------------------------------------------

TP_COMPUTE = ("gathered", "parallel")


def tp_size(mesh: Optional[Mesh]) -> int:
    """The tp extent of ``mesh`` (1 when mesh is None)."""
    return 1 if mesh is None else int(mesh.shape.get("tp", 1))


def check_tp_heads(cfg: TransformerConfig, tp: int,
                   tp_compute: str = "gathered") -> None:
    """Refuse a config that does not shard over ``tp``, in ONE message
    listing every violated axis, as the JAX package does: ``n_kv_heads %
    tp`` (KV heads split over tp), ``d_ff % tp`` under
    ``tp_compute="parallel"`` for a dense config (the MLP's hidden axis
    is column-split), ``moe_experts % tp`` (each rank holds ``E/tp``
    experts)."""
    if tp <= 1:
        return
    problems = []
    if cfg.n_kv_heads % tp:
        problems.append(
            f"n_kv_heads must be divisible by tp — KV heads split "
            f"across the tp axis (n_kv_heads={cfg.n_kv_heads}, tp={tp}); "
            f"pick tp from the divisors of n_kv_heads, or reshape the "
            f"model"
        )
    if tp_compute == "parallel" and not cfg.moe_experts and cfg.d_ff % tp:
        problems.append(
            f"d_ff must be divisible by tp under tp_compute='parallel' "
            f"— the MLP hidden axis is column-split across shards "
            f"(d_ff={cfg.d_ff}, tp={tp}); use tp_compute='gathered' or "
            f"pick tp from the divisors of d_ff"
        )
    if cfg.moe_experts and cfg.moe_experts % tp:
        problems.append(
            f"moe_experts must be divisible by tp — expert banks shard "
            f"E/tp experts per device and tokens reach them via "
            f"all_to_all (moe_experts={cfg.moe_experts}, tp={tp}); "
            f"pick tp from the divisors of moe_experts"
        )
    if problems:
        raise ValueError(
            "tensor-parallel serving refused this config:\n  - "
            + "\n  - ".join(problems)
        )


def _eps(cfg: TransformerConfig) -> float:
    return float(torch.finfo(torch.promote_types(cfg.dtype, torch.float32)).eps)


def tp_parallel_tolerance(cfg: TransformerConfig, tp: int) -> Dict[str, float]:
    """The JAX package's logits tolerance of ``tp_compute="parallel"``
    against the gathered (one-device) arithmetic: the row-parallel wo
    and w_down sum ``tp`` partial products in another tree, ``2 L + 1``
    such blocks with the head, each O(tp eps), composed over depth as a
    random walk, with a 16x margin."""
    blocks = 2 * cfg.n_layers + 1
    bound = 16.0 * max(tp, 1) * (blocks ** 0.5) * _eps(cfg)
    return {"rtol": bound, "atol": bound}


def moe_ep_tolerance(cfg: TransformerConfig, tp: int) -> Dict[str, float]:
    """The JAX package's logits tolerance of expert-parallel MoE against
    the one-device oracle: routing is exact (replicated fp32 router,
    the same top-k), the expert products and the gate-weighted combine
    reassociate, up to three reductions a layer (gate/up, down,
    combine), as a random walk over depth with a 32x margin."""
    blocks = 3 * cfg.n_layers + 1
    bound = 32.0 * max(tp, 1) * (blocks ** 0.5) * _eps(cfg)
    return {"rtol": bound, "atol": bound}


@dataclass(frozen=True)
class _Tp:
    """One call's tensor-parallel plan: ``n`` ranks, this one's index,
    the compute mode, the stored specs of the weight tree
    (``sharding.serving_param_shardings``) and the tp group."""

    n: int
    rank: int
    parallel: bool
    specs: Params
    group: object


@functools.lru_cache(maxsize=16)
def _stored_specs(cfg: TransformerConfig, mesh: Mesh, quant: str) -> Params:
    from kubeflow_controller_tpu_torch.parallel.sharding import (
        serving_param_shardings,
    )

    return serving_param_shardings(cfg, mesh, quant)


def _tp_plan(cfg: TransformerConfig, params: Params, mesh: Optional[Mesh],
             tp_compute: str) -> Optional[_Tp]:
    """The plan of a call over ``mesh``, None at tp <= 1 (the one-device
    path). Refuses a config that does not shard (:func:`check_tp_heads`)
    and an unknown ``tp_compute``."""
    if tp_compute not in TP_COMPUTE:
        raise ValueError(
            f"tp_compute must be 'gathered' or 'parallel' (got {tp_compute!r})")
    tp = tp_size(mesh)
    if tp <= 1:
        return None
    check_tp_heads(cfg, tp, tp_compute)
    return _Tp(tp, mesh.coords["tp"], tp_compute == "parallel",
               _stored_specs(cfg, mesh, weight_quant(params)), mesh.group("tp"))


def _whole(x, spec, tp: _Tp):
    """The whole tensor (or ``(q, scale)`` pair) from this rank's chunk
    stored by ``spec``: each tp-split dimension gathered in rank order,
    bytes unchanged."""
    if isinstance(x, tuple):
        return tuple(_whole(t, s, tp) for t, s in zip(x, spec))
    dims = tp_dims(spec, x.ndim)
    for d in dims:
        x = coll.gather_dim(x, d, tp.group, tp.n)
    # Row-major, as the whole weight is: a product over a strided view
    # takes another kernel, which sums in another order.
    return x.contiguous() if dims else x


def _tp_join(x: torch.Tensor, dim: int, tp: Optional[_Tp]) -> torch.Tensor:
    """Every rank's part of ``x`` along ``dim`` (a head group, a slice of
    d_model or of the vocabulary), joined in rank order (the identity off
    tp), row-major: a reduction over a strided view (the norm's over
    d_model) sums in another order."""
    if tp is None:
        return x
    return coll.gather_dim(x.contiguous(), dim, tp.group, tp.n).contiguous()


def _embed(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
           tp: Optional[_Tp]) -> torch.Tensor:
    """Token embeddings in the compute dtype. Under tp the table is
    stored split on d_model, so each rank looks up its columns and the
    ranks' columns join: the whole lookup's bytes."""
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    if tp is not None and tp_dims(tp.specs["embed"], 2):
        x = _tp_join(x, x.ndim - 1, tp)
    return x


def _head_logits(cfg: TransformerConfig, params: Params,
                 x: torch.Tensor, tp: Optional[_Tp] = None) -> torch.Tensor:
    """Final-norm'd hidden [B, D] -> fp32 logits [B, vocab] (an int8
    ``lm_head`` is dequantized by :func:`_w`). Under tp the logits are
    whole on every rank: "gathered" gathers the head and computes the
    one-device product; "parallel" computes this rank's vocab columns
    and gathers them (a tied head: this rank's d_model rows, summed over
    tp)."""
    dt = cfg.dtype
    tied = params.get("lm_head") is None
    if tp is None or not tp.parallel:
        if tied:
            emb = params["embed"]
            if tp is not None:
                emb = _whole(emb, tp.specs["embed"], tp)
            return (x @ emb.to(dt).T).float()
        head = params if tp is None else {
            "lm_head": _whole(params["lm_head"], tp.specs["lm_head"], tp)}
        return (x @ _w(head, "lm_head", dt)).float()
    if tied:
        emb = params["embed"].to(dt)
        if not tp_dims(tp.specs["embed"], 2):
            return (x @ emb.T).float()
        d_loc = emb.shape[1]
        x_loc = x[..., tp.rank * d_loc:(tp.rank + 1) * d_loc]
        return coll.tp_sum(x_loc @ emb.T).float()
    out = x @ _w(params, "lm_head", dt)
    spec = tp.specs["lm_head"]
    if tp_dims(spec if isinstance(spec, P) else spec[0], 2):
        out = _tp_join(out, out.ndim - 1, tp)
    return out.float()


# -- the paged pool -----------------------------------------------------------

@dataclass
class PagedKVCache:
    """Block-table-indexed KV for continuous batching.

    ``tables[slot, i]`` is the pool page backing the slot's logical
    columns ``[i*bs, (i+1)*bs)``, or the sentinel ``n_blocks``. int8
    pools carry per-(page row, head) fp32 scales; fp pools carry None.
    """

    k: torch.Tensor                  # [L, n_blocks, bs, KVH, D] dtype | int8
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # [L, n_blocks, bs, KVH] f32 | None
    v_scale: Optional[torch.Tensor]
    tables: torch.Tensor             # [B, max_blocks] int32
    length: torch.Tensor             # [B] int32 valid positions per slot
    active: torch.Tensor             # [B] bool slot is decoding


def init_paged_cache(
    cfg: TransformerConfig, n_slots: int, max_blocks: int, n_blocks: int,
    block_size: int, kv_quant: str = "", device: DeviceLike = None,
    tp: int = 1,
) -> PagedKVCache:
    """A zeroed pool of exactly ``n_blocks`` pages (no spare sentinel
    page) plus all-sentinel tables for ``n_slots`` slots. ``tp > 1``:
    this rank's ``KVH / tp`` heads of every page (the JAX package's
    ``shard_paged_cache`` split of the KVH axis); the tables, lengths
    and active flags are whole."""
    dev = resolve_device(device)
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"n_kv_heads={cfg.n_kv_heads} does not divide over tp={tp}")
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads // tp,
             cfg.head_dim)
    if kv_quant == "int8":
        k = torch.zeros(shape, dtype=torch.int8, device=dev)
        v = torch.zeros(shape, dtype=torch.int8, device=dev)
        k_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        v_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    elif kv_quant:
        raise ValueError(f"unknown kv_quant {kv_quant!r} (want '' or 'int8')")
    else:
        k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        k_scale = v_scale = None
    return PagedKVCache(
        k=k, v=v, k_scale=k_scale, v_scale=v_scale,
        tables=torch.full((n_slots, max_blocks), n_blocks,
                          dtype=torch.int32, device=dev),
        length=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        active=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
    )


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with per-(token, head) scales over head_dim
    (``[..., KVH, D] -> int8 same shape + f32 [..., KVH]``). Rounds half
    to even and DIVIDES by the scale, as the JAX package does: a
    multiply by the reciprocal would change some codes."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _pool_write(pool: torch.Tensor, scale: Optional[torch.Tensor],
                layer: Optional[int], blk: torch.Tensor, off: torch.Tensor,
                val: torch.Tensor, valid: torch.Tensor) -> None:
    """Write rows of ``val`` into the pool at page ``blk[i]``, page row
    ``off[i]`` — of one ``layer`` (val ``[N, KVH, D]``), or of every
    layer when ``layer`` is None (val ``[L, N, KVH, D]``) — quantizing
    on write for int8 pools. Rows with ``valid[i]`` False are DROPPED,
    as JAX's ``.at[...].set(mode="drop")`` drops sentinel and
    out-of-span ids.

    PyTorch has no dropping scatter, and selecting the valid rows would
    stop the host until the device catches up. So every row writes, and
    a dropped row is aimed at a location whose final bytes it cannot
    change: the first valid row's location with that row's value, or,
    when no row is valid, its own (clamped) location with the bytes
    already there. Duplicate writes then carry identical bytes, and the
    result does not depend on which one lands last."""
    n_blocks = pool.shape[1]
    n = blk.shape[0]
    blk = blk.long().clamp(0, n_blocks - 1)
    off = off.long()
    rows = torch.arange(n, device=blk.device)
    first = torch.argmax(valid.to(torch.int32))    # first valid row, or 0
    any_valid = valid.any()
    src = torch.where(valid | ~any_valid, rows, first)
    t_blk, t_off = blk[src], off[src]
    if scale is None:
        vals = [(pool, val.to(pool.dtype))]
    else:
        q, s = _kv_quantize(val)
        vals = [(pool, q), (scale, s)]
    for dst, v in vals:
        if layer is None:
            new, old = v[:, src], dst[:, t_blk, t_off]
            dst[:, t_blk, t_off] = torch.where(any_valid, new, old)
        else:
            new, old = v[src], dst[layer, t_blk, t_off]
            dst[layer, t_blk, t_off] = torch.where(any_valid, new, old)


def _occupancy_cap(width: int, view_width: Optional[int]) -> int:
    """The engine's occupancy cap on a slot's page span: the live view
    width, never past the table's full span. One definition for both
    phases and both attention impls."""
    return width if view_width is None else min(view_width, width)


def _capped_kv_views(k_pool, v_pool, tables, width, view_width, k_scale,
                     v_scale, out_dtype):
    """The dense K/V view pair the gather path reads, at the capped
    width, int8 scales applied at gather time."""
    vw = _occupancy_cap(width, view_width)
    k = paged_kv_view(k_pool, tables, vw, scale=k_scale, out_dtype=out_dtype)
    v = paged_kv_view(v_pool, tables, vw, scale=v_scale, out_dtype=out_dtype)
    return k, v


def _layer_params(params: Params, layer: int,
                  tp: Optional[_Tp] = None) -> Params:
    """Layer ``layer``'s weights; both members of a ``(q, scale)`` pair
    are sliced. Under ``tp_compute="gathered"`` each weight stored split
    over tp is gathered whole here, one layer at a time (the JAX
    package's gather at dispatch), but an expert bank, whose experts
    stay this rank's; under ``"parallel"`` the chunks are used as they
    are."""
    lp = {k: (v[0][layer], v[1][layer]) if isinstance(v, tuple) else v[layer]
          for k, v in params["layers"].items()}
    if tp is None or tp.parallel:
        return lp
    specs = tp.specs["layers"]

    def layer_spec(spec):
        if isinstance(spec, tuple) and not isinstance(spec, P):
            return tuple(layer_spec(s) for s in spec)
        return P(*tuple(spec)[1:])

    return {k: v if k in tfm.MOE_BANKS and (v[0] if isinstance(v, tuple) else v).ndim >= 3
            else _whole(v, layer_spec(specs[k]), tp)
            for k, v in lp.items()}


def _dense_lp(lp: Params, dt: torch.dtype) -> Params:
    """Per-layer weights with every ``(q, scale)`` pair dequantized, for
    the paths that run the training FFN (:func:`tfm._moe_ffn`)."""
    return {k: (v[0].to(dt) * v[1].to(dt)) if isinstance(v, tuple) else v
            for k, v in lp.items()}


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: values descending, ties to the
    lower index (``argmax`` returns the first maximum; ``torch.topk``
    promises no order for ties on the card)."""
    vals, idxs = [], []
    rest = probs
    for _ in range(k):
        i = rest.argmax(-1)
        vals.append(rest.gather(-1, i[..., None])[..., 0])
        idxs.append(i)
        rest = rest.scatter(-1, i[..., None], float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _expert(lp: Params, name: str, e: int, dt: torch.dtype) -> torch.Tensor:
    """Expert ``e`` of bank ``name`` in the compute dtype; an int8 bank's
    expert is dequantized as :func:`_w` dequantizes, element for element
    the JAX package's gathered ``q[idx].astype(dt) * scale[idx]``."""
    w = lp[name]
    if isinstance(w, tuple):
        return w[0][e].to(dt) * w[1][e].to(dt)
    return w[e].to(dt)


def _moe_decode_ffn(cfg: TransformerConfig, lp: Params,
                    h: torch.Tensor) -> torch.Tensor:
    """The routed FFN for one token a row (``h [B, 1, D]``), as the JAX
    package's ``_moe_decode_ffn``: fp32 router probabilities, the
    ``top_k`` experts a row (:func:`_top_k`), gates not renormalized, no
    capacity (decode drops no token). Each expert is dequantized once a
    layer and applied to every row; a row keeps the outputs of the
    experts it picked, in pick order, and sums them scaled by its gates
    in the compute dtype."""
    dt = cfg.dtype
    hb = h[:, 0]                                           # [B, D]
    probs = torch.softmax(hb.float() @ lp["w_router"].float(), dim=-1)
    gates, idx = _top_k(probs, cfg.moe_top_k)              # [B, k]
    out_k = torch.zeros((hb.shape[0], cfg.moe_top_k, hb.shape[1]),
                        dtype=dt, device=h.device)
    for e in range(cfg.moe_experts):
        act = (F.silu(hb @ _expert(lp, "w_gate", e, dt))
               * (hb @ _expert(lp, "w_up", e, dt)))
        out_e = act @ _expert(lp, "w_down", e, dt)         # [B, D]
        out_k = torch.where((idx == e)[..., None], out_e[:, None, :], out_k)
    return (out_k * gates[..., None].to(dt)).sum(1)[:, None, :]


def _moe_block_ffn(cfg: TransformerConfig, lp: Params,
                   h: torch.Tensor) -> torch.Tensor:
    """The routed FFN over a block of positions (prefill, chunks,
    verify windows): the training FFN with capacity factor
    ``E / top_k``, which makes every expert's capacity the whole group,
    so no token is dropped whatever the training capacity factor."""
    moe_cfg = cfg.replace(
        moe_capacity_factor=float(cfg.moe_experts) / cfg.moe_top_k)
    ffn = {k: lp[k] for k in ("w_router", *tfm.MOE_BANKS)}
    return tfm._moe_ffn(moe_cfg, _dense_lp(ffn, cfg.dtype), h)[0]


def _moe_ep_ffn(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
                tp: _Tp) -> torch.Tensor:
    """The expert-parallel routed FFN under tp (the JAX package's
    ``_moe_ep_ffn``), in both compute modes: this rank holds ``E/tp``
    experts of each bank (int8 ``(q, scale)`` banks too), and tokens
    travel to their experts.

    1. Route on the whole activations: fp32 router probabilities and
       the ``top_k`` experts a token (:func:`_top_k`), the same on every
       rank and as on one device.
    2. This rank's stripe of ``ceil(n / tp)`` of the ``n`` tokens (the
       last stripe padded with rows routed nowhere), and the dispatch
       buffer ``[tp, E/tp, n_loc, D]``: for every rank's experts, each
       stripe token routed there or zeros. The capacity is the whole
       stripe: serving drops no token.
    3. ``all_to_all`` over tp; each local expert's 2-D products over the
       ``tp * n_loc`` rows it received (an int8 expert dequantized
       alone, as :func:`_expert` does).
    4. ``all_to_all`` back, the gate-weighted combine over the experts,
       and the stripes gathered: the output is whole on every rank.

    Routing decisions are exact; the products and the combine sum in
    another order than one device's, within :func:`moe_ep_tolerance`."""
    dt = cfg.dtype
    lead, d = h.shape[:-1], h.shape[-1]
    hf = h.reshape(-1, d)
    n, e_all = hf.shape[0], cfg.moe_experts
    el = e_all // tp.n
    probs = torch.softmax(hf.float() @ lp["w_router"].float(), dim=-1)
    gates, idx = _top_k(probs, cfg.moe_top_k)              # [n, k]
    n_loc = -(-n // tp.n)
    pad = n_loc * tp.n - n
    rows = slice(tp.rank * n_loc, (tp.rank + 1) * n_loc)
    xs = F.pad(hf, (0, 0, 0, pad))[rows]
    # Padded rows route nowhere: expert -1 matches no expert, so their
    # dispatch slabs and combine weights are exact zeros.
    is_ = F.pad(idx, (0, 0, 0, pad), value=-1)[rows]
    gs = F.pad(gates, (0, 0, 0, pad))[rows]
    one = (is_[..., None] == torch.arange(e_all, device=h.device)).float()
    sel = one.sum(1)                                       # [n_loc, E]
    # [E = dest rank x local expert, 1, n_loc, D]: collectives.all_to_all's
    # [E, G, cap, D] with one group.
    send = (sel.T[:, None, :, None].to(dt) * xs.to(dt)[None, None])
    xe = coll.all_to_all(send, axis="tp")                  # [el, tp, n_loc, D]
    xe = xe.reshape(el, tp.n * n_loc, d)
    out_e = []
    for e in range(el):
        a = (F.silu(xe[e] @ _expert(lp, "w_gate", e, dt))
             * (xe[e] @ _expert(lp, "w_up", e, dt)))
        out_e.append(a @ _expert(lp, "w_down", e, dt))
    back = torch.stack(out_e).reshape(el, tp.n, n_loc, d)
    ret = coll.all_to_all(back, axis="tp", inverse=True)   # [E, 1, n_loc, D]
    comb = (one * gs[..., None]).sum(1).to(dt)             # [n_loc, E] gate or 0
    out_loc = torch.einsum("ce,ecd->cd", comb, ret[:, 0])
    out = coll.gather_dim(out_loc.contiguous(), 0, tp.group, tp.n)[:n]
    return out.reshape(*lead, d)


def _ffn(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
         decode: bool = False, tp: Optional[_Tp] = None) -> torch.Tensor:
    """The layer's FFN in the compute dtype: SwiGLU, or for a MoE model
    the routed bank (:func:`_moe_decode_ffn` for one token a row,
    :func:`_moe_block_ffn` over a block, :func:`_moe_ep_ffn` for either
    under tp). Under ``tp_compute="parallel"`` the dense FFN's
    column-split gate and up and row-split down end in one tp sum."""
    if cfg.moe_experts:
        if tp is not None:
            return _moe_ep_ffn(cfg, lp, h, tp)
        return (_moe_decode_ffn if decode else _moe_block_ffn)(cfg, lp, h)
    dt = cfg.dtype
    gate = F.silu(h @ _w(lp, "w_gate", dt))
    up = h @ _w(lp, "w_up", dt)
    down = (gate * up) @ _w(lp, "w_down", dt)
    return coll.tp_sum(down) if tp is not None and tp.parallel else down


def _project_qkv(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
                 positions: torch.Tensor, tp: Optional[_Tp]):
    """The rotated query groups ``[..., G, rep, D]`` and the rotated K and
    V ``[..., G, D]`` of ``h`` at ``positions``. Under tp, G is this
    rank's ``KVH / tp`` heads: projected from the column chunks
    (``"parallel"``: a column slice of wq is a head slice), or projected
    whole and sliced (``"gathered"``: the one-device values)."""
    dt = cfg.dtype
    hd = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    lead = h.shape[:-1]
    q = (h @ _w(lp, "wq", dt)).reshape(*lead, -1, hd)
    k = (h @ _w(lp, "wk", dt)).reshape(*lead, -1, hd)
    v = (h @ _w(lp, "wv", dt)).reshape(*lead, -1, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    g = k.shape[-2]
    qg = q.reshape(*lead, g, rep, hd)
    if tp is not None and not tp.parallel:
        gl = g // tp.n
        sl = slice(tp.rank * gl, (tp.rank + 1) * gl)
        qg, k, v = qg[..., sl, :, :], k[..., sl, :], v[..., sl, :]
    return qg, k, v


def _attn_out(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
              attn: torch.Tensor, tp: Optional[_Tp]) -> torch.Tensor:
    """``x`` plus the output projection of the head outputs ``attn [...,
    G, rep, D]``: under ``"gathered"`` the ranks' head groups joined (the
    one-device layout) through the whole wo; under ``"parallel"`` this
    rank's rows of wo, summed over tp."""
    lead = attn.shape[:-3]
    if tp is not None and not tp.parallel:
        attn = _tp_join(attn, attn.ndim - 3, tp)
    out = attn.reshape(*lead, -1) @ _w(lp, "wo", cfg.dtype)
    return x + (coll.tp_sum(out) if tp is not None and tp.parallel else out)


# -- fused block prefill --------------------------------------------------------

@dataclass
class KVCache:
    """A contiguous cache: every row at the same ``length``."""

    k: torch.Tensor          # [L, B, max_seq, KVH, D]
    v: torch.Tensor
    length: int              # valid positions


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  device: DeviceLike = None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=0)


def _block_prefill(
    cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
    tp: Optional[_Tp] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ONE forward pass over the whole prompt ``[B, S]`` from position 0:
    the last position's fp32 logits ``[B, vocab]`` and every layer's K
    (rotated, as the cache keeps it) and V, ``[L, B, S, KVH, D]``.

    Attention runs through :func:`mha` with ``impl="auto"`` (``"xla"``
    when ``cfg.attn_impl == "xla"``): the flash kernels where the JAX
    package's shape rule holds, the dense path on other prompt lengths.
    q and k enter un-rotated with rope tables shared by every layer.

    Under tp (the JAX package's fused prefill at ``"gathered"`` and its
    ``_tp_prefill_forward`` otherwise): ``"gathered"`` runs the one-device
    forward on the gathered layers, every head (a MoE model's FFN the
    expert-parallel one), and returns this rank's ``KVH / tp`` heads of
    K and V; ``"parallel"`` projects, attends and returns this rank's
    head group, with one tp sum after wo and one after the FFN."""
    b, s = prompt.shape
    dt = cfg.dtype
    hd = cfg.head_dim
    x = _embed(cfg, params, prompt, tp)                   # [B, S, D]
    positions = torch.arange(s, dtype=torch.int32,
                             device=prompt.device).expand(b, s)
    attn_impl = "xla" if cfg.attn_impl == "xla" else "auto"
    tables = rope_full_tables(positions, hd, cfg.rope_theta)
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer, tp)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ _w(lp, "wq", dt)).reshape(b, s, -1, hd)
        k = (h @ _w(lp, "wk", dt)).reshape(b, s, -1, hd)
        v = (h @ _w(lp, "wv", dt)).reshape(b, s, -1, hd)
        attn = mha(q, k, v, causal=True, impl=attn_impl, rope_tables=tables)
        k = rope(k, positions, cfg.rope_theta)          # rotated for the cache
        if tp is not None and not tp.parallel:
            gl = k.shape[2] // tp.n
            k = k[:, :, tp.rank * gl:(tp.rank + 1) * gl]
            v = v[:, :, tp.rank * gl:(tp.rank + 1) * gl]
        ks.append(k)
        vs.append(v)
        out = attn.reshape(b, s, -1) @ _w(lp, "wo", dt)
        x = x + (coll.tp_sum(out) if tp is not None and tp.parallel else out)
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2, tp=tp)
    x = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _head_logits(cfg, params, x, tp), torch.stack(ks), torch.stack(vs)


def prefill(
    cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """Fused block prefill into a FRESH cache: one forward over the
    whole prompt ``[B, S]`` (not S decode steps) fills positions
    ``[0, S)``. Returns the last position's fp32 logits ``[B, vocab]``
    and the cache (written in place) with ``length = S``."""
    s = prompt.shape[1]
    if s > cache.k.shape[2]:
        raise ValueError(f"prompt {s} exceeds cache capacity {cache.k.shape[2]}")
    logits, ks, vs = _block_prefill(cfg, params, prompt)
    cache.k[:, :, :s] = ks.to(cache.k.dtype)
    cache.v[:, :, :s] = vs.to(cache.v.dtype)
    cache.length = s
    return logits, cache


# -- the contiguous multi-turn path ---------------------------------------------

def _check_cache_capacity(cache: KVCache, new_tokens: int, what: str) -> None:
    """Refuse writes past the cache's window (a slice assignment past
    ``max_seq`` would raise deep in a layer, or, with JAX's clamped
    update, overwrite the newest positions)."""
    max_seq = cache.k.shape[2]
    if int(cache.length) + new_tokens > max_seq:
        raise ValueError(
            f"{what}: cache length {int(cache.length)} + {new_tokens} new "
            f"tokens exceeds max_seq {max_seq}")


def _decode_layer(
    cfg: TransformerConfig, lp: Params, x: torch.Tensor, pos: int,
    layer: int, cache: KVCache,
) -> torch.Tensor:
    """One decoder layer of the contiguous cache for one token a row at
    position ``pos``: the row's rotated k and v land in place at
    ``[layer, :, pos]``, then the query attends columns ``<= pos``
    (grouped einsums over the un-repeated cache, fp32 softmax)."""
    b = x.shape[0]
    hd = cfg.head_dim
    dt = cfg.dtype
    g = cfg.n_kv_heads
    rep = cfg.n_heads // g
    max_seq = cache.k.shape[2]
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ _w(lp, "wq", dt)).reshape(b, 1, cfg.n_heads, hd)
    k = (h @ _w(lp, "wk", dt)).reshape(b, 1, g, hd)
    v = (h @ _w(lp, "wv", dt)).reshape(b, 1, g, hd)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    cache.k[layer, :, pos] = k[:, 0].to(cache.k.dtype)
    cache.v[layer, :, pos] = v[:, 0].to(cache.v.dtype)
    qg = q.reshape(b, 1, g, rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                     cache.k[layer].float()) * (hd ** -0.5)   # [B,G,rep,1,S]
    valid = torch.arange(max_seq, device=x.device) <= pos
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1).to(dt)
    attn = torch.einsum("bgrqk,bkgd->bqgrd", p, cache.v[layer]).reshape(b, 1, -1)
    x = x + attn @ _w(lp, "wo", dt)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _ffn(cfg, lp, h, decode=True)


def decode_step(
    cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One token for every row of a contiguous cache (``tokens`` [B, 1]
    at position ``cache.length``): fp32 logits [B, vocab] and the cache,
    written in place, with ``length`` advanced by one."""
    _check_cache_capacity(cache, 1, "decode_step")
    x = params["embed"].to(cfg.dtype)[tokens.long()]      # [B, 1, D]
    pos = int(cache.length)
    for layer in range(cfg.n_layers):
        x = _decode_layer(cfg, _layer_params(params, layer), x, pos, layer,
                          cache)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    cache.length = pos + 1
    return _head_logits(cfg, params, x[:, 0]), cache


def prefill_continue(
    cfg: TransformerConfig, params: Params, new_tokens: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """A turn's new tokens ``[B, S_new]`` in ONE forward over a cache
    that already holds ``length`` positions: position i attends the
    cache's columns ``< length`` and the new positions ``<= i``. The
    cache half and the causal intra-block half are scored by two
    grouped einsums and normalised by one fp32 softmax. The new rotated
    K and V land at ``[length, length + S_new)`` in place. Returns the
    last position's fp32 logits and the cache."""
    b, s = new_tokens.shape
    dt = cfg.dtype
    hd = cfg.head_dim
    g = cfg.n_kv_heads
    rep = cfg.n_heads // g
    max_seq = cache.k.shape[2]
    start = int(cache.length)
    _check_cache_capacity(cache, s, "prefill_continue")
    dev = new_tokens.device
    x = params["embed"].to(dt)[new_tokens.long()]         # [B, S, D]
    positions = start + torch.arange(s, dtype=torch.int32,
                                     device=dev).expand(b, s)
    cache_visible = torch.arange(max_seq, device=dev) < start
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    scale = hd ** -0.5
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ _w(lp, "wq", dt)).reshape(b, s, cfg.n_heads, hd)
        k = (h @ _w(lp, "wk", dt)).reshape(b, s, g, hd)
        v = (h @ _w(lp, "wv", dt)).reshape(b, s, g, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        qg = q.reshape(b, s, g, rep, hd)
        kc, vc = cache.k[layer], cache.v[layer]           # [B, max, G, D]
        s_cache = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                               kc.float()) * scale        # [B,G,rep,S,max]
        s_cache = torch.where(cache_visible, s_cache, -1e30)
        s_new = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                             k.float()) * scale           # [B,G,rep,S,S]
        s_new = torch.where(causal, s_new, -1e30)
        p = torch.softmax(torch.cat([s_cache, s_new], -1), -1).to(dt)
        attn = (torch.einsum("bgrqk,bkgd->bqgrd", p[..., :max_seq], vc)
                + torch.einsum("bgrqk,bkgd->bqgrd", p[..., max_seq:], v)
                ).reshape(b, s, -1)
        x = x + attn @ _w(lp, "wo", dt)
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2)
        # After this layer's attention read the cache: written in place.
        cache.k[layer, :, start:start + s] = k.to(cache.k.dtype)
        cache.v[layer, :, start:start + s] = v.to(cache.v.dtype)
    x = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    cache.length = start + s
    return _head_logits(cfg, params, x), cache


def _filter_logits(logits: torch.Tensor, top_k: int = 0,
                   top_p: float = 1.0) -> torch.Tensor:
    """Top-k, then nucleus filtering with scalar knobs, the JAX
    package's op sequence: ``logits < kth`` goes to ``-inf``; top-p
    keeps the tokens whose preceding sorted mass is ``< top_p`` (the top
    token always), cut at the smallest kept logit."""
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, -1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, -1), -1)
        keep_sorted = torch.cat(
            [torch.ones_like(cum[..., :1], dtype=torch.bool),
             cum[..., :-1] < top_p], -1)
        thresh = torch.where(
            keep_sorted, sorted_logits,
            torch.tensor(float("inf"), device=logits.device)
        ).amin(-1, keepdim=True)
        logits = torch.where(logits < thresh, neg_inf, logits)
    return logits


def generate_from_cache(
    cfg: TransformerConfig, params: Params, logits: torch.Tensor,
    cache: KVCache, max_new_tokens: int, temperature: float = 0.0,
    top_k: int = 0, top_p: float = 1.0, rng: Optional[prng.Key] = None,
    return_state: bool = False,
):
    """Decode ``max_new_tokens`` from a prefilled (or continued) cache
    and its last-position logits ``[B, vocab]``: the multi-turn entry
    (turn 1 :func:`prefill`, later turns :func:`prefill_continue`).
    Greedy takes the argmax; ``temperature > 0`` draws JAX's
    ``categorical`` from ``_filter_logits(logits / temperature)`` under
    step ``i``'s key of ``prng.split(rng, max_new_tokens)`` (``rng``
    defaults to ``PRNGKey(0)``). Every step writes one row of the cache
    in place, so the loop holds one cache, not one a step. Returns the
    tokens ``[B, new]`` int32, and with ``return_state`` also the final
    logits and the cache (``length`` advanced by ``max_new_tokens``)."""
    _check_cache_capacity(cache, max_new_tokens, "generate_from_cache")
    b, vocab = logits.shape
    dev = logits.device
    keys = None
    if temperature > 0.0:
        if rng is None:
            rng = prng.prng_key(torch.tensor(0, dtype=torch.int32))
        keys = prng.split(rng, max_new_tokens)
    toks = []
    for i in range(max_new_tokens):
        if keys is None:
            tok = logits.argmax(-1).to(torch.int32)
        else:
            filtered = _filter_logits(logits / temperature, top_k, top_p)
            key = (keys[0][..., i].to(dev), keys[1][..., i].to(dev))
            noise = prng.gumbel(prng.random_bits(key, b * vocab)).reshape(
                b, vocab)
            tok = torch.argmax(noise + filtered, -1).to(torch.int32)
        logits, cache = decode_step(cfg, params, tok[:, None], cache)
        toks.append(tok)
    out = (torch.stack(toks, 1) if toks
           else torch.zeros((b, 0), dtype=torch.int32, device=dev))
    if return_state:
        return out, logits, cache
    return out


def generate(
    cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
    max_new_tokens: int, temperature: float = 0.0, top_k: int = 0,
    top_p: float = 1.0, rng: Optional[prng.Key] = None,
    max_seq: Optional[int] = None,
) -> torch.Tensor:
    """Greedy or sampled generation from a fresh contiguous cache:
    :func:`prefill` of the prompt ``[B, S]``, then
    :func:`generate_from_cache`. Returns ``[B, new]`` int32."""
    b, s_prompt = prompt.shape
    max_seq = max_seq or cfg.max_seq
    if s_prompt + max_new_tokens > max_seq:
        raise ValueError(
            f"prompt {s_prompt} + new {max_new_tokens} exceeds max_seq "
            f"{max_seq}")
    cache = init_kv_cache(cfg, b, max_seq, device=prompt.device)
    logits, cache = prefill(cfg, params, prompt, cache)
    return generate_from_cache(
        cfg, params, logits, cache, max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, rng=rng)


# -- decode -------------------------------------------------------------------

def _decode_layer_paged(
    cfg: TransformerConfig, lp: Params, x: torch.Tensor, pos: torch.Tensor,
    layer: int, cache: PagedKVCache, view_width: Optional[int],
    attn_impl: str, tp: Optional[_Tp] = None,
) -> torch.Tensor:
    """One decoder layer for every slot at its own position: row b's new
    k/v land in page ``tables[b, pos[b] // bs]`` at row ``pos[b] % bs``
    (inactive rows and sentinel pages drop the write), THEN the slot
    attends its pages with the mask ``c <= pos[b]``. Under tp the rank
    writes and attends its own head group."""
    b = x.shape[0]
    hd = cfg.head_dim
    dt = cfg.dtype
    n_blocks, bs = cache.k.shape[1], cache.k.shape[2]
    mb = cache.tables.shape[1]
    width = mb * bs
    vw = _occupancy_cap(width, view_width)

    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    qg, k, v = _project_qkv(cfg, lp, h, pos[:, None], tp)
    bi = (pos // bs).clamp(0, mb - 1).long()
    blk = cache.tables.gather(1, bi[:, None])[:, 0]
    # Inactive rows drop their write: a retired slot's table row stays on
    # the device until the host's next push, and its pages may already
    # belong to another slot.
    valid = cache.active & (pos < width) & (blk < n_blocks)
    off = pos % bs
    _pool_write(cache.k, cache.k_scale, layer, blk, off, k[:, 0], valid)
    _pool_write(cache.v, cache.v_scale, layer, blk, off, v[:, 0], valid)
    k_scale = None if cache.k_scale is None else cache.k_scale[layer]
    v_scale = None if cache.v_scale is None else cache.v_scale[layer]
    if attn_impl == "kernel":
        attn = paged_attention_decode(
            qg[:, 0], cache.k[layer], cache.v[layer], cache.tables, pos,
            k_scale=k_scale, v_scale=v_scale, width=vw,
            sm_scale=hd ** -0.5, out_dtype=dt,
            tp=1 if tp is None else tp.n)[:, None]   # [B, 1, G, rep, D]
    else:
        k_cache, v_cache = _capped_kv_views(
            cache.k[layer], cache.v[layer], cache.tables, width, view_width,
            k_scale, v_scale, dt)                        # [B, vw, G, D]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                         k_cache.float()) * (hd ** -0.5)
        visible = (torch.arange(vw, device=x.device)[None, :]
                   <= pos[:, None])                      # [B, vw]
        s = torch.where(visible[:, None, None, None, :], s, MASK_VALUE)
        p = torch.softmax(s, dim=-1).to(dt)
        attn = torch.einsum("bgrqk,bkgd->bqgrd", p, v_cache)
    x = _attn_out(cfg, lp, x, attn, tp)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _ffn(cfg, lp, h, decode=True, tp=tp)


def _decode_step_paged_impl(cfg, params, tokens, cache, view_width, attn_impl,
                            tp):
    x = _embed(cfg, params, tokens, tp)                    # [B, 1, D]
    pos = cache.length
    for layer in range(cfg.n_layers):
        x = _decode_layer_paged(cfg, _layer_params(params, layer, tp), x, pos,
                                layer, cache, view_width, attn_impl, tp)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _head_logits(cfg, params, x[:, 0], tp)
    cache.length = torch.where(cache.active, pos + 1, pos)
    return logits, cache


def decode_step_paged(
    cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
    cache: PagedKVCache, view_width: Optional[int] = None,
    attn_impl: str = "kernel", mesh: Optional[Mesh] = None,
    tp_compute: str = "gathered",
) -> Tuple[torch.Tensor, PagedKVCache]:
    """One token for every slot at its own position (``tokens`` [B, 1]).
    Returns fp32 logits [B, vocab] and the cache, whose pool took the new
    k/v in place and whose ``length`` advanced on active slots only.
    ``view_width`` caps the pages attention walks to the engine's live
    occupancy; writes still guard against the full table span.
    ``mesh``/``tp_compute``: tensor parallelism (module docstring); the
    logits come out whole on every rank."""
    attn_impl = check_attn_impl(attn_impl)
    tp = _tp_plan(cfg, params, mesh, tp_compute)
    with use_mesh(mesh):
        return _decode_step_paged_impl(cfg, params, tokens, cache, view_width,
                                       attn_impl, tp)


# -- chunked prefill ------------------------------------------------------------

def prefill_chunk_paged(
    cfg: TransformerConfig, params: Params, toks: torch.Tensor,
    cache: PagedKVCache, slot: int, offset: int, n_real: int,
    view_width: Optional[int] = None, attn_impl: str = "kernel",
    mesh: Optional[Mesh] = None, tp_compute: str = "gathered",
) -> Tuple[torch.Tensor, PagedKVCache]:
    """One prefill chunk of ONE slot: ``toks`` [1, W] (padded to W, the
    first ``n_real`` real) at absolute positions ``offset + [0, W)``.

    Every layer attends the slot's cached columns ``< offset`` plus the
    chunk's own fresh K/V as a causal tile; the chunk's K/V scatter into
    the slot's pages only after ALL layers (pad columns past the table
    span or on sentinel entries drop). Returns the last real position's
    fp32 logits [1, vocab] and the cache with ``length[slot] = offset +
    n_real``. ``mesh``/``tp_compute``: see :func:`decode_step_paged`
    (each rank attends and writes its own head group)."""
    attn_impl = check_attn_impl(attn_impl)
    if toks.shape[0] != 1:
        raise ValueError(
            f"prefill_chunk_paged refused this call:\n  - toks must carry "
            f"exactly ONE request row — chunked prefill advances a single "
            f"slot per dispatch (got batch {toks.shape[0]})")
    tp = _tp_plan(cfg, params, mesh, tp_compute)
    with use_mesh(mesh):
        return _prefill_chunk_paged_impl(cfg, params, toks, cache, slot,
                                         offset, n_real, view_width,
                                         attn_impl, tp)


def _prefill_chunk_paged_impl(cfg, params, toks, cache, slot, offset, n_real,
                              view_width, attn_impl, tp):
    b, w = toks.shape
    dt = cfg.dtype
    hd = cfg.head_dim
    n_blocks, bs = cache.k.shape[1], cache.k.shape[2]
    mb = cache.tables.shape[1]
    width = mb * bs
    vw = _occupancy_cap(width, view_width)
    dev = toks.device
    trow = cache.tables[slot]                              # [mb]
    if attn_impl == "gather":
        kc_all, vc_all = _capped_kv_views(
            cache.k, cache.v, trow, width, view_width, cache.k_scale,
            cache.v_scale, dt)                             # [L, vw, G, D]
        cache_visible = torch.arange(vw, device=dev) < offset
        causal = torch.ones((w, w), dtype=torch.bool, device=dev).tril()

    x = _embed(cfg, params, toks, tp)                      # [1, W, D]
    positions = offset + torch.arange(w, dtype=torch.int32, device=dev)[None]
    scale = hd ** -0.5
    k_rows, v_rows = [], []
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer, tp)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        qg, k, v = _project_qkv(cfg, lp, h, positions, tp)
        if attn_impl == "kernel":
            attn = paged_attention_prefill(
                qg[0], k[0], v[0], cache.k[layer], cache.v[layer], trow,
                offset,
                k_scale=None if cache.k_scale is None else cache.k_scale[layer],
                v_scale=None if cache.v_scale is None else cache.v_scale[layer],
                width=vw, sm_scale=scale, out_dtype=dt,
                tp=1 if tp is None else tp.n)[None]
        else:
            kc, vc = kc_all[layer], vc_all[layer]
            s_cache = torch.einsum("bqgrd,kgd->bgrqk", qg.float(),
                                   kc.float()) * scale     # [1,G,rep,W,vw]
            s_cache = torch.where(cache_visible, s_cache, MASK_VALUE)
            s_new = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                 k.float()) * scale        # [1,G,rep,W,W]
            s_new = torch.where(causal, s_new, MASK_VALUE)
            p = torch.softmax(torch.cat([s_cache, s_new], -1), -1).to(dt)
            attn = (torch.einsum("bgrqk,kgd->bqgrd", p[..., :vw], vc)
                    + torch.einsum("bgrqk,bkgd->bqgrd", p[..., vw:], v))
        x = _attn_out(cfg, lp, x, attn, tp)
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2, tp=tp)
        k_rows.append(k[0])
        v_rows.append(v[0])

    # Scatter the chunk's k/v at absolute columns offset + [0, W).
    wcols = offset + torch.arange(w, device=dev)
    blk = trow[(wcols // bs).clamp(0, mb - 1)]
    valid = (wcols < width) & (blk < n_blocks)
    woff = wcols % bs
    _pool_write(cache.k, cache.k_scale, None, blk, woff,
                torch.stack(k_rows), valid)
    _pool_write(cache.v, cache.v_scale, None, blk, woff,
                torch.stack(v_rows), valid)
    x_last = x[:, n_real - 1]
    logits = _head_logits(
        cfg, params, rmsnorm(x_last, params["final_norm"], cfg.norm_eps), tp)
    cache.length[slot] = offset + n_real
    return logits, cache


def prefill_into_paged(
    cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
    cache: PagedKVCache, slot: int, mesh: Optional[Mesh] = None,
    tp_compute: str = "gathered",
) -> Tuple[torch.Tensor, PagedKVCache]:
    """Block-prefill ONE request's prompt ``[1, S]`` (the fused forward
    of :func:`prefill`: the same logits and KV bytes) and scatter its S
    positions into the pages of slot ``slot``'s table row, quantizing on
    write for int8 pools. Sets ``length[slot] = S`` and ``active[slot] =
    True``; every other slot's pages are untouched. Returns the last
    position's fp32 logits ``[1, vocab]`` and the cache.
    ``mesh``/``tp_compute``: see :func:`decode_step_paged` and
    :func:`_block_prefill` (each rank scatters its own head group)."""
    if prompt.shape[0] != 1:
        raise ValueError(
            f"prefill_into_paged admits one request (got batch "
            f"{prompt.shape[0]})")
    n_blocks, bs = cache.k.shape[1], cache.k.shape[2]
    mb = cache.tables.shape[1]
    s = prompt.shape[1]
    if s > mb * bs:
        raise ValueError(f"prompt {s} exceeds slot capacity {mb * bs}")
    tp = _tp_plan(cfg, params, mesh, tp_compute)
    with use_mesh(mesh):
        logits, ks, vs = _block_prefill(cfg, params, prompt, tp)
    trow = cache.tables[slot]
    cols = torch.arange(s, device=prompt.device)
    blk = trow[(cols // bs).clamp(0, mb - 1)]
    off = cols % bs
    valid = blk < n_blocks                       # sentinel entries drop
    _pool_write(cache.k, cache.k_scale, None, blk, off, ks[:, 0], valid)
    _pool_write(cache.v, cache.v_scale, None, blk, off, vs[:, 0], valid)
    cache.length[slot] = s
    cache.active[slot] = True
    return logits, cache


# -- speculative verify ---------------------------------------------------

def verify_step_paged(
    cfg: TransformerConfig, params: Params,
    draft: torch.Tensor,        # [B, K] int32 proposed continuations
    draft_len: torch.Tensor,    # [B] int32 in [0, K] valid drafts a row
    logits: torch.Tensor,       # [B, vocab] carried last-position logits
    cache: PagedKVCache,
    eos: torch.Tensor,          # [B] int32 EOS id a row (-1 = none)
    max_commit: torch.Tensor,   # [B] int32 commit cap, >= 1
    view_width: Optional[int] = None,
    attn_impl: str = "kernel",
    sampling: Optional[Tuple[torch.Tensor, ...]] = None,
    mesh: Optional[Mesh] = None,
    tp_compute: str = "gathered",
) -> Tuple[torch.Tensor, ...]:
    """Verify every slot's window ``[t0 = argmax(logits), draft]`` (W =
    K + 1 positions from ``length[b]``) in ONE forward over the slot's
    pages, and commit the longest argmax-consistent run.

    ``sampling`` (``(temperature, top_k, top_p, seed, gen, pos)``, each
    ``[B]``; see :func:`verify_step_paged_sampled`) draws t0 and the
    per-position predictions instead of taking argmaxes, and adds the
    next committed token to the result.

    Acceptance is the JAX package's: the cumulative prefix of draft
    tokens equal to the previous position's argmax, capped by
    ``draft_len``; ``n = min(1 + accepted, max(max_commit, 1))``; cut
    just after the window's first EOS; ``n = 0`` on inactive rows. Only
    the accepted positions' K/V reach the pool (rejected and padded
    positions drop — rollback is never committing), ``length += n``, and
    the new logits are those at window position ``n - 1``.

    Attention: ``"kernel"`` is ``paged_attention_verify`` (on the card
    the chunk kernel, B6's verify entry), ``"gather"`` the gathered-view
    oracle. Returns ``(window [B, W], n [B], new_logits [B, vocab],
    cache)``; the pool is written in place. ``mesh``/``tp_compute``: see
    :func:`decode_step_paged`; the logits are whole on every rank, so
    every rank takes the same acceptance decisions."""
    attn_impl = check_attn_impl(attn_impl)
    tp = _tp_plan(cfg, params, mesh, tp_compute)
    with use_mesh(mesh):
        return _verify_step_paged_impl(
            cfg, params, draft, draft_len, logits, cache, eos, max_commit,
            view_width, attn_impl, sampling, tp)


def _verify_step_paged_impl(cfg, params, draft, draft_len, logits, cache, eos,
                            max_commit, view_width, attn_impl, sampling, tp):
    b, k_draft = draft.shape
    w = k_draft + 1
    dt = cfg.dtype
    hd = cfg.head_dim
    n_blocks, bs = cache.k.shape[1], cache.k.shape[2]
    mb = cache.tables.shape[1]
    width = mb * bs
    vw = _occupancy_cap(width, view_width)
    dev = draft.device
    pos0 = cache.length                                    # [B]
    if sampling is None:
        t0 = logits.argmax(-1).to(torch.int32)
    else:
        # Sampled rows draw t0 under the key of the next stream position;
        # greedy rows take the argmax inside sample_step_slots.
        s_temp, s_topk, s_topp, s_seed, s_gen, s_pos = sampling
        t0 = sample_step_slots(logits, s_temp, s_topk, s_topp, s_seed,
                               s_gen, s_pos)
    window = torch.cat([t0[:, None], draft.to(torch.int32)], 1)   # [B, W]
    x = _embed(cfg, params, window, tp)                    # [B, W, D]
    arange_w = torch.arange(w, dtype=torch.int32, device=dev)
    positions = pos0[:, None] + arange_w[None, :]
    scale = hd ** -0.5
    if attn_impl == "gather":
        kview, vview = _capped_kv_views(
            cache.k, cache.v, cache.tables, width, view_width, cache.k_scale,
            cache.v_scale, dt)                             # [L, B, vw, G, D]
        cache_visible = (torch.arange(vw, device=dev)[None, :]
                         < pos0[:, None])[:, None, None, None, :]
        causal = arange_w[:, None] >= arange_w[None, :]    # [W, W]
    k_rows, v_rows = [], []
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer, tp)
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        qg, k, v = _project_qkv(cfg, lp, h, positions, tp)
        if attn_impl == "kernel":
            attn = paged_attention_verify(
                qg, k, v, cache.k[layer], cache.v[layer], cache.tables, pos0,
                k_scale=None if cache.k_scale is None else cache.k_scale[layer],
                v_scale=None if cache.v_scale is None else cache.v_scale[layer],
                width=vw, sm_scale=scale, out_dtype=dt,
                tp=1 if tp is None else tp.n)              # [B, W, G, rep, D]
        else:
            kc, vc = kview[layer], vview[layer]
            s_cache = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                   kc.float()) * scale     # [B,G,rep,W,vw]
            s_cache = torch.where(cache_visible, s_cache, MASK_VALUE)
            s_new = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                 k.float()) * scale        # [B,G,rep,W,W]
            s_new = torch.where(causal, s_new, MASK_VALUE)
            p = torch.softmax(torch.cat([s_cache, s_new], -1), -1).to(dt)
            attn = (torch.einsum("bgrqk,bkgd->bqgrd", p[..., :vw], vc)
                    + torch.einsum("bgrqk,bkgd->bqgrd", p[..., vw:], v))
        x = _attn_out(cfg, lp, x, attn, tp)
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2, tp=tp)
        k_rows.append(k)
        v_rows.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    all_logits = _head_logits(cfg, params, x, tp)          # [B, W, vocab]

    preds = all_logits.argmax(-1).to(torch.int32)          # [B, W]
    if sampling is not None:
        # Speculative sampling with a point-mass draft: sample the
        # filtered target at each window position under that position's
        # key and accept a draft token iff it equals the sample; on a
        # rejection the sample is the correction, carried as next_tok.
        pred_pos = s_pos[:, None] + 1 + arange_w[None, :]
        sampled_preds = _sample_rows_2d(
            all_logits, s_temp, s_topk, s_topp, s_seed, s_gen, pred_pos)
        preds = torch.where((s_temp > 0.0)[:, None], sampled_preds, preds)
    ok = ((window[:, 1:] == preds[:, :-1])
          & (arange_w[None, :k_draft] < draft_len[:, None]))
    acc = torch.cumprod(ok.to(torch.int32), 1).sum(1)
    n = 1 + acc                                            # [B], 1..K+1
    n = torch.minimum(n, max_commit.clamp_min(1))
    is_eos = (window == eos[:, None]) & (eos[:, None] >= 0)
    eos_pos = torch.argmax(is_eos.to(torch.int32), 1)      # first EOS, or 0
    n = torch.where(is_eos.any(1) & (eos_pos < n), eos_pos + 1, n)
    n = torch.where(cache.active, n, 0).to(torch.int32)

    # Commit the accepted positions only: columns length + [0, n) through
    # the slot's table; rejected, padded and inactive positions drop.
    wcols = positions.long()                               # [B, W]
    commit = arange_w[None, :] < n[:, None]
    blk = cache.tables.gather(1, (wcols // bs).clamp(0, mb - 1))
    valid = (commit & (wcols < width) & (blk < n_blocks)).reshape(-1)
    blk, woff = blk.reshape(-1), (wcols % bs).reshape(-1)
    g = k_rows[0].shape[-2]
    _pool_write(cache.k, cache.k_scale, None, blk, woff,
                torch.stack(k_rows).reshape(cfg.n_layers, b * w, g, hd), valid)
    _pool_write(cache.v, cache.v_scale, None, blk, woff,
                torch.stack(v_rows).reshape(cfg.n_layers, b * w, g, hd), valid)
    idx = (n.long() - 1).clamp(0, k_draft)
    rows = torch.arange(b, device=dev)
    new_logits = all_logits[rows, idx]
    cache.length = pos0 + n
    if sampling is None:
        return window, n, new_logits, cache
    # preds[n - 1] is the draw at stream position pos + n: the next
    # quantum's first sample from new_logits (its argmax on greedy rows).
    return window, n, preds[rows, idx], new_logits, cache


def verify_step_paged_sampled(
    cfg: TransformerConfig, params: Params,
    draft: torch.Tensor,        # [B, K] int32 proposed continuations
    draft_len: torch.Tensor,    # [B] int32 in [0, K] valid drafts a row
    logits: torch.Tensor,       # [B, vocab] carried last-position logits
    cache: PagedKVCache,
    eos: torch.Tensor,          # [B] int32 EOS id a row (-1 = none)
    max_commit: torch.Tensor,   # [B] int32 commit cap, >= 1
    temperature: torch.Tensor,  # [B] f32, <= 0 rows verify greedily
    top_k: torch.Tensor,        # [B] int32
    top_p: torch.Tensor,        # [B] f32
    seed: torch.Tensor,         # [B] int32
    gen: torch.Tensor,          # [B] int32
    pos: torch.Tensor,          # [B] int32 tokens emitted a row
    view_width: Optional[int] = None,
    attn_impl: str = "kernel",
    mesh: Optional[Mesh] = None,
    tp_compute: str = "gathered",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           PagedKVCache]:
    """:func:`verify_step_paged` with per-row sampling: the speculative
    sampling rule for a deterministic draft (accept-with-probability
    ``min(1, p/q)`` for a point-mass ``q`` is "sample the filtered
    target; accept while it equals the draft", and the sample at the
    rejected position is the residual correction). Greedy rows keep the
    argmax-equality rule with the same bits. Keys are
    :func:`_sample_keys`', so acceptance does not depend on the batch.
    Returns ``(window, n, next_tok, new_logits, cache)``: ``next_tok`` is
    the draw the next quantum makes first. Under tp (``mesh``) the
    sampling inputs and the logits are whole on every rank, so every
    rank draws the same tokens."""
    return verify_step_paged(
        cfg, params, draft, draft_len, logits, cache, eos, max_commit,
        view_width=view_width, attn_impl=attn_impl,
        sampling=(temperature, top_k, top_p, seed, gen, pos), mesh=mesh,
        tp_compute=tp_compute)


# -- batched sampling: per-row filters, counter-based per-request keys ---------

def generation_keys(seed: torch.Tensor, gen: torch.Tensor) -> prng.Key:
    """Each generation's key ``fold_in(PRNGKey(seed), gen)``: a function
    of the request's lane alone, so the engine computes it on the host
    when a lane changes."""
    return prng.fold_in(prng.prng_key(seed), gen)


def _sample_keys(seed: torch.Tensor, gen: torch.Tensor,
                 pos: torch.Tensor) -> prng.Key:
    """Per-row keys ``fold_in(fold_in(PRNGKey(seed), gen), pos)``: a
    function of (request seed, generation index, position in the
    generated stream) only, never of the step, the slot or the batch."""
    return prng.fold_in(generation_keys(seed, gen), pos)


def _filter_logits_rows(
    logits: torch.Tensor,       # [B, vocab]
    temperature: torch.Tensor,  # [B] f32, <= 0 rows pass through (greedy)
    top_k: torch.Tensor,        # [B] int32, 0 disables
    top_p: torch.Tensor,        # [B] f32, >= 1 disables
) -> torch.Tensor:
    """Per-row temperature, top-k and top-p, the JAX package's op
    sequence and tie handling (``scaled < kth`` and ``scaled < thresh``
    go to ``-inf``; ties with the cut survive). A row whose knob is off
    passes through that filter bitwise.

    One sort serves both filters: the top-k cut maps the descending
    values to themselves with a ``-inf`` tail, which is exactly the sort
    of the top-k-filtered row that the JAX package sorts again. The
    softmax and the cumulative sum sum in another order than XLA's, so
    the top-p cut can move only on a row whose cumulative mass lies
    within a few ulps of ``top_p``."""
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    v = scaled.shape[-1]
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    sorted_desc = torch.sort(scaled, -1, descending=True).values
    kth = sorted_desc.gather(
        -1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    on_k = (top_k > 0)[:, None]
    scaled = torch.where(on_k & (scaled < kth), neg_inf, scaled)
    sorted2 = torch.where(on_k & (sorted_desc < kth), neg_inf, sorted_desc)
    e = torch.exp(sorted2 - sorted2[:, :1])
    cum = torch.cumsum(e / e.sum(-1, keepdim=True), -1)
    keep_sorted = torch.cat(
        [torch.ones_like(cum[:, :1], dtype=torch.bool),
         cum[:, :-1] < top_p[:, None]], -1)
    thresh = torch.where(keep_sorted, sorted2,
                         torch.tensor(float("inf"), device=logits.device)
                         ).amin(-1, keepdim=True)
    return torch.where((top_p < 1.0)[:, None] & (scaled < thresh),
                       neg_inf, scaled)


def sampling_noise(gen_key: prng.Key, pos: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """The Gumbel noise of each row's draw at ``pos`` under its
    generation key (:func:`generation_keys`, broadcast against pos):
    ``[..., vocab]`` float32. It depends on the key alone, so the engine
    draws a whole chunk's noise in one call."""
    return prng.gumbel_rows(prng.fold_in(gen_key, pos), vocab)


def sample_with_noise(
    logits: torch.Tensor,       # [B, vocab]
    temperature: torch.Tensor,  # [B] f32, <= 0 means greedy for that row
    top_k: torch.Tensor,        # [B] int32
    top_p: torch.Tensor,        # [B] f32
    noise: torch.Tensor,        # [B, vocab] from :func:`sampling_noise`
    mask: Optional[torch.Tensor] = None,   # [B, vocab] bool, True = allowed
) -> torch.Tensor:
    """:func:`sample_step_slots` given each row's Gumbel noise."""
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.tensor(float("-inf"), device=logits.device))
    greedy = logits.argmax(-1)
    filtered = _filter_logits_rows(logits, temperature, top_k, top_p)
    sampled = torch.argmax(noise + filtered, -1)
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)


def sample_step_slots(
    logits: torch.Tensor,       # [B, vocab]
    temperature: torch.Tensor,  # [B] f32, <= 0 means greedy for that row
    top_k: torch.Tensor,        # [B] int32
    top_p: torch.Tensor,        # [B] f32
    seed: torch.Tensor,         # [B] int32 per-request seed
    gen: torch.Tensor,          # [B] int32 generation index
    pos: torch.Tensor,          # [B] int32 position in the generated stream
    mask: Optional[torch.Tensor] = None,   # [B, vocab] bool, True = allowed
) -> torch.Tensor:
    """One token a slot. Greedy rows (``temperature <= 0``) take the
    argmax the greedy engine takes (the first maximum; the same bits), so
    sampled traffic in a batch never moves a greedy row. Sampled rows
    draw ``categorical`` from their filtered logits under the key of
    :func:`_sample_keys`. ``mask`` sends disallowed tokens to ``-inf``
    before both; an all-True row changes nothing."""
    return sample_with_noise(
        logits, temperature, top_k, top_p,
        sampling_noise(generation_keys(seed, gen), pos, logits.shape[-1]),
        mask)


def _sample_rows_2d(
    all_logits: torch.Tensor,   # [B, W, vocab]
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,        # [B]
    top_p: torch.Tensor,        # [B]
    seed: torch.Tensor,         # [B]
    gen: torch.Tensor,          # [B]
    pos: torch.Tensor,          # [B, W] stream position of each column
) -> torch.Tensor:
    """:func:`sample_step_slots` over a ``[B, W]`` window (no mask): each
    position draws under its own key, so the draw at stream position p is
    the draw plain decode would make there."""
    b, w, v = all_logits.shape
    rep = lambda x: x.repeat_interleave(w)  # noqa: E731
    return sample_step_slots(
        all_logits.reshape(b * w, v), rep(temperature), rep(top_k),
        rep(top_p), rep(seed), rep(gen), pos.reshape(-1)).reshape(b, w)


# -- copy-on-write page copy ---------------------------------------------------

def copy_pool_pages(cache: PagedKVCache, src_ids, dst_ids) -> PagedKVCache:
    """Copy whole pool pages ``src -> dst`` in place, on the device: the
    copy-on-write of ``n > 1`` forks. int8 pools copy the int8 payload
    and its scales verbatim (no requantization), so a copied page is the
    bytes of its source. A sentinel (``>= n_blocks``) destination drops
    its write; a sentinel source reads the last page, as JAX's clamped
    gather does. Under tp each rank copies its own head group of the
    pages (its pool), with no collective, as in the JAX package."""
    n_blocks = cache.k.shape[1]
    pairs = [(min(int(s), n_blocks - 1), int(d))
             for s, d in zip(src_ids, dst_ids) if 0 <= int(d) < n_blocks]
    if not pairs:
        return cache
    dev = cache.k.device
    src = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=dev)
    dst = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=dev)
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if t is not None:
            t[:, dst] = t[:, src]
    return cache


# -- page movement: the host tier and the external ingest --------------------

def _page_ids(ids, device: torch.device) -> torch.Tensor:
    return torch.as_tensor([int(i) for i in ids], dtype=torch.long,
                           device=device)


def gather_pool_pages(
    cache: PagedKVCache, ids,
) -> List[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                Optional[torch.Tensor]]]:
    """Copy whole pool pages to host memory, one ``(k, v, k_scale,
    v_scale)`` tuple a page (in ``ids`` order) of tensors ``[L, 1, bs,
    KVH(, D)]`` in the pool's storage types (int8 payload and fp32
    scales for int8 pools, never dequantized; scales None for fp pools).
    Each page owns its bytes, so a page the host tier drops frees them.
    On the card one device gather puts each page's layers side by side,
    then one copy a page and part lands in a pinned buffer of its own;
    the call returns once the bytes are there, so a page freed after it
    may be rewritten at once. Every id must name a real page (the JAX
    package pads its id lists with a sentinel to bound compiles; the
    port needs no padding)."""
    n_blocks = cache.k.shape[1]
    if any(not 0 <= int(i) < n_blocks for i in ids):
        raise ValueError(f"gather_pool_pages: ids {list(ids)} outside "
                         f"[0, {n_blocks})")
    parts = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    dev = cache.k.device
    if dev.type != "cuda":
        return [tuple(None if t is None else t[:, int(i):int(i) + 1].clone()
                      for t in parts) for i in ids]
    idx = _page_ids(ids, dev)
    # [n, L, ...]: page j of a part is one contiguous block on the card.
    rows = [None if t is None else t.transpose(0, 1).index_select(0, idx)
            for t in parts]
    pages = []
    for j in range(len(ids)):
        page = []
        for r in rows:
            if r is None:
                page.append(None)
                continue
            host = torch.empty((r.shape[1], 1) + tuple(r.shape[2:]),
                               dtype=r.dtype, pin_memory=True)
            host[:, 0].copy_(r[j], non_blocking=True)
            page.append(host)
        pages.append(tuple(page))
    # The tier hands these bytes out, and the pages they came from may
    # be reused by the next dispatch: wait for the copies here.
    torch.cuda.current_stream(dev).synchronize()
    return pages


def export_pool_pages(
    cache: PagedKVCache, ids, wait: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """Copy whole pool pages to host memory in bulk, as the JAX package's
    ``gather_pool_pages`` lays them out: ``(k, v, k_scale, v_scale)``,
    each ``[L, n, bs, KVH(, D)]`` in the pool's storage types (int8
    codes and fp32 scales for int8 pools, never dequantized; scales None
    for fp pools), pages in ``ids`` order. The migration and prefix-pull
    wire format. On the card: one ``index_select`` of the pages a part
    on the device, then one copy a part into one pinned buffer.
    ``wait=False`` returns once the copies are enqueued: work later on
    the same stream (an ``install_pool_pages`` of these tensors, a
    rewrite of the pages) is ordered after them, but a host read must
    first synchronize the stream."""
    n_blocks = cache.k.shape[1]
    if any(not 0 <= int(i) < n_blocks for i in ids):
        raise ValueError(f"export_pool_pages: ids {list(ids)} outside "
                         f"[0, {n_blocks})")
    dev = cache.k.device
    idx = _page_ids(ids, dev)
    out = []
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if t is None:
            out.append(None)
            continue
        rows = t.index_select(1, idx)
        if dev.type == "cuda":
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            rows = host
        out.append(rows)
    if wait and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return tuple(out)


def pool_page_host_bytes(cache: PagedKVCache, tp: int = 1) -> int:
    """Host bytes one whole pool page occupies off the card (K and V in
    the storage type, plus the fp32 scales of int8 pools): the unit the
    host tier's budget counts in. ``tp``: the pool holds this rank's
    ``1 / tp`` of every page's heads, and the page's bytes are ``tp``
    times its share (the JAX package counts the whole page at any
    tp)."""
    n_layers = cache.k.shape[0]
    per = cache.k[0, 0].numel() * cache.k.element_size()
    n = 2 * n_layers * per
    if cache.k_scale is not None:
        n += 2 * n_layers * cache.k_scale[0, 0].numel() * 4
    return n * tp


def install_pool_pages(
    cache: PagedKVCache, pages_k: torch.Tensor, pages_v: torch.Tensor,
    scales_k: Optional[torch.Tensor], scales_v: Optional[torch.Tensor],
    dst_ids,
) -> PagedKVCache:
    """Write pages (``[L, n, bs, KVH(, D)]``: ``gather_pool_pages``'
    pages joined along dim 1, on the host or the card) into the pool's
    ``dst_ids`` in place, bytes verbatim: int8
    payload and scales as they are, never requantized, so an installed
    page is its source's bits. A host tensor is copied to the card
    behind the work already on the stream (pinned memory: without
    stopping the host)."""
    if not len(dst_ids):
        return cache
    n_blocks = cache.k.shape[1]
    if any(not 0 <= int(i) < n_blocks for i in dst_ids):
        raise ValueError(f"install_pool_pages: ids {list(dst_ids)} outside "
                         f"[0, {n_blocks})")
    dev = cache.k.device
    dst = _page_ids(dst_ids, dev)
    for pool, pages in ((cache.k, pages_k), (cache.v, pages_v),
                        (cache.k_scale, scales_k), (cache.v_scale, scales_v)):
        if pool is None:
            continue
        pool[:, dst] = pages.to(dev, non_blocking=True).to(pool.dtype)
    return cache


def scatter_row_into_pool(
    cache: PagedKVCache, ext_k: torch.Tensor, ext_v: torch.Tensor, row: int,
    ids, starts, block_size: int, mesh: Optional[Mesh] = None,
) -> PagedKVCache:
    """Ingest full blocks of one row of an external contiguous cache
    (``[L, B, S, KVH, D]``, K rotated) into pool pages: block ``j``
    (tokens ``starts[j] + [0, block_size)``) into page ``ids[j]``,
    quantizing on write for int8 pools (``_pool_write``; the scales are
    per (token, head), so a head's codes do not depend on the others).
    The ``register_prefix`` path: the one place KV is copied into the
    pool from outside. Under tp (``mesh``) the external cache holds every
    head, and each rank takes its own head group."""
    if not len(ids):
        return cache
    tp = tp_size(mesh)
    if tp > 1:
        gl = ext_k.shape[3] // tp
        heads = slice(mesh.coords["tp"] * gl, (mesh.coords["tp"] + 1) * gl)
        ext_k, ext_v = ext_k[:, :, :, heads], ext_v[:, :, :, heads]
    dev = cache.k.device
    bs = int(block_size)
    cols = (torch.as_tensor([int(s) for s in starts], dtype=torch.long,
                            device=dev)[:, None]
            + torch.arange(bs, device=dev)[None, :]).reshape(-1)
    blk = _page_ids(ids, dev).repeat_interleave(bs)
    off = torch.arange(bs, device=dev).repeat(len(ids))
    valid = torch.ones_like(blk, dtype=torch.bool)
    for pool, scale, ext in ((cache.k, cache.k_scale, ext_k),
                             (cache.v, cache.v_scale, ext_v)):
        rows = ext[:, row].to(dev).index_select(1, cols)   # [L, m*bs, KVH, D]
        _pool_write(pool, scale, None, blk, off, rows, valid)
    return cache
