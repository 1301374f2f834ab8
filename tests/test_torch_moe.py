"""The port's mixture-of-experts decoder held against the JAX package on
the CPU: the routed FFN in both dispatch forms, the loss and its
gradients, int8 experts, every serving path, weight-only int8 banks, the
streamed init, and the engine's and ``serve()``'s greedy streams.

Everything runs at ``tiny_moe`` (4 experts, top-2, d_ff 64) in fp32
(the int8 training test widens it so that B7's route is taken), on the
same numpy inputs for both packages; the JAX side's paged attention
runs its Pallas kernels in interpret mode (``attn_impl="pallas"``) and
the port's wrappers their plain versions. Tolerances are the JAX
package's own: 1e-5 on the routed FFN's output and 1e-4 on gradients
(``tests/test_moe.py``), 2e-4 on serving logits (``test_moe.py:182``)
and 5e-4 on block prefill at the default capacity factor
(``tests/test_generate.py:108``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane import spec_decode as jspec
from kubeflow_controller_tpu.dataplane.serving_engine import (
    Request as JRequest, ServingEngine as JEngine,
)
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtf
from kubeflow_controller_tpu.ops import paged_attention_pallas as pap
from kubeflow_controller_tpu_torch import convert
from kubeflow_controller_tpu_torch.dataplane import spec_decode as tspec
from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttf

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    pap.pltpu is None, reason="pallas TPU backend not built into this jax")

SERVE_ATOL = 2e-4
PREFILL_ATOL = 5e-4
# The aux vector's drop rate is 1 - mean(kept): JAX's mean of all-ones
# may round to one ulp above 1 (-3e-8 where the port gives 0).
AUX = dict(rtol=1e-6, atol=2 ** -23)
# int8 training: test_torch_quant.py's limits for the fp32 decoder (a
# code may flip at a rounding tie that the frameworks' upstream sums
# place differently).
QUANT_LOSS_RTOL, QUANT_LEAF_REL_L2 = 3e-4, 5e-2
BS, MB = 8, 4


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


@functools.lru_cache(None)
def _master(seed=1, **kw):
    """Master weights of ``tiny_moe_config(**kw)``: the JAX init's tree and
    scales (norms at 1, else ``N(0, 1) / sqrt(fan_in)``), drawn with numpy."""
    cfg = jtf.tiny_moe_config(**kw)
    shapes = jax.eval_shape(lambda k: jtf.init_params(cfg, k), jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name.endswith("norm"):
            return np.ones(s.shape, s.dtype)
        fan_in = s.shape[-1] if name == "embed" else s.shape[-2]
        return (rng.standard_normal(s.shape) * fan_in ** -0.5).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(quant="", **kw):
    """(cfg_j, cfg_t, serving params j, serving params t) from the JAX
    init, through each package's ``inference_params``."""
    cfg_j = jtf.tiny_moe_config(n_kv_heads=4, **kw)
    cfg_t = ttf.tiny_moe_config(n_kv_heads=4, **kw)
    master = _master(n_kv_heads=4, **kw)
    return (cfg_j, cfg_t, jgen.inference_params(cfg_j, master, quant=quant),
            tgen.inference_params(cfg_t, convert.params_from_numpy(master, device="cpu"),
                                  quant=quant))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


# -- the routed FFN and the loss ---------------------------------------------------

def _capture_picks(module, monkeypatch):
    """Record the routing picks each dispatch form of ``module`` receives."""
    seen = []
    for name in ("_moe_dispatch_einsum", "_moe_dispatch_gather"):
        fn = getattr(module, name)

        def wrapped(cfg, x, picks, *a, _fn=fn):
            seen.append(picks)
            return _fn(cfg, x, picks, *a)

        monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [8.0, 0.1], ids=["cf8", "cf0.1_drops"])
def test_moe_ffn_matches_jax(cf, dispatch, monkeypatch):
    """``_moe_ffn`` on layer 0 of the same weights and activations: the
    routing picks (expert, gate, slot, kept) equal, the output within
    1e-5, the ``[aux, z_loss, drop_rate]`` vector within 1e-6 relative;
    at cf 0.1 tokens are dropped."""
    jc = jtf.tiny_moe_config(moe_capacity_factor=cf, moe_dispatch=dispatch)
    tc = ttf.tiny_moe_config(moe_capacity_factor=cf, moe_dispatch=dispatch)
    master = _master()
    lpj = jax.tree.map(lambda a: a[0], master["layers"])
    lpt = {k: torch.from_numpy(np.array(v[0])) for k, v in master["layers"].items()}
    h = np.random.default_rng(0).standard_normal((2, 24, 64)).astype(np.float32)
    picks_j = _capture_picks(jtf, monkeypatch)
    picks_t = _capture_picks(ttf, monkeypatch)
    oj, aj, traced = jax.jit(lambda lp, x: (*jtf._moe_ffn(jc, lp, x), picks_j[-1]))(
        lpj, jnp.asarray(h))
    ot, at = ttf._moe_ffn(tc, lpt, torch.from_numpy(h))
    assert len(picks_j) == len(picks_t) == 1
    for pj, pt in zip(traced, picks_t[0]):
        for a, b, what in zip(map(np.asarray, pj), map(np.asarray, pt),
                              ("choice", "gate", "pos", "keep")):
            if what == "gate":
                np.testing.assert_allclose(b, a, rtol=1e-6)
            else:
                np.testing.assert_array_equal(b, a, err_msg=what)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **AUX)
    assert (float(at[2]) > 0.5) == (cf < 1)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("z", [0.0, 0.1], ids=["z_off", "z_on"])
def test_next_token_loss_and_grads_match_jax(z, dispatch):
    """The decoder's loss (with the load-balance term, and the router
    z-loss when weighted), its metrics and every gradient, router and
    banks included, within 1e-4 of the JAX package's."""
    jc = jtf.tiny_moe_config(moe_router_z_weight=z, moe_dispatch=dispatch)
    tc = ttf.tiny_moe_config(moe_router_z_weight=z, moe_dispatch=dispatch)
    params = _master()
    tokens = np.random.default_rng(1).integers(0, 256, (2, 17)).astype(np.int32)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jtf.next_token_loss(jc, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(params)
    tp = convert.params_from_numpy(params, device="cpu")
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    lt, mt = ttf.next_token_loss(tc, tp, {"tokens": torch.from_numpy(tokens)})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=1e-4)
    assert set(mt) == set(mj) == {"accuracy", "perplexity", "moe_aux", "moe_drop_rate"}
    for k in mt:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    for n, g, w in zip(_names(params), gt, convert.tree_leaves(jax.device_get(gj))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=n)


@pytest.mark.parametrize("quant", ["int8", "int8_fused"])
def test_int8_experts_match_jitted_jax(quant, monkeypatch):
    """Int8 experts (each expert's three products through
    ``maybe_quant_dot``) against ``jax.jit`` of the JAX functions, at
    d_model 128, d_ff 256, cf 1.0 and 256 tokens, where each expert's
    ``[128, 128] @ [128, 256]`` and ``[128, 256] @ [256, 128]`` take B7's
    route under ``int8_fused`` (its plain version here): ``_moe_ffn``
    within 1e-5 where no code flips (its routing is exact), and, under
    ``int8_fused`` (whose decoder also takes the composed route, for the
    products ``fusable`` refuses), the decoder's loss and gradients
    within the int8 decoder's limits."""
    from kubeflow_controller_tpu_torch.ops import quant_fused as qf

    kw = dict(d_model=128, d_ff=256, moe_capacity_factor=1.0)
    jc = jtf.tiny_moe_config(quant=quant, **kw)
    tc = ttf.tiny_moe_config(quant=quant, **kw)
    params = _master(**kw)
    lpj = jax.tree.map(lambda a: a[0], params["layers"])
    lpt = {k: torch.from_numpy(np.array(v[0])) for k, v in params["layers"].items()}
    h = np.random.default_rng(2).standard_normal((4, 64, 128)).astype(np.float32)
    oj, aj = jax.jit(lambda lp, x: jtf._moe_ffn(jc, lp, x))(lpj, jnp.asarray(h))
    fused = []
    real = qf.fused_int8_matmul
    monkeypatch.setattr(qf, "fused_int8_matmul",
                        lambda x, w: (fused.append(tuple(x.shape)), real(x, w))[1])
    ot, at = ttf._moe_ffn(tc, lpt, torch.from_numpy(h))
    assert len(fused) == (3 * tc.moe_experts if quant == "int8_fused" else 0)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **AUX)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)

    if quant == "int8":
        return      # int8_fused's decoder runs both routes: the composed too
    tokens = np.random.default_rng(3).integers(0, 256, (4, 65)).astype(np.int32)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jtf.next_token_loss(jc, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(params)
    tp = convert.params_from_numpy(params, device="cpu")
    leaves = [p.requires_grad_(True) for p in convert.tree_leaves(tp)]
    lt, _ = ttf.next_token_loss(tc, tp, {"tokens": torch.from_numpy(tokens)})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=QUANT_LOSS_RTOL)
    for n, g, w in zip(_names(params), gt, convert.tree_leaves(jax.device_get(gj))):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) <= QUANT_LEAF_REL_L2, n


def test_configs_params_and_flops_match_jax():
    """The MoE presets' fields, the parameter tree's names and shapes
    (router ``[L, D, E]``, banks ``[L, E, D, F]`` and ``[L, E, F, D]``),
    the parameter count and the active-parameter FLOPs equal the JAX
    package's; ``convert`` carries the router and the banks both ways."""
    for name in ("tiny_moe_config", "mixtral_8x7b_config"):
        jc, tc = getattr(jtf, name)(), getattr(ttf, name)()
        for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
                  "d_ff", "max_seq", "rope_theta", "moe_experts", "moe_top_k",
                  "moe_capacity_factor", "moe_aux_weight", "moe_router_z_weight",
                  "moe_group_size", "moe_dispatch", "remat"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert ttf.train_flops_per_token(tc, 2048) == jtf.train_flops_per_token(jc, 2048)
    jc, tc = jtf.tiny_moe_config(), ttf.tiny_moe_config()
    params = _master()
    mine = ttf.init_params(tc, device="cpu")
    assert _names(mine) == _names(params)
    for a, b in zip(convert.tree_leaves(mine), convert.tree_leaves(params)):
        assert tuple(a.shape) == np.shape(b)
    assert ttf.count_params(mine) == jtf.count_params(params)
    back = convert.params_to_numpy(convert.params_from_numpy(params, device="cpu"))
    assert _names(back) == _names(params)
    for a, b in zip(convert.tree_leaves(back), convert.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- weight-only int8 banks and the streamed init -----------------------------------

def _bits(x):
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_banks_bitwise_equal_jax_inference_params(dtype):
    """``inference_params(quant="int8")`` quantizes each bank over its
    contraction axis: codes ``[L, E, D, F]`` and scales ``[L, E, 1, F]``
    (in the compute dtype) bit for bit the JAX package's; the router
    stays fp32, as drawn."""
    jc = jtf.tiny_moe_config(dtype=getattr(jnp, dtype))
    tc = ttf.tiny_moe_config(dtype=getattr(torch, dtype))
    master = _master()
    pj = jgen.inference_params(jc, master, quant="int8")
    pt = tgen.inference_params(tc, convert.params_from_numpy(master, device="cpu"),
                               quant="int8")
    for k in ttf.MOE_BANKS:
        (qj, sj), (qt, st) = pj["layers"][k], pt["layers"][k]
        assert qt.dtype == torch.int8 and st.dtype == tc.dtype
        assert tuple(st.shape) == np.shape(sj) == (2, 4, 1, qt.shape[-1])
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj), err_msg=k)
        np.testing.assert_array_equal(_bits(st), _bits(sj), err_msg=k)
    r = pt["layers"]["w_router"]
    assert r.dtype == torch.float32 and pj["layers"]["w_router"].dtype == jnp.float32
    np.testing.assert_array_equal(r.numpy(), np.asarray(pj["layers"]["w_router"]))


def _flat(tree):
    out = []
    for leaf in convert.tree_leaves(tree):
        out += list(leaf) if isinstance(leaf, tuple) else [leaf]
    return out


@pytest.mark.parametrize("dtype,quant", [
    (torch.float32, ""), (torch.bfloat16, ""), (torch.float32, "int8"),
    (torch.bfloat16, "int8"),
], ids=["fp32", "bf16", "fp32-int8", "bf16-int8"])
def test_streamed_init_equals_whole_init(dtype, quant):
    """``init_inference_params`` (the banks drawn and quantized a layer
    and an expert at a time) equals ``inference_params(init_params(...,
    dtype=cfg.dtype))`` bit for bit, in the same tree order; a dense
    model's too."""
    moe = ttf.tiny_moe_config(dtype=dtype, n_layers=3)
    for cfg in (moe, ttf.tiny_config(dtype=dtype)):
        a = tgen.init_inference_params(cfg, seed=5, device="cpu", quant=quant)
        b = tgen.inference_params(
            cfg, ttf.init_params(cfg, seed=5, device="cpu", dtype=cfg.dtype),
            quant=quant)
        assert _names(a) == _names(b) and list(a["layers"]) == list(b["layers"])
        fa, fb = _flat(a), _flat(b)
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            assert x.dtype == y.dtype and torch.equal(x, y)
    whole = ttf.init_params(moe, seed=5, device="cpu", dtype=dtype)["layers"]["w_down"]
    assert torch.equal(ttf.init_bank_layer(moe, "w_down", 1, 5, "cpu", dtype), whole[1])


# -- the serving paths --------------------------------------------------------------

def test_contiguous_paths_match_jax():
    """``prefill`` (drop-free routing at the default capacity factor,
    within 5e-4), a turn through ``prefill_continue`` and three
    ``decode_step``s (top-k routing of one token, within 2e-4): logits
    against the JAX functions', the same greedy tokens."""
    cfg_j, cfg_t, pj, pt = _pair()
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, 256, (2, 10)).astype(np.int32)
    cj = jgen.init_kv_cache(cfg_j, 2, 24)
    lj, cj = jax.jit(functools.partial(jgen.prefill, cfg_j))(pj, jnp.asarray(prompt), cj)
    ct = tgen.init_kv_cache(cfg_t, 2, 24, device="cpu")
    lt, ct = tgen.prefill(cfg_t, pt, torch.from_numpy(prompt), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=PREFILL_ATOL)
    turn = rng.integers(0, 256, (2, 7)).astype(np.int32)
    lj, cj = jax.jit(functools.partial(jgen.prefill_continue, cfg_j))(
        pj, jnp.asarray(turn), cj)
    lt, ct = tgen.prefill_continue(cfg_t, pt, torch.from_numpy(turn), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=SERVE_ATOL)
    step_j = jax.jit(functools.partial(jgen.decode_step, cfg_j))
    for _ in range(3):
        tok = np.asarray(lj.argmax(-1)).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], lt.argmax(-1).numpy())
        lj, cj = step_j(pj, jnp.asarray(tok), cj)
        lt, ct = tgen.decode_step(cfg_t, pt, torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=SERVE_ATOL)


def test_decode_routing_orders_ties_as_lax_top_k():
    """``_top_k``: descending, ties to the lower index, as ``lax.top_k``
    (rows with exact ties, as probabilities can be)."""
    p = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                    [0.3, 0.2, 0.3, 0.2]], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(p), 2)
    vt, it = tgen._top_k(torch.from_numpy(p), 2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _to_port(cache_j):
    host = jax.device_get(cache_j)

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x, copy=True))

    return tgen.PagedKVCache(k=t(host.k), v=t(host.v), k_scale=t(host.k_scale),
                             v_scale=t(host.v_scale), tables=t(host.tables),
                             length=t(host.length), active=t(host.active))


def test_paged_paths_match_jax(quant=""):
    """Into one shuffled pool: two prompts by ``prefill_into_paged``, a
    third chunkwise by ``prefill_chunk_paged`` (a full chunk and a padded
    tail), two ``decode_step_paged`` micro-steps of all three, then one
    ``verify_step_paged`` of K=3 drafts (slot 0's the greedy
    continuation): logits within 2e-4 of the JAX functions' at every
    call, the verify window and counts equal. (Int8 weights run these
    paths in the engine test below.)"""
    cfg_j, cfg_t, pj, pt = _pair(quant)
    n_blocks = 3 * MB
    tables = np.random.default_rng(5).permutation(n_blocks).astype(
        np.int32).reshape(3, MB)
    cache_j = jgen.init_paged_cache(cfg_j, 3, MB, n_blocks, BS, "")
    cache_j = cache_j._replace(tables=jnp.asarray(tables))
    cache_t = _to_port(cache_j)
    rng = np.random.default_rng(7)
    rows_j, rows_t = [], []
    fill_j = jax.jit(functools.partial(jgen.prefill_into_paged, cfg_j))
    for slot, s in enumerate((11, 6)):
        prompt = rng.integers(0, 256, (1, s)).astype(np.int32)
        lj, cache_j = fill_j(pj, jnp.asarray(prompt), cache_j, jnp.int32(slot))
        lt, cache_t = tgen.prefill_into_paged(cfg_t, pt, torch.from_numpy(prompt),
                                              cache_t, slot)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=SERVE_ATOL)
        rows_j.append(np.asarray(lj))
        rows_t.append(lt)
    vw = MB * BS
    chunk_j = jax.jit(functools.partial(jgen.prefill_chunk_paged, cfg_j,
                                        view_width=vw, attn_impl="pallas"))
    prompt = rng.integers(0, 256, 12).astype(np.int32)
    for off in (0, 8):
        w_real = min(BS, 12 - off)
        w = BS if w_real == BS else 1 << (w_real - 1).bit_length()
        buf = np.zeros((1, w), np.int32)
        buf[0, :w_real] = prompt[off:off + w_real]
        lj, cache_j = chunk_j(pj, jnp.asarray(buf), cache_j, jnp.int32(2),
                              jnp.int32(off), jnp.int32(w_real))
        lt, cache_t = tgen.prefill_chunk_paged(
            cfg_t, pt, torch.from_numpy(buf), cache_t, 2, off, w_real,
            view_width=vw, attn_impl="kernel")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=SERVE_ATOL)
    rows_j.append(np.asarray(lj))
    rows_t.append(lt)
    cache_j = cache_j._replace(active=jnp.asarray([True, True, True]))
    cache_t.active = torch.tensor([True, True, True])
    logits_j = jnp.asarray(np.concatenate(rows_j))
    logits_t = torch.cat(rows_t)
    step_j = jax.jit(functools.partial(jgen.decode_step_paged, cfg_j,
                                       view_width=vw, attn_impl="pallas"))
    for _ in range(2):
        toks = np.asarray(logits_j.argmax(-1)).astype(np.int32)
        assert np.array_equal(toks, logits_t.argmax(-1).numpy())
        logits_j, cache_j = step_j(pj, jnp.asarray(toks[:, None]), cache_j)
        logits_t, cache_t = tgen.decode_step_paged(
            cfg_t, pt, torch.from_numpy(toks[:, None]), cache_t,
            view_width=vw, attn_impl="kernel")
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   atol=SERVE_ATOL)
    # Slot 0 drafts its own greedy continuation (JAX's), slot 1 random
    # drafts, slot 2 none.
    k = 3
    greedy, lg, cj = [], logits_j, cache_j
    for _ in range(k + 1):
        tok = lg.argmax(-1).astype(jnp.int32)
        greedy.append(np.asarray(tok))
        lg, cj = step_j(pj, tok[:, None], cj)
    draft = np.stack(greedy, 1)[:, 1:].astype(np.int32)
    draft[1] = rng.integers(0, 256, k)
    dlen = np.asarray([k, k, 0], np.int32)
    eos = np.full(3, -1, np.int32)
    max_commit = np.full(3, k + 1, np.int32)
    wj, nj, lj, cache_j = jax.jit(functools.partial(
        jgen.verify_step_paged, cfg_j, view_width=vw, attn_impl="pallas"))(
            pj, jnp.asarray(draft), jnp.asarray(dlen), logits_j, cache_j,
            jnp.asarray(eos), jnp.asarray(max_commit))
    wt, nt, lt, cache_t = tgen.verify_step_paged(
        cfg_t, pt, torch.from_numpy(draft), torch.from_numpy(dlen),
        logits_t, cache_t, torch.from_numpy(eos), torch.from_numpy(max_commit),
        view_width=vw, attn_impl="kernel")
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt[0]) == k + 1
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=SERVE_ATOL)


# -- the engine and serve() ----------------------------------------------------------

def _work():
    rng = np.random.default_rng(2)
    return [(rng.integers(0, 256, n).astype(np.int32), m)
            for n, m in zip((5, 13, 5, 20, 13, 5), (9, 7, 12, 6, 10, 8))]


def _oracle(base, work, streams):
    """A proposer of the package whose ``DraftProposer`` is ``base``."""
    return type("Oracle", (_Oracle, base), {})(work, streams)


class _Oracle:
    """Drafts each request's continuation in a plain run's streams, so
    that drafts are accepted on random weights."""

    def __init__(self, work, streams):
        self.book = [(list(map(int, p)), streams[rid]) for rid, (p, _) in enumerate(work)]

    def _next(self, ctx, k):
        ctx = list(map(int, ctx))
        for prompt, stream in self.book:
            n = len(prompt)
            if ctx[:n] == prompt and ctx[n:] == stream[:len(ctx) - n]:
                return stream[len(ctx) - n:][:k]
        return []

    def has_candidate(self, ctx):
        return bool(self._next(ctx, 1))

    def propose(self, contexts, k):
        draft = np.zeros((len(contexts), k), np.int32)
        lens = np.zeros(len(contexts), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is not None:
                got = self._next(ctx, k)
                draft[i, :len(got)] = got
                lens[i] = len(got)
        return draft, lens


@pytest.mark.parametrize("quant,mode,spec", [
    ("", "exact", False), ("", "bucketed", True), ("int8", "exact", True),
], ids=["exact", "bucketed-spec", "int8w-exact-spec"])
def test_engine_streams_equal_jax_engine(quant, mode, spec):
    """Greedy streams token for token the JAX engine's, with more requests
    than slots: exact and bucketed prefill (chunks, a padded tail), fp
    and int8 weights; speculative runs draft the port's plain run's
    continuations (accepted in part: the verify step's logits decide),
    through both engines' verify steps; the counters ``moe_tokens_dispatched`` and
    ``moe_experts_per_shard`` and the traffic model's gauges equal too."""
    cfg_j, cfg_t, pj, pt = _pair(quant)
    work = _work()
    reqs = [(i, p, m) for i, (p, m) in enumerate(work)]
    kw = dict(n_slots=3, max_seq=32, block_size=BS, prefill_mode=mode)

    def run_jax(**extra):
        eng = JEngine(cfg_j, pj, attn_impl="pallas", **kw, **extra)
        out = eng.run([JRequest(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])
        return eng, {c.rid: c.tokens for c in out}

    extra = {}
    if spec:
        extra = dict(spec_decode=True, draft_k=4)
        plain = {c.rid: c.tokens for c in ServingEngine(
            cfg_t, pt, attn_impl="kernel", device="cpu", **kw).run(
                [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])}
        extra_j = dict(extra, proposer=_oracle(jspec.DraftProposer, work, plain))
        extra["proposer"] = _oracle(tspec.DraftProposer, work, plain)
    jeng, want = run_jax(**(extra_j if spec else {}))
    eng = ServingEngine(cfg_t, pt, attn_impl="kernel", device="cpu", **kw, **extra)
    got = {c.rid: c.tokens for c in eng.run(
        [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])}
    assert got == want
    a, b = eng.stats.summary(), jeng.stats.summary()
    for k in ("moe_tokens_dispatched", "moe_experts_per_shard", "spec_steps",
              "draft_accepted", "hbm_bytes_per_step", "hbm_bytes_per_step_verify",
              "flops_per_token_per_shard"):
        assert a[k] == b[k], k
    assert a["moe_experts_per_shard"] == 4 and a["moe_tokens_dispatched"] > 0
    if spec:
        assert a["draft_accepted"] > 0


def test_serve_tiny_moe_equals_jax_serve(tmp_path, monkeypatch):
    """``serve(config="tiny_moe")`` writes the JAX ``serve()``'s
    completions on the same fp32 weights, with its MoE counters."""
    import json

    from kubeflow_controller_tpu.dataplane.entrypoints import serve_lm as jserve

    master = _master(seed=0)
    monkeypatch.setattr(serve_lm, "_load_params", lambda *a, **k: (
        convert.params_from_numpy(master, device="cpu"), None))
    monkeypatch.setattr(jserve, "_load_params", lambda *a, **k: (
        jax.tree.map(jnp.asarray, master), None))
    common = dict(config="tiny_moe", batch=3, prompt_len=9, max_new_tokens=5,
                  slots=2, block_size=4, attn_impl="pallas")
    files, res = [], []
    for name, serve, extra in (("jax", jserve.serve, {}),
                               ("port", serve_lm.serve, dict(device="cpu"))):
        out = tmp_path / f"{name}.jsonl"
        res.append(serve(output_file=str(out), **common, **extra))
        files.append([json.loads(line) for line in out.read_text().splitlines()])
    assert files[0] == files[1] and len(files[1]) == 3
    for k in ("moe_tokens_dispatched", "moe_experts_per_shard", "hbm_bytes_per_step",
              "flops_per_token_per_shard", "requests"):
        assert res[0][k] == res[1][k], k
    assert res[1]["moe_tokens_dispatched"] > 0
