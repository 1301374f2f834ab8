"""The port's paged decode and chunked prefill (``kubeflow_controller_
tpu_torch/models/generate.py``) held against the JAX package's, on
``tiny_config`` weights from JAX's own init carried across with
``convert.params_from_numpy``.

Both attention paths are checked: the port's ``"gather"`` against JAX's
``"xla"`` oracle, and the port's ``"kernel"`` (on the CPU, the kernels'
plain versions) against JAX's ``"pallas"`` (interpret mode). Logits are
held to the JAX package's end-to-end ``PALLAS_LOGITS_TOL``; int8 codes
to bitwise equality where the inputs are the same bytes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu.ops import paged_attention_pallas as pap
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttfm

# The JAX package's declared end-to-end logits tolerance
# (tests/test_paged_attention_pallas.py:57).
PALLAS_LOGITS_TOL = dict(rtol=5e-5, atol=5e-5)
BS = 8
MB = 4          # pages per slot: a 32-column table span


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def test_kv_quantize_bitwise_equals_jax():
    """Codes and scales bitwise equal, including exact half-way values
    (round half to even) and an all-zero row (scale floor 1e-30/127)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 3, 16)).astype(np.float32) * 3
    x[0, 0] = 0.0
    # amax 127 -> scale 1.0: entries at k + 0.5 round to even.
    x[1, 0] = 0.0
    x[1, 0, 0] = 127.0
    x[1, 0, 1:6] = [2.5, -3.5, 0.5, -0.5, 126.5]
    q_j, s_j = jgen._kv_quantize(jnp.asarray(x))
    q_t, s_t = tgen._kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert q_t[1, 0, 1:6].tolist() == [2, -4, 0, 0, 126]


def _pool_write_reference(pool, layer, blk, off, val, valid):
    out = pool.copy()
    for i in range(len(blk)):
        if valid[i]:
            if layer is None:
                out[:, blk[i], off[i]] = val[:, i]
            else:
                out[layer, blk[i], off[i]] = val[i]
    return out


@pytest.mark.parametrize("case", ["mixed", "collide", "none_valid"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_pool_write_drops_invalid_rows(case, quant):
    """Rows marked invalid (inactive slots, sentinel pages, columns past
    the table span) leave the pool untouched — also when their clamped
    target is exactly a valid row's target, and when no row is valid."""
    rng = np.random.default_rng(1)
    L, n, g, hd = 2, 5, 2, 4
    pool = rng.standard_normal((L, n, BS, g, hd)).astype(np.float32)
    scale = rng.uniform(0.1, 1, (L, n, BS, g)).astype(np.float32)
    blk = np.asarray([1, n, 4, n, 0], np.int64)          # n = sentinel
    off = np.asarray([3, 2, 2, 7, 0], np.int64)
    valid = blk < n
    if case == "collide":
        # Row 1's sentinel clamps to page n-1 = 4 at row 2: row 2's target.
        valid[4] = False
    if case == "none_valid":
        valid[:] = False
    for layer in (1, None):
        shape = (5, g, hd) if layer is not None else (L, 5, g, hd)
        val = rng.standard_normal(shape).astype(np.float32)
        p_t = torch.from_numpy(pool.copy())
        if quant:
            p_t = torch.zeros(pool.shape, dtype=torch.int8)
            s_t = torch.from_numpy(scale.copy())
            tgen._pool_write(p_t, s_t, layer, torch.from_numpy(blk),
                             torch.from_numpy(off), torch.from_numpy(val),
                             torch.from_numpy(valid))
            q, s = tgen._kv_quantize(torch.from_numpy(val))
            want_q = _pool_write_reference(
                np.zeros(pool.shape, np.int8), layer, blk, off, q.numpy(),
                valid)
            want_s = _pool_write_reference(scale, layer, blk, off,
                                           s.numpy(), valid)
            np.testing.assert_array_equal(p_t.numpy(), want_q)
            np.testing.assert_array_equal(s_t.numpy(), want_s)
        else:
            tgen._pool_write(p_t, None, layer, torch.from_numpy(blk),
                             torch.from_numpy(off), torch.from_numpy(val),
                             torch.from_numpy(valid))
            want = _pool_write_reference(pool, layer, blk, off, val, valid)
            np.testing.assert_array_equal(p_t.numpy(), want)


def _models(n_kv_heads=2, seed=0):
    cfg_j = jtfm.tiny_config(n_kv_heads=n_kv_heads)
    cfg_t = ttfm.tiny_config(n_kv_heads=n_kv_heads)
    params_j = jgen.inference_params(
        cfg_j, jtfm.init_params(cfg_j, jax.random.key(seed)))
    params_t = params_from_numpy(jax.device_get(params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


IMPLS = [("xla", "gather"), ("pallas", "kernel")]


def _assert_pools_close(cache_j, cache_t, quant):
    if quant:
        # Equal codes except where a K/V value a few ulps apart between
        # the frameworks sits on a rounding boundary (one code step).
        for a, b in ((cache_j.k, cache_t.k), (cache_j.v, cache_t.v)):
            d = np.abs(np.asarray(a, np.int32) - b.numpy().astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-2
        for a, b in ((cache_j.k_scale, cache_t.k_scale),
                     (cache_j.v_scale, cache_t.v_scale)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       **PALLAS_LOGITS_TOL)
    else:
        for a, b in ((cache_j.k, cache_t.k), (cache_j.v, cache_t.v)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       **PALLAS_LOGITS_TOL)
    np.testing.assert_array_equal(cache_t.length.numpy(),
                                  np.asarray(cache_j.length))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("impl_j,impl_t", IMPLS, ids=["gather", "kernel"])
def test_prefill_then_decode_matches_jax(impl_j, impl_t, quant):
    """Two slots prefill chunkwise (a full chunk plus a padded tail; a
    single padded chunk) into shuffled pages of a pool with no spare
    page, then decode 3 steps with one slot retired after the first:
    logits, pool bytes and lengths agree with JAX at every step."""
    if impl_j == "pallas" and pap.pltpu is None:
        pytest.skip("pallas TPU backend not built into this jax")
    kvq = "int8" if quant else ""
    cfg_j, cfg_t, params_j, params_t = _models()
    n_blocks = 2 * MB
    tables = np.random.default_rng(5).permutation(n_blocks).astype(
        np.int32).reshape(2, MB)
    tables[1, 2:] = n_blocks                 # slot 1 reserved 2 pages only
    cache_j = jgen.init_paged_cache(cfg_j, 2, MB, n_blocks, BS, kvq)
    cache_j = cache_j._replace(tables=jnp.asarray(tables))
    cache_t = tgen.init_paged_cache(cfg_t, 2, MB, n_blocks, BS, kvq,
                                    device="cpu")
    cache_t.tables = torch.from_numpy(tables.copy())
    vw = MB * BS
    chunk_j = jax.jit(functools.partial(
        jgen.prefill_chunk_paged, cfg_j, view_width=vw, attn_impl=impl_j))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg_j.vocab_size, s).astype(np.int32)
               for s in (12, 5)]
    last_j, last_t = [], []
    for slot, pr in enumerate(prompts):
        for off in range(0, pr.size, BS):
            w_real = min(BS, pr.size - off)
            w = BS if w_real == BS else 1 << (w_real - 1).bit_length()
            buf = np.zeros((1, w), np.int32)
            buf[0, :w_real] = pr[off:off + w_real]
            lj, cache_j = chunk_j(
                params_j, jnp.asarray(buf), cache_j, jnp.int32(slot),
                jnp.int32(off), jnp.int32(w_real))
            lt, cache_t = tgen.prefill_chunk_paged(
                cfg_t, params_t, torch.from_numpy(buf), cache_t, slot, off,
                w_real, view_width=vw, attn_impl=impl_t)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                       **PALLAS_LOGITS_TOL)
        last_j.append(np.asarray(lj))
        last_t.append(lt)
    _assert_pools_close(cache_j, cache_t, quant)

    cache_j = cache_j._replace(active=jnp.asarray([True, True]))
    cache_t.active = torch.tensor([True, True])
    logits_j = jnp.asarray(np.concatenate(last_j))
    logits_t = torch.cat(last_t)
    step_j = jax.jit(functools.partial(
        jgen.decode_step_paged, cfg_j, view_width=vw, attn_impl=impl_j))
    for i in range(3):
        toks = np.asarray(logits_j.argmax(-1)).astype(np.int32)
        assert np.array_equal(toks, logits_t.argmax(-1).numpy())
        logits_j, cache_j = step_j(params_j, jnp.asarray(toks[:, None]),
                                   cache_j)
        logits_t, cache_t = tgen.decode_step_paged(
            cfg_t, params_t, torch.from_numpy(toks[:, None]), cache_t,
            view_width=vw, attn_impl=impl_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   **PALLAS_LOGITS_TOL)
        _assert_pools_close(cache_j, cache_t, quant)
        if i == 0:
            # Retire slot 1: its later writes must drop on both sides.
            cache_j = cache_j._replace(active=jnp.asarray([True, False]))
            cache_t.active = torch.tensor([True, False])


def test_inference_params_casts_fp32_to_compute_dtype():
    cfg = ttfm.tiny_config(dtype=torch.bfloat16)
    params = ttfm.init_params(cfg, seed=1, device="cpu")
    out = tgen.inference_params(cfg, params)
    assert out["layers"]["wq"].dtype == torch.bfloat16
    assert out["embed"].dtype == torch.bfloat16
    assert params["layers"]["wq"].dtype == torch.float32   # not in place


def test_init_params_layout_matches_jax():
    """Same tree, shapes and stacked [L, ...] layout as the JAX init, and
    scaled-normal statistics (the draws themselves differ by design)."""
    cfg_j = jtfm.tiny_config()
    cfg_t = ttfm.tiny_config()
    pj = jax.device_get(jtfm.init_params(cfg_j, jax.random.key(0)))
    pt = ttfm.init_params(cfg_t, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    for path, leaf in flat_j:
        node = pt
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.float32
    assert float(pt["layers"]["wq"].std()) == pytest.approx(
        cfg_t.d_model ** -0.5, rel=0.1)
    bf = ttfm.init_params(cfg_t, seed=0, device="cpu", dtype=torch.bfloat16)
    assert bf["layers"]["w_up"].dtype == torch.bfloat16


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        ttfm.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jtfm.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ttfm.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0).numpy(),
        np.asarray(jtfm.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
        rtol=1e-5, atol=1e-5)


# -- fused block prefill (exact prefill) -------------------------------------

@pytest.mark.parametrize("s", [16, 13], ids=["S16", "S13"])
def test_prefill_matches_jax(s):
    """The fused block prefill of a [2, S] batch (one forward over the
    prompt; the dense attention path on the CPU, in both packages):
    last-position logits and every layer's rotated K and V against JAX's
    ``prefill``, at a length that tiles the page grid and one that does
    not, in a cache longer than the prompt."""
    cfg_j, cfg_t, params_j, params_t = _models()
    prompt = np.random.default_rng(11).integers(
        0, cfg_j.vocab_size, (2, s)).astype(np.int32)
    lj, cj = jax.jit(functools.partial(jgen.prefill, cfg_j))(
        params_j, jnp.asarray(prompt), jgen.init_kv_cache(cfg_j, 2, 24))
    cache_t = tgen.init_kv_cache(cfg_t, 2, 24, device="cpu")
    lt, ct = tgen.prefill(cfg_t, params_t, torch.from_numpy(prompt), cache_t)
    assert ct is cache_t and ct.length == int(cj.length) == s
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
    for a, b in ((cj.k, ct.k), (cj.v, ct.v)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PALLAS_LOGITS_TOL)
    assert not ct.k[:, :, s:].any()


def test_flash_gate_matches_the_jax_dispatch_gate():
    """``mha``'s auto rule sends a prompt of at least 256 tokens to the
    flash kernels only at lengths that tile into blocks of at least 128,
    by the JAX package's own block rule; every other length takes the
    dense path instead of failing in the kernel."""
    from kubeflow_controller_tpu.ops import attention as jattn
    from kubeflow_controller_tpu_torch.ops import attention as tattn

    lengths = list(range(1, 700)) + [1000, 1042, 1024, 2048, 2054, 3000,
                                     4096, 8192]
    for s in lengths:
        for seg in (False, True):
            assert tattn._flash_block_ok(s, seg) == jattn._flash_block_ok(s, seg), (s, seg)
    refused = [s for s in lengths if s >= 256 and not tattn._flash_block_ok(s)]
    assert 1042 in refused and 2054 in refused, refused


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_prefill_into_paged_matches_jax(quant):
    """One request's prompt (13 tokens: a full page and a partial one)
    prefilled into slot 1's shuffled pages of a pool with no spare page:
    logits, the pool's bytes (int8 codes within one code), ``length`` and
    ``active`` against JAX; slot 0's pages untouched on both sides."""
    kvq = "int8" if quant else ""
    cfg_j, cfg_t, params_j, params_t = _models()
    n_blocks = 2 * MB
    tables = np.random.default_rng(5).permutation(n_blocks).astype(
        np.int32).reshape(2, MB)
    tables[1, 2:] = n_blocks                 # slot 1 reserved 2 pages only
    cache_j = jgen.init_paged_cache(cfg_j, 2, MB, n_blocks, BS, kvq)
    cache_j = cache_j._replace(tables=jnp.asarray(tables))
    cache_t = tgen.init_paged_cache(cfg_t, 2, MB, n_blocks, BS, kvq,
                                    device="cpu")
    cache_t.tables = torch.from_numpy(tables.copy())
    prompt = np.random.default_rng(12).integers(
        0, cfg_j.vocab_size, (1, 13)).astype(np.int32)
    lj, cache_j = jax.jit(functools.partial(jgen.prefill_into_paged, cfg_j))(
        params_j, jnp.asarray(prompt), cache_j, jnp.int32(1))
    lt, cache_t = tgen.prefill_into_paged(
        cfg_t, params_t, torch.from_numpy(prompt), cache_t, 1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
    _assert_pools_close(cache_j, cache_t, quant)
    assert cache_t.length.tolist() == np.asarray(cache_j.length).tolist() == [0, 13]
    assert cache_t.active.tolist() == np.asarray(cache_j.active).tolist() == [False, True]
    assert not cache_t.k[:, tables[0]].any()
    with pytest.raises(ValueError, match="one request"):
        tgen.prefill_into_paged(cfg_t, params_t, torch.zeros((2, 4), dtype=torch.int32),
                                cache_t, 0)
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        tgen.prefill_into_paged(cfg_t, params_t,
                                torch.zeros((1, MB * BS + 1), dtype=torch.int32),
                                cache_t, 0)
