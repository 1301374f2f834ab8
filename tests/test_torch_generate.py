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

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

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


# -- the contiguous multi-turn path and the page movement (prefix cache) ------

from kubeflow_controller_tpu_torch.ops import prng  # noqa: E402

SEEDS = (0, 1, 7, 2 ** 31 - 1)


@pytest.mark.parametrize("n", [1, 2, 5, 64])
def test_prng_split_bitwise_equals_jax(n):
    """``prng.split`` is ``jax.random.split`` (partitionable route) on
    keys from a grid of seeds, also on split keys split again."""
    for seed in SEEDS:
        kj = jax.random.key(seed)
        kt = prng.prng_key(torch.tensor(seed, dtype=torch.int32))
        for _ in range(2):
            want = np.asarray(jax.random.key_data(
                jax.random.split(kj, n))).astype(np.int64)
            k0, k1 = prng.split(kt, n)
            np.testing.assert_array_equal(k0.numpy(), want[:, 0])
            np.testing.assert_array_equal(k1.numpy(), want[:, 1])
            kj = jax.random.split(kj, n)[n - 1]
            kt = (k0[n - 1], k1[n - 1])


def _contiguous_session(cfg_j, cfg_t, params_j, params_t, prompt, cap):
    cj = jgen.init_kv_cache(cfg_j, prompt.shape[0], cap)
    lj, cj = jax.jit(functools.partial(jgen.prefill, cfg_j))(
        params_j, jnp.asarray(prompt), cj)
    ct = tgen.init_kv_cache(cfg_t, prompt.shape[0], cap, device="cpu")
    lt, ct = tgen.prefill(cfg_t, params_t, torch.from_numpy(prompt), ct)
    return lj, cj, lt, ct


def _assert_caches_close(cj, ct):
    assert int(cj.length) == int(ct.length)
    for a, b in ((cj.k, ct.k), (cj.v, ct.v)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PALLAS_LOGITS_TOL)


def test_prefill_continue_and_decode_step_match_jax():
    """A [2, 10] prompt block-prefilled, a turn of 7 new tokens through
    ``prefill_continue`` (cache half and causal half under one softmax),
    then 3 ``decode_step``s: logits and the rotated K/V cache against
    JAX's at every call; the cache's tail stays zero; a write past the
    window is refused as JAX refuses it."""
    cfg_j, cfg_t, params_j, params_t = _models()
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, cfg_j.vocab_size, (2, 10)).astype(np.int32)
    lj, cj, lt, ct = _contiguous_session(cfg_j, cfg_t, params_j, params_t,
                                         prompt, 24)
    turn = rng.integers(0, cfg_j.vocab_size, (2, 7)).astype(np.int32)
    lj, cj = jax.jit(functools.partial(jgen.prefill_continue, cfg_j))(
        params_j, jnp.asarray(turn), cj)
    lt, ct2 = tgen.prefill_continue(cfg_t, params_t, torch.from_numpy(turn), ct)
    assert ct2 is ct and ct.length == 17
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
    _assert_caches_close(cj, ct)
    step_j = jax.jit(functools.partial(jgen.decode_step, cfg_j))
    for _ in range(3):
        tok = np.asarray(lj.argmax(-1)).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], lt.argmax(-1).numpy())
        lj, cj = step_j(params_j, jnp.asarray(tok), cj)
        lt, ct = tgen.decode_step(cfg_t, params_t, torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
        _assert_caches_close(cj, ct)
    assert not ct.k[:, :, 20:].any()
    for fn, arg in ((tgen.prefill_continue, torch.zeros((2, 5), dtype=torch.int32)),
                    (tgen.generate_from_cache, None)):
        with pytest.raises(ValueError, match="exceeds max_seq"):
            if arg is None:
                fn(cfg_t, params_t, lt, ct, 5)
            else:
                fn(cfg_t, params_t, arg, ct)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        jgen.prefill_continue(cfg_j, params_j, jnp.zeros((2, 5), jnp.int32), cj)


SAMPLING = [dict(), dict(temperature=0.8), dict(temperature=1.1, top_k=20),
            dict(temperature=0.7, top_k=0, top_p=0.9)]


@pytest.mark.parametrize("kw", SAMPLING,
                         ids=["greedy", "temp", "top_k", "top_p"])
def test_generate_from_cache_streams_equal_jax(kw):
    """``generate_from_cache(return_state=True)`` from a prefilled cache,
    then a second turn through ``prefill_continue`` and again, greedy and
    sampled under ``fold_in(key(seed), turn)`` as ``serve()`` keys its
    turns: the token streams equal JAX's; the returned logits and cache
    agree within the generate tolerance."""
    cfg_j, cfg_t, params_j, params_t = _models()
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, cfg_j.vocab_size, (3, 9)).astype(np.int32)
    lj, cj, lt, ct = _contiguous_session(cfg_j, cfg_t, params_j, params_t,
                                         prompt, 40)
    sampled = kw.get("temperature", 0.0) > 0
    for turn in range(2):
        if turn:
            follow = rng.integers(0, cfg_j.vocab_size, (3, 6)).astype(np.int32)
            lj, cj = jgen.prefill_continue(cfg_j, params_j, jnp.asarray(follow), cj)
            lt, ct = tgen.prefill_continue(cfg_t, params_t,
                                           torch.from_numpy(follow), ct)
        rj = jax.random.fold_in(jax.random.key(5), turn) if sampled else None
        rt = (prng.fold_in(prng.prng_key(torch.tensor(5, dtype=torch.int32)),
                           torch.tensor(turn)) if sampled else None)
        tj, lj, cj = jgen.generate_from_cache(
            cfg_j, params_j, lj, cj, 8, rng=rj, return_state=True, **kw)
        tt, lt, ct = tgen.generate_from_cache(
            cfg_t, params_t, lt, ct, 8, rng=rt, return_state=True, **kw)
        assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, 8)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
        _assert_caches_close(cj, ct)
    # generate() is prefill + generate_from_cache on a fresh cache.
    want = jgen.generate(cfg_j, params_j, jnp.asarray(prompt), 5, max_seq=16,
                         rng=jax.random.key(3) if sampled else None, **kw)
    got = tgen.generate(cfg_t, params_t, torch.from_numpy(prompt), 5, max_seq=16,
                        rng=(prng.prng_key(torch.tensor(3, dtype=torch.int32))
                             if sampled else None), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_filter_logits_matches_jax():
    """The scalar-knob filter: the same surviving set and values as JAX's
    (ties with the top-k cut survive)."""
    rng = np.random.default_rng(23)
    logits = (rng.standard_normal((6, 97)) * 3).astype(np.float32)
    logits[::2, :4] = logits[::2, :1]
    for top_k, top_p in ((0, 1.0), (5, 1.0), (1, 1.0), (0, 0.8), (10, 0.5),
                         (0, 0.0)):
        want = np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k, top_p))
        got = tgen._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def _random_pools(quant, n_blocks=6, seed=24):
    """The same random pool bytes in a JAX and a port paged cache."""
    cfg_j, cfg_t, _, _ = _models()
    kvq = "int8" if quant else ""
    cj = jgen.init_paged_cache(cfg_j, 1, MB, n_blocks, BS, kvq)
    ct = tgen.init_paged_cache(cfg_t, 1, MB, n_blocks, BS, kvq, device="cpu")
    rng = np.random.default_rng(seed)
    arrays = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(ct, name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            a = rng.integers(-127, 128, tuple(t.shape)).astype(np.int8)
        else:
            a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        arrays[name] = a
        setattr(ct, name, torch.from_numpy(a.copy()))
    cj = cj._replace(**{k: jnp.asarray(a) for k, a in arrays.items()})
    return cj, ct


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_gather_install_round_trip_bit_for_bit(quant):
    """Pages out with ``gather_pool_pages`` (one tuple a page, the
    storage types, scales for int8 pools) equal JAX's bytes, and
    installed into other pages of another pool they are their source's
    bits; the untouched pages stay; ``pool_page_host_bytes`` is each
    page's payload size and JAX's."""
    cj, ct = _random_pools(quant)
    ids = [4, 1, 5]
    want = jgen.gather_pool_pages(cj, ids)
    pages = tgen.gather_pool_pages(ct, ids)
    assert len(pages) == len(ids)
    got = tuple(None if page[0] is None else torch.cat(page, 1)
                for page in zip(*pages))
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape and g.shape[1] == len(ids)
        np.testing.assert_array_equal(g.numpy(), w)
    for page in pages:
        assert (tgen.pool_page_host_bytes(ct) == jgen.pool_page_host_bytes(cj)
                == sum(a.nbytes for a in page if a is not None))
        assert all(a is None or a.shape[1] == 1 for a in page)
    _, dst = _random_pools(quant, seed=25)
    before = {n: getattr(dst, n).clone() for n in ("k", "v", "k_scale", "v_scale")
              if getattr(dst, n) is not None}
    tgen.install_pool_pages(dst, *got, [0, 2, 3])
    for name, src in before.items():
        new = getattr(dst, name)
        np.testing.assert_array_equal(new[:, [0, 2, 3]].numpy(),
                                      getattr(ct, name)[:, ids].numpy())
        np.testing.assert_array_equal(new[:, [1, 4, 5]].numpy(),
                                      src[:, [1, 4, 5]].numpy())
    with pytest.raises(ValueError, match="outside"):
        tgen.gather_pool_pages(ct, [6])
    with pytest.raises(ValueError, match="outside"):
        tgen.install_pool_pages(dst, *got, [0, 2, 6])
    assert tgen.install_pool_pages(dst, *got, []) is dst


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_scatter_row_into_pool_matches_jax(quant):
    """Full blocks of row 1 of an external contiguous cache (the
    ``register_prefix`` ingest) scattered into chosen pages, quantized on
    write for int8 pools: the pool's bytes against JAX's (fp pools bit for
    bit); every other page untouched."""
    cj, ct = _random_pools(quant)
    rng = np.random.default_rng(26)
    shape = (ct.k.shape[0], 2, 3 * BS, ct.k.shape[3], ct.k.shape[4])
    ek = rng.standard_normal(shape).astype(np.float32)
    ev = rng.standard_normal(shape).astype(np.float32)
    ids, starts = [3, 0], [BS, 2 * BS]
    cj = jgen.scatter_row_into_pool(cj, jnp.asarray(ek), jnp.asarray(ev), 1,
                                    ids, starts, BS)
    keep = {n: getattr(ct, n).clone() for n in ("k", "v")}
    tgen.scatter_row_into_pool(ct, torch.from_numpy(ek), torch.from_numpy(ev),
                               1, ids, starts, BS)
    if quant:
        # JAX's jitted quantizer may differ by an ulp of a scale, and so
        # by one code at a rounding boundary (as in exact prefill).
        _assert_pools_close(cj, ct, quant)
    else:
        for name in ("k", "v"):
            np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                          np.asarray(getattr(cj, name)))
    np.testing.assert_array_equal(ct.k[:, [1, 2, 4, 5]].numpy(),
                                  keep["k"][:, [1, 2, 4, 5]].numpy())


# -- the slot cache: the contiguous per-slot reference path -------------------

def _assert_slot_caches_close(cj, ct):
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
    np.testing.assert_array_equal(ct.active.numpy(), np.asarray(cj.active))
    for a, b in ((cj.k, ct.k), (cj.v, ct.v)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **PALLAS_LOGITS_TOL)


def _slot_session(cfg_j, cfg_t, params_j, params_t, prompts, n_slots, cap):
    """``prefill_into_slot`` of ``prompts[i]`` into slot i of both
    packages' slot caches; returns each side's logits rows and cache."""
    cj = jgen.init_slot_cache(cfg_j, n_slots, cap)
    ct = tgen.init_slot_cache(cfg_t, n_slots, cap, device="cpu")
    lj, lt = [], []
    for i, p in enumerate(prompts):
        a, cj = jgen.prefill_into_slot(cfg_j, params_j, jnp.asarray(p[None]), cj,
                                       jnp.int32(i))
        b, ct2 = tgen.prefill_into_slot(cfg_t, params_t, torch.from_numpy(p[None]),
                                        ct, i)
        assert ct2 is ct
        lj.append(np.asarray(a))
        lt.append(b.numpy())
    return np.concatenate(lj), cj, np.concatenate(lt), ct


def test_decode_step_slots_matches_jax():
    """Three slots at their own positions (prompts of 5, 9 and 3 tokens;
    slot 3 never admitted) through ``prefill_into_slot`` and 4
    ``decode_step_slots``, then slot 1 retired at capacity: the logits
    and the cache (K, V, lengths, liveness) against JAX's within
    ``PALLAS_LOGITS_TOL`` at every step; the retired row's write at
    ``max_seq`` is dropped on both sides, never clamped onto a live
    column."""
    cfg_j, cfg_t, params_j, params_t = _models()
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).astype(np.int32) for n in (5, 9, 3)]
    lj, cj, lt, ct = _slot_session(cfg_j, cfg_t, params_j, params_t, prompts, 4, 16)
    np.testing.assert_allclose(lt, lj, **PALLAS_LOGITS_TOL)
    _assert_slot_caches_close(cj, ct)
    step_j = jax.jit(functools.partial(jgen.decode_step_slots, cfg_j))
    tok = np.zeros((4, 1), np.int32)
    tok[:3, 0] = lj.argmax(-1)
    for _ in range(4):
        lj, cj = step_j(params_j, jnp.asarray(tok), cj)
        lt, ct = tgen.decode_step_slots(cfg_t, params_t, torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
        _assert_slot_caches_close(cj, ct)
        tok = np.asarray(lj.argmax(-1)).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], lt.argmax(-1).numpy())
    # Retire slot 1 at capacity: its next write falls at column 16 of 16.
    cj = cj._replace(length=cj.length.at[1].set(16), active=cj.active.at[1].set(False))
    ct.length[1], ct.active[1] = 16, False
    before = ct.k[:, 1].clone()
    lj, cj = step_j(params_j, jnp.asarray(tok), cj)
    lt, ct = tgen.decode_step_slots(cfg_t, params_t, torch.from_numpy(tok), ct)
    assert torch.equal(ct.k[:, 1], before) and int(ct.length[1]) == 16
    _assert_slot_caches_close(cj, ct)
    np.testing.assert_allclose(lt.numpy()[[0, 2]], np.asarray(lj)[[0, 2]],
                               **PALLAS_LOGITS_TOL)


def test_decode_step_slots_at_one_position_is_the_scalar_decode():
    """The contract of ``_decode_layer_slots``' docstring: with every slot
    at one position, the slot decode is the contiguous ``decode_step``,
    logits and cache, bit for bit."""
    cfg_j, cfg_t, params_j, params_t = _models()
    rng = np.random.default_rng(32)
    prompt = rng.integers(0, cfg_t.vocab_size, (3, 7)).astype(np.int32)
    cont = tgen.init_kv_cache(cfg_t, 3, 16, device="cpu")
    lc, cont = tgen.prefill(cfg_t, params_t, torch.from_numpy(prompt), cont)
    slots = tgen.init_slot_cache(cfg_t, 3, 16, device="cpu")
    slots.k.copy_(cont.k)
    slots.v.copy_(cont.v)
    slots.length[:] = 7
    slots.active[:] = True
    ls = lc
    for _ in range(4):
        tok = lc.argmax(-1).to(torch.int32)[:, None]
        lc, cont = tgen.decode_step(cfg_t, params_t, tok, cont)
        ls, slots = tgen.decode_step_slots(cfg_t, params_t, tok, slots)
        assert torch.equal(ls, lc)
        assert torch.equal(slots.k, cont.k) and torch.equal(slots.v, cont.v)
        assert slots.length.tolist() == [cont.length] * 3


def test_prefill_chunk_into_slot_matches_jax():
    """A 19-token prompt prefilled into slot 1 in chunks of 8 (the last
    one padded: 3 real tokens), beside slot 0 mid-decode: each chunk's
    logits and the cache against JAX's, and the last chunk's logits are
    ``prefill_into_slot``'s; a chunk past capacity drops its pad columns."""
    cfg_j, cfg_t, params_j, params_t = _models()
    rng = np.random.default_rng(33)
    first = rng.integers(0, cfg_j.vocab_size, 6).astype(np.int32)
    _, cj, _, ct = _slot_session(cfg_j, cfg_t, params_j, params_t, [first], 2, 24)
    prompt = rng.integers(0, cfg_j.vocab_size, 19).astype(np.int32)
    chunk_j = jax.jit(functools.partial(jgen.prefill_chunk_into_slot, cfg_j))
    for off in range(0, 19, 8):
        n_real = min(8, 19 - off)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n_real] = prompt[off:off + n_real]
        lj, cj = chunk_j(params_j, jnp.asarray(toks), cj, jnp.int32(1), jnp.int32(off),
                         jnp.int32(n_real))
        lt, ct = tgen.prefill_chunk_into_slot(cfg_t, params_t, torch.from_numpy(toks),
                                              ct, 1, off, n_real)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
        _assert_slot_caches_close(cj, ct)
    whole, _ = tgen.prefill_into_slot(cfg_t, params_t, torch.from_numpy(prompt[None]),
                                      tgen.init_slot_cache(cfg_t, 2, 24, device="cpu"), 1)
    np.testing.assert_allclose(lt.numpy(), whole.numpy(), **PALLAS_LOGITS_TOL)
    # A chunk at offset 20 of a 24-column row: 4 of its 8 columns land.
    toks = rng.integers(0, cfg_j.vocab_size, (1, 8)).astype(np.int32)
    lj, cj = chunk_j(params_j, jnp.asarray(toks), cj, jnp.int32(0), jnp.int32(20),
                     jnp.int32(4))
    lt, ct = tgen.prefill_chunk_into_slot(cfg_t, params_t, torch.from_numpy(toks), ct,
                                          0, 20, 4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
    _assert_slot_caches_close(cj, ct)
    with pytest.raises(ValueError, match="admits one request"):
        tgen.prefill_chunk_into_slot(cfg_t, params_t, torch.zeros((2, 8), dtype=torch.int32),
                                     ct, 0, 0, 8)


def test_verify_step_slots_matches_jax():
    """Four slots (one inactive) verify windows of K=4: a row whose drafts
    are its greedy continuation (all accepted), one with a wrong second
    draft, one cut by a committed EOS with ``draft_len`` short. The
    window, the committed counts, the carried logits and the cache equal
    JAX's (counts and windows exactly); the committed rows' cache is the
    greedy decode's. Then ``max_commit`` cuts the counts (to at least 1)
    as JAX's does."""
    cfg_j, cfg_t, params_j, params_t = _models()
    rng = np.random.default_rng(34)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).astype(np.int32) for n in (6, 8, 4, 5)]
    lj, cj, lt, ct = _slot_session(cfg_j, cfg_t, params_j, params_t, prompts, 4, 24)
    cj = cj._replace(active=cj.active.at[3].set(False))
    ct.active[3] = False
    # Row 0's greedy continuation, from a copy of the port's cache.
    probe = tgen.SlotKVCache(ct.k.clone(), ct.v.clone(), ct.length.clone(),
                             ct.active.clone())
    greedy, lp = [], torch.from_numpy(lt)
    for _ in range(5):
        tok = lp.argmax(-1).to(torch.int32)[:, None]
        greedy.append(tok[:, 0].numpy())
        lp, probe = tgen.decode_step_slots(cfg_t, params_t, tok, probe)
    greedy = np.stack(greedy, 1)                                  # [4, 5]
    draft = rng.integers(0, cfg_j.vocab_size, (4, 4)).astype(np.int32)
    draft[0] = greedy[0, 1:]
    draft[1, 0] = greedy[1, 1]
    draft[2] = greedy[2, 1:]
    draft_len = np.array([4, 4, 3, 4], np.int32)
    eos = np.array([-1, -1, greedy[2, 2], -1], np.int32)
    max_commit = np.array([8, 8, 8, 8], np.int32)
    args_j = [jnp.asarray(a) for a in (draft, draft_len)]
    wj, nj, lj2, cj = jgen.verify_step_slots(
        cfg_j, params_j, *args_j, jnp.asarray(lj), cj, jnp.asarray(eos),
        jnp.asarray(max_commit))
    wt, nt, lt2, ct = tgen.verify_step_slots(
        cfg_t, params_t, torch.from_numpy(draft), torch.from_numpy(draft_len),
        torch.from_numpy(lt), ct, torch.from_numpy(eos), torch.from_numpy(max_commit))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert nt.tolist() == [5, 2, 3, 0]
    np.testing.assert_allclose(lt2.numpy()[:3], np.asarray(lj2)[:3], **PALLAS_LOGITS_TOL)
    _assert_slot_caches_close(cj, ct)
    # Rows 0 and 2 committed the greedy stream: the cache is the decoded one's.
    for row, n in ((0, 5), (2, 3)):
        np.testing.assert_allclose(
            ct.k[:, row, :prompts[row].size + n].numpy(),
            probe.k[:, row, :prompts[row].size + n].numpy(), **PALLAS_LOGITS_TOL)
    # max_commit caps the count at 1 minimum.
    cap = np.array([2, 0, 8, 8], np.int32)
    _, nj, _, _ = jgen.verify_step_slots(cfg_j, params_j, *args_j, jnp.asarray(lj2), cj,
                                         jnp.asarray(eos), jnp.asarray(cap))
    _, nt, _, _ = tgen.verify_step_slots(
        cfg_t, params_t, torch.from_numpy(draft), torch.from_numpy(draft_len), lt2, ct,
        torch.from_numpy(eos), torch.from_numpy(cap))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def test_block_prefill_matches_tokenwise_decode():
    """The reference's case (``tests/test_generate.py:58``) on the port,
    beside JAX's ``prefill_tokenwise``: the block prefill's logits and
    cache equal ``prefill_tokenwise``'s from an empty cache, and decode
    continues alike from either; the port's tokenwise logits and cache
    are JAX's."""
    cfg_j, cfg_t, params_j, params_t = _models()
    toks = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (2, 10)).astype(np.int32)
    lb, cb = tgen.prefill(cfg_t, params_t, torch.from_numpy(toks),
                          tgen.init_kv_cache(cfg_t, 2, 16, device="cpu"))
    lw, cw = tgen.prefill_tokenwise(cfg_t, params_t, torch.from_numpy(toks),
                                    tgen.init_kv_cache(cfg_t, 2, 16, device="cpu"))
    assert int(cb.length) == int(cw.length) == 10
    np.testing.assert_allclose(lb.numpy(), lw.numpy(), atol=2e-4)
    for a, b in ((cb.k, cw.k), (cb.v, cw.v)):
        np.testing.assert_allclose(a[:, :, :10].numpy(), b[:, :, :10].numpy(), atol=2e-5)
    nxt = torch.ones((2, 1), dtype=torch.int32)
    la, _ = tgen.decode_step(cfg_t, params_t, nxt, cb)
    lb2, _ = tgen.decode_step(cfg_t, params_t, nxt, cw)
    np.testing.assert_allclose(la.numpy(), lb2.numpy(), atol=2e-4)
    lj, cj = jgen.prefill_tokenwise(cfg_j, params_j, jnp.asarray(toks),
                                    jgen.init_kv_cache(cfg_j, 2, 16))
    cw = tgen.init_kv_cache(cfg_t, 2, 16, device="cpu")
    lw, cw = tgen.prefill_tokenwise(cfg_t, params_t, torch.from_numpy(toks), cw)
    np.testing.assert_allclose(lw.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
    _assert_caches_close(cj, cw)


def test_prefill_tokenwise_extends_existing_cache():
    """The reference's case (``tests/test_generate.py:109``): a second turn
    through ``prefill_tokenwise`` on a non-empty cache equals one fresh
    block prefill of both turns, and equals JAX's continuation."""
    cfg_j, cfg_t, params_j, params_t = _models()
    rng = np.random.default_rng(7)
    turn1 = rng.integers(0, cfg_t.vocab_size, (2, 6)).astype(np.int32)
    turn2 = rng.integers(0, cfg_t.vocab_size, (2, 5)).astype(np.int32)
    both = np.concatenate([turn1, turn2], 1)
    ref_l, ref_c = tgen.prefill(cfg_t, params_t, torch.from_numpy(both),
                                tgen.init_kv_cache(cfg_t, 2, 16, device="cpu"))
    lj, cj, lt, ct = _contiguous_session(cfg_j, cfg_t, params_j, params_t, turn1, 16)
    got_l, got_c = tgen.prefill_tokenwise(cfg_t, params_t, torch.from_numpy(turn2), ct)
    assert int(got_c.length) == int(ref_c.length) == 11
    np.testing.assert_allclose(got_l.numpy(), ref_l.numpy(), atol=3e-4)
    lj, cj = jgen.prefill_tokenwise(cfg_j, params_j, jnp.asarray(turn2), cj)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
    _assert_caches_close(cj, got_c)


def test_slot_paths_take_a_moe_model():
    """tiny_moe through the slot paths: prefill, a chunk and decode steps
    route their FFNs as JAX's do (the block FFN at capacity E / top_k, one
    token a row through the decode FFN)."""
    cfg_j = jtfm.tiny_moe_config()
    cfg_t = ttfm.tiny_moe_config()
    params_j = jgen.inference_params(cfg_j, jtfm.init_params(cfg_j, jax.random.key(3)))
    params_t = params_from_numpy(jax.device_get(params_j), device="cpu")
    rng = np.random.default_rng(35)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).astype(np.int32) for n in (6, 4)]
    lj, cj, lt, ct = _slot_session(cfg_j, cfg_t, params_j, params_t, prompts, 2, 16)
    np.testing.assert_allclose(lt, lj, rtol=5e-4, atol=5e-4)
    toks = rng.integers(0, cfg_j.vocab_size, (1, 4)).astype(np.int32)
    lj, cj = jgen.prefill_chunk_into_slot(cfg_j, params_j, jnp.asarray(toks), cj,
                                          jnp.int32(1), jnp.int32(4), jnp.int32(4))
    lt, ct = tgen.prefill_chunk_into_slot(cfg_t, params_t, torch.from_numpy(toks), ct,
                                          1, 4, 4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=5e-4, atol=5e-4)
    tok = np.array([[1], [2]], np.int32)
    lj, cj = jgen.decode_step_slots(cfg_j, params_j, jnp.asarray(tok), cj)
    lt, ct = tgen.decode_step_slots(cfg_t, params_t, torch.from_numpy(tok), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=5e-4, atol=5e-4)
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
