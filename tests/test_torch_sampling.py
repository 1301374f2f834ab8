"""The port's sampling parts held against the JAX package, on the CPU.

* The key chain (``ops/prng.py``, ``generate._sample_keys``): keys, the
  random bits and the uniforms drawn from them bitwise equal to JAX's
  over a grid of seeds (0, 1, 7, 2^31 - 1), generations 0..3 and
  positions 0..1000. The Gumbel noise is held to
  ``|dg| <= GUMBEL_TOL * eps32 * (1 + |g|)``: ``log`` is not bitwise
  across XLA's CPU, torch's CPU and CUDA (the largest seen on this grid
  is 1.0 of those units).
* ``_filter_logits_rows``: bitwise, on every row whose top-p cut is not
  within ``TOP_P_EPS`` of ``top_p`` (the softmax and the cumulative sum
  sum in another order than XLA's); those rows are counted.
* ``sample_step_slots`` with and without a mask, greedy rows mixed in:
  tokens equal; the smallest top-2 gap of ``gumbel + logits`` on the
  grid is reported, so that a flipped draw would be explained.
* ``verify_step_paged_sampled`` through the gather oracle and the
  kernel route: window, n and next_tok bitwise, logits within
  ``PALLAS_LOGITS_TOL``.
* ``copy_pool_pages`` for fp and int8 pools: bitwise.
* ``BlockPool`` under random ref/owner soups: the same results, errors
  and refcounts as JAX's.
* Every mask's ``allowed`` vector on each state that a replay of random
  strings reaches, and ``make_mask``'s errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane import kv_blocks as jkv
from kubeflow_controller_tpu.dataplane import sampling as jsamp
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu.ops import paged_attention_pallas as pap
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane import kv_blocks as tkv
from kubeflow_controller_tpu_torch.dataplane import sampling as tsamp
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttfm
from kubeflow_controller_tpu_torch.ops import prng

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

PALLAS_LOGITS_TOL = dict(rtol=5e-5, atol=5e-5)
GUMBEL_TOL = 2.0
TOP_P_EPS = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
SEEDS = (0, 1, 7, 2 ** 31 - 1)
BS, MB, K = 8, 6, 4
PROMPT_LENS = (9, 13, 6, 11)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def _grid(pos=range(1001)):
    s, g, p = np.meshgrid(np.asarray(SEEDS, np.int32),
                          np.arange(4, dtype=np.int32),
                          np.asarray(list(pos), np.int32), indexing="ij")
    return s.reshape(-1), g.reshape(-1), p.reshape(-1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_jax_threefry_is_partitionable():
    """The port rebuilds the partitionable route; a change of JAX's
    default would change every reference draw."""
    assert jax.config.jax_threefry_partitionable is True


def test_sample_keys_equal_jax_over_the_seed_grid():
    seed, gen, pos = _grid()
    kj = np.asarray(jax.random.key_data(
        jax.jit(jgen._sample_keys)(seed, gen, pos))).astype(np.int64)
    k0, k1 = tgen._sample_keys(_t(seed), _t(gen), _t(pos))
    np.testing.assert_array_equal(k0.numpy(), kj[:, 0])
    np.testing.assert_array_equal(k1.numpy(), kj[:, 1])


@functools.lru_cache(None)
def _draws(n=384):
    """JAX's bits, uniforms and gumbels of every 25th position of the
    grid, and the port's."""
    seed, gen, pos = _grid(range(0, 1001, 25))
    keys = jax.jit(jgen._sample_keys)(seed, gen, pos)
    tiny = np.finfo(np.float32).tiny
    bits = jax.jit(jax.vmap(lambda k: jax.random.bits(k, (n,))))(keys)
    unif = jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=tiny, maxval=1.0)))(keys)
    gumb = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (n,))))(keys)
    tkeys = tgen._sample_keys(_t(seed), _t(gen), _t(pos))
    tbits = prng.random_bits(tkeys, n)
    return (np.asarray(bits), np.asarray(unif), np.asarray(gumb),
            tbits.numpy(), prng.uniform(tbits).numpy(),
            prng.gumbel(tbits).numpy())


def test_random_bits_and_uniform_bitwise_equal_jax():
    bits, unif, _, tbits, tunif, _ = _draws()
    np.testing.assert_array_equal(tbits, bits.astype(np.int64))
    np.testing.assert_array_equal(tunif.view(np.int32), unif.view(np.int32))
    assert tunif.min() > 0.0 and tunif.max() < 1.0


def test_gumbel_within_the_stated_bound():
    _, _, gumb, _, _, tgumb = _draws()
    g = gumb.astype(np.float64)
    err = np.abs(tgumb.astype(np.float64) - g) / (EPS32 * (1.0 + np.abs(g)))
    print(f"gumbel: max |dg| = {err.max():.3f} eps32 * (1 + |g|), "
          f"{(err > 0).mean():.4f} of draws differ")
    assert err.max() <= GUMBEL_TOL


def test_categorical_equals_jax():
    """``prng.categorical`` draws JAX's ``jax.random.categorical`` tokens
    on the grid's keys (logits with ties at the top in some rows)."""
    seed, gen, pos = _grid(range(0, 1001, 40))
    logits = (np.random.default_rng(3).normal(size=(seed.size, 97)) * 2
              ).astype(np.float32)
    logits[::3, :5] = logits[::3, :1]
    keys = jax.jit(jgen._sample_keys)(seed, gen, pos)
    want = np.asarray(jax.jit(jax.vmap(jax.random.categorical))(keys, logits))
    got = prng.categorical(tgen._sample_keys(_t(seed), _t(gen), _t(pos)),
                           _t(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def _filter_inputs(v=97):
    """Rows over temperatures x top_k in {0, 1, 5, V} x top_p in {0.1,
    0.9, 1.0}, with tied logits in some rows."""
    rng = np.random.default_rng(0)
    rows = [(t, k, p) for t in (0.0, 0.7, 1.3) for k in (0, 1, 5, v)
            for p in (0.1, 0.9, 1.0)]
    logits = (rng.normal(size=(len(rows), v)) * 3).astype(np.float32)
    logits[::4, :8] = logits[::4, :1]          # ties at the top
    temp, tk, tp = (np.asarray(c, dt) for c, dt in zip(
        zip(*rows), (np.float32, np.int32, np.float32)))
    return logits, temp, tk, tp


def _boundary_rows(logits, temp, tk, tp):
    """Rows whose cumulative top-p mass (in float64) comes within
    TOP_P_EPS of top_p: where the cut may move with the summation
    order."""
    out = []
    for i in range(logits.shape[0]):
        if tp[i] >= 1.0:
            continue
        x = np.sort(logits[i].astype(np.float64)
                    / (temp[i] if temp[i] > 0 else 1.0))[::-1]
        if tk[i] > 0:
            x = np.where(x < x[min(tk[i], x.size) - 1], -np.inf, x)
        p = np.exp(x - x[0])
        cum = np.cumsum(p / p.sum())
        if np.abs(cum - tp[i]).min() < TOP_P_EPS:
            out.append(i)
    return out


def test_filter_logits_rows_bitwise_off_the_top_p_boundary():
    logits, temp, tk, tp = _filter_inputs()
    want = np.asarray(jax.jit(jgen._filter_logits_rows)(logits, temp, tk, tp))
    got = tgen._filter_logits_rows(_t(logits), _t(temp), _t(tk),
                                   _t(tp)).numpy()
    edge = _boundary_rows(logits, temp, tk, tp)
    print(f"filter: {len(edge)} of {len(tp)} rows within {TOP_P_EPS} of "
          "their top_p cut")
    keep = [i for i in range(len(tp)) if i not in edge]
    assert len(keep) >= len(tp) - 2
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  want[keep].view(np.int32))
    # The knobs bite: top_k=1 keeps the ties of the maximum only, a row
    # with both knobs off passes through as logits / temperature.
    for i in keep:
        finite = np.isfinite(got[i]).sum()
        if tk[i] == 1:
            assert finite == (got[i] == got[i].max()).sum()
        if tk[i] in (0, logits.shape[1]) and tp[i] >= 1.0:
            assert finite == logits.shape[1]


def _sample_inputs(b=12, v=97, seed=1):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, v)) * 2).astype(np.float32)
    temp = np.where(np.arange(b) % 3 == 0, 0.0,
                    rng.uniform(0.5, 1.5, b)).astype(np.float32)
    tk = rng.choice([0, 5, 20], b).astype(np.int32)
    tp = rng.choice([1.0, 0.9, 0.95], b).astype(np.float32)
    seeds = rng.choice(np.asarray(SEEDS, np.int32), b).astype(np.int32)
    gens = rng.integers(0, 4, b).astype(np.int32)
    pos = rng.integers(0, 1001, b).astype(np.int32)
    mask = rng.random((b, v)) < 0.3
    mask[:, 0] = True
    return logits, temp, tk, tp, seeds, gens, pos, mask


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_sample_step_slots_tokens_equal_jax(masked):
    """Tokens equal JAX's on 8 batches of sampled and greedy rows; greedy
    rows are the (masked) argmax. The smallest top-2 gap of gumbel +
    filtered logits over the sampled rows is reported."""
    gaps = []
    for rep in range(8):
        lg, temp, tk, tp, seeds, gens, pos, mask = _sample_inputs(seed=rep)
        m = mask if masked else None
        want = np.asarray(jax.jit(jgen.sample_step_slots)(
            lg, temp, tk, tp, seeds, gens, pos,
            **({"mask": m} if masked else {})))
        got = tgen.sample_step_slots(
            _t(lg), _t(temp), _t(tk), _t(tp), _t(seeds), _t(gens), _t(pos),
            mask=None if m is None else _t(m)).numpy()
        np.testing.assert_array_equal(got, want)
        base = np.where(m, lg, -np.inf) if masked else lg
        greedy = temp <= 0
        np.testing.assert_array_equal(got[greedy], base[greedy].argmax(-1))
        if masked:
            assert mask[np.arange(len(got)), got].all()
        filt = tgen._filter_logits_rows(
            _t(base.astype(np.float32)), _t(temp), _t(tk), _t(tp))
        z = (tgen.sampling_noise(tgen.generation_keys(_t(seeds), _t(gens)),
                                 _t(pos), lg.shape[1])
             + filt).numpy()[~greedy]
        top2 = np.sort(z, -1)[:, -2:]
        gaps.extend(top2[:, 1] - top2[:, 0])
    print(f"sample_step_slots: smallest top-2 gap {min(gaps):.3e}")
    assert min(gaps) > 0.0


# -- the sampled verify step ----------------------------------------------------

@functools.lru_cache(None)
def _models():
    cfg_j = jtfm.tiny_config()
    cfg_t = ttfm.tiny_config()
    params_j = jgen.inference_params(
        cfg_j, jtfm.init_params(cfg_j, jax.random.key(0)))
    params_t = params_from_numpy(jax.device_get(params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


@functools.lru_cache(None)
def _prefilled(kvq):
    """A JAX paged cache with 4 slots prefilled into shuffled pages (slot
    3 then retired) and its carried logits."""
    cfg_j, _, params_j, _ = _models()
    n = len(PROMPT_LENS)
    n_blocks = n * MB
    tables = np.random.default_rng(3).permutation(n_blocks).astype(
        np.int32).reshape(n, MB)
    cache = jgen.init_paged_cache(cfg_j, n, MB, n_blocks, BS, kvq)
    cache = cache._replace(tables=jnp.asarray(tables))
    rng = np.random.default_rng(4)
    fill = jax.jit(functools.partial(jgen.prefill_into_paged, cfg_j))
    rows = []
    for slot, s in enumerate(PROMPT_LENS):
        prompt = rng.integers(0, cfg_j.vocab_size, (1, s)).astype(np.int32)
        lg, cache = fill(params_j, jnp.asarray(prompt), cache, jnp.int32(slot))
        rows.append(np.asarray(lg))
    cache = cache._replace(active=cache.active.at[n - 1].set(False))
    return cache, np.concatenate(rows)


def _to_port(cache_j):
    host = jax.device_get(cache_j)

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x, copy=True))

    return tgen.PagedKVCache(k=t(host.k), v=t(host.v), k_scale=t(host.k_scale),
                             v_scale=t(host.v_scale), tables=t(host.tables),
                             length=t(host.length), active=t(host.active))


@pytest.mark.parametrize("impl_j,impl_t", [("xla", "gather"), ("pallas", "kernel")],
                         ids=["gather", "kernel"])
def test_verify_step_paged_sampled_matches_jax(impl_j, impl_t):
    """Four slots verify K=4 drafts, two of them sampled (one drafting
    its own sampled continuation, so draws are accepted), one greedy and
    one inactive: window, n and next_tok bitwise, new logits and pages
    within tolerance."""
    if impl_j == "pallas" and pap.pltpu is None:
        pytest.skip("pallas TPU backend not built into this jax")
    cfg_j, cfg_t, params_j, params_t = _models()
    cache_j, logits = _prefilled("")
    cache_t = _to_port(cache_j)
    temp = np.asarray([0.9, 0.0, 1.2, 0.8], np.float32)
    tk = np.asarray([20, 0, 0, 5], np.int32)
    tp = np.asarray([0.95, 1.0, 0.9, 1.0], np.float32)
    seeds = np.asarray([3, 0, 2 ** 31 - 1, 7], np.int32)
    gens = np.asarray([0, 0, 2, 1], np.int32)
    pos = np.asarray([5, 0, 17, 2], np.int32)
    samp = (temp, tk, tp, seeds, gens, pos)
    # Row 0 drafts the tokens it would sample one at a time: a plain
    # sampled decode from the same cache, in JAX.
    step = jax.jit(functools.partial(jgen.decode_step_paged, cfg_j))
    c, lg, row0 = cache_j, jnp.asarray(logits), []
    for j in range(K + 1):
        tok = jgen.sample_step_slots(lg, temp, tk, tp, seeds, gens, pos + j)
        row0.append(int(tok[0]))
        lg, c = step(params_j, tok[:, None], c)
    draft = np.random.default_rng(9).integers(
        0, cfg_j.vocab_size, (4, K)).astype(np.int32)
    draft[0] = row0[1:]
    dlen = np.asarray([K, K, 3, K], np.int32)
    eos = np.full(4, -1, np.int32)
    max_commit = np.full(4, K + 1, np.int32)
    wj, nj, tj, lj, cache_j = jax.jit(functools.partial(
        jgen.verify_step_paged_sampled, cfg_j, view_width=MB * BS,
        attn_impl=impl_j))(params_j, draft, dlen, logits, cache_j, eos,
                           max_commit, *samp)
    wt, nt, tt, lt, cache_t = tgen.verify_step_paged_sampled(
        cfg_t, params_t, _t(draft), _t(dlen), _t(logits), cache_t, _t(eos),
        _t(max_commit), *map(_t, samp), view_width=MB * BS, attn_impl=impl_t)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert int(nt[0]) == K + 1 and int(nt[3]) == 0
    assert wt[0].tolist() == row0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
    np.testing.assert_allclose(cache_t.k.numpy(), np.asarray(cache_j.k),
                               **PALLAS_LOGITS_TOL)
    np.testing.assert_array_equal(cache_t.length.numpy(),
                                  np.asarray(cache_j.length))


# -- copy-on-write page copy ---------------------------------------------------

@pytest.mark.parametrize("kvq", ["", "int8"], ids=["fp", "int8"])
def test_copy_pool_pages_bitwise_equal_jax(kvq):
    cache_j, _ = _prefilled(kvq)
    cache_t = _to_port(cache_j)
    n_blocks = cache_t.k.shape[1]
    src, dst = [3, 7, 0], [11, n_blocks, 5]      # the sentinel write drops
    cache_j = jgen.copy_pool_pages(cache_j, src, dst)
    before = cache_t.k.clone()
    tgen.copy_pool_pages(cache_t, src, dst)
    for a, b in ((cache_j.k, cache_t.k), (cache_j.v, cache_t.v),
                 (cache_j.k_scale, cache_t.k_scale),
                 (cache_j.v_scale, cache_t.v_scale)):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert torch.equal(cache_t.k[:, 11], before[:, 3])
    assert torch.equal(cache_t.k[:, 5], before[:, 0])


# -- the block pool --------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_block_pool_soup_equals_jax(seed):
    """Random alloc/ref/unref soups under owner tokens, owner-set debug
    mode on: every result, every error and the final refcounts and owner
    sets equal JAX's."""
    rng = np.random.default_rng(seed)
    pools = (jkv.BlockPool(6, debug_owners=True),
             tkv.BlockPool(6, debug_owners=True))
    owners = [None, ("fork", 1, 1), ("fork", 1, 2), ("fork-src", 2, 1)]
    for _ in range(200):
        op = rng.choice(["alloc", "ref", "unref"])
        bid = int(rng.integers(0, 6))
        owner = owners[int(rng.integers(0, len(owners)))]
        outs = []
        for pool in pools:
            try:
                if op == "alloc":
                    outs.append(pool.alloc(owner=owner))
                else:
                    getattr(pool, op)(bid, owner=owner)
                    outs.append(None)
            except (RuntimeError, AssertionError) as e:
                outs.append(type(e).__name__ + str(e).split(" (")[0])
        assert outs[0] == outs[1], (op, bid, owner, outs)
        assert pools[0].used_blocks == pools[1].used_blocks
    for b in range(6):
        assert pools[0].refcount(b) == pools[1].refcount(b)
        assert pools[0].owners(b) == pools[1].owners(b)
    assert pools[0].free_blocks == pools[1].free_blocks


# -- masks -------------------------------------------------------------------------

MASK_SPECS = ["json", "re:[0-9]+(\\.[0-9]+)?", "re:(ab|c)*d?", "re:[^a-c]x.",
              "set:1,5,9"]


@pytest.mark.parametrize("spec", MASK_SPECS)
@pytest.mark.parametrize("eos", [None, 99])
def test_mask_allowed_equals_jax_on_replayed_states(spec, eos):
    """Replay random admissible strings through both packages' masks
    (vocab 100, the default token alphabet): every ``allowed`` vector and
    every completeness answer on the way are equal."""
    v = 100
    mj = jsamp.make_mask(spec, v, eos_id=eos)
    mt = tsamp.make_mask(spec, v, eos_id=eos)
    assert type(mt).__name__ == type(mj).__name__
    rng = np.random.default_rng(len(spec))
    for _ in range(12):
        sj, st = mj.init_state(), mt.init_state()
        for _ in range(16):
            aj, at = mj.allowed(sj), mt.allowed(st)
            np.testing.assert_array_equal(at, aj)
            assert mt.is_complete(st) == mj.is_complete(sj)
            if not aj.any():
                break
            tok = int(rng.choice(np.flatnonzero(aj)))
            sj, st = mj.advance(sj, tok), mt.advance(st, tok)


@pytest.mark.parametrize("spec", ["bogus", "re:(ab", "re:a)", "re:[ab",
                                  "re:*a", "re:a\\", "set:1,x", "set:400",
                                  "set:"])
def test_make_mask_errors_equal_jax(spec):
    with pytest.raises(ValueError) as ej:
        jsamp.make_mask(spec, 100, eos_id=None)
    with pytest.raises(ValueError) as et:
        tsamp.make_mask(spec, 100, eos_id=None)
    assert str(et.value) == str(ej.value)


def test_sampling_params_validation_equals_jax():
    for kw in (dict(temperature=-0.1), dict(temperature=float("nan")),
               dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5), dict(n=0),
               dict(seed=-1), dict(max_tokens=0)):
        with pytest.raises(ValueError) as ej:
            jsamp.SamplingParams(**kw).validate()
        with pytest.raises(ValueError) as et:
            tsamp.SamplingParams(**kw).validate()
        assert str(et.value) == str(ej.value)
    ok = dict(temperature=0.7, top_k=5, top_p=0.9, n=4, seed=9)
    tsamp.SamplingParams(**ok).validate()
    assert not tsamp.SamplingParams(**ok).is_greedy
