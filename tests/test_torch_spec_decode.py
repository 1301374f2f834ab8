"""Greedy speculative decoding in the port held against the JAX package:
the verify step (``models/generate.py:verify_step_paged``), the
prompt-lookup proposer and the speculative engine.

Weights come from the JAX init (``tiny_config``, fp32) and cross as
numpy arrays. The verify step runs from the same pool bytes on both
sides (a JAX prefill, carried across), under both attention routes:
the port's ``"gather"`` against JAX's ``"xla"`` oracle, and ``"kernel"``
(on the CPU the kernel's plain version) against ``"pallas"`` (interpret
mode). ``window`` and ``n`` must be bitwise equal; logits and pages are
held to the JAX package's end-to-end ``PALLAS_LOGITS_TOL`` (int8 codes
within one code).

The two reference tests that fail on this path (ROADMAP C6) state
contracts the port is held to here, on inputs where they bite: an EOS
whose first occurrence in the window is at index 1 commits exactly two
tokens; ``max_commit`` clamps ``n`` exactly; rejected positions leave no
KV behind; and a budget crossed by a multi-token accept retires the
request at exactly its budget, with draft tokens accepted.
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
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu.ops import paged_attention_pallas as pap
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane import kv_blocks as tkv
from kubeflow_controller_tpu_torch.dataplane import spec_decode as tspec
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttfm

PALLAS_LOGITS_TOL = dict(rtol=5e-5, atol=5e-5)
BS, MB, K = 8, 6, 4
PROMPT_LENS = (9, 13, 6, 11)

needs_pallas = pytest.mark.skipif(
    pap.pltpu is None, reason="pallas TPU backend not built into this jax")


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


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
    """A JAX paged cache with 4 slots prefilled into shuffled pages (slot 3
    then retired) and its carried logits (JAX arrays are immutable: the
    tests share them)."""
    cfg_j, cfg_t, params_j, _ = _models()
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
    logits = np.concatenate(rows)
    return cache, logits


def _to_port(cache_j):
    host = jax.device_get(cache_j)

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x, copy=True))

    return tgen.PagedKVCache(k=t(host.k), v=t(host.v), k_scale=t(host.k_scale),
                             v_scale=t(host.v_scale), tables=t(host.tables),
                             length=t(host.length), active=t(host.active))


def _greedy(cache_j, logits, steps):
    """JAX's plain greedy continuation ``[B, steps]`` after the carried
    logits (the first column is their argmax)."""
    cfg_j, _, params_j, _ = _models()
    step = jax.jit(functools.partial(jgen.decode_step_paged, cfg_j))
    out, lg = [], jnp.asarray(logits)
    for _ in range(steps):
        tok = lg.argmax(-1).astype(jnp.int32)
        out.append(np.asarray(tok))
        lg, cache_j = step(params_j, tok[:, None], cache_j)
    return np.stack(out, 1)


def _verify_port(cache_t, logits, draft, dlen, eos, max_commit, impl):
    _, cfg_t, _, params_t = _models()
    return tgen.verify_step_paged(
        cfg_t, params_t, torch.from_numpy(draft), torch.from_numpy(dlen),
        torch.from_numpy(logits), cache_t, torch.from_numpy(eos),
        torch.from_numpy(max_commit), view_width=MB * BS, attn_impl=impl)


def _assert_pools_close(cache_j, cache_t, quant):
    if quant:
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


# -- the verify step -----------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("impl_j,impl_t", [("xla", "gather"), ("pallas", "kernel")],
                         ids=["gather", "kernel"])
def test_verify_step_paged_matches_jax(impl_j, impl_t, quant):
    """Four slots verify K=4 drafts at once: row 0 the exact greedy
    continuation (clamped by max_commit 3), row 1 greedy with its third
    draft token wrong, row 2 random drafts of which 2 are valid, row 3
    inactive. ``window`` and ``n`` bitwise, new logits, pages and lengths
    within tolerance of JAX's."""
    if impl_j == "pallas" and pap.pltpu is None:
        pytest.skip("pallas TPU backend not built into this jax")
    kvq = "int8" if quant else ""
    cfg_j, _, params_j, _ = _models()
    cache_j, logits = _prefilled(kvq)
    cache_t = _to_port(cache_j)
    greedy = _greedy(cache_j, logits, K + 1)
    draft = greedy[:, 1:].copy()
    draft[1, 2] = (draft[1, 2] + 1) % cfg_j.vocab_size
    draft[2] = np.random.default_rng(9).integers(0, cfg_j.vocab_size, K)
    dlen = np.asarray([K, K, 2, K], np.int32)
    eos = np.full(4, -1, np.int32)
    max_commit = np.asarray([3, K + 1, K + 1, K + 1], np.int32)
    wj, nj, lj, cache_j = jax.jit(functools.partial(
        jgen.verify_step_paged, cfg_j, view_width=MB * BS, attn_impl=impl_j))(
            params_j, jnp.asarray(draft), jnp.asarray(dlen),
            jnp.asarray(logits), cache_j, jnp.asarray(eos),
            jnp.asarray(max_commit))
    wt, nt, lt, cache_t = _verify_port(cache_t, logits, draft, dlen, eos,
                                       max_commit, impl_t)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert nt.tolist()[0] == 3 and nt.tolist()[1] == 3 and nt.tolist()[3] == 0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **PALLAS_LOGITS_TOL)
    _assert_pools_close(cache_j, cache_t, quant)
    np.testing.assert_array_equal(cache_t.length.numpy(), np.asarray(cache_j.length))


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_eos_first_seen_at_window_index_1_commits_two(impl):
    """C6: with a perfect draft, an EOS id whose first occurrence in the
    window is at index 1 commits exactly the two tokens through it, and
    the slot's length advances by 2. (The reference test picked an EOS
    equal to the window's first token, where n = 1 is the contract.)"""
    cache_j, logits = _prefilled("")
    greedy = _greedy(cache_j, logits, K + 1)
    rows = [b for b in range(3) if greedy[b, 1] != greedy[b, 0]]
    assert rows, greedy
    b = rows[0]
    eos = np.full(4, -1, np.int32)
    eos[b] = greedy[b, 1]
    cache_t = _to_port(cache_j)
    length0 = cache_t.length.clone()
    window, n, _, cache_t = _verify_port(
        cache_t, logits, greedy[:, 1:].copy(), np.full(4, K, np.int32), eos,
        np.full(4, K + 1, np.int32), impl)
    assert window[b].tolist() == greedy[b].tolist()
    assert int(n[b]) == 2
    assert int(cache_t.length[b]) == int(length0[b]) + 2
    others = [r for r in range(3) if r != b]
    assert all(int(n[r]) == K + 1 for r in others if eos[r] < 0)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_max_commit_clamps_n_exactly(impl):
    """C6: a perfect draft under max_commit m commits exactly m tokens
    (m = 0 counts as 1), for every m in 0..K+1."""
    cache_j, logits = _prefilled("")
    greedy = _greedy(cache_j, logits, K + 1)
    for m in range(K + 2):
        cache_t = _to_port(cache_j)
        _, n, _, cache_t = _verify_port(
            cache_t, logits, greedy[:, 1:].copy(), np.full(4, K, np.int32),
            np.full(4, -1, np.int32), np.full(4, m, np.int32), impl)
        assert n.tolist() == [max(m, 1)] * 3 + [0], m


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_rejected_positions_leave_no_kv(impl, quant):
    """C6: verify a draft that is wrong from its second token (n = 2 on
    every live row), then decode greedily: the stream equals plain
    greedy decode from the same start, and no pool byte outside the
    committed columns changed."""
    kvq = "int8" if quant else ""
    _, cfg_t, _, params_t = _models()
    cache_j, logits = _prefilled(kvq)
    greedy = _greedy(cache_j, logits, K + 4)
    draft = greedy[:, 1:K + 1].copy()
    draft[:, 1:] = (draft[:, 1:] + 7) % cfg_t.vocab_size
    cache_t = _to_port(cache_j)
    before = [cache_t.k.clone(), cache_t.v.clone()]
    window, n, lg, cache_t = _verify_port(
        cache_t, logits, draft, np.full(4, K, np.int32),
        np.full(4, -1, np.int32), np.full(4, K + 1, np.int32), impl)
    assert n.tolist() == [2, 2, 2, 0]
    written = torch.zeros(cache_t.k.shape[1:3], dtype=torch.bool)
    for b, s in enumerate(PROMPT_LENS[:3]):
        for c in (s, s + 1):
            written[cache_t.tables[b, c // BS], c % BS] = True
    for now, old in zip((cache_t.k, cache_t.v), before):
        assert torch.equal(now[:, ~written], old[:, ~written])
    stream = [window[:, :2]]
    for _ in range(K + 2):
        tok = lg.argmax(-1).to(torch.int32)
        stream.append(tok[:, None])
        lg, cache_t = tgen.decode_step_paged(cfg_t, params_t, tok[:, None],
                                             cache_t, view_width=MB * BS,
                                             attn_impl=impl)
    got = torch.cat(stream, 1).numpy()
    np.testing.assert_array_equal(got[:3], greedy[:3])


# -- the proposer ----------------------------------------------------------------

def _contexts(seed):
    """Contexts with planted n-grams: a random history, a repeated
    pattern, a looping tail and degenerate short ones."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(12):
        n = int(rng.integers(1, 40))
        ctx = rng.integers(0, 6 if rng.random() < 0.5 else 50, n)
        if n > 8 and rng.random() < 0.5:
            pat = ctx[:int(rng.integers(2, 5))]
            ctx = np.concatenate([ctx, pat, ctx[:3], pat])
        out.append(ctx.astype(np.int32))
    out += [np.asarray([5], np.int32), np.asarray([5, 5], np.int32),
            np.asarray([1, 2, 1, 2], np.int32), None]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_prompt_lookup_equals_jax(seed):
    """``propose`` and ``has_candidate`` of the port's
    PromptLookupProposer equal JAX's over a seeded grid of contexts,
    draft widths and n-gram ranges."""
    ctxs = _contexts(seed)
    for ngram in ((3, 2), (4, 1), (2, 2)):
        pj = jspec.PromptLookupProposer(*ngram)
        pt = tspec.PromptLookupProposer(*ngram)
        for k in (1, 3, 5, 8):
            dj, lj = pj.propose(ctxs, k)
            dt, lt = pt.propose(ctxs, k)
            np.testing.assert_array_equal(dt, dj)
            np.testing.assert_array_equal(lt, lj)
        for c in ctxs:
            if c is not None:
                assert pt.has_candidate(c) == pj.has_candidate(c)


def test_make_proposer():
    assert isinstance(tspec.make_proposer("prompt"), tspec.PromptLookupProposer)
    # The radix proposer (refused until the prefix cache was ported)
    # walks a prefix store, and needs one, as in JAX.
    with pytest.raises(ValueError, match="requires prefix_cache"):
        tspec.make_proposer("radix")
    store = tkv.PrefixStore(None, 4, 8)
    prop = tspec.make_proposer("radix", store)
    assert isinstance(prop, tspec.RadixProposer) and prop.store is store
    with pytest.raises(ValueError, match="unknown proposer"):
        tspec.make_proposer("model")
    with pytest.raises(ValueError, match="ngram_min"):
        tspec.PromptLookupProposer(ngram_max=1, ngram_min=2)


# -- the speculative engine ------------------------------------------------------

def _tiled(cfg, n=6, period=4, reps=6, max_new=12, seed=5):
    """Repetitive prompts (a short random pattern tiled): prompt lookup
    finds n-gram matches from the first eligible step."""
    rng = np.random.default_rng(seed)
    return [(np.tile(rng.integers(0, cfg.vocab_size, period).astype(np.int32),
                     reps), max_new + i % 3) for i in range(n)]


class _Oracle:
    """Drafts the plain engine's own continuation of a request (known
    from a plain run), so multi-token accepts fire on random weights."""

    def __init__(self, work, streams):
        self.book = [(p, streams[i]) for i, (p, _) in enumerate(work)]

    def propose(self, contexts, k):
        draft = np.zeros((len(contexts), k), np.int32)
        lens = np.zeros((len(contexts),), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is None:
                continue
            for prompt, stream in self.book:
                if (ctx.size >= prompt.size
                        and np.array_equal(ctx[:prompt.size], prompt)
                        and list(ctx[prompt.size:]) == stream[:ctx.size - prompt.size]):
                    got = stream[ctx.size - prompt.size:][:k]
                    draft[i, :len(got)] = got
                    lens[i] = len(got)
                    break
        return draft, lens


class _PortOracle(_Oracle, tspec.DraftProposer):
    pass


class _JaxOracle(_Oracle, jspec.DraftProposer):
    pass


def _run(make, work, eos=None, **kw):
    eng = make(**kw)
    req = JRequest if isinstance(eng, JEngine) else Request
    out = eng.run([req(rid=i, prompt=p, max_new_tokens=m, eos_id=eos)
                   for i, (p, m) in enumerate(work)])
    return {c.rid: (list(c.tokens), c.finish_reason) for c in out}, eng


def _port(**kw):
    _, cfg_t, _, params_t = _models()
    return ServingEngine(cfg_t, params_t, device="cpu", **kw)


def _jax(**kw):
    cfg_j, _, params_j, _ = _models()
    return JEngine(cfg_j, params_j, attn_impl="pallas", **kw)


def _counters(stats):
    return (stats.draft_proposed, stats.draft_accepted, stats.spec_steps,
            stats.spec_probe_steps, dict(stats.spec_step_tokens_hist))


@needs_pallas
@pytest.mark.parametrize("mode,kvq,oracle", [
    ("exact", "", False), ("exact", "", True), ("exact", "int8", True),
    ("bucketed", "", True)], ids=["exact-fp-prompt", "exact-fp-oracle",
                                  "exact-int8-oracle", "bucketed-fp-oracle"])
def test_spec_engine_streams_and_counters_equal_jax(mode, kvq, oracle):
    """The speculative engine over tiled prompts, with the prompt-lookup
    proposer or an oracle that drafts the plain stream: streams equal the
    port's plain engine's and the JAX speculative engine's, with an EOS
    retiring some requests, and the spec counters (proposed, accepted,
    verify steps, probe steps, the committed-tokens histogram) equal
    JAX's on the same trace."""
    cfg_j = _models()[0]
    work = _tiled(cfg_j)
    kw = dict(n_slots=3, max_seq=48, prefill_mode=mode, kv_quant=kvq)
    plain, _ = _run(_port, work, **kw)
    counts = {}
    for toks, _ in plain.values():
        for t in toks[3:-2]:
            counts[t] = counts.get(t, 0) + 1
    eos = max(sorted(counts), key=lambda t: counts[t])
    plain, _ = _run(_port, work, eos=eos, **kw)
    assert {r for _, r in plain.values()} == {"eos", "length"}
    streams = {i: toks for i, (toks, _) in plain.items()}
    spec = dict(spec_decode=True, draft_k=8, **kw)
    got, eng = _run(_port, work, eos=eos,
                    proposer=_PortOracle(work, streams) if oracle else "prompt",
                    **spec)
    want, jeng = _run(_jax, work, eos=eos,
                      proposer=_JaxOracle(work, streams) if oracle else "prompt",
                      **spec)
    assert got == plain == want
    assert _counters(eng.stats) == _counters(jeng.stats)
    assert eng.stats.spec_steps > 0 and eng.stats.draft_proposed > 0
    if oracle:
        assert eng.stats.draft_accepted > 0
        assert any(n > 1 for n in eng.stats.spec_step_tokens_hist)
    summary = eng.stats.summary()
    assert summary["acceptance_rate"] == eng.stats.acceptance_rate
    for n_tok, c in eng.stats.spec_step_tokens_hist.items():
        assert summary[f"spec_step_tokens_{n_tok}"] == c
    assert eng.pool.used_blocks == 0


def test_spec_budget_exact_at_multi_token_boundary():
    """C6: with draft_k=7 (an 8-wide window) and budgets that are not
    multiples of 8, an oracle proposer gets drafts accepted and every
    request retires at EXACTLY its budget, reason "length", with the
    plain stream: a window crossing the budget is clamped, not committed
    and trimmed."""
    cfg_j = _models()[0]
    rng = np.random.default_rng(1)
    work = [(rng.integers(0, cfg_j.vocab_size, p).astype(np.int32), m)
            for p, m in ((3, 5), (9, 2), (5, 10), (7, 4), (4, 8), (6, 6),
                         (8, 3), (3, 9))]
    kw = dict(n_slots=3, max_seq=48)
    plain, _ = _run(_port, work, **kw)
    streams = {i: toks for i, (toks, _) in plain.items()}
    got, eng = _run(_port, work, spec_decode=True, draft_k=7,
                    proposer=_PortOracle(work, streams), **kw)
    assert got == plain
    for i, (_, m) in enumerate(work):
        assert len(got[i][0]) == m and got[i][1] == "length"
    assert eng.stats.draft_accepted > 0
    assert any(n > 1 for n in eng.stats.spec_step_tokens_hist)


def test_spec_deadline_retirement_is_row_local():
    """Deadline-retiring a slot mid-speculation does not perturb its
    neighbours: the doomed row retires with a prefix of its plain stream,
    the survivor and the late admission finish their budgets with theirs,
    and every page comes back."""
    cfg_j = _models()[0]
    rng = np.random.default_rng(1)
    work = [(rng.integers(0, cfg_j.vocab_size, p).astype(np.int32), m)
            for p, m in ((3, 24), (9, 12), (5, 10))]
    kw = dict(n_slots=2, max_seq=40, decode_chunk=1)
    plain, _ = _run(_port, work, **kw)
    streams = {i: toks for i, (toks, _) in plain.items()}
    now = [0.0]
    eng = _port(clock=lambda: now[0], spec_decode=True, draft_k=4,
                proposer=_PortOracle(work, streams), **kw)
    for i, (p, m) in enumerate(work):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=m,
                           deadline_s=4.5 if i == 0 else None))
    out = []
    for _ in range(200):
        out.extend(eng.step())
        now[0] += 1.0
        if eng.idle:
            break
    got = {c.rid: c for c in out}
    assert got[0].finish_reason == "deadline"
    assert 0 < len(got[0].tokens) < 24
    assert got[0].tokens == streams[0][:len(got[0].tokens)]
    for rid in (1, 2):
        assert got[rid].finish_reason == "length"
        assert got[rid].tokens == streams[rid]
    assert eng.stats.spec_steps > 0 and eng.pool.used_blocks == 0
