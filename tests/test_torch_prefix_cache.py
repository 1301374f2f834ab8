"""The port's prefix cache and host tier in the serving engine, held
against the JAX engine on the CPU (``tiny_config``, fp32, the JAX init's
weights carried across as numpy arrays).

Mirrors ``tests/test_kv_blocks.py``'s and ``tests/test_kv_tier.py``'s
engine tests, each run through both engines on the same requests:

* streams with the cache on equal the cache-off streams and the JAX
  engine's, under slot churn and under eviction pressure in a 14-page
  pool; the ``prefix_*`` counters equal JAX's;
* tier on vs off on a workload whose prefixes overflow the pool (spills
  and rehydrates both happen): greedy, seeded sampled (with ``n = 2``
  forks among them) and int8 KV; ``spilled_pages``, ``rehydrate_hits``,
  ``rehydrate_tokens`` and the zero-copy count equal JAX's;
* ``register_prefix`` of a ``generate_from_cache`` session, ``reset``,
  cancel / deadline / drain releasing every pin on both tiers (owner
  sets on), the radix proposer's speculation, and ``serve(turns=3)``
  with and without the cache against the JAX ``serve()``.

The JAX engine runs its default ``attn_impl="xla"``; the port runs
``"kernel"`` (on CPU tensors, the kernels' plain versions).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane import sampling as jsamp
from kubeflow_controller_tpu.dataplane.serving_engine import (
    Request as JRequest, ServingEngine as JEngine,
)
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane import sampling as tsamp
from kubeflow_controller_tpu_torch.dataplane import spec_decode as tspec
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import generate as tgen
from kubeflow_controller_tpu_torch.models import transformer as ttfm

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

COUNTERS = ("prefix_hit_tokens", "prefix_zero_copy_tokens",
            "prefix_lookup_tokens", "spilled_pages", "spill_bytes",
            "rehydrate_hits", "rehydrate_tokens", "host_pages_resident",
            "prefill_chunks", "pool_blocks_in_use", "pool_blocks_total")


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


def _engine(port, **kw):
    cfg_j, cfg_t, params_j, params_t = _models()
    if port:
        return ServingEngine(cfg_t, params_t, device="cpu", **kw)
    return JEngine(cfg_j, params_j, **kw)


def _run(port, reqs, **kw):
    eng = _engine(port, **kw)
    comps = eng.run(list(reqs))
    return {(c.rid, c.gen): list(c.tokens) for c in comps}, eng


def _counters(eng):
    return {k: getattr(eng.stats, k) for k in COUNTERS}


def _shared_prefix_requests(port, n, shared_len=12, tail_max=5, seed=3,
                            max_new=5):
    """One system prompt, per-request tails (the reference's shape)."""
    req = Request if port else JRequest
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, shared_len)
    return [req(rid=i,
                prompt=np.concatenate(
                    [shared, rng.integers(0, 256, 1 + i % tail_max)]
                ).astype(np.int32),
                max_new_tokens=max_new + i % 3) for i in range(n)]


def _sp(port, rid, n=1):
    samp = tsamp if port else jsamp
    return samp.SamplingParams(temperature=0.9, top_k=8, top_p=0.9,
                               seed=100 + rid, n=n)


def _cycling_requests(port, families=4, waves=3, params=None):
    """Prefixes revisited across waves through a pool that cannot hold
    them (the reference's tier workload)."""
    req = Request if port else JRequest
    rng = np.random.default_rng(3)
    fams = [rng.integers(0, 256, 16) for _ in range(families)]
    r2 = np.random.default_rng(7)
    out, rid = [], 0
    for _ in range(waves):
        for f in fams:
            tail = r2.integers(0, 256, 1 + rid % 4)
            out.append(req(rid=rid,
                           prompt=np.concatenate([f, tail]).astype(np.int32),
                           max_new_tokens=4,
                           params=None if params is None else params(port, rid)))
            rid += 1
    return out


_BUCKETED = dict(n_slots=3, max_seq=32, prefill_mode="bucketed", block_size=4)
_TIER_KW = dict(n_slots=2, max_seq=32, prefill_mode="bucketed",
                block_size=4, prefix_cache=True, kv_pool_blocks=12)


def _no_leaked_pins(eng):
    """Every trie node carries no request pin, resident pages only the
    trie's hold; spilled nodes hold no page and each live tier entry
    belongs to one node."""
    store, tier = eng._prefix_store, eng._host_tier
    stack = list(store.trie.root.children.values())
    n_res, handles = 0, []
    while stack:
        n = stack.pop()
        assert n.refs == 0, "request pin leaked past retirement"
        if n.block >= 0:
            n_res += 1
            assert n.host_handle is None
            assert store.pool.refcount(n.block) == 1
        elif tier is not None and tier.has(n.host_handle):
            handles.append(n.host_handle)
        stack.extend(n.children.values())
    assert store.pool.used_blocks == n_res
    if tier is not None:
        assert len(handles) == len(set(handles)) == tier.resident_pages


# -- the cache in the engine ------------------------------------------------------

@pytest.mark.parametrize("pool", [None, 14], ids=["churn", "pool14"])
def test_prefix_cache_streams_equal_cache_off_and_jax(pool):
    """8 shared-prefix requests over 3 slots: the cache-on streams equal
    the cache-off streams and the JAX engine's, and the counters are
    JAX's. In a 14-page pool (live reservations fit, the trie's tenancy
    does not) eviction runs and some admissions requeue; every tenancy
    unwinds once."""
    off, _ = _run(True, _shared_prefix_requests(True, 8), **_BUCKETED)
    kw = dict(_BUCKETED, prefix_cache=True)
    if pool:
        kw["kv_pool_blocks"] = pool
    on, eng = _run(True, _shared_prefix_requests(True, 8), **kw)
    ref, jeng = _run(False, _shared_prefix_requests(False, 8), **kw)
    assert on == off == ref
    assert _counters(eng) == _counters(jeng)
    assert eng.stats.prefix_hit_tokens > 0
    assert 0.0 < eng.stats.prefix_hit_rate < 1.0
    summary = eng.stats.summary()
    assert summary["prefix_hit_rate"] == eng.stats.prefix_hit_rate
    if pool:
        assert eng.stats.pool_blocks_total == 14
    _no_leaked_pins(eng)


TIER_CASES = {
    "greedy": dict(),
    "sampled": dict(params=lambda port, rid: _sp(port, rid)),
    "int8": dict(kv_quant="int8"),
    "sampled_n2": dict(params=lambda port, rid: _sp(port, rid,
                                                    n=2 if rid % 3 == 0 else 1)),
}


@functools.lru_cache(None)
def _tier_off(case):
    kw = dict(TIER_CASES[case])
    params = kw.pop("params", None)
    return _run(True, _cycling_requests(True, params=params), **_TIER_KW, **kw)


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_tier_on_vs_off_equal_and_counters_equal_jax(case, monkeypatch):
    """The cycling workload (4 families of 16-token prefixes, 3 waves,
    a 12-page pool) with the tier off and on: the streams are the same
    (pages come back bit for bit), and equal the JAX tier-on engine's,
    with its spill and rehydrate counts; rehydrated tokens are not
    counted zero-copy. Owner sets on: every release comes from a holder."""
    monkeypatch.setenv("TPUJOB_KV_DEBUG_OWNERS", "1")
    kw = dict(TIER_CASES[case])
    params = kw.pop("params", None)
    off, _ = _tier_off(case)
    on, eng = _run(True, _cycling_requests(True, params=params),
                   host_kv_mb=64.0, **_TIER_KW, **kw)
    ref, jeng = _run(False, _cycling_requests(False, params=params),
                     host_kv_mb=64.0, **_TIER_KW, **kw)
    assert eng.pool.debug_owners
    assert on == off == ref
    assert _counters(eng) == _counters(jeng)
    assert eng.stats.spilled_pages > 0 and eng.stats.rehydrate_hits > 0
    assert eng.stats.rehydrate_tokens > 0 and eng.stats.spill_bytes > 0
    assert (eng.stats.prefix_zero_copy_tokens
            <= eng.stats.prefix_hit_tokens - eng.stats.rehydrate_tokens)
    entry = next(iter(eng._host_tier._pages.values()))
    assert (eng._host_tier.payload_nbytes(entry)
            == tgen.pool_page_host_bytes(eng.cache))
    if case == "sampled_n2":
        assert eng.stats.cow_page_copies > 0
    _no_leaked_pins(eng)


def test_host_kv_mb_zero_builds_no_tier_and_args_checked_as_jax():
    """``host_kv_mb=0`` builds no tier and serves the tier-off engine's
    streams and pool trajectory; the JAX engine's argument checks."""
    base, eng0 = _tier_off("greedy")
    zero, engz = _run(True, _cycling_requests(True), host_kv_mb=0.0, **_TIER_KW)
    assert zero == base and engz._host_tier is None
    assert engz.stats.spilled_pages == 0 and engz.stats.host_pages_resident == 0
    assert engz.stats.pool_blocks_in_use == eng0.stats.pool_blocks_in_use
    for port in (True, False):
        with pytest.raises(ValueError, match="prefix_cache"):
            _engine(port, prefill_mode="bucketed", block_size=4,
                    host_kv_mb=16.0)
        with pytest.raises(ValueError, match=">= 0"):
            _engine(port, prefill_mode="bucketed", block_size=4,
                    prefix_cache=True, host_kv_mb=-1.0)
        with pytest.raises(ValueError, match="prefix_cache requires"):
            _engine(port, prefix_cache=True)
        with pytest.raises(ValueError, match="requires prefix_cache"):
            _engine(port, spec_decode=True, proposer="radix")
        eng = _engine(port, n_slots=3, max_seq=32, prefill_mode="bucketed",
                      block_size=4, prefix_cache=True)
        assert eng.pool.n_blocks == 2 * 3 * 8


def test_register_prefix_multiturn_session_equals_jax():
    """A ``generate_from_cache(return_state=True)`` session registered in
    the engine: every full block registers, turn 2 (session + follow-up)
    hits every full block but the tail's, and streams what a cold
    cache-off engine streams, as in the JAX engine."""
    cfg_j, cfg_t, params_j, params_t = _models()
    max_seq, bs = 64, 4
    prompt = np.random.default_rng(9).integers(0, 256, 12).astype(np.int32)
    follow = np.random.default_rng(10).integers(0, 256, 6).astype(np.int32)
    cj = jgen.init_kv_cache(cfg_j, 1, max_seq)
    lj, cj = jgen.prefill(cfg_j, params_j, jnp.asarray(prompt[None]), cj)
    tj, lj, cj = jgen.generate_from_cache(cfg_j, params_j, lj, cj, 8,
                                          return_state=True)
    ct = tgen.init_kv_cache(cfg_t, 1, max_seq, device="cpu")
    lt, ct = tgen.prefill(cfg_t, params_t, torch.from_numpy(prompt[None]), ct)
    tt, lt, ct = tgen.generate_from_cache(cfg_t, params_t, lt, ct, 8,
                                          return_state=True)
    assert tt.tolist() == np.asarray(tj).tolist()
    session = np.concatenate([prompt, tt[0].numpy().astype(np.int32)])
    kw = dict(n_slots=2, max_seq=max_seq, prefill_mode="bucketed",
              block_size=bs)
    got = {}
    for port, cache in ((True, ct), (False, cj)):
        eng = _engine(port, prefix_cache=True, **kw)
        assert eng.register_prefix(session, cache, row=0) == 20
        req = (Request if port else JRequest)(
            rid=0, prompt=np.concatenate([session, follow]), max_new_tokens=6)
        got[port] = ({c.rid: list(c.tokens) for c in eng.run([req])},
                     eng.stats.prefix_hit_tokens)
    cold, _ = _run(True, [Request(rid=0, prompt=np.concatenate([session, follow]),
                                  max_new_tokens=6)], **kw)
    assert got[True] == got[False]
    assert got[True][0] == {0: cold[(0, 0)]}
    assert got[True][1] == 20 >= 20 - bs
    assert _engine(True, **kw).register_prefix(session, ct) == 0
    with pytest.raises(ValueError, match="exceed cache capacity"):
        _engine(True, prefix_cache=True, **kw).register_prefix(
            np.zeros(max_seq + 1, np.int32), ct)


def test_reset_rebuilds_both_tiers_and_serves_the_same():
    """``reset()`` empties both tiers, rewires the store in place (the
    radix proposer keeps its store), and the engine then serves the
    tier-off streams again."""
    eng = _engine(True, host_kv_mb=64.0, spec_decode=True, proposer="radix",
                  **_TIER_KW)
    store = eng._prefix_store
    eng.run(_cycling_requests(True, waves=2))
    assert eng._host_tier.resident_pages > 0 and eng.pool.used_blocks > 0
    eng.reset()
    assert eng._host_tier.resident_pages == 0 and eng.pool.used_blocks == 0
    assert eng._prefix_store is store and eng._proposer.store is store
    assert store.tier is eng._host_tier and store.trie.tier is eng._host_tier
    assert store.pool is eng.pool and eng.stats.submitted == 0
    on = {(c.rid, c.gen): list(c.tokens)
          for c in eng.run(_cycling_requests(True))}
    assert on == _tier_off("greedy")[0]


@pytest.mark.parametrize("tier", [0.0, 64.0], ids=["no_tier", "tier"])
def test_cancel_deadline_drain_release_pins_on_both_tiers(tier, monkeypatch):
    """Cycling prefix pressure with a cancel in flight, one queued, a
    deadline and a forced drain, in both engines on the same clock: the
    same completions; no retirement path leaks a pin on either tier;
    evicting everything then clearing leaves both tiers empty."""
    monkeypatch.setenv("TPUJOB_KV_DEBUG_OWNERS", "1")
    out = {}
    for port in (True, False):
        clock_t = [0.0]
        eng = _engine(port, clock=lambda: clock_t[0], host_kv_mb=tier,
                      **_TIER_KW)
        reqs = _cycling_requests(port)
        reqs[5].deadline_s = 0.5
        for r in reqs:
            eng.submit(r)
        comps = []
        for _ in range(12):
            clock_t[0] += 0.01
            comps.extend(eng.step())
        eng.cancel(7)
        eng.cancel(11)
        for _ in range(3):
            clock_t[0] += 0.01
            comps.extend(eng.step())
        clock_t[0] += 2.0
        comps.extend(eng.step())
        comps.extend(eng.drain(grace_s=0.0))
        assert {c.rid for c in comps} == {r.rid for r in reqs}
        out[port] = (sorted((c.rid, c.finish_reason, tuple(c.tokens))
                            for c in comps), _counters(eng))
        if port:
            _no_leaked_pins(eng)
            reasons = {c.finish_reason for c in comps}
            assert "cancelled" in reasons
            assert reasons <= {"cancelled", "deadline", "shed", "length"}
            trie = eng._prefix_store.trie
            while trie.evict_chain(8, spill=eng._spill_cb()):
                pass
            assert eng.pool.used_blocks == 0
            eng._prefix_store.clear()
            if tier:
                assert eng.stats.spilled_pages > 0
                assert eng._prefix_store.tier.resident_pages == 0
    assert out[True] == out[False]


def test_radix_speculation_streams_and_counters_equal_jax():
    """Prefix cache on, ``proposer="radix"``, ``draft_k=4``: 6 requests,
    then the same prompts under new rids, so the second wave drafts the
    first wave's replies from the trie. Streams equal the plain engine's
    and the JAX engine's; drafts, accepts and verify steps are JAX's."""
    def reqs(port):
        req = Request if port else JRequest
        rng = np.random.default_rng(31)
        prompts = [rng.integers(0, 256, 9 + i).astype(np.int32)
                   for i in range(6)]
        return [req(rid=w * 6 + i, prompt=p, max_new_tokens=12)
                for w in range(2) for i, p in enumerate(prompts)]

    kw = dict(n_slots=3, max_seq=32, prefill_mode="bucketed", block_size=4,
              prefix_cache=True)
    spec = dict(spec_decode=True, draft_k=4, proposer="radix")
    plain, _ = _run(True, reqs(True), **kw)
    got, eng = _run(True, reqs(True), **kw, **spec)
    ref, jeng = _run(False, reqs(False), **kw, **spec)
    assert got == plain == ref
    assert isinstance(eng._proposer, tspec.RadixProposer)
    for k in ("draft_proposed", "draft_accepted", "spec_steps",
              "spec_probe_steps", "prefix_hit_tokens"):
        assert getattr(eng.stats, k) == getattr(jeng.stats, k), k
    assert eng.stats.draft_accepted > 0


# -- serve() ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(turns=3, prefix_cache=True),
    dict(turns=3, prefix_cache=True, host_kv_mb=1.0, kv_pool_mb=0.05),
    dict(turns=3),
    dict(turns=2, temperature=0.8, seed=3),
    dict(prefix_cache=True, speculative=True, proposer="radix"),
], ids=["turns3-cache", "turns3-tier", "turns3-contiguous",
        "turns2-contiguous-sampled", "radix"])
def test_serve_writes_the_jax_serve_completions(kw, tmp_path, monkeypatch):
    """serve() with the prefix cache, the tier, ``turns`` with and
    without the cache and the radix proposer writes the completions file
    the JAX serve() writes on the same weights, with its prefix
    counters."""
    from kubeflow_controller_tpu.dataplane.entrypoints import serve_lm as jserve
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import (
        serve_lm as tserve,
    )
    cfg_j = jtfm.tiny_config()
    params_t = params_from_numpy(jax.device_get(
        jtfm.init_params(cfg_j, jax.random.key(0))), device="cpu")
    monkeypatch.setattr(tserve, "_load_params",
                        lambda *a, **k: (params_t, None))
    common = dict(config="tiny", batch=3, prompt_len=9, max_new_tokens=5,
                  slots=2, block_size=4, **kw)
    files, res = [], []
    for name, serve, extra in (("jax", jserve.serve, {}),
                               ("port", tserve.serve, dict(device="cpu"))):
        out = tmp_path / f"{name}.jsonl"
        res.append(serve(output_file=str(out), **common, **extra))
        files.append([json.loads(line) for line in out.read_text().splitlines()])
    assert files[0] == files[1]
    assert len(files[1]) == 3
    assert all(len(r["completion"]) == 5 * kw.get("turns", 1) for r in files[1])
    for k in ("prefix_hit_tokens", "prefix_hit_rate", "spilled_pages",
              "rehydrate_hits", "draft_accepted", "requests"):
        assert res[0].get(k) == res[1].get(k), k
    if kw.get("prefix_cache") and kw.get("turns"):
        assert res[1]["prefix_hit_rate"] > 0


def test_serve_and_cli_check_the_cache_flags_as_jax(tmp_path):
    """The reference's checks: ``host_kv_mb`` negative or without the
    cache, top-k/top-p on the contiguous multi-turn path (ValueError in
    serve(), usage and exit 2 on the command line); the CLI serves
    ``--turns``, ``--prefix-cache``, ``--host-kv-mb`` and ``--proposer
    radix``."""
    from kubeflow_controller_tpu_torch.dataplane.entrypoints import (
        serve_lm as tserve,
    )
    base = dict(config="tiny", batch=1, prompt_len=5, max_new_tokens=2,
                block_size=4, device="cpu")
    for kw, msg in ((dict(host_kv_mb=-1.0), ">= 0"),
                    (dict(host_kv_mb=1.0), "requires --prefix-cache"),
                    (dict(turns=2, top_k=3), "temperature only"),
                    (dict(turns=2, top_p=0.5), "temperature only")):
        with pytest.raises(ValueError, match=msg):
            tserve.serve(**base, **kw)
    argv = ["--config", "tiny", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--max-new-tokens", "2", "--block-size", "4",
            "--output", str(tmp_path / "o.jsonl")]
    for flag in (["--host-kv-mb", "-1"], ["--host-kv-mb", "1"]):
        with pytest.raises(SystemExit) as e:
            tserve.main(argv + flag)
        assert e.value.code == 2
    for flag in (["--turns", "2"], ["--turns", "2", "--prefix-cache"],
                 ["--prefix-cache", "--host-kv-mb", "1"],
                 ["--prefix-cache", "--speculative", "--proposer", "radix"]):
        assert tserve.main(argv + flag) == 0, flag
        rows = (tmp_path / "o.jsonl").read_text().splitlines()
        turns = int(flag[1]) if flag[0] == "--turns" else 1
        assert all(len(json.loads(r)["completion"]) == 2 * turns for r in rows)
