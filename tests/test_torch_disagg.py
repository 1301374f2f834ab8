"""Prefill/decode disaggregation and fleet prefix pulls in the port, held
against the JAX package and against the port's one-engine runs, on the
CPU (``tiny_config``, fp32, the JAX init's weights carried across).

Both packages build the same fleets of real tiny engines (bucketed
prefill, the prefix cache, pages of 4) under one fake clock:

* greedy disaggregated streams bit for bit the JAX fleet's and the
  port's one-engine streams, for fp and int8 pools, with
  ``fleet_summary`` equal to JAX's; sampled and ``n = 2`` streams;
* a :class:`MigrationPayload`'s arrays equal to JAX's, bit for bit
  (pages, int8 scales, the logits row), and the exported logits row
  fixed at park time whatever runs on the engine meanwhile;
* zero-copy tokens, cancel and deadline while parked, a kill of the
  decode and of the prefill replica mid-handoff, a lost ACK and its
  dedup, migration counters folded across a rolling restart, and a
  fleet prefix pull into a host tier: outcomes and summaries equal to
  JAX's, every pool leak-free after drain;
* ``serve(disagg=True)`` with a trace, a fault plan and the watchdog
  against the JAX ``serve()``, and the command line's checks.
"""

import copy
import functools
import json

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane import faults as jfaults
from kubeflow_controller_tpu.dataplane import router as jrouter
from kubeflow_controller_tpu.dataplane import sampling as jsamp
from kubeflow_controller_tpu.dataplane import serving_engine as jse
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane import faults as tfaults
from kubeflow_controller_tpu_torch.dataplane import router as trouter
from kubeflow_controller_tpu_torch.dataplane import sampling as tsamp
from kubeflow_controller_tpu_torch.dataplane import serving_engine as tse
from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm
from kubeflow_controller_tpu_torch.models import transformer as ttfm

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)


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


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(port, clock, kv_quant="", n_slots=2, **kw):
    cfg_j, cfg_t, params_j, params_t = _models()
    base = dict(n_slots=n_slots, max_seq=64, prefill_mode="bucketed",
                block_size=4, prefix_cache=True, kv_quant=kv_quant,
                clock=clock)
    base.update(kw)
    if port:
        return tse.ServingEngine(cfg_t, params_t, device="cpu", **base)
    return jse.ServingEngine(cfg_j, params_j, **base)


def _fleet(port, clock, n_decode=1, kv_quant="", decode_slots=2,
           injector=None, **router_kw):
    mod = trouter if port else jrouter
    r = mod.FleetRouter(clock=clock, block_size=4, injector=injector,
                        **router_kw)
    r.add_replica("prefill-0", _engine(port, clock, kv_quant,
                                       injector=injector), role="prefill")
    for i in range(n_decode):
        r.add_replica(f"decode-{i}",
                      _engine(port, clock, kv_quant, n_slots=decode_slots,
                              injector=injector), role="decode")
    return r


def _requests(port, n=6, shared=12, seed=3, max_new=5, params_fn=None):
    """One system prompt and per-request tails (the reference's shape)."""
    req = tse.Request if port else jse.Request
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, 256, shared)
    out = []
    for i in range(n):
        tail = rng.integers(0, 256, 1 + i % 3)
        out.append(req(rid=i, prompt=np.concatenate([sysp, tail]).astype(
            np.int32), max_new_tokens=max_new,
            params=params_fn(port, i) if params_fn else None))
    return out


def _pump(router, clock, steps=600, dt=0.05):
    for _ in range(steps):
        if router.idle:
            return
        clock.t += dt
        router.step()
    raise AssertionError(f"fleet not idle: {router.pending} pending")


def _tokens(router):
    return {(c.rid, c.gen): list(c.tokens) for c in router.completions
            if c.finish_reason in ("eos", "length")}


def _one_engine(port, reqs, kv_quant=""):
    eng = _engine(port, Clock(), kv_quant)
    return {(c.rid, c.gen): list(c.tokens)
            for c in eng.run([copy.deepcopy(r) for r in reqs])
            if c.finish_reason in ("eos", "length")}


def _leak_check(eng):
    """No slot occupied, every used page a trie page, no request pin."""
    assert all(s is None for s in eng.slots)
    trie = eng._prefix_store.trie
    assert eng.pool.used_blocks == trie.n_nodes()
    refs, stack = 0, list(trie.root.children.values())
    while stack:
        nd = stack.pop()
        refs += nd.refs
        stack.extend(nd.children.values())
    assert refs == 0


def _drain_and_leak_check(router):
    for h in router.replicas:
        h.engine.drain(grace_s=0.0)
        _leak_check(h.engine)


def _result(router):
    return (_tokens(router), router.outcome_counts, router.fleet_summary(),
            sorted((c.rid, c.gen, c.finish_reason) for c in router.completions))


# -- bit-exactness across the hop -------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["fp", "int8"])
def test_disagg_greedy_streams_equal_jax_and_one_engine(kv_quant):
    """Six shared-prefix requests through prefill-0 -> decode-0: the
    streams equal the port's one-engine run and the JAX fleet's, and
    the fleet's summaries (migrations, pages, bytes, zero-copy tokens,
    prefix hits) are equal."""
    results = []
    for port in (True, False):
        clock = Clock()
        router = _fleet(port, clock, kv_quant=kv_quant)
        for r in _requests(port):
            router.submit(r)
        _pump(router, clock)
        results.append(_result(router))
        p = router.get_replica("prefill-0").engine
        assert p.stats.submitted == (p.stats.finished + p.stats.rejected
                                     + p.stats.migrated_out)
        _drain_and_leak_check(router)
    got, want = results
    assert got == want
    assert got[0] == _one_engine(True, _requests(True), kv_quant)
    fs = got[2]
    assert fs["migrations"] == 6 and fs["pages_migrated"] > 0
    assert fs["migration_bytes"] > 0


def test_disagg_sampled_and_forked_streams():
    """Seeded sampling and an ``n = 2`` request cross the hop unchanged:
    the port's fleet equals its one-engine run and the JAX fleet."""
    def sp(port, i):
        samp = tsamp if port else jsamp
        if i == 2:
            return samp.SamplingParams(temperature=0.7, seed=42, n=2)
        return samp.SamplingParams(temperature=0.8, top_k=8, seed=100 + i)

    results = []
    for port in (True, False):
        clock = Clock()
        router = _fleet(port, clock)
        for r in _requests(port, n=4, params_fn=sp):
            router.submit(r)
        _pump(router, clock)
        results.append(_result(router))
        _drain_and_leak_check(router)
    assert results[0] == results[1]
    got = results[0][0]
    assert (2, 0) in got and (2, 1) in got
    assert got == _one_engine(True, _requests(True, n=4, params_fn=sp))


def _bits(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        t = t.numpy()
    t = np.asarray(t)
    return t.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[t.itemsize])


def _parked(port, kv_quant, prompt):
    eng = _engine(port, Clock(), kv_quant)
    req = tse.Request if port else jse.Request
    eng.submit(req(rid=5, prompt=prompt, max_new_tokens=7, eos_id=3,
                   prefill_only=True))
    for _ in range(20):
        eng.step()
        if eng.export_ready_rids():
            return eng
    raise AssertionError("never parked")


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["fp", "int8"])
def test_migration_payload_equals_jax(kv_quant):
    """A parked request's payload, whole and with its first 8 tokens
    skipped, against JAX's: every scalar field and the page offsets
    equal; the pages, scales and logits row in JAX's layout (``[L, m,
    bs, KVH(, D)]``) and within fp32 rounding of JAX's (the two prefills
    round the last bits of K and V differently; int8 codes within one
    step); and, with the port's pool set to JAX's bytes, the shipped
    pages and scales JAX's bit for bit (the gather takes the same pages
    in the same order, and int8 ships raw). The prefill-only slot
    reserved only its prompt's pages and its row stays inactive."""
    prompt = np.random.default_rng(8).integers(0, 256, 14).astype(np.int32)
    engines = [_parked(port, kv_quant, prompt) for port in (True, False)]
    t_eng, j_eng = engines
    assert t_eng.export_ready_rids() == j_eng.export_ready_rids() == [5]
    assert t_eng.pool.used_blocks == j_eng.pool.used_blocks == 4
    assert not bool(t_eng.cache.active.any())
    arrays = ("pages_k", "pages_v", "scales_k", "scales_v")
    for skip in (0, 8):
        got = t_eng.export_request(5, skip_tokens=skip)
        want = j_eng.export_request(5, skip_tokens=skip)
        for k in ("rid", "max_new_tokens", "eos_id", "page_starts",
                  "prompt_len", "skip_tokens", "block_size", "kv_quant",
                  "nbytes", "attempt", "submit_t", "admit_t", "deadline_t"):
            assert getattr(got, k) == getattr(want, k), k
        np.testing.assert_array_equal(got.prompt, want.prompt)
        for k in arrays + ("logits_row",):
            g, w = getattr(got, k), getattr(want, k)
            assert (g is None) == (w is None) == (
                k.startswith("scales") and not kv_quant), k
            if g is None:
                continue
            assert tuple(g.shape) == w.shape and g.dtype == getattr(
                torch, str(w.dtype)), k
            if g.dtype == torch.int8:
                assert np.abs(g.numpy().astype(np.int32)
                              - np.asarray(w, np.int32)).max() <= 1, k
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
        assert got.pages_k.shape[1] == 4 - skip // 4
        assert got.params.is_greedy
    assert t_eng.stats.migration_bytes == j_eng.stats.migration_bytes
    # The same pool bytes in, the same payload bytes out.
    for name in ("k", "v", "k_scale", "v_scale"):
        src = getattr(j_eng.cache, name)
        if src is not None:
            getattr(t_eng.cache, name).copy_(
                torch.from_numpy(np.asarray(jax.device_get(src))))
    for skip in (0, 4, 12):
        got = t_eng.export_request(5, skip_tokens=skip)
        want = j_eng.export_request(5, skip_tokens=skip)
        for k in arrays:
            g, w = getattr(got, k), getattr(want, k)
            if g is not None:
                np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)
    with pytest.raises(ValueError, match="not a block multiple"):
        t_eng.export_request(5, skip_tokens=3)
    with pytest.raises(KeyError, match="not export-ready"):
        t_eng.export_request(6)


def test_exported_logits_row_is_fixed_at_park_time():
    """Park a request, then run other traffic through the same engine
    (prefills into the other slots, decode chunks, a fork): the row it
    exports is the one it parked with, bit for bit, and lives in storage
    of its own, not a view of the engine's logits buffer."""
    prompt = np.random.default_rng(8).integers(0, 256, 14).astype(np.int32)
    eng = _engine(True, Clock(), n_slots=3)
    eng.submit(tse.Request(rid=5, prompt=prompt, max_new_tokens=7,
                           prefill_only=True))
    while not eng.export_ready_rids():
        eng.step()
    i = next(k for k, s in enumerate(eng.slots) if s is not None)
    at_park = eng.logits[i].clone()
    slot = eng.slots[i]
    assert (slot.export_logits.untyped_storage().data_ptr()
            != eng.logits.untyped_storage().data_ptr())
    rng = np.random.default_rng(1)
    eng.submit(tse.Request(rid=6, prompt=rng.integers(0, 256, 9),
                           max_new_tokens=6))
    eng.submit(tse.Request(rid=7, prompt=rng.integers(0, 256, 11),
                           max_new_tokens=4,
                           params=tsamp.SamplingParams(n=2)))
    done = []
    while len(done) < 3:
        done.extend(eng.step())
        # The engine's logits buffer takes writes in place, this row's
        # too (a reset of a parked slot's row would show here).
        eng.logits[i] = float("nan")
    assert torch.isnan(eng.logits[i]).all()
    payload = eng.export_request(5)
    assert torch.equal(payload.logits_row, at_park)
    assert eng.export_ready_rids() == [5]


def test_zero_copy_tokens_equal_jax():
    """The first migration of a 16-token prefix ships its pages and
    publishes them to the receiver's trie; the later ones match there
    and ship pointers: ``migrated_zero_copy_tokens`` > 0, equal to
    JAX's, and the exporter's books close without Completions."""
    results = []
    for port in (True, False):
        clock = Clock()
        router = _fleet(port, clock)
        for r in _requests(port, shared=16):
            router.submit(r)
        _pump(router, clock)
        results.append(_result(router))
        p = router.get_replica("prefill-0").engine
        d = router.get_replica("decode-0").engine
        assert p.stats.migrated_out == d.stats.migrated_in == 6
        assert p.stats.submitted == p.stats.migrated_out
        _drain_and_leak_check(router)
    assert results[0] == results[1]
    assert results[0][2]["migrated_zero_copy_tokens"] > 0


# -- handoff failures ---------------------------------------------------------------

def _park_then(port, action):
    """One prefill and one single-slot decode replica: rid 0 holds the
    decode slot for a long budget, rid 1 parks export-ready; then
    ``action(router, clock)`` and the fleet runs dry."""
    clock = Clock()
    router = _fleet(port, clock, decode_slots=1)
    reqs = _requests(port, n=3)
    reqs[0].max_new_tokens = 32
    reqs[1].deadline_s = 3.0
    for r in reqs:
        router.submit(r)
    p = router.get_replica("prefill-0").engine
    for _ in range(200):
        clock.t += 0.05
        router.step()
        if 1 in p.export_ready_rids():
            break
    else:
        raise AssertionError("rid 1 never parked export-ready")
    action(router, clock)
    _pump(router, clock)
    out = _result(router)
    _drain_and_leak_check(router)
    return out


def _cancel_1(router, clock):
    assert router.cancel(1)


def _expire_1(router, clock):
    clock.t += 10.0


def _kill(name):
    def action(router, clock):
        assert router.kill(name)
    return action


@pytest.mark.parametrize("action,reasons", [
    (_cancel_1, {0: "length", 1: "cancelled", 2: "length"}),
    (_expire_1, {0: "length", 1: "deadline", 2: "length"}),
    (_kill("prefill-0"), {0: "length", 1: "length", 2: "length"}),
], ids=["cancel", "deadline", "kill-prefill"])
def test_parked_request_outcomes_equal_jax(action, reasons):
    """While rid 1 waits parked for a decode slot: a cancel, its deadline
    passing, or a kill of the prefill replica (the fleet falls back to
    one stage). Every rid ends in one outcome, none is delivered twice, the
    outcomes and summaries equal JAX's, and no pool leaks."""
    got = _park_then(True, action)
    want = _park_then(False, action)
    assert got == want
    assert {rid: r for rid, _, r in got[3]} == reasons
    assert got[2]["duplicate_completions"] == 0
    assert got[2]["completed"] + got[2]["cancelled"] == 3


def test_kill_decode_mid_handoff_equals_jax():
    """One of two decode replicas dies with migrated requests decoding
    on it: they restart through prefill and migrate to the survivor;
    each rid ends once, and the outcomes equal JAX's."""
    results = []
    for port in (True, False):
        clock = Clock()
        router = _fleet(port, clock, n_decode=2)
        for r in _requests(port, max_new=8):
            router.submit(r)
        for _ in range(200):
            clock.t += 0.05
            router.step()
            if router.migrations >= 2:
                break
        victim = next(n for n in ("decode-0", "decode-1")
                      if n in router._assigned.values())
        assert router.kill(victim)
        _pump(router, clock)
        results.append(_result(router))
        _drain_and_leak_check(router)
    assert results[0] == results[1]
    fs = results[0][2]
    assert fs["completed"] == 6 and fs["redispatched"] > 0
    assert fs["duplicate_completions"] == 0
    assert results[0][0] == _one_engine(True, _requests(True, max_new=8))


def _lost_ack_plan(mod):
    return mod.FaultPlan.from_dict({"specs": [
        {"kind": "drop_migration", "site": "router.migrate", "rid": 1,
         "max_fires": 1},
        {"kind": "drop_migration", "site": "router.migrate_ack", "rid": 2,
         "max_fires": 1},
    ]})


def test_lost_payload_and_lost_ack_equal_jax():
    """A payload lost in flight re-sends next quantum; an install whose
    ACK was lost re-sends to the same receiver, which dedupes it: one
    ``migrate_dedups``, two ``migration_timeouts``, the one-engine
    streams, and JAX's summary."""
    results = []
    for port in (True, False):
        mod = tfaults if port else jfaults
        clock = Clock()
        inj = mod.FaultInjector(_lost_ack_plan(mod), clock=clock)
        router = _fleet(port, clock, n_decode=2, injector=inj)
        for r in _requests(port):
            router.submit(r)
        _pump(router, clock)
        results.append(_result(router) + (inj.summary(),))
        _drain_and_leak_check(router)
    assert results[0] == results[1]
    fs = results[0][2]
    assert fs["migrate_dedups"] == 1 and fs["migration_timeouts"] == 2
    assert fs["faults_injected"] == 0       # the router's fires, not engines'
    assert results[0][4]["faults_total"] == 2
    assert results[0][0] == _one_engine(True, _requests(True))


def test_rolling_restart_folds_migration_counters():
    results = []
    for port in (True, False):
        clock = Clock()
        router = _fleet(port, clock)
        for r in _requests(port, n=4):
            router.submit(r)
        _pump(router, clock)
        before = router.fleet_summary()
        router.rolling_restart(lambda name: _engine(port, clock), grace_s=1.0)
        after = router.fleet_summary()
        for key in ("pages_migrated", "migration_bytes",
                    "migrated_zero_copy_tokens", "samples_dropped",
                    "migrations"):
            assert after[key] == before[key], key
        assert before["pages_migrated"] > 0
        results.append(after)
        _drain_and_leak_check(router)
    assert results[0] == results[1]


# -- fleet prefix pulls ----------------------------------------------------------------

def _pull_fleet(port):
    """Two mixed replicas with host tiers serve a first wave sharing a
    20-token prefix; the owner is cordoned, so the second wave routes to
    the other replica, which pulls the prefix into its tier and
    rehydrates it at admission."""
    clock = Clock()
    mod = trouter if port else jrouter
    router = mod.FleetRouter(clock=clock, block_size=4)
    for name in ("m0", "m1"):
        router.add_replica(name, _engine(port, clock, host_kv_mb=1.0))
    reqs = _requests(port, n=6, shared=20)
    for r in reqs[:3]:
        router.submit(r)
    _pump(router, clock)
    owner = router._assigned.get(0) or next(iter(router._owners.values()))
    router.get_replica(owner).cordoned = True
    for r in reqs[3:]:
        router.submit(r)
    _pump(router, clock)
    return router, owner


def test_prefix_pull_into_the_tier_equals_jax():
    results = []
    for port in (True, False):
        router, owner = _pull_fleet(port)
        other = next(h for h in router.replicas if h.name != owner)
        assert other.engine.stats.rehydrate_hits > 0
        results.append(_result(router))
        _drain_and_leak_check(router)
    assert results[0] == results[1]
    fs = results[0][2]
    assert fs["prefix_pulls"] >= 1
    assert fs["prefix_pull_pages"] == 5          # the 20-token prefix
    assert fs["prefix_pull_bytes"] > 0
    assert results[0][0] == _one_engine(True, _requests(True, n=6, shared=20))


# -- serve() and the command line ---------------------------------------------------

@pytest.fixture
def _same_weights(monkeypatch):
    cfg_j = jtfm.tiny_config()
    master = jax.device_get(jtfm.init_params(cfg_j, jax.random.key(0)))
    monkeypatch.setattr(serve_lm, "_load_params", lambda *a, **k: (
        params_from_numpy(master, device="cpu"), None))


#: Summary keys of wall time (they differ run to run).
_TIMED = ("tokens_per_sec", "wall_s", "ttft_p50_ms", "ttft_p95_ms",
          "tpot_p50_ms", "tpot_p95_ms", "queue_wait_p50_ms",
          "queue_wait_p95_ms", "slot_utilization")


def test_serve_disagg_equals_jax_serve(_same_weights, tmp_path):
    """``serve(disagg=True, trace=..., fault_plan=..., fault_seed=...,
    watchdog_stale_s=...)`` writes the JAX ``serve()``'s completions and
    a loadable trace, and its summary has JAX's keys (but the jit-cache
    counts) with the same untimed values: the fleet counters, the spans
    and the fault ledger. The plan drops one payload in flight."""
    from kubeflow_controller_tpu.dataplane.entrypoints import serve_lm as jserve
    from kubeflow_controller_tpu_torch.obs.trace import load_chrome_trace

    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"specs": [
        {"kind": "drop_migration", "site": "router.migrate", "max_fires": 1}]}))
    common = dict(config="tiny", batch=4, slots=2, prompt_len=10,
                  max_new_tokens=5, block_size=4, disagg=True,
                  fault_plan=str(plan), fault_seed=3, watchdog_stale_s=30.0,
                  attn_impl="xla")
    files, res = [], []
    for name, serve, extra in (("jax", jserve.serve, {}),
                               ("port", serve_lm.serve, dict(device="cpu"))):
        out = tmp_path / f"{name}.jsonl"
        trace = tmp_path / f"{name}.trace.json"
        res.append(serve(output_file=str(out), trace=str(trace), **common,
                         **extra))
        files.append([json.loads(line) for line in out.read_text().splitlines()])
        doc = load_chrome_trace(str(trace))
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] != "M"}
        assert {"migrate_export", "migrate_install", "migrate",
                "migrate_timeout", "fault_injected"} <= names
    assert files[0] == files[1] and len(files[1]) == 4
    want, got = res
    assert set(got) == set(want) - {"prefill_compiles", "admit_cache_size"}
    for k in set(got) - set(_TIMED) - {"heartbeat"}:
        assert got[k] == want[k], k
    assert got["migrations"] == 4 and got["migration_timeouts"] == 1
    assert got["faults_total"] == 1 and got["spans_dropped"] == 0
    assert got["faults.router.migrate.drop_migration"] == 1


def test_cli_disagg_flags_and_their_errors(tmp_path, capsys):
    """The command line serves ``--disagg --trace --fault-plan
    --fault-seed --watchdog-stale-s`` (the one-engine completions, a
    trace file), and refuses as the JAX parser does: a negative or
    engine-path watchdog, a plan under ``--turns``, a malformed plan."""
    base = ["--config", "tiny", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "9", "--max-new-tokens", "4",
            "--block-size", "4"]
    one = tmp_path / "one.jsonl"
    assert serve_lm.main(base + ["--prefix-cache", "--output", str(one)]) == 0
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"specs": [{"kind": "hang", "site": "engine.step",
                                           "target": "decode-0",
                                           "max_fires": 2}]}))
    out, trace = tmp_path / "d.jsonl", tmp_path / "t.json"
    assert serve_lm.main(base + [
        "--disagg", "--trace", str(trace), "--fault-plan", str(plan),
        "--fault-seed", "2", "--watchdog-stale-s", "30", "--output",
        str(out)]) == 0
    assert out.read_text() == one.read_text()
    assert json.loads(trace.read_text())["otherData"]["spans_recorded"] > 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"specs": [{"kind": "meltdown"}]}))
    for flags, msg in ((["--watchdog-stale-s", "-1"], "must be >= 0"),
                       (["--watchdog-stale-s", "1"], "requires --disagg"),
                       (["--fault-plan", str(plan), "--turns", "2"],
                        "continuous-batching"),
                       (["--fault-plan", str(bad)], "fault kind")):
        with pytest.raises(SystemExit) as e:
            serve_lm.main(base + flags)
        assert e.value.code == 2
        assert msg in capsys.readouterr().err
    for kw, msg in ((dict(disagg=True, turns=2), "single-turn"),
                    (dict(disagg=True, paged=False), "paged block pool"),
                    (dict(watchdog_stale_s=1.0), "requires --disagg")):
        with pytest.raises(ValueError, match=msg):
            serve_lm.serve(config="tiny", batch=1, prompt_len=4,
                           device="cpu", **kw)
    # The fleet serves over a tp gang (tests/test_torch_tp_serving.py):
    # one process is no gang of two ranks, and the serving mesh says so.
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        serve_lm.serve(config="tiny", tp=2, disagg=True, device="cpu")
