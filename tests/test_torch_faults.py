"""The port's fault injection (``dataplane/faults.py``) held against the
JAX package's on the CPU: plan validation and its messages, the JSON
round trip, the injector's fire schedule on one driven clock (windows,
rid and target scopes, ``max_fires``, seeded ``prob`` thinning, kind
filters), its ledger, and the sites the engine and the host tier
instrument: ``tier.read``, ``engine.submit``, ``engine.step`` (hang and
slow) and ``engine.admit_migrated``.
"""

import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane import faults as jfaults
from kubeflow_controller_tpu.dataplane import kv_blocks as jkv
from kubeflow_controller_tpu.dataplane.serving_engine import (
    Rejected as JRejected, Request as JRequest, ServingEngine as JEngine,
)
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane import faults as tfaults
from kubeflow_controller_tpu_torch.dataplane import kv_blocks as tkv
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Rejected, Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import transformer as ttfm

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


def test_registries_equal_jax():
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.PLANES == jfaults.PLANES
    assert tfaults.SITES == jfaults.SITES
    assert "informer.deliver" in tfaults.SITES


@pytest.mark.parametrize("spec", [
    dict(kind="meltdown"), dict(kind="hang", plane="disk"),
    dict(kind="hang", site="engine.stpe"), dict(kind="slow", prob=1.5),
    dict(kind="slow", prob=-0.1), dict(kind="slow", factor=0.5),
    dict(kind="hang", after=5.0, until=1.0),
], ids=["kind", "plane", "site", "prob-high", "prob-low", "factor", "window"])
def test_spec_validation_messages_equal_jax(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultSpec(**spec)
    with pytest.raises(ValueError) as got:
        tfaults.FaultSpec(**spec)
    assert str(got.value) == str(want.value)


_PLAN = {"specs": [
    {"kind": "crash", "site": "router.replica_step", "target": "decode-1",
     "after": 1.0, "until": 3.0, "max_fires": 1},
    {"kind": "hang", "plane": "engine", "site": "engine.step",
     "target": "decode-0", "after": 0.5, "until": 2.0},
    {"kind": "slow", "site": "engine.step", "factor": 3.0, "prob": 0.5},
    {"kind": "drop_migration", "site": "router.migrate", "rid": 7,
     "max_fires": 2},
    {"kind": "drop_migration", "site": "router.migrate_ack", "prob": 0.3},
    {"kind": "tier_io_error", "plane": "tier", "prob": 0.4,
     "max_fires": 5},
    {"kind": "refuse_admit", "site": "*", "target": "prefill-0",
     "prob": 0.25},
    {"kind": "hang", "site": "router.dispatch", "prob": 0.2},
]}


def test_plan_json_round_trip_equals_jax(tmp_path):
    """A plan loaded from its JSON file gives JAX's ``to_dict`` (infinite
    windows left out) and survives a round trip. A bare list of specs
    fails in both alike (``from_dict`` reads ``d.get`` before its list
    branch): the port keeps the reference's behaviour."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(_PLAN))
    got, want = tfaults.load_plan(str(path)), jfaults.load_plan(str(path))
    assert got.to_dict() == want.to_dict()
    assert tfaults.FaultPlan.from_dict(got.to_dict()).to_dict() == got.to_dict()
    assert "until" not in got.to_dict()["specs"][2]
    assert math.isinf(got.specs[2].until)
    for mod in (tfaults, jfaults):
        with pytest.raises(AttributeError):
            mod.FaultPlan.from_dict(_PLAN["specs"])


_CHECKS = [
    ("router", "router.replica_step", "decode-1", None, ("crash",)),
    ("engine", "engine.step", "decode-0", None, ("hang", "slow")),
    ("engine", "engine.step", "prefill-0", None, ("hang", "slow")),
    ("router", "router.migrate", "prefill-0", 7, ("drop_migration",)),
    ("router", "router.migrate", "prefill-0", 8, ("drop_migration",)),
    ("router", "router.migrate_ack", "decode-0", 3, ("drop_migration",)),
    ("tier", "tier.read", "decode-0", None, ("tier_io_error",)),
    ("engine", "engine.submit", "prefill-0", 5, ("refuse_admit",)),
    ("engine", "engine.admit_migrated", "decode-0", 5, ("refuse_admit",)),
    ("router", "router.dispatch", "decode-1", 9, ("hang",)),
    ("router", "router.dispatch", "decode-1", 9, None),
]


@pytest.mark.parametrize("seed", [0, 11])
def test_fire_schedule_equals_jax(seed):
    """400 checks over every site, on one clock stepped by 0.01 s: both
    injectors fire the same spec at the same checks, and their ledgers
    (``total_fires``, ``fired``, ``summary``) are equal."""
    clocks = {"t": 0.0}
    clock = lambda: clocks["t"]                     # noqa: E731
    injectors = [mod.FaultInjector(mod.FaultPlan.from_dict(_PLAN),
                                   clock=clock, seed=seed)
                 for mod in (tfaults, jfaults)]
    got, want = [], []
    for k in range(400):
        clocks["t"] = 0.01 * k
        plane, site, target, rid, kinds = _CHECKS[k % len(_CHECKS)]
        for inj, out in zip(injectors, (got, want)):
            spec = inj.fires(plane, site, target=target, rid=rid, kinds=kinds)
            out.append(None if spec is None else spec.kind)
    assert got == want
    assert sum(x is not None for x in got) > 50
    assert {x for x in got if x} >= {"crash", "hang", "slow", "drop_migration"}
    t, j = injectors
    assert t.total_fires == j.total_fires
    assert t.fired == j.fired
    assert t.summary() == j.summary()


def test_fires_trace_an_event_and_an_empty_plan_matches_nothing():
    from kubeflow_controller_tpu_torch.obs.trace import Tracer

    tr = Tracer()
    inj = tfaults.FaultInjector(
        tfaults.FaultPlan([tfaults.FaultSpec(kind="hang",
                                             site="router.dispatch")]),
        clock=lambda: 2.5, tracer=tr)
    assert inj.fires("router", "router.dispatch", target="a", rid=4).kind == "hang"
    (ev,) = tr.snapshot()
    assert (ev.name, ev.track, ev.rid, ev.t0) == ("fault_injected", "router",
                                                  "4", 2.5)
    assert dict(ev.attrs) == {"site": "router.dispatch", "kind": "hang",
                              "target": "a"}
    empty = tfaults.FaultInjector()
    assert all(empty.fires(p, s) is None for p, s, *_ in _CHECKS)
    assert empty.summary() == {"faults_total": 0.0}


# -- tier.read ----------------------------------------------------------------------

def _np_page(i, nbytes=16):
    k = np.full((1, 1, 1, 1, nbytes // 4), i, np.float32)
    return (k, None, None, None)


def _t_page(i, nbytes=16):
    k = torch.full((1, 1, 1, 1, nbytes // 4), float(i), dtype=torch.float32)
    return (k, None, None, None)


def test_tier_read_faults_equal_jax():
    """Both tiers under one ``tier_io_error`` plan (prob 0.5, on one
    target): each ``has`` and ``pop`` answers the same, a failed read
    drops its entry (no leak), and ``io_errors`` and the residency
    agree; the other target's reads never fail."""
    plan = {"specs": [{"kind": "tier_io_error", "site": "tier.read",
                       "target": "r0", "prob": 0.5}]}
    tiers = []
    for mod, kv, page in ((tfaults, tkv, _t_page), (jfaults, jkv, _np_page)):
        inj = mod.FaultInjector(mod.FaultPlan.from_dict(plan), seed=3)
        tier = kv.HostKVTier(16 * 40, injector=inj, target="r0")
        tiers.append((tier, [tier.put(page(i)) for i in range(40)]))
    (t, th), (j, jh) = tiers
    assert th == jh
    got, want = [], []
    for k, h in enumerate(th):
        if k % 2:
            got.append(t.has(h))
            want.append(j.has(h))
        else:
            p, q = t.pop(h), j.pop(h)
            got.append(None if p is None else float(p[0].flatten()[0]))
            want.append(None if q is None else float(q[0].flatten()[0]))
    assert got == want
    assert None in got and False in got
    assert t.io_errors == j.io_errors > 0
    assert t.resident_pages == j.resident_pages
    assert t.resident_bytes == j.resident_bytes
    other = tkv.HostKVTier(64, injector=t.injector, target="r1")
    h = other.put(_t_page(1))
    assert other.has(h) and other.pop(h) is not None


# -- the engine's sites ------------------------------------------------------------

@functools.lru_cache(None)
def _models():
    cfg_j = jtfm.tiny_config()
    cfg_t = ttfm.tiny_config()
    params_j = jgen.inference_params(
        cfg_j, jtfm.init_params(cfg_j, jax.random.key(0)))
    params_t = params_from_numpy(jax.device_get(params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _engine(port, plan, clock, **kw):
    cfg_j, cfg_t, params_j, params_t = _models()
    mod = tfaults if port else jfaults
    inj = mod.FaultInjector(mod.FaultPlan.from_dict(plan), clock=clock,
                            seed=1)
    base = dict(n_slots=2, max_seq=32, block_size=4, prefill_mode="bucketed",
                injector=inj, clock=clock)
    base.update(kw)
    if port:
        eng = ServingEngine(cfg_t, params_t, device="cpu", **base)
    else:
        eng = JEngine(cfg_j, params_j, **base)
    eng.fault_target = "r0"
    return eng


def test_engine_submit_and_step_faults_equal_jax():
    """``refuse_admit`` at ``engine.submit`` rejects the same rids with
    the typed reason; a ``hang`` window at ``engine.step`` returns empty
    quanta and freezes the heartbeat; ``slow`` lets one quantum in
    ``factor`` through. Streams, heartbeats, ``faults_injected`` and the
    rejections equal the JAX engine's step by step."""
    plan = {"specs": [
        {"kind": "refuse_admit", "site": "engine.submit", "rid": 2},
        {"kind": "refuse_admit", "site": "engine.submit", "rid": 4},
        {"kind": "hang", "site": "engine.step", "after": 1.0, "until": 2.0},
        {"kind": "slow", "site": "engine.step", "after": 3.0, "until": 4.0,
         "factor": 2.0},
    ]}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, 6 + i).astype(np.int32) for i in range(6)]
    runs = []
    for port in (True, False):
        clock_t = {"t": 0.0}
        eng = _engine(port, plan, lambda: clock_t["t"])
        req, rej = (Request, Rejected) if port else (JRequest, JRejected)
        refused = []
        for i, p in enumerate(prompts):
            try:
                eng.submit(req(rid=i, prompt=p, max_new_tokens=5))
            except rej as e:
                refused.append((i, e.reason))
        trail, out = [], []
        for k in range(60):
            clock_t["t"] = 0.125 * k
            comps = eng.step()
            out.extend(comps)
            trail.append((eng.stats.heartbeat, len(comps)))
            if eng.idle:
                break
        runs.append((refused, trail, {c.rid: list(c.tokens) for c in out},
                     eng.stats.faults_injected, eng.stats.rejected))
    assert runs[0] == runs[1]
    refused, trail = runs[0][0], runs[0][1]
    assert refused == [(2, "fault_injected"), (4, "fault_injected")]
    hb = [h for h, _ in trail]
    # Frozen through the hang window (t in [1, 2): 8 quanta).
    assert hb[8] == hb[15] and hb[16] == hb[15] + 1


def test_admit_migrated_refusal_releases_the_probe_pin():
    """An injected ``refuse_admit`` at ``engine.admit_migrated``: the
    receiver raises the typed Rejected, counts the fault, and the pin
    its migration probe took is released (no trie node keeps a
    reference); the same payload then installs on the next try."""
    clock = lambda: 0.0                               # noqa: E731
    plan = {"specs": [{"kind": "refuse_admit", "site": "engine.admit_migrated",
                       "max_fires": 1}]}
    kw = dict(prefix_cache=True)
    src = _engine(True, {"specs": []}, clock, **kw)
    dst = _engine(True, plan, clock, **kw)
    prompt = np.random.default_rng(9).integers(0, 256, 13).astype(np.int32)
    # The receiver's trie holds the prompt's first blocks, so the probe
    # pins a path.
    dst.run([Request(rid=100, prompt=prompt[:8], max_new_tokens=2)])
    src.submit(Request(rid=1, prompt=prompt, max_new_tokens=4,
                       prefill_only=True))
    while not src.export_ready_rids():
        src.step()
    path, matched = dst.migration_probe(prompt)
    assert matched == 8 and all(n.refs == 1 for n in path)
    payload = src.export_request(1, skip_tokens=matched)
    with pytest.raises(Rejected, match="fault_injected"):
        dst.admit_migrated(payload, path=path)
    assert all(n.refs == 0 for n in path)
    assert dst.stats.faults_injected == 1 and dst.stats.rejected == 1
    path, matched = dst.migration_probe(prompt)
    dst.admit_migrated(src.export_request(1, skip_tokens=matched), path=path)
    src.finish_export(1)
    out = dst.run([])
    assert [c.rid for c in out] == [1] and len(out[0].tokens) == 4
    assert dst.stats.migrated_in == 1 and src.stats.migrated_out == 1
    assert src.stats.submitted == (src.stats.finished + src.stats.rejected
                                   + src.stats.migrated_out)
