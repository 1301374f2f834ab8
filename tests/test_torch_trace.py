"""The port's span recorder (``obs/trace.py``) and the engine's tracer
sites, held against the JAX package's on the CPU.

* The :class:`Tracer` itself: the same calls on one fake clock export
  the same Chrome trace (ring eviction and the drop count included),
  and ``load_chrome_trace`` accepts and refuses the same documents.
* The engine: on one workload through the prefix cache and a host tier
  small enough to spill and rehydrate, every rid's engine spans (name,
  parent, attributes) equal the JAX engine's; the streams do not change
  with a tracer; a drain flushes the trace to its file.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane.serving_engine import (
    Request as JRequest, ServingEngine as JEngine,
)
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu.obs import trace as jtrace
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane.serving_engine import (
    Request, ServingEngine,
)
from kubeflow_controller_tpu_torch.models import transformer as ttfm
from kubeflow_controller_tpu_torch.obs import trace as ttrace

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


class _Clock:
    """A clock that moves only when told to."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_tracer(mod, capacity):
    clock = _Clock()
    tr = mod.Tracer(capacity=capacity, clock=clock)
    sid = tr.add_span("dispatch", 100.0, 100.5, track="router", rid="3",
                      replica="r0", attempt=0)
    tr.add_span("prefill_chunk", 100.1, 100.2, rid="3", parent=sid,
                offset=0, width=8, final=False)
    clock.t = 101.0
    tr.add_event("park", track="router", rid="4", attempt=1, delay_s=0.25)
    with tr.span("sync", track="control", rid="job-a", key="a") as outer:
        clock.t = 101.5
        with tr.span("inner", track="control") as inner:
            clock.t = 102.0
            inner.set(outcome="ok")
        outer.set(n=2)
    try:
        with tr.span("failing", track="custom"):
            clock.t = 102.5
            raise KeyError("x")
    except KeyError:
        pass
    tr.add_event("retire", 103.0, rid="3", finish_reason="eos", n_tokens=4)
    return tr


@pytest.mark.parametrize("capacity", [64, 3], ids=["roomy", "wrapping"])
def test_tracer_export_equals_jax(capacity, tmp_path):
    """The same span, event and context-manager calls on one fake clock
    give the JAX tracer's export bit for bit: spans, parents, tracks and
    tids, the ring's eviction and the recorded and dropped counts."""
    got = _drive_tracer(ttrace, capacity)
    want = _drive_tracer(jtrace, capacity)
    assert got.export() == want.export()
    assert (got.spans_recorded, got.spans_dropped) == (
        want.spans_recorded, want.spans_dropped)
    assert got.spans_dropped == (4 if capacity == 3 else 0)
    names = [s.name for s in got.snapshot()]
    assert names == [s.name for s in want.snapshot()]
    # The failing context records its exception's type; the inner span
    # is the outer one's child.
    spans = {s.name: s for s in got.snapshot()}
    if capacity == 64:
        assert dict(spans["failing"].attrs)["error"] == "KeyError"
        assert spans["inner"].parent == spans["sync"].sid
    path = tmp_path / "t.json"
    got.path = str(path)
    assert got.flush() == str(path)
    assert ttrace.load_chrome_trace(str(path)) == jtrace.load_chrome_trace(
        str(path))
    assert ttrace.Tracer().flush() is None
    with pytest.raises(ValueError, match="capacity must be positive"):
        ttrace.Tracer(capacity=0)


@pytest.mark.parametrize("doc", [
    [], {"traceEvents": {}}, {"traceEvents": [1]},
    {"traceEvents": [{"ph": "Q", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": -1}]},
    {"traceEvents": [{"ph": "i", "pid": 1, "ts": 0}]},
], ids=["list", "events-dict", "non-dict", "phase", "dur", "tid"])
def test_load_chrome_trace_refuses_what_jax_refuses(doc, tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError) as want:
        jtrace.load_chrome_trace(str(path))
    with pytest.raises(ValueError) as got:
        ttrace.load_chrome_trace(str(path))
    assert str(got.value) == str(want.value)


# -- the engine's spans -----------------------------------------------------------

@functools.lru_cache(None)
def _models():
    cfg_j = jtfm.tiny_config()
    cfg_t = ttfm.tiny_config()
    params_j = jgen.inference_params(
        cfg_j, jtfm.init_params(cfg_j, jax.random.key(0)))
    params_t = params_from_numpy(jax.device_get(params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


#: Bucketed prefill with the prefix cache over a 12-page pool and a host
#: tier: the cycling workload spills and rehydrates.
_KW = dict(n_slots=2, max_seq=32, prefill_mode="bucketed", block_size=4,
           prefix_cache=True, kv_pool_blocks=12, host_kv_mb=1.0)


def _requests(port, waves=2):
    req = Request if port else JRequest
    rng = np.random.default_rng(3)
    fams = [rng.integers(0, 256, 16) for _ in range(4)]
    tails = np.random.default_rng(7)
    out = []
    for _ in range(waves):
        for f in fams:
            rid = len(out)
            tail = tails.integers(0, 256, 1 + rid % 4)
            out.append(req(rid=rid, max_new_tokens=4 + rid % 2,
                           prompt=np.concatenate([f, tail]).astype(np.int32)))
    return out


def _engine(port, tracer=None, **kw):
    cfg_j, cfg_t, params_j, params_t = _models()
    clock = _Clock()
    if port:
        eng = ServingEngine(cfg_t, params_t, device="cpu", tracer=tracer,
                            clock=clock, **_KW, **kw)
    else:
        eng = JEngine(cfg_j, params_j, tracer=tracer, clock=clock, **_KW,
                      **kw)
    return eng, clock


def _run_traced(port):
    mod = ttrace if port else jtrace
    tracer = mod.Tracer(clock=lambda: 0.0)
    eng, clock = _engine(port, tracer)
    for r in _requests(port):
        eng.submit(r)
    comps = []
    while not eng.idle:
        clock.t += 0.25
        comps.extend(eng.step())
    return tracer, eng, {c.rid: list(c.tokens) for c in comps}


def _per_rid(tracer):
    """Each rid's spans in record order: (name, parent's name, attrs,
    t0, t1); the engine's rid-less spans (table pushes, dispatches,
    quanta) as their names' counts."""
    spans = tracer.snapshot()
    by_sid = {s.sid: s for s in spans}
    lanes, rest = {}, {}
    for s in spans:
        if s.rid is None:
            rest[s.name] = rest.get(s.name, 0) + 1
            continue
        parent = by_sid[s.parent].name if s.parent is not None else None
        lanes.setdefault(s.rid, []).append(
            (s.name, parent, s.attrs, s.t0, s.t1))
    return lanes, rest


def test_engine_spans_per_rid_equal_jax():
    """On one workload (prefix hits, spills attributed to the admitting
    rid, rehydrates), every rid's engine spans equal the JAX engine's:
    names, order, parents, attributes and timestamps on one fake clock
    (submit, queue_wait, admit, prefill_chunk, kv_spill, kv_rehydrate,
    retire). The rid-less engine spans come in the same kinds."""
    got_tr, eng, got = _run_traced(True)
    want_tr, jeng, want = _run_traced(False)
    assert got == want
    lanes, rest = _per_rid(got_tr)
    jlanes, jrest = _per_rid(want_tr)
    assert lanes == jlanes
    kinds = {n for lane in lanes.values() for n, *_ in lane}
    assert {"submit", "queue_wait", "admit", "prefill_chunk", "kv_spill",
            "kv_rehydrate", "retire"} <= kinds
    assert set(rest) == set(jrest) == {
        "push_tables", "dispatch", "device_get", "decode_quantum"}
    assert rest["decode_quantum"] == jrest["decode_quantum"]
    # One retire a completion, as the stats count them.
    retires = [s for s in got_tr.snapshot() if s.name == "retire"]
    assert len(retires) == eng.stats.finished == len(got)
    assert eng.stats.spans_recorded == got_tr.spans_recorded
    assert eng.stats.spans_dropped == 0


def test_tracer_changes_no_stream_and_drain_flushes(tmp_path):
    """A traced engine serves the untraced engine's streams and counters;
    a drain mid-run flushes a loadable trace holding one retire event a
    completion the drain returned."""
    _, _, traced = _run_traced(True)
    eng, clock = _engine(True)
    comps = eng.run(_requests(True))
    assert {c.rid: list(c.tokens) for c in comps} == traced
    assert eng.stats.spans_recorded == 0
    path = tmp_path / "drain.json"
    tracer = ttrace.Tracer(path=str(path))
    eng, clock = _engine(True, tracer)
    for r in _requests(True):
        eng.submit(r)
    out = []
    for _ in range(6):
        clock.t += 0.25
        out.extend(eng.step())
    assert not path.exists()
    out.extend(eng.drain(grace_s=0.0))
    doc = ttrace.load_chrome_trace(str(path))
    retired = [e for e in doc["traceEvents"] if e.get("name") == "retire"]
    assert len(retired) == len(out) == len(_requests(True))
    assert {e["args"]["finish_reason"] for e in retired} >= {"shed"}
    assert doc["otherData"]["spans_dropped"] == 0
