"""The mirror of ``tests/test_obs.py`` on the port: the tracer, the
metrics registry, the reservoirs and the instrumented planes of
``kubeflow_controller_tpu_torch``.

Every case and seed of the reference file is kept, with its
assertions on the port. Where the outcome is deterministic the same
inputs also go through the JAX package and the two are compared:
histogram buckets and snapshots, registry snapshots, reservoir
contents, the tracer's ring, drop counters and Chrome JSON (names,
parents, attributes), ``MetricsLogger``'s clamped JSON, the engine's
streams and span counts by name (``tiny_config`` on the CPU: the port's
engine with ``device="cpu"`` and ``attn_impl="gather"``, the plain
attention; the JAX engine with its defaults), and the control plane's
sync and queue-wait spans. The concurrent-writer snapshot is held to
the reference's invariants and to the JAX registry's totals, which
the threads' interleaving does not decide.
"""

import json
import math
import threading
import types

import jax
import numpy as np
import pytest
import torch

from kubeflow_controller_tpu.dataplane import metrics as jmetrics
from kubeflow_controller_tpu.dataplane import serving_engine as jengine
from kubeflow_controller_tpu.models import generate as jgen
from kubeflow_controller_tpu.models import transformer as jtfm
from kubeflow_controller_tpu.obs import telemetry as jtele
from kubeflow_controller_tpu.obs import trace as jtrace
from kubeflow_controller_tpu_torch.convert import params_from_numpy
from kubeflow_controller_tpu_torch.dataplane import metrics as tmetrics
from kubeflow_controller_tpu_torch.dataplane import serving_engine as tengine
from kubeflow_controller_tpu_torch.models import transformer as ttfm
from kubeflow_controller_tpu_torch.obs import telemetry as ttele
from kubeflow_controller_tpu_torch.obs import trace as ttrace
from kubeflow_controller_tpu_torch.obs.telemetry import Histogram, Reservoir, registry
from kubeflow_controller_tpu_torch.obs.trace import Tracer

# One intra-op thread, as every port test module sets at import
# (tests/test_torch_import.py says why).
torch.set_num_threads(1)

J = types.SimpleNamespace(tele=jtele, trace=jtrace, metrics=jmetrics, engine=jengine)
T = types.SimpleNamespace(tele=ttele, trace=ttrace, metrics=tmetrics, engine=tengine)
BOTH = (J, T)


@pytest.fixture(autouse=True)
def _clean_registry():
    for m in BOTH:
        m.tele.reset_registry()
    yield
    for m in BOTH:
        m.tele.reset_registry()


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_kernels():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX inference params, port config, port params): the
    same ``tiny_config`` weights from JAX's init (seed 0)."""
    jcfg = jtfm.tiny_config()
    jparams = jgen.inference_params(jcfg, jtfm.init_params(jcfg, jax.random.key(0)))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, ttfm.tiny_config(), tparams


def _requests(m, cfg, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [
        m.engine.Request(rid=i,
                         prompt=rng.integers(0, cfg.vocab_size,
                                             4 + int(rng.integers(0, 5))).astype(np.int32),
                         max_new_tokens=3 + int(rng.integers(0, 5)))
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# Telemetry primitives


class TestHistogram:
    def test_bucket_boundaries_are_exact_binary_edges(self):
        h = Histogram("lat_s", lo_exp=-4, hi_exp=4)
        assert h.bucket_index(1.0) == 0 - h.lo_exp
        assert h.bucket_index(1.0000001) == 1 - h.lo_exp
        assert h.bucket_index(2.0) == 1 - h.lo_exp
        assert h.bucket_index(2.1) == 2 - h.lo_exp
        assert h.bucket_index(0.5) == -1 - h.lo_exp
        assert h.bucket_index(0.25) == -2 - h.lo_exp
        jh = jtele.Histogram("lat_s", lo_exp=-4, hi_exp=4)
        for v in (1.0, 1.0000001, 2.0, 2.1, 0.5, 0.25, 0.3, 3.0, 7.99, 8.0):
            assert h.bucket_index(v) == jh.bucket_index(v), v

    def test_clamping_underflow_overflow_nonfinite(self):
        h = Histogram("lat_s", lo_exp=-4, hi_exp=4)
        assert h.bucket_index(2.0 ** -10) == 0
        assert h.bucket_index(0.0) == 0
        assert h.bucket_index(-1.0) == 0
        last = len(h._buckets) - 1
        assert h.bucket_index(2.0 ** 10) == last
        assert h.bucket_index(math.inf) == last
        assert h.bucket_index(2.0 ** 4) == 4 - h.lo_exp
        assert h.bucket_index(2.0 ** 4 + 1) == last
        jh = jtele.Histogram("lat_s", lo_exp=-4, hi_exp=4)
        assert len(h._buckets) == len(jh._buckets)
        for v in (2.0 ** -10, 0.0, -1.0, 2.0 ** 10, math.inf, 16.0, 17.0, math.nan):
            assert h.bucket_index(v) == jh.bucket_index(v), v

    def test_snapshot_fields(self):
        snaps = []
        for m in BOTH:
            r = m.tele.MetricsRegistry()
            h = r.histogram("lat_s", "serving", lo_exp=-2, hi_exp=2)
            for v in (0.3, 1.0, 1.5, 3.0, 100.0):
                h.observe(v)
            snaps.append(r.snapshot())
        snap = snaps[1]
        assert snap["serving.lat_s.count"] == 5.0
        assert snap["serving.lat_s.sum"] == pytest.approx(105.8)
        assert snap["serving.lat_s.min"] == 0.3
        assert snap["serving.lat_s.max"] == 100.0
        assert snap["serving.lat_s.bucket_le_2e-1"] == 1.0   # 0.3
        assert snap["serving.lat_s.bucket_le_2e0"] == 1.0    # 1.0
        assert snap["serving.lat_s.bucket_le_2e1"] == 1.0    # 1.5
        assert snap["serving.lat_s.bucket_le_2e2"] == 1.0    # 3.0
        assert snap["serving.lat_s.bucket_overflow"] == 1.0  # 100.0
        assert snap == snaps[0]


class TestRegistry:
    def test_label_isolation_and_get_or_create(self):
        snaps = []
        for m in BOTH:
            r = m.tele.MetricsRegistry()
            a = r.counter("requests", "serving")
            b = r.counter("requests", "router")
            assert a is not b
            a.inc(3)
            assert r.counter("requests", "serving") is a    # get-or-create
            snaps.append(r.snapshot())
        assert snaps[1]["serving.requests"] == 3.0
        assert snaps[1]["router.requests"] == 0.0
        assert snaps[1] == snaps[0]

    def test_kind_mismatch_raises(self):
        msgs = []
        for m in BOTH:
            r = m.tele.MetricsRegistry()
            r.counter("x", "s")
            with pytest.raises(TypeError) as e:
                r.gauge("x", "s")
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]

    def test_negative_counter_increment_rejected(self):
        msgs = []
        for m in BOTH:
            r = m.tele.MetricsRegistry()
            with pytest.raises(ValueError) as e:
                r.counter("x").inc(-1)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]

    def test_snapshot_deterministic_under_concurrent_writers(self):
        n_threads, n_ops = 8, 500
        seeds = list(range(n_threads))
        snaps = []
        for m in BOTH:
            r = m.tele.MetricsRegistry()

            def work(seed, r=r):
                rng = np.random.default_rng(seed)
                c = r.counter("ops", "serving")
                h = r.histogram("v", "serving", lo_exp=-2, hi_exp=8)
                g = r.gauge("last", "serving")
                for _ in range(n_ops):
                    c.inc()
                    h.observe(float(rng.uniform(0.1, 100.0)))
                    g.set(float(seed))

            threads = [threading.Thread(target=work, args=(s,)) for s in seeds]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            snap = r.snapshot()
            assert snap["serving.ops"] == float(n_threads * n_ops)
            assert snap["serving.v.count"] == float(n_threads * n_ops)
            buckets = sum(v for k, v in snap.items() if k.startswith("serving.v.bucket"))
            assert buckets == float(n_threads * n_ops)
            assert snap == r.snapshot()
            assert list(snap) == sorted(snap)
            snaps.append(snap)
        # The threads' interleaving decides the gauge (the last writer)
        # and the order of the float sum, nothing else: every seeded
        # observation lands in the same bucket in both packages.
        jsnap, tsnap = snaps
        assert list(tsnap) == list(jsnap)
        assert tsnap["serving.last"] in seeds
        for k in tsnap:
            if k == "serving.v.sum":
                assert tsnap[k] == pytest.approx(jsnap[k], rel=1e-12)
            elif k != "serving.last":
                assert tsnap[k] == jsnap[k], k


class TestReservoir:
    def test_exact_below_cap(self):
        for m in BOTH:
            r = m.tele.Reservoir(cap=8)
            r.extend([3.0, 1.0, 2.0])
            assert list(r) == [3.0, 1.0, 2.0]
            assert len(r) == 3 and r.total == 3 and r.dropped == 0
            assert r[1] == 1.0 and r[-1] == 2.0

    def test_sliding_window_above_cap(self):
        got = []
        for m in BOTH:
            r = m.tele.Reservoir(cap=4)
            r.extend(range(1, 7))                    # 1..6
            assert list(r) == [3.0, 4.0, 5.0, 6.0]
            assert r.total == 6 and r.dropped == 2
            got.append((list(r), r.total, r.dropped, r[0], r[-1]))
        assert got[1] == got[0]

    def test_since_survives_eviction(self):
        got = []
        for m in BOTH:
            r = m.tele.Reservoir(cap=4)
            r.extend(range(10))
            seen = r.total
            assert r.since(seen) == []
            r.extend([10.0, 11.0])
            assert r.since(seen) == [10.0, 11.0]
            assert r.since(0) == list(r)
            got.append([r.since(n) for n in range(14)])
        assert got[1] == got[0]

    def test_clear_and_bool(self):
        r = Reservoir(cap=2, items=[1.0, 2.0, 3.0])
        j = jtele.Reservoir(cap=2, items=[1.0, 2.0, 3.0])
        assert r and r.dropped == 1
        assert list(r) == list(j) and r.dropped == j.dropped
        r.clear()
        assert not r and r.total == 0 and r.dropped == 0

    def test_bad_cap_rejected(self):
        msgs = []
        for m in BOTH:
            with pytest.raises(ValueError) as e:
                m.tele.Reservoir(cap=0)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]


class TestMetricsLoggerNonFinite:
    def test_inf_nan_clamped_to_null(self, tmp_path):
        lines = []
        for m in BOTH:
            path = tmp_path / f"m-{len(lines)}.jsonl"
            ml = m.metrics.MetricsLogger(str(path))
            ml.write(0, {"ok": 1.5, "up": math.inf, "down": -math.inf, "bad": math.nan})
            ml.close()
            lines.append(path.read_text().strip())
        line = lines[1]
        rec = json.loads(line)
        assert rec["ok"] == 1.5
        assert rec["up"] is None
        assert rec["down"] is None
        assert rec["bad"] is None
        for token in ("Infinity", "NaN"):
            assert token not in line
        assert rec == json.loads(lines[0])


# ---------------------------------------------------------------------------
# Tracer


def _export(tr):
    """A tracer's Chrome JSON, its spans as (name, parent's name, attrs)
    and its counters."""
    spans = tr.snapshot()
    by_sid = {s.sid: s.name for s in spans}
    return (tr.export(), [(s.name, by_sid.get(s.parent), s.attrs) for s in spans],
            tr.spans_recorded, tr.spans_dropped)


class TestTracer:
    def test_ring_bounds_and_drop_counters(self):
        out = []
        for m in BOTH:
            tr = m.trace.Tracer(capacity=4, clock=lambda: 0.0)
            for i in range(6):
                tr.add_span(f"s{i}", 0.0, 1.0)
            assert tr.spans_recorded == 6
            assert tr.spans_dropped == 2
            spans = tr.snapshot()
            assert len(spans) == 4
            assert [s.name for s in spans] == ["s2", "s3", "s4", "s5"]
            out.append(_export(tr))
        assert out[1] == out[0]

    def test_ctx_manager_parent_links(self):
        out = []
        for m in BOTH:
            tr = m.trace.Tracer(clock=lambda: 0.0)
            with tr.span("outer", rid="k"):
                with tr.span("inner", rid="k") as inner:
                    inner.set(n=1)
            spans = {s.name: s for s in tr.snapshot()}
            assert spans["inner"].parent == spans["outer"].sid
            assert spans["outer"].parent is None
            assert dict(spans["inner"].attrs)["n"] == 1
            out.append(_export(tr))
        assert out[1] == out[0]

    def test_ctx_manager_error_attr(self):
        out = []
        for m in BOTH:
            tr = m.trace.Tracer(clock=lambda: 0.0)
            with pytest.raises(RuntimeError):
                with tr.span("boom"):
                    raise RuntimeError("x")
            (s,) = tr.snapshot()
            assert dict(s.attrs).get("error")
            out.append(_export(tr))
        assert out[1] == out[0]

    def test_export_valid_chrome_json(self, tmp_path):
        docs = []
        for m in BOTH:
            tr = m.trace.Tracer(clock=lambda: 0.0, path=str(tmp_path / f"t{len(docs)}.json"))
            tr.add_span("work", 0.0, 0.5, rid="7", track="dataplane", k=1)
            tr.add_event("mark", 0.25, rid="7", track="router")
            tr.flush()
            docs.append(m.trace.load_chrome_trace(tr.path))
        doc = docs[1]
        evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
        x = next(e for e in evs if e["ph"] == "X")
        i = next(e for e in evs if e["ph"] == "i")
        assert x["name"] == "work" and x["dur"] == pytest.approx(5e5)
        assert x["args"]["rid"] == "7" and x["args"]["k"] == 1
        assert i["s"] == "t"
        procs = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert {"dataplane", "router"} <= procs
        assert doc == docs[0]

    def test_flush_idempotent_and_pathless(self, tmp_path):
        assert Tracer().flush() is None          # no path: no-op
        docs = []
        for m in BOTH:
            tr = m.trace.Tracer(clock=lambda: 0.0, path=str(tmp_path / f"t{len(docs)}.json"))
            tr.add_span("a", 0.0, 1.0)
            tr.flush()
            tr.add_span("b", 1.0, 2.0)
            tr.flush()                           # whole-file rewrite
            doc = m.trace.load_chrome_trace(tr.path)
            names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
            assert names == ["a", "b"]
            docs.append(doc)
        assert docs[1] == docs[0]

    def test_bad_capacity_rejected(self):
        msgs = []
        for m in BOTH:
            with pytest.raises(ValueError) as e:
                m.trace.Tracer(capacity=0)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# Data plane integration


ENGINE_KW = dict(n_slots=3, max_seq=32)
#: The JAX engine's jit-cache counts, which the port's summary leaves
#: out (it compiles no per-shape functions: dataplane/metrics.py).
JIT_CACHE_KEYS = {"prefill_compiles", "admit_cache_size"}


def _engine(m, models, **kw):
    jcfg, jparams, tcfg, tparams = models
    if m is J:
        return jengine.ServingEngine(jcfg, jparams, **ENGINE_KW, **kw), jcfg
    return tengine.ServingEngine(tcfg, tparams, device="cpu", attn_impl="gather",
                                 **ENGINE_KW, **kw), tcfg


def _names(doc):
    """Each non-metadata event name's count in a Chrome trace."""
    out = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] != "M":
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


class TestEngineTracing:
    def test_noop_tracer_bit_identity(self, models):
        """Tracing observes the engine and never steers it: greedy
        streams with and without a tracer are bit-identical, and the
        JAX engine's."""
        streams = []
        for m in BOTH:
            plain, cfg = _engine(m, models)
            traced, _ = _engine(m, models, tracer=m.trace.Tracer())
            a = {c.rid: list(c.tokens) for c in plain.run(_requests(m, cfg))}
            b = {c.rid: list(c.tokens) for c in traced.run(_requests(m, cfg))}
            assert a == b
            streams.append(a)
        assert streams[1] == streams[0]

    def test_span_conservation_and_linkage(self, models, tmp_path):
        counts = []
        for m in BOTH:
            tr = m.trace.Tracer(path=str(tmp_path / f"t{len(counts)}.json"))
            eng, cfg = _engine(m, models, tracer=tr)
            comps = eng.run(_requests(m, cfg))
            tr.flush()
            doc = m.trace.load_chrome_trace(tr.path)
            by_name = {}
            for ev in doc["traceEvents"]:
                if ev["ph"] == "M":
                    continue
                by_name.setdefault(ev["name"], []).append(ev)
            want = {str(c.rid): c.finish_reason for c in comps}
            submits = {e["args"]["rid"] for e in by_name["submit"]}
            retires = [e["args"] for e in by_name["retire"]]
            assert submits == set(want)
            assert len(retires) == len(want)
            for args in retires:
                assert args["finish_reason"] == want[args["rid"]]
            for name in ("queue_wait", "admit", "prefill_chunk"):
                assert {e["args"]["rid"] for e in by_name[name]} == set(want)
            assert by_name["decode_quantum"]
            assert by_name["dispatch"]
            assert eng.stats.spans_recorded == tr.spans_recorded
            assert eng.stats.spans_dropped == tr.spans_dropped
            counts.append((_names(doc), tr.spans_recorded, tr.spans_dropped, want))
        assert counts[1] == counts[0]

    def test_drain_error_flushes_metrics_and_trace(self, models, tmp_path):
        """The overrun exit path: DrainError leaves a parseable trace file
        and a metrics line tagged drain_error."""
        out = []
        for m in BOTH:
            mpath = tmp_path / f"m{len(out)}.jsonl"
            tr = m.trace.Tracer(path=str(tmp_path / f"t{len(out)}.json"))
            eng, cfg = _engine(m, models, tracer=tr, metrics_path=str(mpath))
            with pytest.raises(m.engine.DrainError) as e:
                eng.run(_requests(m, cfg), max_steps=2)
            recs = [json.loads(line) for line in mpath.read_text().splitlines()]
            assert recs[-1]["drain_error"] == 1.0
            doc = m.trace.load_chrome_trace(tr.path)
            assert any(s.name == "submit" for s in tr.snapshot())
            out.append((_names(doc), sorted(c.rid for c in e.value.completions),
                        sorted(set(recs[-1]) - JIT_CACHE_KEYS)))
        assert out[1] == out[0]

    def test_drain_flushes_metrics_and_trace(self, models, tmp_path):
        out = []
        for m in BOTH:
            mpath = tmp_path / f"m{len(out)}.jsonl"
            tr = m.trace.Tracer(path=str(tmp_path / f"t{len(out)}.json"))
            eng, cfg = _engine(m, models, tracer=tr, metrics_path=str(mpath))
            for r in _requests(m, cfg, n=2):
                eng.submit(r)
            comps = eng.drain(grace_s=30.0)
            assert comps
            recs = [json.loads(line) for line in mpath.read_text().splitlines()]
            assert recs[-1]["drained"] == 1.0
            doc = m.trace.load_chrome_trace(tr.path)
            assert any(e["name"] == "retire" for e in doc["traceEvents"] if e["ph"] != "M")
            out.append(({c.rid: (c.finish_reason, list(c.tokens)) for c in comps},
                        _names(doc)))
        assert out[1] == out[0]

    def test_serving_stats_reservoirs_bounded(self):
        out = []
        for m in BOTH:
            stats = m.metrics.ServingStats()
            cap = m.metrics.SAMPLE_CAP
            for i in range(cap + 100):
                stats.ttfts_s.append(float(i))
            assert len(stats.ttfts_s) == cap
            assert stats.samples_dropped == 100
            assert stats.summary()["samples_dropped"] == 100
            assert m.metrics.percentile(stats.ttfts_s, 100) == float(cap + 99)
            out.append((cap, list(stats.ttfts_s)[:3],
                        [m.metrics.percentile(stats.ttfts_s, p) for p in (50, 95, 99)]))
        assert out[1] == out[0]

    def test_registry_feeds_from_engine_stats(self):
        snaps = []
        for m in BOTH:
            stats = m.metrics.ServingStats()
            stats.record(m.engine.Completion(rid=1, tokens=[1, 2], finish_reason="eos",
                                             submit_t=0.0, first_token_t=0.5,
                                             done_t=1.0, admit_t=0.1))
            snaps.append(m.tele.registry().snapshot())
        snap = snaps[1]
        assert snap is not None and snap == registry().snapshot()
        assert snap["serving.requests_finished"] == 1.0
        assert snap["serving.finish_eos"] == 1.0
        assert snap["serving.ttft_s.count"] == 1.0
        assert snap == snaps[0]


# ---------------------------------------------------------------------------
# Control plane integration


def _controller_spans(pkg):
    """The reference's control-plane run on ``pkg``'s LocalRuntime: its
    spans as (name, track, rid, attrs), in record order, and the
    registry's sync count."""
    import importlib

    core = importlib.import_module(f"{pkg}.api.core")
    api = importlib.import_module(f"{pkg}.api.types")
    runtime = importlib.import_module(f"{pkg}.runtime")
    trace = importlib.import_module(f"{pkg}.obs.trace")
    tele = importlib.import_module(f"{pkg}.obs.telemetry")
    tr = trace.Tracer()
    rt = runtime.LocalRuntime(tracer=tr)
    rt.submit(api.TPUJob(
        metadata=core.ObjectMeta(name="job", namespace="default"),
        spec=api.TPUJobSpec(replica_specs=[api.ReplicaSpec(
            replica_type=api.ReplicaType.WORKER,
            template=core.PodTemplateSpec(spec=core.PodSpec(containers=[
                core.Container(name="t", image="jax:latest")])),
            tpu=api.TPUSliceSpec(accelerator_type="v5p-8", num_slices=1),
        )])))
    rt.step(steps=5)
    # The noop fast path fires on a REPEAT sync of a steady job; with
    # resync_period=0 nothing re-enqueues the key, so poke it the way a
    # resync would.
    for _ in range(3):
        rt.controller.queue.add("default/job")
        rt.controller.drain()
    spans = [(s.name, s.track, s.rid, s.attrs) for s in tr.snapshot()]
    return spans, tele.registry().snapshot()["control.syncs"]


class TestControllerTracing:
    def test_sync_and_queue_wait_spans(self):
        from test_torch_native import load_jax_native

        load_jax_native()           # both controllers on their C++ cores
        spans, n_syncs = _controller_spans("kubeflow_controller_tpu_torch")
        syncs = [s for s in spans if s[0] == "sync"]
        waits = [s for s in spans if s[0] == "queue_wait"]
        assert syncs and waits
        assert all(s[1] == "control" for s in syncs + waits)
        assert any(s[2] == "default/job" for s in syncs)
        outcomes = {dict(s[3]).get("outcome") for s in syncs}
        assert outcomes - {None}, "sync spans must carry an outcome"
        assert any(dict(s[3]).get("noop") for s in syncs)
        assert n_syncs >= len(syncs)
        assert (spans, n_syncs) == _controller_spans("kubeflow_controller_tpu")
