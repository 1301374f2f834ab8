"""The port's C++ runtime core (``kubeflow_controller_tpu_torch/csrc/
tpujob_native.cc``, built with the host C++ compiler at first use) against
the port's pure-Python reference and against the JAX package's native
library: identical semantics required.

The first half is ``tests/test_native.py`` on the port: every case runs
against both of the port's implementations (the Python one is the
behavioural spec; the native one must match it exactly). Here the native
core is not optional: where the JAX tests skip without their library, these
fail, since the port builds its own. The throughput sanity check is not
copied (it is timing-bound). The second half drives the same seeded
operation soups through the port's native workqueue, expectations and
object index, the port's Python ones and the JAX package's native ones,
and compares every result, and holds ``wq_backoff_delay`` bit for bit
across the three. The control plane imports no torch, so neither does this
file.
"""

import importlib
import os
import random
import subprocess
import sys
import threading
import time

import pytest

from kubeflow_controller_tpu_torch import native
from kubeflow_controller_tpu_torch.controller.expectations import ControllerExpectations
from kubeflow_controller_tpu_torch.controller.workqueue import (
    RateLimitingQueue,
    backoff_delay,
)
from kubeflow_controller_tpu_torch.native.queue import (
    NativeControllerExpectations, NativeRateLimitingQueue,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def queue_impls():
    return [RateLimitingQueue, NativeRateLimitingQueue]


def exp_impls():
    return [ControllerExpectations, NativeControllerExpectations]


def test_native_core_builds_into_the_package_build_dir():
    """The library is built from the port's own source into ``_build/``,
    under a name keyed by the source's and the flags' hash, and no
    temporary file of the build is left beside it."""
    assert native.available(), native.load_error()
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("tpujob_native-")
    assert native.SOURCE == os.path.join(
        ROOT, "kubeflow_controller_tpu_torch", "csrc", "tpujob_native.cc")
    assert os.path.exists(path) and native.load_error() == ""
    assert not [f for f in os.listdir(native.BUILD_DIR)
                if f.startswith("tpujob_native-") and f.endswith(".tmp")]
    # The top-level csrc/ stays the JAX package's: the two sources are
    # copies, and nvcc's glob of the port's csrc/*.cu does not take it.
    with open(native.SOURCE) as a, open(os.path.join(ROOT, "csrc",
                                                     "tpujob_native.cc")) as b:
        assert a.read() == b.read()
    from kubeflow_controller_tpu_torch.ops import _build
    assert native.SOURCE not in _build.SOURCES


@pytest.mark.parametrize("Queue", queue_impls())
class TestQueueSemantics:
    def test_dedup(self, Queue):
        q = Queue()
        q.add("k")
        q.add("k")
        assert len(q) == 1
        assert q.get(0.5) == "k"

    def test_redo_while_processing(self, Queue):
        q = Queue()
        q.add("k")
        assert q.get(0.5) == "k"
        q.add("k")               # arrives mid-processing
        assert q.get(0.05) is None   # not yet re-queued
        q.done("k")
        assert q.get(0.5) == "k"     # redo fires after done

    def test_add_after_orders_by_due_time(self, Queue):
        q = Queue()
        q.add_after("late", 0.2)
        q.add_after("early", 0.05)
        assert q.get(1.0) == "early"
        assert q.get(1.0) == "late"

    def test_rate_limit_backoff_grows(self, Queue):
        q = Queue(0.01, 1.0)
        q.add_rate_limited("k")
        assert q.num_requeues("k") == 1
        assert q.get(1.0) == "k"
        q.done("k")
        q.forget("k")
        assert q.num_requeues("k") == 0

    def test_get_timeout(self, Queue):
        q = Queue()
        t0 = time.monotonic()
        assert q.get(0.05) is None
        assert time.monotonic() - t0 >= 0.04

    def test_shutdown_unblocks_waiters(self, Queue):
        q = Queue()
        got = []

        def waiter():
            got.append(q.get(5.0))

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        q.shutdown()
        t.join(2.0)
        assert not t.is_alive()
        assert got == [None]

    def test_concurrent_producers_consumers(self, Queue):
        q = Queue()
        seen = []
        lock = threading.Lock()

        def consumer():
            while True:
                item = q.get(0.5)
                if item is None:
                    return
                with lock:
                    seen.append(item)
                q.done(item)

        consumers = [threading.Thread(target=consumer) for _ in range(4)]
        for c in consumers:
            c.start()
        for i in range(200):
            q.add(f"job-{i % 50}")   # heavy dedup pressure
        deadline = time.time() + 5
        while time.time() < deadline and not q.empty_and_idle():
            time.sleep(0.01)
        q.shutdown()
        for c in consumers:
            c.join(2.0)
        assert set(seen) == {f"job-{i}" for i in range(50)}


@pytest.mark.parametrize("Exp", exp_impls())
class TestExpectationsSemantics:
    def test_lifecycle(self, Exp):
        e = Exp()
        assert e.satisfied("k")          # unknown key: trust cache
        e.expect_creations("k", 2)
        assert not e.satisfied("k")
        e.creation_observed("k")
        assert not e.satisfied("k")
        e.creation_observed("k")
        assert e.satisfied("k")

    def test_deletions_and_pending(self, Exp):
        e = Exp()
        e.expect_deletions("k", 1)
        assert e.pending("k") == (0, 1)
        e.deletion_observed("k")
        assert e.satisfied("k")
        e.delete_expectations("k")
        assert e.pending("k") is None

    def test_ttl_backstop(self, Exp):
        e = Exp(0.05)
        e.expect_creations("k", 99)
        assert not e.satisfied("k")
        time.sleep(0.06)
        assert e.satisfied("k")


def test_controller_uses_native_by_default():
    from kubeflow_controller_tpu_torch.native.queue import make_expectations, make_queue

    assert type(make_queue()).__name__ == "NativeRateLimitingQueue"
    assert type(make_expectations()).__name__ == "NativeControllerExpectations"


class TestBackoffDelay:
    """The rate-limit delay function: capped exponential with deterministic
    jitter. The Python version is the spec; the C++ core must produce the
    bit-identical double for identical inputs."""

    KEYS = ["default/job-a", "lmsvc:default/chat", "", "k" * 200, "ns/j|x"]
    FAILURES = [0, 1, 2, 3, 7, 15, 31, 32, 33, 100, 10_000]

    def test_cap_and_jitter_envelope(self):
        base, cap = 0.005, 60.0
        for key in self.KEYS:
            for f in self.FAILURES:
                raw = min(base * 2.0 ** min(f, 32), cap)
                d = backoff_delay(base, cap, key, f)
                assert 0.75 * raw <= d < raw, (key, f, d)

    def test_huge_failure_count_stays_capped(self):
        # 2**failures must never materialize: the exponent is clamped, so
        # even absurd counts return promptly and never exceed the cap.
        d = backoff_delay(0.005, 60.0, "k", 10_000_000)
        assert 0.75 * 60.0 <= d < 60.0

    def test_deterministic_but_key_dependent(self):
        a = backoff_delay(0.01, 1.0, "ns/a", 3)
        assert a == backoff_delay(0.01, 1.0, "ns/a", 3)
        # Different keys (or failure counts) land on different beats:
        # the anti-thundering-herd property after a controller restart.
        others = {
            backoff_delay(0.01, 1.0, k, f)
            for k in ("ns/b", "ns/c", "ns/d")
            for f in (3, 4)
        }
        assert len(others) == 6 and a not in others

    def test_native_parity_bit_identical(self):
        from kubeflow_controller_tpu_torch.native.queue import native_backoff_delay

        for base, cap in ((0.005, 60.0), (0.01, 1.0), (0.02, 300.0)):
            for key in self.KEYS:
                for f in self.FAILURES:
                    py = backoff_delay(base, cap, key, f)
                    cc = native_backoff_delay(base, cap, key, f)
                    assert py == cc, (base, cap, key, f, py, cc)


@pytest.mark.parametrize("Queue", queue_impls())
def test_add_beats_pending_add_after(Queue):
    """k8s semantics in BOTH implementations: an immediate add promotes a
    key parked in the delayed heap instead of being swallowed."""
    q = Queue()
    q.add_after("k", 3600.0)
    assert q.get(timeout=0.05) is None
    q.add("k")
    assert q.get(timeout=0.5) == "k"
    q.done("k")
    assert q.get(timeout=0.05) is None


@pytest.mark.parametrize("Queue", queue_impls())
class TestEarliestDeadline:
    """client-go delaying-queue semantics: re-adding a parked key keeps the
    EARLIEST deadline, in BOTH implementations."""

    def test_shorter_delay_wins(self, Queue):
        q = Queue()
        q.add_after("k", 3600.0)     # parked far in the future
        q.add_after("k", 0.05)       # must supersede, not be swallowed
        assert q.get(timeout=1.0) == "k"
        q.done("k")
        # the superseded 3600s entry must not fire a second time
        assert q.get(timeout=0.1) is None
        assert q.empty_and_idle()

    def test_longer_delay_does_not_extend(self, Queue):
        q = Queue()
        q.add_after("k", 0.05)
        q.add_after("k", 3600.0)     # later deadline: ignored
        assert q.get(timeout=1.0) == "k"
        q.done("k")
        assert q.get(timeout=0.1) is None
        assert q.empty_and_idle()

    def test_len_counts_parked_item_once(self, Queue):
        q = Queue()
        q.add_after("k", 3600.0)
        q.add_after("k", 1800.0)
        q.add_after("k", 900.0)      # three heap entries, one real item
        assert len(q) == 1
        assert not q.empty_and_idle()

    def test_immediate_add_then_due_fires_once(self, Queue):
        q = Queue()
        q.add_after("k", 0.05)
        q.add("k")                   # beats the delay
        assert q.get(timeout=0.5) == "k"
        q.done("k")
        time.sleep(0.08)             # let the parked deadline pass
        assert q.get(timeout=0.05) is None
        assert q.empty_and_idle()


# ---------------------------------------------------------------------------
# Object index + fingerprint parity (native mirror vs pure-Python paths)
# ---------------------------------------------------------------------------


class TestObjectIndexParity:
    """Property battery: a random create/update/delete/label-churn soup
    applied to the C++ ObjectIndex and to a pure-Python reference of the
    same contract (the ObjectStore label-index shape). Buckets, counts,
    and fingerprint hit/miss decisions must agree at every step."""

    KINDS = ("Pod", "Service")
    LABELS = ("training.tpu.io/job-name", "serving.tpu.io/lmservice")

    def _make(self):
        from kubeflow_controller_tpu_torch.native.objindex import make_object_index

        ix = make_object_index()
        assert ix is not None
        return ix

    def test_random_soup_buckets_match(self):
        import random

        rng = random.Random(0xC0FFEE)
        ix = self._make()
        # Python reference: kind -> {key: (uid, rv, labels)}, plus the
        # label index kind -> lk -> value -> set(keys).
        objs = {k: {} for k in self.KINDS}
        index = {k: {lk: {} for lk in self.LABELS} for k in self.KINDS}
        keys = [f"default/obj-{i}" for i in range(40)]
        rv = 0

        def ref_remove(kind, key):
            old = objs[kind].pop(key, None)
            if old is None:
                return
            for lk, v in old[2].items():
                bucket = index[kind][lk].get(v)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del index[kind][lk][v]

        for step in range(600):
            kind = rng.choice(self.KINDS)
            key = rng.choice(keys)
            op = rng.random()
            if op < 0.75:  # upsert (create or update, maybe label churn)
                rv += 1
                uid = objs[kind].get(key, (f"u{rv}",))[0]
                labels = {}
                for lk in self.LABELS:
                    if rng.random() < 0.6:
                        labels[lk] = f"owner-{rng.randrange(6)}"
                ref_remove(kind, key)
                objs[kind][key] = (uid, rv, labels)
                for lk, v in labels.items():
                    index[kind][lk].setdefault(v, set()).add(key)
                ix.upsert(kind, key, uid, rv, 1, labels)
            else:  # delete
                ref_remove(kind, key)
                ix.remove(kind, key)

            if step % 50 == 49:  # full cross-check periodically
                for k in self.KINDS:
                    assert ix.count(k) == len(objs[k])
                    for lk in self.LABELS:
                        for v, members in index[k][lk].items():
                            assert set(ix.bucket(k, lk, v)) == members, (
                                step, k, lk, v)
                        # and no phantom buckets on the native side
                        for v in [f"owner-{i}" for i in range(6)]:
                            if v not in index[k][lk]:
                                assert ix.bucket(k, lk, v) == []

    def test_fingerprint_decisions_match_python_tuples(self):
        """Drive the probe/commit protocol through a churn sequence and
        assert each hit/miss agrees with the Python tuple-compare spec."""
        import random

        rng = random.Random(7)
        ix = self._make()
        LK = self.LABELS[0]
        last_fp = {}   # Python reference: job key -> fp tuple
        rv = 0
        jobs = [f"default/job-{i}" for i in range(4)]

        def py_fp(job):
            name = job.split("/", 1)[1]
            pods = []
            for key, (uid, krv, labels) in pod_objs.items():
                if labels.get(LK) == name:
                    pods.append((uid, krv))
            return (job_meta[job], tuple(sorted(pods)))

        pod_objs = {}
        job_meta = {}
        for step in range(300):
            job = rng.choice(jobs)
            name = job.split("/", 1)[1]
            op = rng.random()
            if op < 0.3:   # pod churn under the job
                rv += 1
                pkey = f"default/{name}-pod-{rng.randrange(3)}"
                pod_objs[pkey] = (f"pu-{pkey}", rv, {LK: name})
                ix.upsert("Pod", pkey, f"pu-{pkey}", rv, 1, {LK: name})
            elif op < 0.4:  # pod delete
                pkey = f"default/{name}-pod-{rng.randrange(3)}"
                pod_objs.pop(pkey, None)
                ix.remove("Pod", pkey)
            elif op < 0.5:  # job rv bump (annotation churn)
                rv += 1
                job_meta[job] = f"ju-{job}|{rv}|1"
            if job not in job_meta:
                rv += 1
                job_meta[job] = f"ju-{job}|{rv}|1"

            # probe: native decision must equal the Python tuple compare
            fp = py_fp(job)
            expect_hit = last_fp.get(job) == fp
            got_hit = ix.fp_probe(
                job, job_meta[job], "default",
                "Pod", LK, name, "", "", "", "-")
            assert got_hit == expect_hit, (step, job)
            if not got_hit and rng.random() < 0.8:
                # commit the pending candidate (the steady sync completing)
                ix.fp_commit(job)
                last_fp[job] = fp
            # (uncommitted misses model syncs that wrote status: the next
            # probe must still compare against the OLD committed fp)

        hits, misses = ix.fp_counts()
        assert hits + misses == 300
        assert hits > 0 and misses > 0

    def test_slice_mirror_fp_decisions_match_python(self):
        """Slice-health mirror parity: fp_probe_mirrored composes the
        health term natively from SlicePool's write-through mirror; its
        hit/miss decisions must equal the Python _sync_fingerprint spec
        (``tuple(sorted((name, healthy) for s in holdings(uid)))``, or
        None when the planner won't read health) through allocation,
        degradation, preemption, restore, and release churn."""
        import random

        from kubeflow_controller_tpu_torch.cluster.slices import (
            InsufficientCapacity, SlicePool,
        )

        rng = random.Random(21)
        ix = self._make()
        pool = SlicePool(mirror=ix)
        names = pool.add_pool("v5e-16", 6)
        uids = [f"uid-{i}" for i in range(3)]
        last = {}  # uid -> committed Python reference fingerprint

        def py_ref(uid, want):
            health = None
            if want:
                health = tuple(sorted(
                    (s.name, s.healthy) for s in pool.holdings(uid)))
            return ("ident", health)

        hits = misses = 0
        for step in range(300):
            op = rng.random()
            if op < 0.35:
                try:
                    pool.allocate_gang(rng.choice(uids), "v5e-16",
                                       rng.randrange(1, 4))
                except InsufficientCapacity:
                    pass
            elif op < 0.5:
                pool.mark_unhealthy(rng.choice(names))
            elif op < 0.6:
                pool.preempt(rng.choice(names))
            elif op < 0.75:
                pool.restore(rng.choice(names))
            elif op < 0.85:
                pool.release(rng.choice(uids))

            uid = rng.choice(uids)
            want = rng.random() < 0.8
            ref = py_ref(uid, want)
            expect_hit = last.get(uid) == ref
            got = ix.fp_probe_mirrored(
                f"default/{uid}", "ident", "default",
                "Pod", self.LABELS[0], "x", "", "", "", uid, want)
            assert got == expect_hit, (step, uid, want)
            if got:
                hits += 1
            else:
                misses += 1
                ix.fp_commit(f"default/{uid}")
                last[uid] = ref
        assert hits > 0 and misses > 0

    def test_slice_mirror_none_vs_empty_health(self):
        """want_health=False (planner ignores health; Python health_key
        None) and want_health=True with zero held slices (empty tuple)
        are DISTINCT fingerprints — toggling must miss."""
        ix = self._make()
        assert not ix.fp_probe_mirrored(
            "default/j", "i", "default",
            "Pod", self.LABELS[0], "j", "", "", "", "u", False)
        ix.fp_commit("default/j")
        assert ix.fp_probe_mirrored(
            "default/j", "i", "default",
            "Pod", self.LABELS[0], "j", "", "", "", "u", False)
        assert not ix.fp_probe_mirrored(
            "default/j", "i", "default",
            "Pod", self.LABELS[0], "j", "", "", "", "u", True)

    def test_forget_clears_committed_and_pending(self):
        ix = self._make()
        ix.upsert("Pod", "default/a-pod-0", "pu", 1, 1,
                  {self.LABELS[0]: "a"})
        assert not ix.fp_probe("default/a", "u|1|1", "default",
                               "Pod", self.LABELS[0], "a", "", "", "", "-")
        ix.fp_commit("default/a")
        assert ix.fp_probe("default/a", "u|1|1", "default",
                           "Pod", self.LABELS[0], "a", "", "", "", "-")
        ix.fp_forget("default/a")
        assert not ix.fp_probe("default/a", "u|1|1", "default",
                               "Pod", self.LABELS[0], "a", "", "", "", "-")


class TestRuntimeIndexParity:
    """End-to-end: the SAME deterministic job/lmservice soup driven through
    a native-index runtime and a forced-Python runtime must produce
    identical sync decisions — skip counts, label-selected sets, watch
    delta order, and final object state."""

    def _soup(self, use_native, pkg="kubeflow_controller_tpu_torch"):
        imp = importlib.import_module
        core, types = imp(f"{pkg}.api.core"), imp(f"{pkg}.api.types")
        Container, ObjectMeta, PodSpec = (
            core.Container, core.ObjectMeta, core.PodSpec)
        PodTemplateSpec, thaw = core.PodTemplateSpec, core.thaw
        LMService, LMServiceSpec, ReplicaSpec = (
            types.LMService, types.LMServiceSpec, types.ReplicaSpec)
        ReplicaType, TPUJob, TPUJobSpec, TPUSliceSpec = (
            types.ReplicaType, types.TPUJob, types.TPUJobSpec,
            types.TPUSliceSpec)
        PodRunPolicy = imp(f"{pkg}.cluster.cluster").PodRunPolicy
        LocalRuntime = imp(f"{pkg}.runtime").LocalRuntime
        naming = imp(f"{pkg}.tpu.naming")

        rng = random.Random(42)
        rt = LocalRuntime(
            PodRunPolicy(start_delay=1, run_duration=10 ** 9),
            use_native_index=use_native,
        )
        rt.cluster.slice_pool.add_pool("v5p-8", 64)
        # runtime_id generation must be identical across the two runtimes
        # (it lands in pod names, which land in the compared deltas)
        rt._opts.rng = random.Random(99)
        deltas = []

        def listen(ev):
            deltas.append((ev.type.value, ev.kind,
                           ev.obj.metadata.namespace,
                           ev.obj.metadata.name,
                           ev.obj.metadata.resource_version))

        rt.cluster.jobs.subscribe(listen)
        rt.cluster.pods.subscribe(listen)

        for i in range(6):
            rt.submit(TPUJob(
                metadata=ObjectMeta(name=f"par-{i}", namespace="default"),
                spec=TPUJobSpec(replica_specs=[ReplicaSpec(
                    replica_type=ReplicaType.WORKER,
                    template=PodTemplateSpec(spec=PodSpec(containers=[
                        Container(name="t", image="jax:latest")])),
                    tpu=TPUSliceSpec(accelerator_type="v5p-8",
                                     num_slices=1),
                )]),
            ))
        for i in range(2):
            rt.submit_lmservice(LMService(
                metadata=ObjectMeta(name=f"srv-{i}", namespace="default"),
                spec=LMServiceSpec(model="tiny", replicas=2),
            ))
        rt.step(dt=1.0, steps=5)

        # resync waves + metadata churn, deterministically interleaved
        for round_ in range(4):
            for inf in (rt.job_informer, rt.pod_informer,
                        rt.service_informer, rt.lmservice_informer):
                inf.resync()
            while rt.controller.drain(max_items=5000):
                pass
            i = rng.randrange(6)
            j = thaw(rt.cluster.jobs.try_get("default", f"par-{i}"))
            j.metadata.annotations["churn"] = f"r{round_}"
            rt.cluster.jobs.update(j)
            rt.step(dt=1.0, steps=2)
            if round_ == 2:
                # Eventless slice-health flip on a held slice: the
                # fingerprint's health term must shift (and re-steady
                # after restore) identically on both paths — native reads
                # it from the pool's write-through mirror, Python
                # recomputes it from holdings() per probe.
                held = [s for s in rt.cluster.slice_pool.list("v5p-8")
                        if s.holder]
                if held:
                    name = held[rng.randrange(len(held))].name
                    rt.cluster.slice_pool.mark_unhealthy(name)
                    for inf in (rt.job_informer, rt.pod_informer,
                                rt.service_informer, rt.lmservice_informer):
                        inf.resync()
                    while rt.controller.drain(max_items=5000):
                        pass
                    rt.cluster.slice_pool.restore(name)
                    rt.step(dt=1.0, steps=2)
        for inf in (rt.job_informer, rt.pod_informer,
                    rt.service_informer, rt.lmservice_informer):
            inf.resync()
        while rt.controller.drain(max_items=5000):
            pass
        for store in (rt.cluster.jobs, rt.cluster.pods,
                      rt.cluster.services, rt.cluster.lmservices):
            store.flush()

        selected = {
            name: sorted(
                p.metadata.name for p in rt.cluster.pods.list(
                    "default", {naming.LABEL_JOB: name}))
            for name in (f"par-{i}" for i in range(6))
        }
        state = {
            j.metadata.name: (j.status.phase.value,
                              j.metadata.resource_version,
                              j.status.observed_generation)
            for j in rt.cluster.jobs.list("default")
        }
        stats = (rt.controller.syncs_skipped_noop, rt.controller.fp_misses,
                 rt.controller.fp_stats())
        rt.stop()
        return deltas, selected, state, stats

    def test_native_and_python_paths_agree(self):
        d_py, sel_py, state_py, stats_py = self._soup(use_native=False)
        d_nx, sel_nx, state_nx, stats_nx = self._soup(use_native=True)
        assert d_py == d_nx          # watch delta order, event for event
        assert sel_py == sel_nx      # label-selected sets
        assert state_py == state_nx  # final object state
        # identical skip/run decisions: Python counters agree, and the
        # native hit/miss counters match the Python-path pair exactly
        assert stats_py[:2] == stats_nx[:2]
        assert stats_nx[2] == (stats_nx[0], stats_nx[1])

    def test_port_native_equals_jax_native(self):
        """The same soup through the port's C++ core and the JAX package's:
        the same deltas, selections, final state and fingerprint counts."""
        port = self._soup(use_native=True)
        jax = self._soup(use_native=True, pkg="kubeflow_controller_tpu")
        assert port == jax

    def test_python_fallback_runs_without_lib(self):
        # Always runs (no native mark): the forced-Python path must be
        # fully functional on its own.
        deltas, selected, state, stats = self._soup(use_native=False)
        assert state and all(s[0] == "Running" for s in state.values())
        assert stats[0] > 0          # resync waves actually skipped


# -- the port's native core against the JAX package's, operation for operation


JAX = "kubeflow_controller_tpu"


def load_jax_native():
    """The JAX package's native library, loaded in this process. Its loader
    builds it with ``make`` on first use straight into its output path and
    remembers a failed load, so a process that opened it while another
    worker's build was still writing it would never retry: retry here
    (the JAX package itself is not edited)."""
    mod = importlib.import_module(f"{JAX}.native")
    deadline = time.monotonic() + 120
    while mod.load() is None and time.monotonic() < deadline:
        if os.environ.get("TPUJOB_NATIVE", "1") == "0":
            break
        mod._load_attempted = False
        time.sleep(0.5)
    assert mod.load() is not None, "the JAX package's native library did not load"
    return mod


def _queues(base=1000.0, cap=4000.0):
    """The port's native and Python queues and the JAX package's native
    one. The base delay is far beyond the test's length, so a rate-limited
    or delayed add never comes due while the soup runs: every get is
    decided by the queue's state, not by the clock."""
    load_jax_native()
    jq = importlib.import_module(f"{JAX}.native.queue")
    return [NativeRateLimitingQueue(base, cap), RateLimitingQueue(base, cap),
            jq.NativeRateLimitingQueue(base, cap)]


def test_queue_soup_matches_python_and_jax_native():
    rng = random.Random(2024)
    qs = _queues()
    keys = [f"default/job-{i}" for i in range(12)] + ["lmsvc:default/chat"]
    held = []
    for step in range(3000):
        x = rng.random()
        if x < 0.25:
            op = ("add", rng.choice(keys))
        elif x < 0.32:
            op = ("add_after", rng.choice(keys), rng.choice([0.0, -1.0, 2000.0]))
        elif x < 0.40:
            op = ("add_rate_limited", rng.choice(keys))
        elif x < 0.45:
            op = ("forget", rng.choice(keys))
        elif x < 0.55:
            op = ("num_requeues", rng.choice(keys))
        elif x < 0.80:
            op = ("get",)
        elif x < 0.95 and held:
            op = ("done", held.pop(rng.randrange(len(held))))
        else:
            op = ("len",)
        outs = []
        for q in qs:
            if op[0] == "get":
                outs.append(q.get(timeout=0.0))
            elif op[0] == "len":
                outs.append((len(q), q.empty_and_idle()))
            else:
                outs.append(getattr(q, op[0])(*op[1:]))
        assert outs[0] == outs[1] == outs[2], (step, op, outs)
        if op[0] == "get" and outs[0] is not None:
            held.append(outs[0])
    # Shut down: the queued items still come out, in the same order, then
    # every get returns None at once.
    for q in qs:
        q.shutdown()
    for _ in range(len(keys) + 1):
        outs = [q.get(timeout=1.0) for q in qs]
        assert outs[0] == outs[1] == outs[2], outs
        if outs[0] is None:
            break
    assert outs == [None] * 3


def test_expectations_soup_matches_python_and_jax_native():
    rng = random.Random(77)
    load_jax_native()
    jq = importlib.import_module(f"{JAX}.native.queue")
    es = [NativeControllerExpectations(300.0), ControllerExpectations(300.0),
          jq.NativeControllerExpectations(300.0)]
    keys = [f"default/job-{i}" for i in range(6)]
    for step in range(2000):
        key = rng.choice(keys)
        x = rng.random()
        if x < 0.15:
            op = ("expect_creations", key, rng.randrange(0, 4))
        elif x < 0.25:
            op = ("expect_deletions", key, rng.randrange(0, 3))
        elif x < 0.45:
            op = ("creation_observed", key)
        elif x < 0.55:
            op = ("deletion_observed", key)
        elif x < 0.60:
            op = ("delete_expectations", key)
        elif x < 0.80:
            op = ("satisfied", key)
        else:
            op = ("pending", key)
        outs = [getattr(e, op[0])(*op[1:]) for e in es]
        outs = [tuple(o) if isinstance(o, list) else o for o in outs]
        assert outs[0] == outs[1] == outs[2], (step, op, outs)


def test_object_index_soup_matches_jax_native():
    """Upserts, removes, label churn, slice-health writes and the probe /
    commit / forget protocol, both probes, on the port's index and the JAX
    package's: every count, bucket, probe decision and counter equal."""
    from kubeflow_controller_tpu_torch.native.objindex import NativeObjectIndex

    load_jax_native()
    jix = importlib.import_module(f"{JAX}.native.objindex")
    ixs = [NativeObjectIndex(), jix.NativeObjectIndex()]
    rng = random.Random(0xBEEF)
    kinds = ("Pod", "Service")
    lks = ("tpu.kubeflow.dev/job", "tpu.kubeflow.dev/lmservice")
    objs = [f"default/obj-{i}" for i in range(30)]
    jobs = [f"default/owner-{i}" for i in range(5)]
    slices = [f"slice-{i}" for i in range(6)]
    rv = 0
    for step in range(3000):
        x = rng.random()
        if x < 0.35:
            rv += 1
            labels = {lk: f"owner-{rng.randrange(5)}" for lk in lks
                      if rng.random() < 0.6}
            op = ("upsert", rng.choice(kinds), rng.choice(objs), f"u{rv % 7}",
                  rv, rng.randrange(1, 3), labels)
        elif x < 0.45:
            op = ("remove", rng.choice(kinds), rng.choice(objs))
        elif x < 0.50:
            op = ("slice_set", f"uid-{rng.randrange(5)}", rng.choice(slices),
                  rng.random() < 0.7)
        elif x < 0.53:
            op = ("slice_clear", f"uid-{rng.randrange(5)}", rng.choice(slices))
        elif x < 0.60:
            op = ("count", rng.choice(kinds))
        elif x < 0.65:
            op = ("bucket_count", rng.choice(kinds), rng.choice(lks))
        elif x < 0.72:
            op = ("bucket", rng.choice(kinds), rng.choice(lks),
                  f"owner-{rng.randrange(5)}")
        elif x < 0.82:
            j = rng.randrange(5)
            op = ("fp_probe", jobs[j], f"ju{j}|{rv // 50}|1", "default",
                  "Pod", lks[0], f"owner-{j}", "Service", lks[0], f"owner-{j}",
                  rng.choice(["-", "h0", "h1"]))
        elif x < 0.90:
            j = rng.randrange(5)
            op = ("fp_probe_mirrored", jobs[j], f"ju{j}|{rv // 50}|1", "default",
                  "Pod", lks[0], f"owner-{j}", "", "", "", f"uid-{j}",
                  rng.random() < 0.8)
        elif x < 0.96:
            op = ("fp_commit", rng.choice(jobs))
        elif x < 0.98:
            op = ("fp_forget", rng.choice(jobs))
        else:
            op = ("fp_counts",)
        outs = [getattr(ix, op[0])(*op[1:]) for ix in ixs]
        if op[0] == "bucket":
            outs = [sorted(o) for o in outs]
        assert outs[0] == outs[1], (step, op, outs)
    hits, misses = ixs[0].fp_counts()
    assert hits > 0 and misses > 0


def test_backoff_delay_bit_identical_across_packages():
    """``wq_backoff_delay`` of the port's library, of the JAX package's, and
    both packages' Python ``backoff_delay``: the same double, bit for bit."""
    import struct

    from kubeflow_controller_tpu_torch.native.queue import native_backoff_delay

    load_jax_native()
    jq = importlib.import_module(f"{JAX}.native.queue")
    jwq = importlib.import_module(f"{JAX}.controller.workqueue")
    rng = random.Random(5)
    keys = TestBackoffDelay.KEYS + [f"ns/job-{rng.randrange(10**6)}"
                                   for _ in range(20)]
    failures = TestBackoffDelay.FAILURES + [rng.randrange(0, 64) for _ in range(20)]
    for base, cap in ((0.005, 60.0), (0.01, 1.0), (0.02, 300.0), (1e-6, 1e6)):
        for key in keys:
            for f in failures:
                got = [native_backoff_delay(base, cap, key, f),
                       jq.native_backoff_delay(base, cap, key, f),
                       backoff_delay(base, cap, key, f),
                       jwq.backoff_delay(base, cap, key, f)]
                bits = {struct.pack("<d", d) for d in got}
                assert len(bits) == 1, (base, cap, key, f, got)


def test_python_paths_without_the_library_under_tpujob_native_0():
    """``TPUJOB_NATIVE=0``: the loader reports why, ``make_queue`` and
    ``make_expectations`` give the Python classes, and nothing is built."""
    code = (
        "from kubeflow_controller_tpu_torch import native\n"
        "from kubeflow_controller_tpu_torch.native.queue import (\n"
        "    make_expectations, make_queue)\n"
        "assert native.load() is None and not native.available()\n"
        "assert native.load_error() == 'TPUJOB_NATIVE=0'\n"
        "assert type(make_queue()).__name__ == 'RateLimitingQueue'\n"
        "assert type(make_expectations()).__name__ == 'ControllerExpectations'\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "TPUJOB_NATIVE": "0"},
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_failed_build_leaves_no_library_and_reports_why(tmp_path, monkeypatch):
    """A source the compiler refuses: ``build`` raises with its output,
    leaves neither the library nor its temporary file, and ``load`` returns
    None with the error kept for the caller that asked for the core."""
    bad = tmp_path / "tpujob_native.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert os.listdir(tmp_path / "_build") == []
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "_error", "")
    assert native.load() is None and "failed" in native.load_error()
    from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster

    with pytest.raises(RuntimeError, match="native object index"):
        FakeCluster(use_native_index=True)
