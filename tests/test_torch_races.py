"""The mirror of ``tests/test_races.py`` on the port: seeded multi-thread
stress runs over the control plane's shared structures in
``kubeflow_controller_tpu_torch`` (the object store and its watch
pipeline, the workqueue and expectations in Python and in the port's C++
core, the slice pool, the informer), each end state checked against the
structure's invariants.

Every case and seed of the reference file is kept. Where threads decide
the outcome the port is held to the invariant the reference asserts;
where one thread does (the coalescing and tombstone white-box cases,
the single-threaded overflow recovery, the frozen replay, a re-add
during processing) the same calls also go through the JAX package and
the outcomes are compared. The native queue and expectations are the
port's own (``kubeflow_controller_tpu_torch/csrc/tpujob_native.cc``,
built with the host C++ compiler at first use). The control plane
imports no torch, so neither does this file.
"""

import importlib
import os
import threading
import types
from collections import Counter, defaultdict

import pytest

from kubeflow_controller_tpu_torch.api import core as port_core
from kubeflow_controller_tpu_torch.cluster.slices import (
    InsufficientCapacity, SlicePool,
)
from kubeflow_controller_tpu_torch.cluster.store import Conflict, NotFound, ObjectStore

SEEDS = range(3)
PACKAGES = ("kubeflow_controller_tpu", "kubeflow_controller_tpu_torch")


def _mods(pkg):
    imp = importlib.import_module
    return types.SimpleNamespace(core=imp(f"{pkg}.api.core"),
                                 store=imp(f"{pkg}.cluster.store"))


def make_pod(name, labels=None, core=port_core):
    return core.Pod(metadata=core.ObjectMeta(
        name=name, namespace="default", labels=labels or {},
    ), spec=core.PodSpec(containers=[core.Container(name="c")]))


def run_threads(fns):
    errors = []

    def wrap(fn):
        def go():
            try:
                fn()
            except Exception as e:  # surfaced after join
                errors.append(e)
        return go

    threads = [threading.Thread(target=wrap(fn)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "worker thread hung"
    if errors:
        raise errors[0]


def both(fn):
    """``fn(modules)`` on the JAX package and on the port; the port's
    outcome, after checking that it equals the JAX package's."""
    want, got = (fn(_mods(pkg)) for pkg in PACKAGES)
    assert got == want
    return got


class TestStoreRaces:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_concurrent_mutations_keep_index_and_rv_consistent(self, seed):
        import random

        store = ObjectStore("Pod", index_labels=("job",))
        jobs = [f"j{i}" for i in range(4)]
        for i in range(20):
            store.create(make_pod(f"p{i}", labels={"job": jobs[i % 4]}))

        events = []
        ev_lock = threading.Lock()

        def listener(ev):
            with ev_lock:
                events.append((ev.type.value, ev.obj.metadata.name,
                               ev.obj.metadata.resource_version))

        store.subscribe(listener, replay=False)

        def worker(wid):
            rng = random.Random(seed * 100 + wid)

            def go():
                for n in range(120):
                    op = rng.random()
                    name = f"p{rng.randrange(30)}"
                    try:
                        if op < 0.35:
                            store.mutate(
                                "default", name,
                                lambda p: p.metadata.labels.__setitem__(
                                    "job", rng.choice(jobs)),
                            )
                        elif op < 0.5:
                            store.create(make_pod(name, labels={"job": rng.choice(jobs)}))
                        elif op < 0.6:
                            store.delete("default", name)
                        elif op < 0.8:
                            cur = store.try_get("default", name)
                            if cur is not None:
                                cur.metadata.labels["job"] = rng.choice(jobs)
                                store.update(cur)
                        else:
                            store.list("default", {"job": rng.choice(jobs)})
                    except (NotFound, Conflict, Exception) as e:
                        if not isinstance(
                            e, (NotFound, Conflict)
                        ) and "AlreadyExists" not in type(e).__name__:
                            raise
            return go

        run_threads([worker(w) for w in range(6)])

        actual = store.list()
        for job in jobs:
            via_index = {p.metadata.name for p in store.list(None, {"job": job})}
            ground = {p.metadata.name for p in actual
                      if p.metadata.labels.get("job") == job}
            assert via_index == ground, (job, via_index ^ ground)
        rvs = [p.metadata.resource_version for p in actual]
        assert len(rvs) == len(set(rvs))
        assert max(rvs, default=0) <= store.revision
        per_key = defaultdict(list)
        for etype, name, rv in events:
            per_key[name].append((rv, etype))
        for name, seq in per_key.items():
            rv_seq = [rv for rv, _ in seq]
            assert rv_seq == sorted(rv_seq), (name, seq)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_conflicting_updates_never_lose_writes(self, seed):
        """N threads each win some conflict-retried increments; the final
        counter equals the number of successful updates."""
        import random

        store = ObjectStore("Pod")
        store.create(make_pod("ctr", labels={"n": "0"}))
        wins = Counter()

        def worker(wid):
            rng = random.Random(seed * 10 + wid)

            def go():
                for _ in range(60):
                    while True:
                        cur = store.get("default", "ctr")
                        cur.metadata.labels["n"] = str(int(cur.metadata.labels["n"]) + 1)
                        try:
                            store.update(cur)
                            wins[wid] += 1
                            break
                        except Conflict:
                            if rng.random() < 0.01:
                                pass  # tiny jitter via branch
            return go

        run_threads([worker(w) for w in range(4)])
        final = int(store.get("default", "ctr").metadata.labels["n"])
        assert final == sum(wins.values()) == 240


def _queue_module(native, monkeypatch, pkg="kubeflow_controller_tpu_torch"):
    monkeypatch.setenv("TPUJOB_NATIVE", native)
    if native == "1":
        if pkg == PACKAGES[0]:
            from test_torch_native import load_jax_native

            load_jax_native()
        if not importlib.import_module(f"{pkg}.native").available():
            pytest.skip("native library unavailable")
    return importlib.import_module(f"{pkg}.native.queue")


@pytest.mark.parametrize("native", ["0", "1"])
class TestQueueRaces:
    def _queue(self, native, monkeypatch, pkg="kubeflow_controller_tpu_torch"):
        q = _queue_module(native, monkeypatch, pkg).make_queue()
        assert (type(q).__name__ == "NativeRateLimitingQueue") == (native == "1")
        return q

    @pytest.mark.parametrize("seed", SEEDS)
    def test_no_lost_keys_no_double_processing(self, seed, native, monkeypatch):
        import random

        q = self._queue(native, monkeypatch)
        keys = [f"k{i}" for i in range(40)]
        target = {k: 3 for k in keys}   # each key added 3 times total
        in_flight = set()
        fl_lock = threading.Lock()
        processed = Counter()
        done_adding = threading.Event()

        def producer(wid):
            rng = random.Random(seed * 7 + wid)

            def go():
                mine = [k for i, k in enumerate(keys) if i % 3 == wid]
                adds = [k for k in mine for _ in range(3)]
                rng.shuffle(adds)
                for k in adds:
                    q.add(k)
            return go

        def consumer():
            def go():
                while True:
                    item = q.get(timeout=0.2)
                    if item is None:
                        if done_adding.is_set():
                            return
                        continue
                    with fl_lock:
                        # a key is never handed to two workers at once
                        assert item not in in_flight, item
                        in_flight.add(item)
                    processed[item] += 1
                    with fl_lock:
                        in_flight.discard(item)
                    q.done(item)
            return go

        producers = [producer(w) for w in range(3)]
        consumers = [consumer() for _ in range(4)]
        threads = [threading.Thread(target=f) for f in producers + consumers]
        for t in threads[:3]:
            t.start()
        for t in threads[3:]:
            t.start()
        for t in threads[:3]:
            t.join(timeout=30)
        done_adding.set()
        for t in threads[3:]:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for k in keys:
            assert 1 <= processed[k] <= target[k], (k, processed[k])

    @pytest.mark.parametrize("seed", SEEDS)
    def test_readd_during_processing_requeues(self, seed, native, monkeypatch):
        seen = []
        for pkg in PACKAGES:
            q = self._queue(native, monkeypatch, pkg)
            q.add("x")
            got = [q.get(timeout=1)]
            racer = threading.Thread(target=lambda: q.add("x"))
            racer.start()
            racer.join()
            q.done("x")
            got.append(q.get(timeout=1))       # the re-add survived
            q.done("x")
            got.append(q.get(timeout=0.05))
            seen.append(got)
        assert seen[1] == ["x", "x", None]
        assert seen[1] == seen[0]


@pytest.mark.parametrize("native", ["0", "1"])
class TestExpectationRaces:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_concurrent_observations_never_go_negative(self, seed, native, monkeypatch):
        exp = _queue_module(native, monkeypatch).make_expectations()
        assert (type(exp).__name__ == "NativeControllerExpectations") == (native == "1")
        key = "default/job"
        exp.expect_creations(key, 64)

        def observer():
            def go():
                for _ in range(16):
                    exp.creation_observed(key)
            return go

        run_threads([observer() for _ in range(4)])
        # exactly fulfilled: satisfied, and further observes keep it so
        assert exp.satisfied(key)
        exp.creation_observed(key)
        assert exp.satisfied(key)


class TestSlicePoolRaces:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_gang_allocation_never_double_assigns(self, seed):
        import random

        pool = SlicePool()
        pool.add_pool("v5e-8", 12)
        jobs = [f"uid-{i}" for i in range(8)]
        stop = threading.Event()

        def worker(wid):
            rng = random.Random(seed * 31 + wid)

            def go():
                for _ in range(150):
                    uid = rng.choice(jobs)
                    op = rng.random()
                    try:
                        if op < 0.5:
                            got = pool.allocate_gang(uid, "v5e-8", rng.randrange(1, 4))
                            for s in got:
                                assert s.holder == uid
                        elif op < 0.8:
                            pool.release(uid)
                        elif op < 0.9:
                            name = rng.choice(pool.list("v5e-8")).name
                            pool.preempt(name)
                            pool.restore(name)
                        else:
                            pool.holdings(uid)
                    except InsufficientCapacity:
                        pass
            return go

        run_threads([worker(w) for w in range(6)])
        stop.set()
        slices = pool.list("v5e-8")
        assert len(slices) == 12
        free_names = {s.name for s in pool.free("v5e-8")}
        for s in slices:
            if s.holder:
                assert s.name not in free_names, s.name
            elif s.healthy:
                assert s.name in free_names, s.name
        for uid in jobs:
            via_index = {s.name for s in pool.holdings(uid)}
            ground = {s.name for s in slices if s.holder == uid}
            assert via_index == ground, (uid, via_index ^ ground)


class TestWatchPipelineRaces:
    """The async watch pipeline (per-subscriber delta queues, off-lock
    coalescing dispatch) under a concurrent writer + informer + resync
    storm: per-key ordering survives coalescing, and no delta is lost."""

    @pytest.mark.parametrize("seed", SEEDS)
    def test_concurrent_writers_informer_resync(self, seed):
        import random

        from kubeflow_controller_tpu_torch.controller.informer import Informer

        store = ObjectStore("Pod", index_labels=("job",), copy_on_read=False)
        jobs = [f"j{i}" for i in range(4)]

        raw_events = []
        raw_lock = threading.Lock()

        def raw_listener(ev):
            with raw_lock:
                raw_events.append((ev.obj.metadata.name, ev.obj.metadata.resource_version,
                                   ev.type.value))

        store.subscribe(raw_listener, replay=True)

        inf = Informer(store)
        inf_events = []
        inf_lock = threading.Lock()

        def handler(ev):
            with inf_lock:
                inf_events.append((ev.obj.metadata.name, ev.obj.metadata.resource_version,
                                   ev.type.value, ev.old_obj is ev.obj))  # resync marker

        inf.add_handler(handler)
        inf.start()

        def writer(wid):
            rng = random.Random(seed * 17 + wid)

            def go():
                for _ in range(120):
                    op = rng.random()
                    name = f"p{rng.randrange(24)}"
                    try:
                        if op < 0.4:
                            store.create(make_pod(name, labels={"job": rng.choice(jobs)}))
                        elif op < 0.8:
                            store.mutate(
                                "default", name,
                                lambda p: p.metadata.labels.__setitem__(
                                    "job", rng.choice(jobs)),
                            )
                        else:
                            store.delete("default", name)
                    except (NotFound, Exception) as e:
                        if not isinstance(e, NotFound) and (
                            "AlreadyExists" not in type(e).__name__
                        ):
                            raise
            return go

        def resyncer():
            def go():
                for _ in range(10):
                    inf.resync()
            return go

        run_threads([writer(w) for w in range(5)] + [resyncer()])
        assert store.flush(), "watch pipeline failed to quiesce"

        per_key = defaultdict(list)
        for name, rv, etype in raw_events:
            per_key[name].append((rv, etype))
        for name, seq in per_key.items():
            rv_seq = [rv for rv, _ in seq]
            assert rv_seq == sorted(rv_seq) and len(rv_seq) == len(set(rv_seq)), (name, seq)

        per_key_inf = defaultdict(list)
        for name, rv, etype, is_resync in inf_events:
            if not is_resync:
                per_key_inf[name].append((rv, etype))
        for name, seq in per_key_inf.items():
            rv_seq = [rv for rv, _ in seq]
            assert rv_seq == sorted(rv_seq) and len(rv_seq) == len(set(rv_seq)), (name, seq)

        live = {k.split("/", 1)[1]: store.try_get("default", k.split("/", 1)[1])
                for k in store.keys()}
        for events in (per_key, per_key_inf):
            for name, seq in events.items():
                last_rv, last_type = seq[-1]
                obj = live.get(name)
                if obj is not None:
                    assert last_type in ("ADDED", "MODIFIED"), (name, seq[-1])
                    assert last_rv == obj.metadata.resource_version, (
                        name, last_rv, obj.metadata.resource_version)
                else:
                    assert last_type == "DELETED", (name, seq[-1])
        for name, obj in live.items():
            cached = inf.get("default", name)
            assert cached is not None, name
            assert cached.metadata.resource_version == obj.metadata.resource_version, name

    def test_coalescing_collapses_bursts_deterministically(self):
        """White-box: park the dispatcher, burst N MODIFIEDs at one key,
        release: exactly one MODIFIED with the latest snapshot and the
        oldest undelivered old_obj is delivered; the same in both
        packages."""
        def run(m):
            store = m.store.ObjectStore("Pod", copy_on_read=False)
            store.create(make_pod("p0", labels={"n": "0"}, core=m.core))
            got = []
            store.subscribe(got.append, replay=False)
            sub = store._subs[-1]
            with sub.lock:
                sub.dispatching = True  # a busy dispatcher elsewhere
            n_before = store.events_coalesced
            for i in range(1, 6):
                store.mutate("default", "p0",
                             lambda p, i=i: p.metadata.labels.__setitem__("n", str(i)))
            with sub.lock:
                sub.dispatching = False
            assert store.flush()
            return ([(e.type.value, e.obj.metadata.labels["n"], e.old_obj.metadata.labels["n"],
                      e.obj.metadata.resource_version) for e in got],
                    store.events_coalesced - n_before, store.max_watch_queue_depth)

        got, coalesced, depth = both(run)
        assert len(got) == 1, got
        kind, n, old_n, _ = got[0]
        assert kind == "MODIFIED"
        assert n == "5"          # latest snapshot
        assert old_n == "0"      # oldest undelivered
        assert coalesced == 4
        assert depth >= 1

    def test_delete_never_coalesces_across_tombstone(self):
        """A DELETED pins the queue: a recreate arrives as its own ADDED,
        never merged into the dead entry."""
        def run(m):
            store = m.store.ObjectStore("Pod", copy_on_read=False)
            store.create(make_pod("p0", core=m.core))
            got = []
            store.subscribe(got.append, replay=False)
            sub = store._subs[-1]
            with sub.lock:
                sub.dispatching = True
            store.mutate("default", "p0", lambda p: p.metadata.labels.__setitem__("x", "1"))
            store.delete("default", "p0")
            store.create(make_pod("p0", core=m.core))
            store.mutate("default", "p0", lambda p: p.metadata.labels.__setitem__("x", "2"))
            with sub.lock:
                sub.dispatching = False
            assert store.flush()
            return ([e.type.value for e in got], dict(got[-1].obj.metadata.labels),
                    [e.obj.metadata.resource_version for e in got])

        kinds, labels, _ = both(run)
        assert kinds == ["MODIFIED", "DELETED", "ADDED"]
        assert labels["x"] == "2"   # the MODIFIED coalesced into the pending ADDED


class TestWatchOverflowResync:
    """Watch-queue overflow recovery: a bounded consumer sheds its buffer
    (drop every pending delta), reads ``store.revision`` as a floor,
    relists, then ignores deliveries at or below the floor and RV-guards
    the rest; the recovered cache converges with a lossless subscriber
    and the store."""

    @staticmethod
    def _apply(cache, lock, floor, ev):
        """RV-guarded incremental apply with a resync floor."""
        name = ev.obj.metadata.name
        rv = ev.obj.metadata.resource_version
        with lock:
            if rv <= floor[0]:
                return  # at/below the last relist snapshot: already covered
            if ev.type.value == "DELETED":
                if cache.get(name, -1) <= rv:
                    cache.pop(name, None)
            elif cache.get(name, -1) < rv:
                cache[name] = rv

    @staticmethod
    def _shed_and_relist(store, sub, cache, lock, floor):
        """Drop the overflowed buffer, then rebuild from the store (the
        floor read after the clear)."""
        with sub.lock:
            sub.pending.clear()
            sub.tail.clear()
        with lock:
            floor[0] = store.revision
            cache.clear()
            for obj in store.list():
                cache[obj.metadata.name] = obj.metadata.resource_version

    @staticmethod
    def _ground_truth(store):
        return {o.metadata.name: o.metadata.resource_version for o in store.list()}

    def test_overflowed_subscriber_sheds_relists_and_converges(self):
        def run(m):
            store = m.store.ObjectStore("Pod", copy_on_read=False, watch_queue_soft_max=4)
            for i in range(6):
                store.create(make_pod(f"p{i}", labels={"n": "0"}, core=m.core))
            lossless, ll_lock = {}, threading.Lock()
            lossy, lo_lock, floor = {}, threading.Lock(), [0]
            seen = []

            def ll(ev):
                self._apply(lossless, ll_lock, [0], ev)

            def lo(ev):
                self._apply(lossy, lo_lock, floor, ev)

            store.subscribe(ll, replay=True)
            store.subscribe(lo, replay=True)
            assert store.flush()
            assert lossy == lossless == self._ground_truth(store)
            seen.append(dict(lossy))

            sub = store._sub_by_listener[lo]
            with sub.lock:
                sub.dispatching = True
            n0 = store.watch_queue_overflows
            for i in range(6):
                store.mutate("default", f"p{i}",
                             lambda p: p.metadata.labels.__setitem__("n", "1"))
            store.delete("default", "p5")
            assert store.watch_queue_overflows > n0
            seen.append(store.watch_queue_overflows - n0)

            with sub.lock:
                sub.pending.clear()
                sub.tail.clear()
                sub.dispatching = False
            assert store.flush()
            assert lossy != lossless  # the divergence is real
            seen.append(dict(lossy))

            with sub.lock:
                sub.dispatching = True
            store.delete("default", "p0")                                  # queued @ R1
            store.create(make_pod("p0", labels={"n": "2"}, core=m.core))  # queued @ R2
            self._shed_and_relist(store, sub, lossy, lo_lock, floor)
            with sub.lock:
                sub.dispatching = False
            assert store.flush()
            assert lossy == lossless == self._ground_truth(store)
            seen.append(dict(lossy))

            store.mutate("default", "p1", lambda p: p.metadata.labels.__setitem__("n", "3"))
            store.create(make_pod("p9", core=m.core))
            store.delete("default", "p2")
            assert store.flush()
            assert lossy == lossless == self._ground_truth(store)
            seen.append(dict(lossy))
            return seen

        both(run)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_overflow_shed_relist_storm_converges(self, seed):
        """5 writers storm 24 keys while the lossy subscriber's dispatcher
        is parked and a shedder drops and relists whenever depth passes
        the bound; once released, the end state matches the lossless
        subscriber and the store."""
        import random
        import time as _time

        store = ObjectStore("Pod", copy_on_read=False, watch_queue_soft_max=8)
        for i in range(24):
            store.create(make_pod(f"p{i}", labels={"n": "0"}))

        lossless, ll_lock = {}, threading.Lock()
        lossy, lo_lock, floor = {}, threading.Lock(), [0]

        def ll(ev):
            self._apply(lossless, ll_lock, [0], ev)

        def lo(ev):
            self._apply(lossy, lo_lock, floor, ev)

        store.subscribe(ll, replay=True)
        store.subscribe(lo, replay=True)
        assert store.flush()

        sub = store._sub_by_listener[lo]
        with sub.lock:
            sub.dispatching = True  # bounded consumer wedged: queue grows
        stop = threading.Event()
        sheds = [0]

        def shedder():
            while not stop.is_set():
                with sub.lock:
                    overflowed = len(sub.pending) > 8
                if overflowed:
                    self._shed_and_relist(store, sub, lossy, lo_lock, floor)
                    sheds[0] += 1
                _time.sleep(0.0005)

        def writer(wid):
            rng = random.Random(seed * 23 + wid)

            def go():
                for _ in range(120):
                    op = rng.random()
                    name = f"p{rng.randrange(24)}"
                    try:
                        if op < 0.5:
                            store.mutate(
                                "default", name,
                                lambda p: p.metadata.labels.__setitem__(
                                    "n", str(rng.randrange(100))),
                            )
                        elif op < 0.8:
                            store.create(make_pod(name))
                        else:
                            store.delete("default", name)
                    except (NotFound, Exception) as e:
                        if not isinstance(e, NotFound) and (
                            "AlreadyExists" not in type(e).__name__
                        ):
                            raise
            return go

        shed_thread = threading.Thread(target=shedder)
        shed_thread.start()
        run_threads([writer(w) for w in range(5)])
        stop.set()
        shed_thread.join(timeout=30)
        assert not shed_thread.is_alive()
        # 24 live keys against a bound of 8: at least one shed and relist.
        assert sheds[0] >= 1
        assert store.watch_queue_overflows > 0

        with sub.lock:
            sub.dispatching = False
        assert store.flush()
        truth = self._ground_truth(store)
        assert lossless == truth
        assert lossy == truth


class TestReplayOffLock:
    """``subscribe(replay=True)`` takes only the snapshot under the store
    lock; the replay entries are enqueued off the write lock, and in
    frozen mode the replay is zero-copy."""

    def test_frozen_replay_is_zero_copy(self):
        def run(m):
            store = m.store.ObjectStore("Pod", copy_on_read=False, watch_shards=4)
            for i in range(100):
                store.create(make_pod(f"p{i:03d}", core=m.core))
            got = []
            dc0 = m.core.deepcopy_count()
            store.subscribe(lambda ev: got.append(ev.obj), replay=True)
            store.flush()
            copies = m.core.deepcopy_count() - dc0
            by_name = {o.metadata.name: o for o in got}
            same = all(by_name[f"p{i:03d}"] is store.try_get("default", f"p{i:03d}")
                       for i in range(100))
            return copies, len(got), same, sorted(by_name)

        copies, n, same, _ = both(run)
        assert copies == 0          # zero copies end to end
        assert n == 100
        assert same                 # the delivered object IS the snapshot

    def test_replay_races_writers_rv_monotonic(self):
        """Writers running beside ``subscribe(replay=True)`` are never
        blocked behind the replay loop, and the subscriber observes
        per-key rv-monotonic order converging on the final state."""
        store = ObjectStore("Pod", copy_on_read=False, watch_shards=4)
        names = [f"p{i:02d}" for i in range(40)]
        for n in names:
            store.create(make_pod(n))

        seen = defaultdict(list)
        seen_lock = threading.Lock()

        def listener(ev):
            with seen_lock:
                seen[ev.obj.metadata.name].append(ev.obj.metadata.resource_version)

        stop = threading.Event()

        def writer(idx):
            k = 0
            while not stop.is_set():
                n = names[(idx * 7 + k) % len(names)]
                k += 1
                try:
                    cur = store.try_get("default", n)
                    if cur is None:
                        continue
                    upd = cur.deepcopy()
                    upd.metadata.labels["w"] = f"{idx}-{k}"
                    store.update(upd)
                except (Conflict, NotFound):
                    continue

        def subscriber():
            store.subscribe(listener, replay=True)

        def stopper():
            # let the writers overlap the replay window, then stop them
            threading.Event().wait(0.2)
            stop.set()

        run_threads([lambda i=i: writer(i) for i in range(4)] + [subscriber, stopper])
        assert store.flush()

        final = {n: store.try_get("default", n).metadata.resource_version for n in names}
        for n in names:
            rvs = seen[n]
            assert rvs, f"{n} never replayed"
            assert rvs == sorted(rvs), f"{n} out of order: {rvs}"
            assert len(set(rvs)) == len(rvs), f"{n} duplicated: {rvs}"
            assert rvs[-1] == final[n]


def test_chaos_soak_pointer():
    """The end-to-end concurrency storm (controller + informers + REST +
    scheduler threads) on the port lives in tests/test_torch_chaos.py;
    this file is the structure-level complement."""
    assert os.path.exists(os.path.join(os.path.dirname(__file__), "test_torch_chaos.py"))
