"""The port's control-plane units against the JAX package's classes, op
for op: seeded operation soups run step by step through both, and every
return value and every state read after each step must be equal.

Units: the workqueue (dedup, re-add while processing, rate-limited
backoff, delays on an injected clock, shutdown, sharded routing), the
expectations cache (with its TTL), ``claim_objects``, the ``ObjectStore``
(create, update with conflicts, mutate, delete, watch, label index,
frozen reads), the ``SlicePool``, the ``EventAggregator`` and the
``Informer`` with an ``informer.deliver`` hang through each package's own
``FaultInjector``, healed by a resync. The copy-on-write contract of
``tests/test_cow_store.py`` and ``tests/test_deepcopy.py`` is held by
the port's store and objects as parametrised cases at the end.

The control plane imports no torch, so neither does this file.
"""

import copy
import dataclasses
import enum
import importlib
import random
import re
import types as pytypes

import pytest

PACKAGES = ("kubeflow_controller_tpu", "kubeflow_controller_tpu_torch")
_UID = re.compile(r"\b[a-z]+-\d{8}-[0-9a-f]{4}\b")


def _mods(pkg: str) -> pytypes.SimpleNamespace:
    imp = importlib.import_module
    return pytypes.SimpleNamespace(
        pkg=pkg,
        core=imp(f"{pkg}.api.core"),
        types=imp(f"{pkg}.api.types"),
        events=imp(f"{pkg}.cluster.events"),
        store=imp(f"{pkg}.cluster.store"),
        slices=imp(f"{pkg}.cluster.slices"),
        recorder=imp(f"{pkg}.cluster.event_recorder"),
        wq=imp(f"{pkg}.controller.workqueue"),
        exp=imp(f"{pkg}.controller.expectations"),
        claim=imp(f"{pkg}.controller.claim"),
        informer=imp(f"{pkg}.controller.informer"),
        faults=imp(f"{pkg}.dataplane.faults"),
    )


JAX, PORT = _mods(PACKAGES[0]), _mods(PACKAGES[1])


class Norm:
    """Objects of either package as plain data; uids by first appearance."""

    def __init__(self):
        self.uids = {}

    def __call__(self, v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: self(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, enum.Enum):
            return v.value
        if isinstance(v, dict):
            return {self(k): self(x)
                    for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))}
        if isinstance(v, (list, tuple)):
            return [self(x) for x in v]
        if isinstance(v, str):
            return _UID.sub(lambda mt: self.uids.setdefault(
                mt.group(0), f"<uid{len(self.uids)}>"), v)
        return v


def _call(norm, fn, *args, **kw):
    try:
        return ("ok", norm(fn(*args, **kw)))
    except Exception as e:  # compared, not swallowed
        return ("raises", type(e).__name__)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


def _lockstep(ops, make_state, apply_op, read_state):
    """Run ``ops`` on a JAX state and a port state; after each op the
    results and the read states must be equal."""
    sides = [(m, Norm(), make_state(m)) for m in (JAX, PORT)]
    for i, op in enumerate(ops):
        out = [(apply_op(m, st, op, norm), norm(read_state(m, st)))
               for m, norm, st in sides]
        assert out[0] == out[1], (i, op, out)


# -- workqueue ---------------------------------------------------------------

ITEMS = ["a", "b", "c", "d", "default/job-1"]


def _queue_ops(seed, n=400, sharded=False):
    r = random.Random(seed)
    ops = []
    for _ in range(n):
        x = r.random()
        it = r.choice(ITEMS)
        if x < 0.22:
            ops.append(("add", it))
        elif x < 0.32:
            ops.append(("add_after", it, r.choice([0.0, 0.003, 0.5, 2.0])))
        elif x < 0.42:
            ops.append(("add_rate_limited", it))
        elif x < 0.47:
            ops.append(("forget", it))
        elif x < 0.50:
            ops.append(("num_requeues", it))
        elif x < 0.70:
            ops.append(("get",))
        elif x < 0.85:
            ops.append(("done", it))
        else:
            ops.append(("advance", r.choice([0.001, 0.01, 0.4, 1.0, 3.0])))
    ops.append(("shutdown",))
    ops += [("add", "a"), ("get",), ("len",)]
    return ops


@pytest.fixture
def fake_clocks(monkeypatch):
    """One injected clock per package's workqueue module."""
    clocks = {}
    for m in (JAX, PORT):
        clocks[m.pkg] = FakeClock()
        monkeypatch.setattr(m.wq, "time", clocks[m.pkg])
    return clocks


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "sharded"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_workqueue_soup(fake_clocks, seed, sharded):
    def make(m):
        q = (m.wq.ShardedRateLimitingQueue(3) if sharded
             else m.wq.RateLimitingQueue(base_delay=0.005, max_delay=1.0))
        return pytypes.SimpleNamespace(q=q, clock=fake_clocks[m.pkg])

    def apply(m, st, op, norm):
        name, *a = op
        if name == "advance":
            st.clock.t += a[0]
            return None
        if name == "get":
            return _call(norm, st.q.get, timeout=0)
        if name == "len":
            return len(st.q)
        return _call(norm, getattr(st.q, name), *a)

    def read(m, st):
        return [len(st.q), st.q.empty_and_idle(),
                [st.q.num_requeues(i) for i in ITEMS]]

    _lockstep(_queue_ops(seed, sharded=sharded), make, apply, read)


def test_workqueue_dedup_and_readd_while_processing():
    def run(m):
        q = m.wq.RateLimitingQueue()
        q.add("a"); q.add("a"); q.add("b")
        out = [q.get(timeout=0)]
        q.add("a")                          # re-add while processing
        out += [q.get(timeout=0), len(q)]
        q.done("a")
        out += [q.get(timeout=0), q.get(timeout=0)]
        return out
    assert run(JAX) == run(PORT) == ["a", "b", 0, "a", None]


def test_backoff_delay_and_fnv_equal():
    r = random.Random(7)
    for _ in range(2000):
        item = r.choice(ITEMS + [r.randint(0, 10 ** 6), "x" * r.randint(0, 9)])
        f = r.randint(0, 80)
        base, cap = r.choice([0.005, 0.05, 1.0]), r.choice([1.0, 60.0, 300.0])
        assert (JAX.wq.backoff_delay(base, cap, item, f)
                == PORT.wq.backoff_delay(base, cap, item, f))
        assert JAX.wq.fnv1a_32(item) == PORT.wq.fnv1a_32(item)
    for n in (1, 2, 3, 8):
        jq, pq = (m.wq.ShardedRateLimitingQueue(n) for m in (JAX, PORT))
        for item in ITEMS + [f"ns/job-{i}" for i in range(50)]:
            assert jq.shards.index(jq._shard(item)) == \
                pq.shards.index(pq._shard(item))


# -- expectations ------------------------------------------------------------


@pytest.mark.parametrize("ttl", [1e9, -1.0], ids=["live", "expired"])
@pytest.mark.parametrize("seed", [0, 1])
def test_expectations_soup(seed, ttl):
    r = random.Random(seed)
    keys = ["ns/a", "ns/b", "lmsvc:ns/c"]
    ops = []
    for _ in range(300):
        k = r.choice(keys)
        ops.append(r.choice([
            ("expect_creations", k, r.randint(0, 3)),
            ("expect_deletions", k, r.randint(0, 2)),
            ("creation_observed", k), ("creation_observed", k),
            ("deletion_observed", k),
            ("satisfied", k), ("pending", k),
            ("delete_expectations", k),
        ]))

    def apply(m, st, op, norm):
        return _call(norm, getattr(st, op[0]), *op[1:])

    def read(m, st):
        return [(k, st.satisfied(k), st.pending(k)) for k in keys]

    _lockstep(ops, lambda m: m.exp.ControllerExpectations(ttl), apply, read)


# -- claim_objects -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_claim_objects_soup(seed):
    r = random.Random(seed)
    specs = []
    for i in range(12):
        specs.append({
            "name": f"p{i}",
            "labels": r.choice([{"job": "j"}, {"job": "j", "x": "1"},
                                {"job": "k"}, {}]),
            "owner": r.choice([None, "self", "other"]),
            "fail": r.random() < 0.2,
        })
    deleting = seed % 2 == 1

    def run(m):
        norm = Norm()
        c, t = m.core, m.types
        job = t.TPUJob(metadata=c.ObjectMeta(name="j", namespace="default",
                                             uid="tpujob-00000001-0000"))
        if deleting:
            job.metadata.deletion_timestamp = 5.0
        pods = []
        for s in specs:
            p = c.Pod(metadata=c.ObjectMeta(name=s["name"],
                                            namespace="default",
                                            labels=dict(s["labels"])))
            if s["owner"] is not None:
                uid = (job.metadata.uid if s["owner"] == "self"
                       else "tpujob-00000002-0000")
                p.metadata.owner_references.append(c.OwnerReference(
                    api_version="v1", kind="TPUJob", name="x", uid=uid))
            pods.append(p.freeze())
        updates = []

        def update(obj):
            updates.append(norm(obj))
            if next(s for s in specs if s["name"] == obj.metadata.name)["fail"]:
                raise RuntimeError("conflict")
            return obj

        claimed = m.claim.claim_objects(job, {"job": "j"}, pods, update)
        return norm(claimed), updates

    assert run(JAX) == run(PORT)


# -- ObjectStore -------------------------------------------------------------

NAMES = [f"p{i}" for i in range(5)]


def _store_ops(seed, n=300):
    r = random.Random(seed)
    ops = [("subscribe", True)]
    for _ in range(n):
        nm = r.choice(NAMES)
        x = r.random()
        if x < 0.25:
            ops.append(("create", nm, r.choice(["j", "k"])))
        elif x < 0.40:
            ops.append(("update", nm, r.choice(["Running", "Failed"])))
        elif x < 0.48:
            ops.append(("update_stale", nm))
        elif x < 0.58:
            ops.append(("mutate", nm, r.choice(["x", "y"])))
        elif x < 0.63:
            ops.append(("update_status", nm))
        elif x < 0.72:
            ops.append(("delete", nm))
        elif x < 0.80:
            ops.append(("get", nm))
        elif x < 0.90:
            ops.append(("list", r.choice([None, {"job": "j"}, {"job": "k"},
                                          {"job": "j", "role": "w"}])))
        elif x < 0.95:
            ops.append(("frozen_write", nm))
        else:
            ops.append(("subscribe", r.random() < 0.5))
    return ops


@pytest.mark.parametrize("seed", range(3))
def test_object_store_soup(seed):
    def make(m):
        clock = FakeClock()
        st = pytypes.SimpleNamespace(
            store=m.store.ObjectStore(
                "Pod", now_fn=clock.time, index_labels=("job",),
                copy_on_read=False, watch_shards=4),
            clock=clock, seen=[], stale={})
        return st

    def pod(m, name, job):
        c = m.core
        return c.Pod(metadata=c.ObjectMeta(
            name=name, namespace="default",
            labels={"job": job, "role": "w"}),
            spec=c.PodSpec(containers=[c.Container(name="t", image="i")]))

    def apply(m, st, op, norm):
        s, name = st.store, op[0]
        st.clock.t += 1.0
        if name == "subscribe":
            def listener(ev, seen=st.seen):
                seen.append((ev.type.value, ev.obj.metadata.name,
                             ev.obj.metadata.resource_version,
                             m.core.is_frozen(ev.obj),
                             None if ev.old_obj is None
                             else ev.old_obj.metadata.resource_version))
            s.subscribe(listener, replay=op[1])
            return len(st.seen)
        if name == "create":
            out = _call(norm, s.create, pod(m, op[1], op[2]))
            cur = s.try_get("default", op[1])
            if cur is not None:
                st.stale.setdefault(op[1], m.core.thaw(cur))
            return out
        if name == "update":
            cur = s.try_get("default", op[1])
            if cur is None:
                return _call(norm, s.update, pod(m, op[1], "j"))
            obj = m.core.thaw(cur)
            st.stale[op[1]] = m.core.thaw(cur)
            obj.status.phase = m.core.PodPhase(op[2])
            return _call(norm, s.update, obj)
        if name == "update_stale":
            if op[1] not in st.stale:
                return None
            obj = st.stale[op[1]].deepcopy()
            obj.status.reason = "stale"
            return _call(norm, s.update, obj)
        if name == "mutate":
            return _call(norm, s.mutate, "default", op[1],
                         lambda p: p.metadata.annotations.__setitem__(
                             "k", op[2]))
        if name == "update_status":
            cur = s.try_get("default", op[1])
            if cur is None:
                return None
            obj = m.core.thaw(cur)
            obj.status.message = "status"
            return _call(norm, s.update_status, obj)
        if name == "delete":
            st.stale.pop(op[1], None)
            return _call(norm, s.delete, "default", op[1])
        if name == "get":
            return [_call(norm, s.get, "default", op[1]),
                    _call(norm, s.try_get, "default", op[1])]
        if name == "list":
            got = s.list("default", op[1])
            return [all(m.core.is_frozen(o) for o in got),
                    sorted(norm(o)["metadata"]["name"] for o in got)]
        if name == "frozen_write":
            cur = s.try_get("default", op[1])
            if cur is None:
                return None
            try:
                cur.metadata.labels["hack"] = "1"
            except m.core.FrozenObjectError:
                return "refused"
            return "accepted"
        raise ValueError(op)

    def read(m, st):
        s = st.store
        s.flush()
        return [s.revision, s.last_delete_revision, sorted(s.keys()),
                [norm_obj for norm_obj in
                 sorted((o.metadata.name, o.metadata.resource_version,
                         o.metadata.generation, o.status.phase.value,
                         dict(o.metadata.annotations), o.status.reason)
                        for o in s.list())],
                list(st.seen)]

    _lockstep(_store_ops(seed), make, apply, read)


# -- SlicePool ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_slice_pool_soup(seed):
    r = random.Random(seed)
    holders = ["u1", "u2", "u3"]
    types_ = ["v5p-8", "v5e-16", "v4-8"]
    ops = [("add_pool", "v5p-8", 3), ("add_pool", "v5e-16", 2)]
    for _ in range(300):
        x = r.random()
        if x < 0.05:
            ops.append(("add_pool", r.choice(types_), r.randint(0, 2)))
        elif x < 0.40:
            ops.append(("allocate_gang", r.choice(holders),
                        r.choice(types_), r.randint(1, 3)))
        elif x < 0.52:
            ops.append(("release", r.choice(holders)))
        elif x < 0.62:
            ops.append(("preempt", r.randint(0, 6)))
        elif x < 0.72:
            ops.append(("mark_unhealthy", r.randint(0, 6)))
        elif x < 0.85:
            ops.append(("restore", r.randint(0, 6)))
        else:
            ops.append(("free", r.choice(types_)))

    def names(pool):
        return sorted(s.name for s in pool.list())

    def apply(m, pool, op, norm):
        name, *a = op
        if name in ("preempt", "mark_unhealthy", "restore"):
            ns = names(pool)
            if not ns:
                return None
            return _call(norm, getattr(pool, name), ns[a[0] % len(ns)])
        if name in ("allocate_gang", "free"):
            got = _call(lambda v: v, getattr(pool, name), *a)
            return got if got[0] == "raises" else \
                ("ok", [s.name for s in got[1]])
        return _call(norm, getattr(pool, name), *a)

    def read(m, pool):
        return [[(s.name, s.shape.accelerator_type, s.holder, s.healthy,
                  list(s.hosts)) for s in pool.list()],
                {h: [s.name for s in pool.holdings(h)] for h in holders},
                {t: [s.name for s in pool.free(t)] for t in types_}]

    _lockstep(ops, lambda m: m.slices.SlicePool(), apply, read)


# -- EventAggregator -----------------------------------------------------------


def test_event_aggregator_soup():
    r = random.Random(3)
    ops = []
    t = 0.0
    for _ in range(600):
        t += r.choice([0.0, 0.5, 5.0, 400.0])
        ops.append(("observe", "default", r.choice(["TPUJob", "Pod"]),
                    r.choice(["a", "b"]), r.choice(["R1", "R2"]),
                    f"msg {r.randint(0, 14)}", t))

    def apply(m, agg, op, norm):
        obs = agg.observe(*op[1:])
        if obs is None:
            return None
        return [obs.created, obs.message, list(obs.key), obs.record.count,
                obs.record.first_ts, obs.record.last_ts]

    def read(m, agg):
        return None

    _lockstep(ops, lambda m: m.recorder.EventAggregator(), apply, read)


# -- Informer with an informer.deliver hang ------------------------------------


@pytest.mark.parametrize("plan", [
    {"specs": [{"kind": "hang", "site": "informer.deliver",
                "max_fires": 3}]},
    {"specs": [{"kind": "hang", "site": "informer.deliver", "prob": 0.4}]},
    {"specs": [{"kind": "hang", "site": "informer.deliver", "target": "Pod",
                "after": 4.0, "until": 9.0}]},
    {"specs": [{"kind": "drop_migration", "site": "informer.deliver"}]},
], ids=["max_fires", "prob", "window", "other_kind"])
def test_informer_deliver_hang_then_resync_heals(plan):
    r = random.Random(11)
    ops = []
    for _ in range(120):
        nm = r.choice(NAMES)
        ops.append(r.choice([("create", nm), ("touch", nm), ("delete", nm),
                             ("tick",), ("resync",), ("read", nm)]))
    ops.append(("resync",))

    def make(m):
        clock = FakeClock()
        clock.t = 0.0
        store = m.store.ObjectStore("Pod", now_fn=clock.time,
                                    index_labels=("job",),
                                    copy_on_read=False)
        inj = m.faults.FaultInjector(m.faults.FaultPlan.from_dict(plan),
                                     clock=clock.time, seed=5)
        inf = m.informer.Informer(store, injector=inj)
        seen = []
        inf.add_handler(lambda ev: seen.append(
            (ev.type.value, ev.obj.metadata.name,
             ev.obj.metadata.resource_version)))
        inf.start()
        return pytypes.SimpleNamespace(store=store, inf=inf, inj=inj,
                                       seen=seen, clock=clock)

    def apply(m, st, op, norm):
        name, *a = op
        c = m.core
        if name == "create":
            return _call(norm, st.store.create, c.Pod(metadata=c.ObjectMeta(
                name=a[0], namespace="default", labels={"job": "j"})))
        if name == "touch":
            return _call(norm, st.store.mutate, "default", a[0],
                         lambda p: setattr(p.status, "reason", "t"))
        if name == "delete":
            return _call(norm, st.store.delete, "default", a[0])
        if name == "tick":
            st.clock.t += 1.0
            return None
        if name == "resync":
            st.inf.resync()
            return None
        got = st.inf.get("default", a[0])
        return [None if got is None else c.is_frozen(got),
                sorted(p.metadata.name for p in st.inf.list(
                    "default", {"job": "j"}))]

    def read(m, st):
        st.inf.flush()
        return [list(st.seen), st.inf.deliveries_suppressed,
                st.inj.total_fires, sorted(st.inj.fired.items()),
                sorted(o.metadata.name for o in st.inf.list())]

    _lockstep(ops, make, apply, read)


def test_port_informer_hang_is_healed_by_resync():
    """The cache updates under a hang while no handler runs; the resync
    re-delivers what the handlers missed."""
    m = PORT
    store = m.store.ObjectStore("Pod", copy_on_read=False)
    inj = m.faults.FaultInjector(m.faults.FaultPlan.from_dict(
        {"specs": [{"kind": "hang", "site": "informer.deliver",
                    "max_fires": 1}]}))
    inf = m.informer.Informer(store, injector=inj)
    seen = []
    inf.add_handler(lambda ev: seen.append(ev.obj.metadata.name))
    inf.start()
    store.create(m.core.Pod(metadata=m.core.ObjectMeta(
        name="a", namespace="default")))
    inf.flush()
    assert inf.get("default", "a") is not None and seen == []
    assert inf.deliveries_suppressed == 1
    inf.resync()
    assert seen == ["a"]


# -- copy-on-write: tests/test_cow_store.py and tests/test_deepcopy.py on the port

c, t = PORT.core, PORT.types


def _make_pod(name, labels=None):
    return c.Pod(metadata=c.ObjectMeta(name=name, namespace="default",
                                       labels=labels or {"job": "j"}),
                 spec=c.PodSpec(containers=[c.Container(name="c",
                                                        image="i")]))


def _frozen_store(**kw):
    return PORT.store.ObjectStore("Pod", copy_on_read=False, **kw)


def cow_get_is_shared_and_immutable():
    s = _frozen_store()
    s.create(_make_pod("a"))
    got = s.get("default", "a")
    assert c.is_frozen(got) and s.get("default", "a") is got
    for write in (lambda: setattr(got.status, "phase", c.PodPhase.RUNNING),
                  lambda: got.metadata.labels.__setitem__("x", "y"),
                  lambda: got.spec.containers.append(None)):
        with pytest.raises(c.FrozenObjectError):
            write()


def cow_list_returns_frozen_refs():
    s = _frozen_store(index_labels=("job",))
    s.create(_make_pod("a"))
    s.create(_make_pod("b"))
    for p in s.list("default", {"job": "j"}):
        assert c.is_frozen(p) and s.get("default", p.metadata.name) is p
        with pytest.raises(c.FrozenObjectError):
            p.metadata.labels["k"] = "v"


def cow_watch_events_are_frozen():
    s = _frozen_store()
    seen = []
    s.subscribe(seen.append, replay=False)
    s.create(_make_pod("a"))
    s.mutate("default", "a",
             lambda p: setattr(p.status, "phase", c.PodPhase.RUNNING))
    s.delete("default", "a")
    assert [ev.type.value for ev in seen] == ["ADDED", "MODIFIED", "DELETED"]
    for ev in seen:
        assert c.is_frozen(ev.obj)
        with pytest.raises(c.FrozenObjectError):
            ev.obj.status.reason = "edited"
    assert c.is_frozen(seen[1].old_obj)


def cow_subscribe_replay_is_frozen():
    s = _frozen_store()
    s.create(_make_pod("a"))
    replayed = []
    s.subscribe(replayed.append, replay=True)
    (ev,) = replayed
    assert ev.obj is s.get("default", "a")
    with pytest.raises(c.FrozenObjectError):
        ev.obj.metadata.annotations["k"] = "v"


def cow_zero_deepcopies_on_read_path():
    s = _frozen_store()
    s.create(_make_pod("a"))
    s.subscribe(lambda ev: None, replay=False)
    before = c.deepcopy_count()
    for _ in range(50):
        s.get("default", "a")
        s.list("default")
    s.subscribe(lambda ev: None, replay=True)
    assert c.deepcopy_count() == before


def cow_create_caller_object_stays_mutable():
    s = _frozen_store()
    mine = _make_pod("a")
    stored = s.create(mine)
    assert c.is_frozen(stored) and not c.is_frozen(mine)
    assert mine.metadata.uid
    mine.status.phase = c.PodPhase.RUNNING
    assert s.get("default", "a").status.phase == c.PodPhase.PENDING


def cow_create_accepts_frozen_input():
    s1, s2 = _frozen_store(), _frozen_store()
    snap = s1.create(_make_pod("a"))
    out = s2.create(snap)
    assert c.is_frozen(out) and s2.get("default", "a") is out


def cow_update_takes_ownership_of_unfrozen_input():
    s = _frozen_store()
    s.create(_make_pod("a"))
    mine = c.thaw(s.get("default", "a"))
    mine.status.phase = c.PodPhase.RUNNING
    out = s.update(mine)
    assert out is mine and c.is_frozen(mine)
    with pytest.raises(c.FrozenObjectError):
        mine.status.reason = "late-write"
    assert s.get("default", "a") is out


def cow_update_copies_frozen_input_once():
    s = _frozen_store()
    snap = s.create(_make_pod("a"))
    out = s.update(snap)
    assert out is not snap and c.is_frozen(out)
    assert out.metadata.resource_version > snap.metadata.resource_version


def cow_mutate_roundtrip_thaw_update_freeze():
    s = _frozen_store()
    s.create(_make_pod("a"))
    before = s.get("default", "a")

    def fn(p):
        assert not c.is_frozen(p)
        p.status.phase = c.PodPhase.RUNNING

    out = s.mutate("default", "a", fn)
    assert c.is_frozen(out) and s.get("default", "a") is out
    assert out.status.phase == c.PodPhase.RUNNING
    assert before.status.phase == c.PodPhase.PENDING


def cow_stale_thawed_copy_still_conflicts():
    s = _frozen_store()
    s.create(_make_pod("a"))
    stale = c.thaw(s.get("default", "a"))
    s.mutate("default", "a",
             lambda p: setattr(p.status, "phase", c.PodPhase.RUNNING))
    stale.status.phase = c.PodPhase.FAILED
    with pytest.raises(PORT.store.Conflict):
        s.update(stale)


def cow_delete_tombstone_is_frozen():
    s = _frozen_store()
    seen = []
    s.subscribe(seen.append, replay=False)
    s.create(_make_pod("a"))
    s.delete("default", "a")
    tomb = seen[-1].obj
    assert seen[-1].type.value == "DELETED" and c.is_frozen(tomb)
    with pytest.raises(c.FrozenObjectError):
        tomb.metadata.name = "x"


class _UnfrozenSource:
    """A watch source handing out private unfrozen parses (a wire source)."""

    kind = "Pod"

    def __init__(self):
        self._listeners = []

    def subscribe(self, listener, replay=True):
        self._listeners.append(listener)

    def unsubscribe(self, listener):
        self._listeners.remove(listener)

    def emit(self, ev):
        for fn in self._listeners:
            fn(ev)


def cow_informer_cache_shares_the_store_snapshot():
    s = _frozen_store()
    s.create(_make_pod("a"))
    inf = PORT.informer.Informer(s)
    inf.start()
    try:
        cached = inf.get("default", "a")
        assert cached is s.get("default", "a")
        assert inf.list("default") == [cached]
        assert inf.list("default")[0] is cached
        with pytest.raises(c.FrozenObjectError):
            cached.status.phase = c.PodPhase.RUNNING
    finally:
        inf.stop()


def cow_informer_freezes_wire_events_on_ingest():
    src = _UnfrozenSource()
    inf = PORT.informer.Informer(src)
    inf.start()
    try:
        pod = _make_pod("w")
        src.emit(PORT.events.WatchEvent(PORT.events.EventType.ADDED, "Pod",
                                        pod))
        cached = inf.get("default", "w")
        assert cached is pod and c.is_frozen(cached)
        with pytest.raises(c.FrozenObjectError):
            cached.metadata.labels["x"] = "y"
    finally:
        inf.stop()


def cow_informer_resync_redelivers_frozen():
    s = _frozen_store()
    s.create(_make_pod("a"))
    inf = PORT.informer.Informer(s)
    inf.start()
    try:
        seen = []
        inf.add_handler(seen.append)
        inf.resync()
        (ev,) = seen
        assert ev.type.value == "MODIFIED" and c.is_frozen(ev.obj)
    finally:
        inf.stop()


def cow_legacy_store_hands_out_mutable_copies():
    s = PORT.store.ObjectStore("Pod")
    s.create(_make_pod("a"))
    got = s.get("default", "a")
    assert not c.is_frozen(got)
    got.status.phase = c.PodPhase.RUNNING
    assert s.get("default", "a").status.phase == c.PodPhase.PENDING


def cow_legacy_events_are_private_copies():
    s = PORT.store.ObjectStore("Pod")
    seen = []
    s.subscribe(seen.append, replay=False)
    s.create(_make_pod("a"))
    seen[0].obj.metadata.labels["scribble"] = "1"
    assert "scribble" not in s.get("default", "a").metadata.labels


# tests/test_deepcopy.py: fully populated objects.

def _full_meta():
    return c.ObjectMeta(
        name="n", generate_name="n-", namespace="ns", uid="u",
        resource_version=9, generation=3, labels={"l": "1"},
        annotations={"a": "2"},
        owner_references=[c.OwnerReference(
            api_version="v1", kind="TPUJob", name="j", uid="ju",
            controller=True, block_owner_deletion=False)],
        creation_timestamp=3.0, deletion_timestamp=4.0)


def _full_pod():
    return c.Pod(
        metadata=_full_meta(),
        spec=c.PodSpec(
            containers=[c.Container(
                name="c", image="img", command=["python", "-m", "x"],
                args=["--a"], env={"K": "V"}, ports=[8476],
                resources={"google.com/tpu": 4, "cpu": 8})],
            restart_policy="Never", node_selector={"pool": "a"},
            scheduling_group="uid-1", assigned_slice="pool/slice-0"),
        status=c.PodStatus(
            phase=c.PodPhase.FAILED, reason="Preempted", message="m",
            pod_ip="10.0.0.1", host_ip="host-0", start_time=1.0,
            finish_time=2.0, exit_code=137))


def _full_service():
    return c.Service(metadata=_full_meta(), spec=c.ServiceSpec(
        selector={"s": "1"},
        ports=[c.ServicePort(port=1, name="p", target_port=2)],
        cluster_ip="10.1.1.1"))


def _full_job():
    return t.TPUJob(
        metadata=_full_meta(),
        spec=t.TPUJobSpec(
            runtime_id="r", data_dir="/d", model_dir="/m", log_dir="/l",
            export_dir="/e",
            replica_specs=[t.ReplicaSpec(
                replica_type=t.ReplicaType.WORKER, replicas=2,
                template=c.PodTemplateSpec(metadata=_full_meta(),
                                           spec=_full_pod().spec),
                tpu=t.TPUSliceSpec(accelerator_type="v5e-16", num_slices=2,
                                   topology="4x4", provisioning="spot"),
                termination_policy=t.TerminationPolicySpec(
                    chief=t.ChiefSpec(replica_name="Worker",
                                      replica_index=1)),
                max_restarts=5)],
            suspend=True, priority=3, ttl_seconds_after_finished=60),
        status=t.TPUJobStatus(
            phase=t.JobPhase.RECOVERING, reason="r",
            conditions=[t.Condition(
                type=t.ConditionType.READY, status=t.ConditionStatus.TRUE,
                reason="cr", message="cm", last_transition_time=7.0)],
            replica_statuses=[t.ReplicaStatus(
                type=t.ReplicaType.WORKER, state=t.ReplicaState.RUNNING,
                states={t.ReplicaState.RUNNING: 4})],
            submit_time=1.0, all_running_time=2.0, completion_time=3.0,
            restarts=2, resizes=1, last_restart_time=4.0,
            observed_generation=3))


def _full_lmservice():
    return t.LMService(
        metadata=_full_meta(),
        spec=t.LMServiceSpec(
            model="tiny", replicas=3,
            slo=t.SLOSpec(ttft_p99_ms=250.0, deadline_s=30.0),
            max_queue=16, prefill_replicas=1, runtime_id="r"),
        status=t.LMServiceStatus(
            phase=t.LMServicePhase.DEGRADED, reason="rr", ready_replicas=2,
            conditions=[t.Condition(
                type=t.ConditionType.READY, status=t.ConditionStatus.FALSE,
                reason="cr", message="cm", last_transition_time=7.0)],
            observed_generation=3))


FULL = (_full_pod, _full_service, _full_job, _full_lmservice)


def _assert_deeply_frozen(obj, path="root"):
    assert getattr(obj, "_sealed", False), f"{path} not sealed"
    for f in dataclasses.fields(obj):
        _assert_value_frozen(getattr(obj, f.name), f"{path}.{f.name}")


def _assert_value_frozen(v, path):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        _assert_deeply_frozen(v, path)
    elif isinstance(v, dict):
        assert type(v) is c._FrozenDict, f"{path}: plain dict"
        for k, item in v.items():
            _assert_value_frozen(item, f"{path}[{k!r}]")
    elif isinstance(v, list):
        assert type(v) is c._FrozenList, f"{path}: plain list"
        for i, item in enumerate(v):
            _assert_value_frozen(item, f"{path}[{i}]")


def _assert_deeply_thawed(obj, path="root"):
    assert not getattr(obj, "_sealed", False), f"{path}: still sealed"
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            _assert_deeply_thawed(v, f"{path}.{f.name}")
        elif isinstance(v, dict):
            assert type(v) is dict, f"{path}.{f.name}: frozen dict leaked"
        elif isinstance(v, list):
            assert type(v) is list, f"{path}.{f.name}: frozen list leaked"


def cow_copies_are_equal_and_independent():
    for make in FULL:
        obj = make()
        cp = obj.deepcopy()
        assert cp == obj and cp == copy.deepcopy(obj)
    pod = _full_pod()
    cp = pod.deepcopy()
    cp.spec.containers[0].env["K"] = "changed"
    cp.metadata.owner_references[0].name = "changed"
    assert pod.spec.containers[0].env["K"] == "V"
    assert pod.metadata.owner_references[0].name == "j"
    job = _full_job()
    cp = job.deepcopy()
    cp.status.replica_statuses[0].states[t.ReplicaState.RUNNING] = 0
    cp.spec.replica_specs[0].termination_policy.chief.replica_index = 9
    assert job.status.replica_statuses[0].states[t.ReplicaState.RUNNING] == 4
    assert job.spec.replica_specs[0].termination_policy.chief.replica_index \
        == 1
    svc = _full_lmservice()
    cp = svc.deepcopy()
    cp.spec.slo.deadline_s = 1.0
    assert svc.spec.slo.deadline_s == 30.0


def cow_freeze_covers_every_field():
    for make in FULL:
        obj = make()
        assert obj.freeze() is obj
        _assert_deeply_frozen(obj)
        assert obj.freeze() is obj


def cow_thaw_roundtrip_equal_and_mutable():
    for make in FULL:
        frozen = make().freeze()
        th = c.thaw(frozen)
        assert th is not frozen and th == frozen
        _assert_deeply_thawed(th)
        assert c.thaw(th) is th


def cow_deepcopy_of_frozen_is_thawed():
    for make in FULL:
        frozen = make().freeze()
        cp = frozen.deepcopy()
        assert cp == frozen
        _assert_deeply_thawed(cp)


def cow_api_fields_match_the_reference():
    """Field drift guard: the port's objects have the reference's fields,
    and every one is sealable."""
    for jmod, pmod in ((JAX.core, PORT.core), (JAX.types, PORT.types)):
        for name in dir(pmod):
            pcls = getattr(pmod, name)
            if not (isinstance(pcls, type) and dataclasses.is_dataclass(pcls)
                    and issubclass(pcls, pmod.__dict__.get(
                        "Sealable", PORT.core.Sealable))):
                continue
            jcls = getattr(jmod, name)
            assert [f.name for f in dataclasses.fields(pcls)] == \
                [f.name for f in dataclasses.fields(jcls)], name
            assert callable(getattr(pcls, "freeze", None)), name


COW_CASES = {name: fn for name, fn in globals().items()
             if name.startswith("cow_") and callable(fn)}


@pytest.mark.parametrize("case", sorted(COW_CASES))
def test_port_copy_on_write_contract(case):
    COW_CASES[case]()
