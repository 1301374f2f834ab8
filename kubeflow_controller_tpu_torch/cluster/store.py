"""Versioned, watchable object store — the apiserver's storage semantics,
in-process.

What the reference trusts etcd + the apiserver for, rebuilt so tests mean
something (SURVEY.md §7 "hard parts" #3):

- resource versions bump on every write;
- updates are optimistic-concurrency checked (the reference does whole-object
  PUT with no conflict handling, ``controller.go:630-636`` — a listed bug);
- reads are aliasing-safe in one of two ways: **legacy mode** returns deep
  copies; **frozen mode** (``copy_on_read=False``) returns shared immutable
  snapshots and moves the deepcopy to the mutation boundary (the reference
  mutates informer-cached objects in place, ``updater/distributed.go:51-54``
  — a listed bug; both modes make that corruption impossible, frozen mode
  without the per-read copy tax — see docs/object_ownership.md);
- every mutation emits a WatchEvent to subscribers — through per-subscriber
  delta queues drained OUTSIDE the store lock (client-go's sharedProcessor /
  DeltaFIFO shape), with consecutive MODIFIEDs per key coalesced to the
  latest snapshot. See docs/watch_pipeline.md for the ordering/flush
  contract.

Counterpart of ``kubeflow_controller_tpu/cluster/store.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from kubeflow_controller_tpu_torch.api.core import is_frozen, new_uid, thaw
from kubeflow_controller_tpu_torch.cluster.events import EventType, WatchEvent


class NotFound(KeyError):
    pass


class AlreadyExists(ValueError):
    pass


class Conflict(ValueError):
    """Optimistic-concurrency failure: stored resource_version moved on."""


Listener = Callable[[WatchEvent], None]


def fnv1a_32(key: str) -> int:
    """Deterministic 32-bit FNV-1a — shard routing must be stable across
    processes and runs (Python's ``hash`` is seed-randomized)."""
    h = 2166136261
    for b in key.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class _SubShard:
    """One key-range shard of a subscriber's delta queue: its own lock,
    deque, and coalescing tail-map, so concurrent writers to different key
    ranges never contend on one lock on the enqueue/drain path."""

    __slots__ = (
        "lock", "cond", "pending", "tail", "dispatching",
        "wait_s", "coalesced", "overflows",
    )

    def __init__(self):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        # entries are mutable [event, key, needs_copy] triples so coalescing
        # can swap the event in place without disturbing queue order
        self.pending: deque = deque()
        self.tail: Dict[str, list] = {}
        self.dispatching = False
        self.wait_s = 0.0       # enqueue-side contended-lock wait
        self.coalesced = 0
        self.overflows = 0


class _Subscription:
    """One watch listener's sharded delta queues + dispatch state.

    The client-go ``processorListener`` analog: writers append deltas under
    the store lock (cheap — one dict probe and a deque append), and whichever
    thread wins a shard's ``dispatching`` flag delivers that shard's entries
    with NO store lock held. Each shard's ``tail`` maps key -> the newest
    still-coalescible pending entry so a burst of MODIFIEDs for one key
    collapses to the latest snapshot (DeltaFIFO semantics) instead of
    queueing N handler invocations. A key always routes to the same shard,
    so per-key ordering — the contract docs/watch_pipeline.md pins — is
    preserved; cross-key delivery order is only defined per shard.
    """

    __slots__ = ("listener", "shards", "nshards", "replaying")

    def __init__(self, listener: Listener, nshards: int = 1):
        self.listener = listener
        self.nshards = max(1, nshards)
        self.shards = [_SubShard() for _ in range(self.nshards)]
        # While True (subscribe-replay in flight), dispatch is parked so the
        # replayer can prepend the snapshot ahead of any racing live events.
        self.replaying = False

    def shard_for(self, key: str) -> _SubShard:
        if self.nshards == 1:
            return self.shards[0]
        return self.shards[fnv1a_32(key) % self.nshards]

    def shard_index(self, key: str) -> int:
        if self.nshards == 1:
            return 0
        return fnv1a_32(key) % self.nshards

    # Legacy single-queue accessors (only meaningful when nshards == 1 —
    # the bare-ObjectStore default): bounded consumers shed an overflowed
    # buffer through these (tests/test_races.py overflow-recovery suite).

    @property
    def lock(self) -> threading.Lock:
        assert self.nshards == 1
        return self.shards[0].lock

    @property
    def pending(self) -> deque:
        assert self.nshards == 1
        return self.shards[0].pending

    @property
    def tail(self) -> Dict[str, list]:
        assert self.nshards == 1
        return self.shards[0].tail

    @property
    def dispatching(self) -> bool:
        assert self.nshards == 1
        return self.shards[0].dispatching

    @dispatching.setter
    def dispatching(self, v: bool) -> None:
        assert self.nshards == 1
        self.shards[0].dispatching = v


class ObjectStore:
    """Thread-safe store for one kind (Pods, Services, or TPUJobs).

    Objects are any dataclass with ``.metadata`` (ObjectMeta) and
    ``.deepcopy()``. Keys are ``namespace/name``.

    ``copy_on_read=True`` (default) is the legacy contract: every read and
    watch emission is a private deep copy the caller may mutate. With
    ``copy_on_read=False`` stored objects are frozen (``.freeze()``) and
    ``get``/``try_get``/``list``, watch events, and subscribe-replay hand
    out **shared frozen references** — zero read-path copies; writers thaw
    at the mutation boundary (``api.core.thaw``). FakeCluster runs its
    stores in frozen mode; bare ObjectStore constructions keep legacy
    semantics.
    """

    def __init__(
        self,
        kind: str,
        now_fn: Callable[[], float] = time.time,
        index_labels: tuple = (),
        copy_on_read: bool = True,
        watch_queue_soft_max: int = 1024,
        watch_shards: int = 1,
        mirror: Any = None,
    ):
        self.kind = kind
        self._now_fn = now_fn
        self._copy_on_read = copy_on_read
        self._lock = threading.RLock()
        self._objects: Dict[str, Any] = {}
        self._rv = 0
        self._last_delete_rv = 0
        # Write-through native mirror (native.objindex.NativeObjectIndex or
        # None): keeps (uid, rv, generation, indexed labels) per key inside
        # the C++ core so the controller's fingerprint probe never walks
        # Python objects. Updated under the store lock on every mutation —
        # the Python store stays authoritative.
        self._mirror = mirror
        self._watch_shards = max(1, watch_shards)
        self._subs: List[_Subscription] = []
        self._sub_by_listener: Dict[Listener, _Subscription] = {}
        # Delta-queue instrumentation (benchmarks/controlplane_bench.py).
        # The bound is soft: coalescing keeps steady-state depth at O(hot
        # keys), and a writer cannot block under the store lock without
        # inviting deadlock, so overflow is counted, not enforced. Live
        # counters are per shard; these accumulate what unsubscribed
        # listeners retired so the store-level properties stay monotonic.
        self._watch_queue_soft_max = watch_queue_soft_max
        self._max_queue_depth = 0
        self._retired_coalesced = 0
        self._retired_overflows = 0
        self._retired_wait_s = 0.0
        # Label indexes (client-go Indexer analog): selector lists on an
        # indexed key touch only matching objects instead of scanning the
        # namespace — the difference between O(jobs) and O(jobs^2) total
        # reconcile work at controller scale (benchmarks/controlplane_bench).
        self._index_labels = tuple(index_labels)
        self._index: Dict[str, Dict[str, set]] = {
            lk: {} for lk in self._index_labels
        }

    def _index_add(self, key: str, obj: Any) -> None:
        for lk in self._index_labels:
            v = obj.metadata.labels.get(lk)
            if v is not None:
                self._index[lk].setdefault(v, set()).add(key)

    def _index_remove(self, key: str, obj: Any) -> None:
        for lk in self._index_labels:
            v = obj.metadata.labels.get(lk)
            if v is not None:
                bucket = self._index[lk].get(v)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del self._index[lk][v]

    # -- native write-through mirror -----------------------------------------

    def _mirror_upsert(self, key: str, obj: Any) -> None:
        m = self._mirror
        if m is None:
            return
        meta = obj.metadata
        sel = None
        labels = meta.labels
        if labels:
            for lk in self._index_labels:
                v = labels.get(lk)
                if v is not None:
                    if sel is None:
                        sel = {}
                    sel[lk] = v
        m.upsert(self.kind, key, meta.uid, meta.resource_version,
                 meta.generation, sel)

    def _mirror_remove(self, key: str) -> None:
        if self._mirror is not None:
            self._mirror.remove(self.kind, key)

    # -- watch ---------------------------------------------------------------

    def subscribe(self, listener: Listener, replay: bool = True) -> None:
        """Register a watch listener. With ``replay``, synthesizes ADDED events
        for existing objects first (how a fresh informer list+watch behaves).

        Only the snapshot is taken under the store lock — replay enqueueing
        happens OFF the write lock, so registering an informer against a
        large store never stalls writers, and frozen-mode replay is
        zero-copy (legacy mode defers its per-event deepcopy to delivery
        time; stored objects are internally immutable, so the deferred copy
        sees exactly the snapshotted state). Ordering stays safe: the
        subscription registers with ``replaying=True`` (dispatch parked), so
        live events land in the shard queues but cannot be delivered; the
        replayer then PREPENDS the snapshot entries — every racing live
        event carries a newer resource version than the snapshot, so each
        subscriber still observes per-key rv-monotonic order. Replay entries
        never become coalesce targets (a racing DELETED may already sit
        behind them; folding a post-delete MODIFIED into a pre-delete entry
        would reorder across the tombstone). Delivery itself happens OFF the
        lock: whichever thread owns a shard's dispatch flag drains it after
        the store lock is released, so a slow handler never serializes other
        writers. A listener may call back into this or any other store."""
        sub = _Subscription(listener, self._watch_shards)
        with self._lock:
            snapshot = list(self._objects.items()) if replay else None
            sub.replaying = replay
            self._subs.append(sub)
            self._sub_by_listener[listener] = sub
        if replay:
            per_shard: List[list] = [[] for _ in range(sub.nshards)]
            needs_copy = self._copy_on_read
            for key, obj in snapshot:
                per_shard[sub.shard_index(key)].append(
                    [WatchEvent(EventType.ADDED, self.kind, obj), key,
                     needs_copy]
                )
            for shard, items in zip(sub.shards, per_shard):
                if not items:
                    continue
                with shard.lock:
                    shard.pending.extendleft(reversed(items))
            sub.replaying = False
        self._drain(sub)

    def unsubscribe(self, listener: Listener) -> None:
        with self._lock:
            sub = self._sub_by_listener.pop(listener, None)
            if sub is not None:
                self._subs.remove(sub)
        if sub is not None:
            with self._lock:
                for shard in sub.shards:
                    self._retired_coalesced += shard.coalesced
                    self._retired_overflows += shard.overflows
                    self._retired_wait_s += shard.wait_s

    # -- delta queues + dispatcher -------------------------------------------

    def _emit(self, ev: WatchEvent) -> None:
        # Caller holds self._lock: enqueue order == resource-version order.
        # No listener runs here — the write path only appends deltas; the
        # caller invokes _dispatch(key) after releasing the lock.
        key = f"{ev.obj.metadata.namespace}/{ev.obj.metadata.name}"
        for sub in self._subs:
            self._enqueue(sub, key, ev)

    def _enqueue(self, sub: _Subscription, key: str, ev: WatchEvent) -> None:
        shard = sub.shard_for(key)
        lk = shard.lock
        if not lk.acquire(False):
            # Contended: another writer/drainer holds this shard. Time the
            # wait — the lock-wait gauge the sharding exists to drive down.
            t0 = time.perf_counter()
            lk.acquire()
            shard.wait_s += time.perf_counter() - t0
        try:
            entry = shard.tail.get(key)
            if entry is not None and ev.type == EventType.MODIFIED:
                # Coalesce: consecutive MODIFIEDs for one key collapse to the
                # latest snapshot; a pending ADDED absorbs the MODIFIED and
                # stays ADDED (client-go DeltaFIFO). old_obj keeps the oldest
                # undelivered state so handlers still see the cumulative diff.
                prior = entry[0]
                entry[0] = WatchEvent(prior.type, ev.kind, ev.obj,
                                      prior.old_obj)
                shard.coalesced += 1
                return
            entry = [ev, key, False]
            shard.pending.append(entry)
            depth = len(shard.pending)
            if ev.type == EventType.DELETED:
                # Nothing coalesces across a tombstone: a re-create after
                # delete must arrive as its own ADDED.
                shard.tail.pop(key, None)
            else:
                shard.tail[key] = entry
        finally:
            lk.release()
        if depth > self._max_queue_depth:
            self._max_queue_depth = depth
        if depth > self._watch_queue_soft_max:
            shard.overflows += 1

    def _dispatch(self, key: Optional[str] = None) -> None:
        """Drain subscribers' queues, called with NO store lock held. A
        write path passes its key so only the one affected shard per
        subscriber is visited (the no-sharding fast path is identical:
        every key maps to shard 0)."""
        with self._lock:
            subs = list(self._subs)
        for sub in subs:
            if key is not None:
                self._drain_shard(sub, sub.shard_for(key))
            else:
                self._drain(sub)

    def _drain(self, sub: _Subscription) -> None:
        for shard in sub.shards:
            self._drain_shard(sub, shard)

    @staticmethod
    def _drain_shard(sub: _Subscription, shard: _SubShard) -> None:
        with shard.lock:
            if shard.dispatching or sub.replaying:
                # the active dispatcher delivers our entries too; during
                # replay the subscriber's queues are parked until the
                # snapshot has been prepended
                return
            shard.dispatching = True
        while True:
            with shard.lock:
                if not shard.pending:
                    shard.dispatching = False
                    shard.cond.notify_all()
                    return
                entry = shard.pending.popleft()
                ev, key, needs_copy = entry
                if shard.tail.get(key) is entry:
                    del shard.tail[key]
            if needs_copy:
                # deferred legacy-mode replay copy (see subscribe())
                ev = WatchEvent(ev.type, ev.kind, ev.obj.deepcopy(),
                                ev.old_obj)
            try:
                sub.listener(ev)
            except BaseException:
                with shard.lock:
                    shard.dispatching = False
                    shard.cond.notify_all()
                raise

    def flush(self, timeout: float = 10.0) -> bool:
        """Quiesce the watch pipeline: block until every subscriber's delta
        queues are empty and no dispatcher is mid-delivery. The determinism
        hook FakeCluster.tick / Controller.drain rely on — after flush(),
        every completed write has been observed by every subscriber. Returns
        False only if a foreign dispatcher failed to finish within
        ``timeout`` wall seconds (it keeps our own draining unbounded)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            subs = list(self._subs)
        for sub in subs:
            for shard in sub.shards:
                while True:
                    self._drain_shard(sub, shard)
                    with shard.lock:
                        if (not shard.pending and not shard.dispatching
                                and not sub.replaying):
                            break
                        if time.monotonic() >= deadline:
                            return False
                        shard.cond.wait(0.05)
        return True

    def _sum_shard_counter(self, attr: str, retired):
        total = retired
        with self._lock:
            subs = list(self._subs)
        for sub in subs:
            for shard in sub.shards:
                total += getattr(shard, attr)
        return total

    @property
    def events_coalesced(self) -> int:
        """MODIFIED events absorbed into a newer pending snapshot."""
        return self._sum_shard_counter("coalesced", self._retired_coalesced)

    @property
    def max_watch_queue_depth(self) -> int:
        """High-water mark of any subscriber shard's pending delta queue."""
        with self._lock:
            return self._max_queue_depth

    @property
    def watch_queue_overflows(self) -> int:
        """Enqueues observed past the soft bound (diagnostic)."""
        return self._sum_shard_counter("overflows", self._retired_overflows)

    @property
    def watch_lock_wait_s(self) -> float:
        """Cumulative time writers spent blocked on contended subscriber
        shard locks — the serialization the per-shard split removes."""
        return self._sum_shard_counter("wait_s", self._retired_wait_s)

    def index_bucket_count(self) -> int:
        """Total label-index buckets (values with >=1 member) across keys."""
        with self._lock:
            return sum(len(v) for v in self._index.values())

    def publish_metrics(self) -> Dict[str, float]:
        """Push this store's gauges into the metrics registry under
        the ``control.store`` subsystem and return them as a dict (the
        controlplane bench emits that dict in its JSON artifact)."""
        from kubeflow_controller_tpu_torch.obs.telemetry import registry

        k = self.kind.lower()
        vals = {
            f"objects_{k}": float(len(self)),
            f"index_buckets_{k}": float(self.index_bucket_count()),
            f"watch_queue_depth_max_{k}": float(self.max_watch_queue_depth),
            f"watch_lock_wait_s_{k}": self.watch_lock_wait_s,
            f"events_coalesced_{k}": float(self.events_coalesced),
        }
        reg = registry()
        for name, v in vals.items():
            reg.gauge(name, "control.store").set(v)
        return vals

    # -- CRUD ----------------------------------------------------------------

    @staticmethod
    def key_of(obj: Any) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def create(self, obj: Any) -> Any:
        with self._lock:
            # Frozen-mode callers may re-submit a frozen snapshot (e.g. a
            # watch tombstone); stamp a private copy instead of their object.
            if not self._copy_on_read and is_frozen(obj):
                obj = obj.deepcopy()
            meta = obj.metadata
            if not meta.name:
                if not meta.generate_name:
                    raise ValueError("object needs name or generate_name")
                # GenerateName semantics: apiserver-side random-ish suffix
                # (reference pods get theirs from GetPodFromTemplate,
                # controller_utils.go:564-570).
                meta.name = meta.generate_name + new_uid("")[4:9]
            key = self.key_of(obj)
            if key in self._objects:
                raise AlreadyExists(key)
            if not meta.uid:
                meta.uid = new_uid(self.kind.lower())
            self._rv += 1
            meta.resource_version = self._rv
            meta.generation = 1   # apiserver stamps generation 1 on create
            if not meta.creation_timestamp:
                meta.creation_timestamp = self._now_fn()
            # One copy total in frozen mode: the caller's object is stamped
            # in place (and stays mutable in their hands); the store keeps
            # a frozen private snapshot shared by the ADDED event, the
            # return value, and every future read.
            stored = obj.deepcopy()
            if not self._copy_on_read:
                stored.freeze()
            self._objects[key] = stored
            self._index_add(key, stored)
            self._mirror_upsert(key, stored)
            if self._copy_on_read:
                self._emit(
                    WatchEvent(EventType.ADDED, self.kind, stored.deepcopy())
                )
                ret = stored.deepcopy()
            else:
                self._emit(WatchEvent(EventType.ADDED, self.kind, stored))
                ret = stored
        self._dispatch(key)
        return ret

    def get(self, namespace: str, name: str) -> Any:
        with self._lock:
            obj = self._objects.get(f"{namespace}/{name}")
            if obj is None:
                raise NotFound(f"{self.kind} {namespace}/{name}")
            return obj.deepcopy() if self._copy_on_read else obj

    def try_get(self, namespace: str, name: str) -> Optional[Any]:
        try:
            return self.get(namespace, name)
        except NotFound:
            return None

    def update(self, obj: Any, enforce_rv: bool = True) -> Any:
        """Optimistic update: fails with Conflict when the caller's copy is
        stale (the safety net the reference lacks, SURVEY.md §8)."""
        with self._lock:
            key = self.key_of(obj)
            cur = self._objects.get(key)
            if cur is None:
                raise NotFound(f"{self.kind} {key}")
            if enforce_rv and obj.metadata.resource_version != cur.metadata.resource_version:
                raise Conflict(
                    f"{self.kind} {key}: stale resource_version "
                    f"{obj.metadata.resource_version} != {cur.metadata.resource_version}"
                )
            if cur.metadata.uid and obj.metadata.uid != cur.metadata.uid:
                raise Conflict(f"{self.kind} {key}: uid changed (delete+recreate race)")
            if not self._copy_on_read:
                # Ownership transfer: an unfrozen input is rv-stamped and
                # sealed in place — zero copies; the caller must not touch
                # it afterwards (it raises if they do). A frozen input
                # (rare: resubmitting a snapshot verbatim) is copied once.
                if is_frozen(obj):
                    obj = obj.deepcopy()
                self._rv += 1
                obj.metadata.resource_version = self._rv
                self._stamp_generation(obj, cur)
                old = cur
                stored = obj.freeze()
                self._index_remove(key, old)
                self._objects[key] = stored
                self._index_add(key, stored)
                self._mirror_upsert(key, stored)
                self._emit(WatchEvent(
                    EventType.MODIFIED, self.kind, stored, old,
                ))
                ret = stored
            else:
                self._rv += 1
                obj.metadata.resource_version = self._rv
                self._stamp_generation(obj, cur)
                old = cur
                stored = obj.deepcopy()
                self._index_remove(key, old)
                self._objects[key] = stored
                self._index_add(key, stored)
                self._mirror_upsert(key, stored)
                self._emit(WatchEvent(
                    EventType.MODIFIED, self.kind,
                    stored.deepcopy(), old.deepcopy(),
                ))
                ret = stored.deepcopy()
        self._dispatch(key)
        return ret

    @staticmethod
    def _stamp_generation(obj: Any, cur: Any) -> None:
        """k8s generation semantics: metadata.generation bumps iff the
        desired state (.spec) changed; status-only writes keep it. The
        no-op sync short-circuit keys off this (docs/watch_pipeline.md)."""
        bump = 1 if (hasattr(obj, "spec") and obj.spec != cur.spec) else 0
        obj.metadata.generation = cur.metadata.generation + bump

    def update_status(self, obj: Any) -> Any:
        """Status-subresource update: replace only ``.status``, rv-checked.

        Frozen mode exploits immutability for structural sharing: the next
        snapshot is built with ``dataclasses.replace``, reusing the stored
        object's frozen spec (the heavy half — pod templates) by reference.
        Only metadata (rv bump) and the incoming status are new, so the
        per-status-write cost stays O(status), not O(object) — the copy
        pattern the whole-object ``update`` can't avoid. The caller's
        status is sealed in place (ownership transfer, as in ``update``);
        a frozen incoming status is copied once instead.

        Labels/annotations can't change through this path (metadata comes
        from the stored object), so the label indexes need no maintenance.
        """
        with self._lock:
            key = self.key_of(obj)
            cur = self._objects.get(key)
            if cur is None:
                raise NotFound(f"{self.kind} {key}")
            if obj.metadata.resource_version != cur.metadata.resource_version:
                raise Conflict(
                    f"{self.kind} {key}: stale resource_version "
                    f"{obj.metadata.resource_version} != {cur.metadata.resource_version}"
                )
            if cur.metadata.uid and obj.metadata.uid != cur.metadata.uid:
                raise Conflict(f"{self.kind} {key}: uid changed (delete+recreate race)")
            status = obj.status
            if self._copy_on_read or is_frozen(status):
                # legacy: the caller keeps their object mutable, so the
                # stored status must be private
                status = status.deepcopy()
            self._rv += 1
            meta = cur.metadata.deepcopy()
            meta.resource_version = self._rv
            old = cur
            stored = dataclasses.replace(cur, metadata=meta, status=status)
            if not self._copy_on_read:
                stored.freeze()  # spec already sealed: O(1) for that branch
                self._objects[key] = stored
                self._mirror_upsert(key, stored)
                self._emit(WatchEvent(
                    EventType.MODIFIED, self.kind, stored, old,
                ))
                ret = stored
            else:
                self._objects[key] = stored
                self._mirror_upsert(key, stored)
                self._emit(WatchEvent(
                    EventType.MODIFIED, self.kind,
                    stored.deepcopy(), old.deepcopy(),
                ))
                ret = stored.deepcopy()
        self._dispatch(key)
        return ret

    def mutate(self, namespace: str, name: str, fn: Callable[[Any], None]) -> Any:
        """Read-modify-write with internal retry — the conflict-safe update
        helper status writers use. ``fn`` always receives a private mutable
        copy (thawed in frozen mode — one copy per attempt, the only copy
        the whole round trip pays there)."""
        while True:
            obj = thaw(self.get(namespace, name))
            fn(obj)
            try:
                return self.update(obj)
            except Conflict:
                continue

    def delete(self, namespace: str, name: str) -> Any:
        with self._lock:
            key = f"{namespace}/{name}"
            obj = self._objects.pop(key, None)
            if obj is None:
                raise NotFound(f"{self.kind} {key}")
            self._index_remove(key, obj)
            self._mirror_remove(key)
            self._rv += 1
            self._last_delete_rv = self._rv
            # The tombstone carries the DELETION's revision (k8s watch
            # semantics): a watcher that saw this event can resume from its
            # resourceVersion without tripping the 410 relist path.
            tomb = obj.deepcopy()
            tomb.metadata.resource_version = self._rv
            if not self._copy_on_read:
                tomb.freeze()
            self._emit(WatchEvent(EventType.DELETED, self.kind, tomb))
        self._dispatch(key)
        return obj

    # -- listing -------------------------------------------------------------

    def list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Any]:
        with self._lock:
            candidates = self._objects
            if label_selector:
                for lk in self._index_labels:
                    if lk in label_selector:
                        keys = self._index[lk].get(label_selector[lk], set())
                        candidates = {
                            k: self._objects[k] for k in keys
                        }
                        break
            out = []
            for key, obj in candidates.items():
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if label_selector and not selector_matches(label_selector, obj.metadata.labels):
                    continue
                out.append(obj.deepcopy() if self._copy_on_read else obj)
            return out

    @property
    def revision(self) -> int:
        """Store-wide resourceVersion high-water mark — what a k8s List
        response carries in ``.metadata.resourceVersion`` (the point a
        watch resumes from)."""
        with self._lock:
            return self._rv

    @property
    def last_delete_revision(self) -> int:
        """Revision of the most recent delete. A k8s-mode watch resuming
        from an OLDER resourceVersion cannot be replayed faithfully (this
        store keeps no event history, and the deleted object is gone from
        the replay set) — the server answers 410 Gone and the client
        relists, exactly real watch-cache-expiry semantics."""
        with self._lock:
            return self._last_delete_rv

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._objects)


def selector_matches(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    """Equality-based label selector (the only kind the reference uses,
    ``pkg/tensorflow/distributed.go:221-228``)."""
    return all(labels.get(k) == v for k, v in selector.items())
