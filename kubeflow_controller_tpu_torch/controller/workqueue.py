"""Rate-limited deduplicating work queue.

Semantics rebuilt from client-go's workqueue as the reference uses it
(``pkg/controller/controller.go:116,194-243``):

- an item present in the queue or currently processing is not enqueued twice
  ("it's fine if the same key is added while being processed — it re-queues",
  the property the single-key-at-a-time discipline relies on);
- ``add_rate_limited`` applies per-item exponential backoff;
- ``forget`` resets an item's failure count after a successful sync.

Implementation is condition-variable based, no busy waiting; delayed items are
released by whichever waiter wakes first.

Counterpart of ``kubeflow_controller_tpu/controller/workqueue.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, Hashable, List, Optional, Set, Tuple

# Exponent clamp for the rate-limit backoff: past this the uncapped delay
# exceeds any sane max_delay anyway, and 2**failures must never materialize
# a huge int for a persistently failing item.
_BACKOFF_MAX_EXP = 32


def backoff_delay(
    base_delay: float, max_delay: float, item: Hashable, failures: int
) -> float:
    """Per-item rate-limit delay: capped exponential with deterministic
    jitter.

    ``min(base * 2^failures, max)`` scaled into ``[0.75, 1.0)`` by an FNV-1a
    hash of (item, failures). The jitter desynchronizes items that started
    failing together (a controller restart re-enqueues every bad key at
    once) so their retries don't thundering-herd on the same beat, while
    staying deterministic — no RNG state, and the C++ core
    (``csrc/tpujob_native.cc::BackoffDelay``) computes the identical double
    for the identical inputs (tests/test_torch_native.py holds the two bit
    for bit). The fleet router retries on this curve too.
    """
    exp = failures if failures < _BACKOFF_MAX_EXP else _BACKOFF_MAX_EXP
    raw = base_delay * float(2 ** exp)
    if raw > max_delay:
        raw = max_delay
    h = 2166136261
    for b in f"{item}|{failures}".encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    frac = h / 4294967296.0
    return raw * (0.75 + 0.25 * frac)


class RateLimitingQueue:
    def __init__(
        self,
        base_delay: float = 0.005,
        max_delay: float = 60.0,
    ):
        self._base_delay = base_delay
        self._max_delay = max_delay
        self._cond = threading.Condition()
        self._queue: List[Hashable] = []       # FIFO of ready items
        self._queued: Set[Hashable] = set()    # ready or waiting-to-be-ready
        self._processing: Set[Hashable] = set()
        self._redo: Set[Hashable] = set()      # re-added while processing
        self._delayed: List[Tuple[float, int, Hashable]] = []  # min-heap
        # item -> authoritative due time. The heap may hold superseded
        # entries (an add_after with a shorter delay re-pushes); an entry
        # whose due time disagrees with this map is stale and is skipped
        # lazily in _promote_due. Count delayed items here, not in the heap.
        self._delayed_due: Dict[Hashable, float] = {}
        self._delayed_seq = 0
        self._failures: Dict[Hashable, int] = {}
        self._shutdown = False

    # -- producer side -------------------------------------------------------

    def add(self, item: Hashable) -> None:
        with self._cond:
            if self._shutdown:
                return
            if item in self._processing:
                # Level-trigger discipline: remember to redo after Done.
                self._redo.add(item)
                return
            if item in self._queued:
                if item not in self._queue:
                    # Parked in the delayed heap (add_after): an immediate
                    # add BEATS the pending delay — k8s workqueue semantics.
                    # Without this, a key parked for a long TTL/backoff
                    # would swallow event-driven re-enqueues until it fires.
                    # Its heap entry goes stale (due-map cleared) and is
                    # skipped when it surfaces.
                    self._delayed_due.pop(item, None)
                    self._queue.append(item)
                    self._cond.notify()
                return
            self._queued.add(item)
            self._queue.append(item)
            self._cond.notify()

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._cond:
            if self._shutdown:
                return
            due = time.monotonic() + delay
            if item in self._queued:
                cur = self._delayed_due.get(item)
                if cur is None:
                    # Already ready in the FIFO — fires sooner than any delay.
                    return
                if due >= cur:
                    # Parked with an earlier-or-equal deadline already.
                    return
                # Parked with a LATER deadline: keep the earliest one
                # (client-go delaying-queue semantics). The old heap entry
                # is now stale and is skipped when it surfaces.
            else:
                self._queued.add(item)
            self._delayed_due[item] = due
            self._delayed_seq += 1
            heapq.heappush(self._delayed, (due, self._delayed_seq, item))
            self._cond.notify()

    def add_rate_limited(self, item: Hashable) -> None:
        with self._cond:
            failures = self._failures.get(item, 0)
            self._failures[item] = failures + 1
        self.add_after(
            item,
            backoff_delay(self._base_delay, self._max_delay, item, failures),
        )

    def forget(self, item: Hashable) -> None:
        with self._cond:
            self._failures.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        with self._cond:
            return self._failures.get(item, 0)

    # -- consumer side -------------------------------------------------------

    def _promote_due(self) -> Optional[float]:
        """Move due delayed items into the FIFO; return seconds until the next
        delayed item (None if heap empty)."""
        now = time.monotonic()
        while self._delayed:
            due, _, item = self._delayed[0]
            if self._delayed_due.get(item) != due:
                # Stale: superseded by a shorter deadline or an immediate add.
                heapq.heappop(self._delayed)
                continue
            if due > now:
                break
            heapq.heappop(self._delayed)
            del self._delayed_due[item]
            if item in self._queued:  # not cancelled
                if item in self._processing:
                    self._redo.add(item)
                    self._queued.discard(item)
                elif item not in self._queue:
                    # (an immediate add may have promoted it already)
                    self._queue.append(item)
        return (self._delayed[0][0] - now) if self._delayed else None

    def get(self, timeout: Optional[float] = None) -> Optional[Hashable]:
        """Block until an item is ready; None on shutdown or timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                next_due = self._promote_due()
                if self._queue:
                    item = self._queue.pop(0)
                    self._queued.discard(item)
                    self._processing.add(item)
                    return item
                if self._shutdown:
                    return None
                wait = next_due
                if deadline is not None:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        return None
                    wait = remain if wait is None else min(wait, remain)
                self._cond.wait(wait)

    def done(self, item: Hashable) -> None:
        with self._cond:
            self._processing.discard(item)
            if item in self._redo:
                self._redo.discard(item)
                self._queued.add(item)
                self._queue.append(item)
                self._cond.notify()

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue) + len(self._delayed_due)

    def empty_and_idle(self) -> bool:
        with self._cond:
            return not (
                self._queue or self._delayed_due
                or self._processing or self._redo
            )


def fnv1a_32(item: Hashable) -> int:
    """Stable 32-bit FNV-1a of an item's string form — shard routing must
    not depend on Python's seed-randomized hash()."""
    h = 2166136261
    for b in str(item).encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class _ShardGroupSource:
    """A worker's view of its shard group: blocking get() over one or more
    shards. With exactly one shard (the workers == shards sweet spot) it
    blocks directly on that shard's condition variable; with several it
    round-robins non-blocking gets with a short park between sweeps."""

    def __init__(self, parent: "ShardedRateLimitingQueue", shards: List,
                 poll: float = 0.005):
        self._parent = parent
        self._shards = shards
        self._poll = poll

    def get(self, timeout: Optional[float] = None):
        if len(self._shards) == 1:
            return self._shards[0].get(timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            for q in self._shards:
                item = q.get(timeout=0)
                if item is not None:
                    return item
            if self._parent.is_shutdown():
                return None
            if deadline is not None and time.monotonic() >= deadline:
                return None
            # Cheap park between sweeps: a delayed item on any shard in the
            # group surfaces within one poll interval.
            item = self._shards[0].get(timeout=self._poll)
            if item is not None:
                return item


class ShardedRateLimitingQueue:
    """Key-range-sharded rate-limiting queue: N independent
    RateLimitingQueues (native C++ ones when available) with FNV-routed
    membership, presenting the single-queue interface.

    A key always maps to the same shard, so every per-key contract —
    dedup-while-queued, redo-after-done, per-item backoff state,
    earliest-deadline delay collapsing — holds exactly as in the unsharded
    queue; only cross-key FIFO order is relaxed to per-shard FIFO.
    ``Controller.run(workers=N)`` binds each worker to a shard group via
    ``worker_source`` so workers block on disjoint locks; the deterministic
    ``drain()`` path uses the top-level ``get(timeout=0)`` sweep.
    """

    def __init__(self, shards: int, make_queue=None, **kwargs):
        if make_queue is None:
            def make_queue(**kw):
                return RateLimitingQueue(**kw)
        self.n_shards = max(1, int(shards))
        self.shards = [make_queue(**kwargs) for _ in range(self.n_shards)]
        self._next = 0  # rotating sweep start so no shard starves in drain
        self._down = False

    def _shard(self, item: Hashable):
        return self.shards[fnv1a_32(item) % self.n_shards]

    def add(self, item: Hashable) -> None:
        self._shard(item).add(item)

    def add_after(self, item: Hashable, delay: float) -> None:
        self._shard(item).add_after(item, delay)

    def add_rate_limited(self, item: Hashable) -> None:
        self._shard(item).add_rate_limited(item)

    def forget(self, item: Hashable) -> None:
        self._shard(item).forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self._shard(item).num_requeues(item)

    def get(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            start = self._next
            self._next = (start + 1) % self.n_shards
            for i in range(self.n_shards):
                q = self.shards[(start + i) % self.n_shards]
                item = q.get(timeout=0)
                if item is not None:
                    return item
            if self._down:
                return None
            if deadline is not None and time.monotonic() >= deadline:
                return None
            # Blocking path (rare: workers use worker_source instead):
            # park briefly on shard 0 and re-sweep.
            item = self.shards[0].get(timeout=0.005)
            if item is not None:
                return item

    def worker_source(self, index: int, nworkers: int) -> _ShardGroupSource:
        """Shard group for worker ``index`` of ``nworkers``: shard j goes to
        worker j % nworkers. Extra workers past the shard count compete
        over all shards (correct — the queues are multi-consumer safe)."""
        mine = [self.shards[j] for j in range(self.n_shards)
                if j % nworkers == index]
        if not mine:
            mine = list(self.shards)
        return _ShardGroupSource(self, mine)

    def done(self, item: Hashable) -> None:
        self._shard(item).done(item)

    def is_shutdown(self) -> bool:
        return self._down

    def shutdown(self) -> None:
        self._down = True
        for q in self.shards:
            q.shutdown()

    def __len__(self) -> int:
        return sum(len(q) for q in self.shards)

    def empty_and_idle(self) -> bool:
        return all(q.empty_and_idle() for q in self.shards)
