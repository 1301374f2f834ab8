"""Event aggregation + spam protection (client-go tools/record parity).

The reference's ``record.EventRecorder`` (vendored client-go
``tools/record``, wired at ``pkg/controller/controller.go:91-94``) has
THREE layers between a controller and the events API
(``vendor/k8s.io/client-go/tools/record/events_cache.go``):

1. **Spam filter** (``events_cache.go:70-131``): a token bucket per
   event source+object — burst 25, refill 1 token / 5 min. A component
   hammering one object gets its excess events DROPPED client-side, not
   posted.
2. **Similar-event aggregation** (``events_cache.go:155-181``): events
   that share (source, object, type, reason) but differ in message are
   collapsed after 10 distinct messages inside a 10-minute window into
   ONE record whose message is
   ``"(combined from similar events): <latest message>"``.
3. **Identical-event dedup** (``EventLogger``): an exact repeat PATCHes
   the stored Event's count/lastTimestamp instead of creating a row.

With layer 3 alone, a crash-looping job whose message varies per pod
name would post one API write per variant. This module implements all
three, backend-neutrally:
``observe()`` answers "drop it", "create a record (you, exactly once)",
or "bump this existing record" — and hands back the EFFECTIVE message
(the combined form once aggregation kicks in).

Thread-safety: reconcile workers and pod-lifecycle threads record
concurrently. Creation responsibility is decided under the aggregator
lock — exactly ONE caller of the first occurrence sees
``obs.created == True`` (ADVICE r4: two racing first observers both saw
``handle is None`` and both POSTed, leaving a duplicate Event object).

Counterpart of ``kubeflow_controller_tpu/cluster/event_recorder.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional, Set, Tuple

DEFAULT_CACHE_SIZE = 4096
# client-go defaults (events_cache.go): NewEventSourceObjectSpamFilter's
# burst/qps and defaultAggregateMaxEvents/defaultAggregateIntervalInSeconds.
SPAM_BURST = 25
SPAM_QPS = 1.0 / 300.0
AGGREGATE_MAX_EVENTS = 10
AGGREGATE_INTERVAL_S = 600.0
AGGREGATE_PREFIX = "(combined from similar events): "


@dataclass
class EventRecord:
    count: int
    first_ts: float
    last_ts: float
    # Backend-private handle for updating the stored record in place
    # (fake cluster: row index; k8s wire: the server-assigned Event name).
    handle: Any = None
    # True while some caller owns the backend-create for this record
    # (set for the observe() that returns created=True, cleared by
    # set_handle/abort_create). Lets a later repeat RECOVER creation when
    # the original POST failed, without reopening the duplicate-POST race.
    creating: bool = False


@dataclass
class Observation:
    """One observe() outcome. ``record`` is the live aggregate entry;
    ``created`` is True for exactly ONE caller per stored record (that
    caller must create the backend row and ``set_handle`` it);
    ``message`` is the effective message to store — the combined form
    when similar-event aggregation has kicked in."""
    record: EventRecord
    created: bool
    message: str
    key: Tuple


@dataclass
class _SpamBucket:
    tokens: float
    last: float


@dataclass
class _AggregateEntry:
    local_messages: Set[str] = field(default_factory=set)
    last_ts: float = 0.0


class EventAggregator:
    """Thread-safe spam filter + similar-event aggregator + identical
    dedup for (namespace, kind, name, reason, message) event keys."""

    def __init__(
        self,
        maxsize: int = DEFAULT_CACHE_SIZE,
        spam_burst: int = SPAM_BURST,
        spam_qps: float = SPAM_QPS,
        aggregate_max_events: int = AGGREGATE_MAX_EVENTS,
        aggregate_interval_s: float = AGGREGATE_INTERVAL_S,
    ):
        self._lock = threading.Lock()
        self._cache: "OrderedDict[Tuple, EventRecord]" = OrderedDict()
        self._maxsize = maxsize
        self._spam: "OrderedDict[Tuple, _SpamBucket]" = OrderedDict()
        self._agg: "OrderedDict[Tuple, _AggregateEntry]" = OrderedDict()
        self._spam_burst = spam_burst
        self._spam_qps = spam_qps
        self._agg_max = aggregate_max_events
        self._agg_interval = aggregate_interval_s

    def _admit(self, source_key: Tuple, now: float) -> bool:
        """Token-bucket spam filter per source+object key."""
        b = self._spam.get(source_key)
        if b is None:
            b = _SpamBucket(tokens=float(self._spam_burst), last=now)
            self._spam[source_key] = b
            while len(self._spam) > self._maxsize:
                self._spam.popitem(last=False)
        else:
            b.tokens = min(
                float(self._spam_burst),
                b.tokens + max(0.0, now - b.last) * self._spam_qps,
            )
            b.last = now
            self._spam.move_to_end(source_key)
        if b.tokens < 1.0:
            return False
        b.tokens -= 1.0
        return True

    def _aggregate_message(
        self, ns: str, kind: str, name: str, reason: str, message: str,
        now: float,
    ) -> str:
        """client-go EventAggregate: once more than ``aggregate_max``
        DISTINCT messages share (object, reason) within the interval,
        collapse onto the combined record."""
        akey = (ns, kind, name, reason)
        e = self._agg.get(akey)
        if e is None or now - e.last_ts > self._agg_interval:
            e = _AggregateEntry()
            self._agg[akey] = e
            self._agg.move_to_end(akey)
            while len(self._agg) > self._maxsize:
                self._agg.popitem(last=False)
        e.last_ts = now
        e.local_messages.add(message)
        if len(e.local_messages) >= self._agg_max:
            return AGGREGATE_PREFIX + message
        return message

    def observe(
        self, namespace: str, kind: str, name: str, reason: str,
        message: str, now: float,
    ) -> Optional[Observation]:
        """Record one occurrence. Returns None when the spam filter drops
        the event (no API write at all); otherwise an ``Observation``
        whose ``created`` flag is True for exactly one caller per stored
        record (that caller POSTs; everyone else PATCHes via ``handle``
        or, if the creator hasn't stashed the handle yet, skips —
        best-effort, the count is already aggregated)."""
        with self._lock:
            if not self._admit((namespace, kind, name), now):
                return None
            eff = self._aggregate_message(
                namespace, kind, name, reason, message, now)
            # Aggregated events share ONE record per (object, reason):
            # the key drops the per-event message variance.
            if eff.startswith(AGGREGATE_PREFIX):
                key = (namespace, kind, name, reason, AGGREGATE_PREFIX)
            else:
                key = (namespace, kind, name, reason, message)
            rec = self._cache.get(key)
            if rec is None:
                rec = EventRecord(
                    count=1, first_ts=now, last_ts=now, creating=True,
                )
                self._cache[key] = rec
                while len(self._cache) > self._maxsize:
                    self._cache.popitem(last=False)
                return Observation(rec, True, eff, key)
            rec.count += 1
            rec.last_ts = now
            self._cache.move_to_end(key)
            return Observation(rec, False, eff, key)

    def begin_create(self, key: Tuple) -> bool:
        """Claim creation responsibility for a record whose original
        creator failed (handle still unset, no creator in flight).
        Exactly one concurrent caller gets True."""
        with self._lock:
            rec = self._cache.get(key)
            if rec is None or rec.handle is not None or rec.creating:
                return False
            rec.creating = True
            return True

    def reclaim_create(self, key: Tuple) -> bool:
        """The stored Event vanished server-side (PATCH answered 404 —
        events are TTL-GC'd on real clusters): atomically forget the stale
        handle and claim re-creation. Exactly one of any number of
        concurrent reclaimers gets True; the rest drop their write — the
        count is aggregated, so the next repeat PATCHes the fresh Event."""
        with self._lock:
            rec = self._cache.get(key)
            if rec is None:
                return False
            if rec.handle is not None:
                rec.handle = None
                rec.creating = True
                return True
            if not rec.creating:
                rec.creating = True
                return True
            return False

    def abort_create(self, key: Tuple) -> None:
        """The claimed backend-create failed: release the claim so a
        later occurrence can retry."""
        with self._lock:
            rec = self._cache.get(key)
            if rec is not None:
                rec.creating = False

    def set_handle(self, key: Tuple, handle: Any) -> None:
        with self._lock:
            rec = self._cache.get(key)
            if rec is not None:
                rec.handle = handle
                rec.creating = False

    def forget(self, key: Tuple) -> None:
        """Drop a key (e.g. the stored record vanished server-side and the
        next occurrence must re-create it)."""
        with self._lock:
            self._cache.pop(key, None)

    def get(
        self, namespace: str, kind: str, name: str, reason: str,
        message: str,
    ) -> Optional[EventRecord]:
        """Record for an event key: the exact-message record when one
        exists, else the combined similar-event record this message would
        have aggregated onto (observe() moves occurrences there once the
        distinct-message threshold trips — without the fallback those
        counts would be unreachable by callers holding the raw message)."""
        with self._lock:
            rec = self._cache.get((namespace, kind, name, reason, message))
            if rec is not None:
                return rec
            return self._cache.get(
                (namespace, kind, name, reason, AGGREGATE_PREFIX)
            )
