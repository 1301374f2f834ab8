"""Low-overhead span recorder with Chrome-trace-event export.

The PyTorch port keeps its own copy of this standard-library module (the
counterpart of ``kubeflow_controller_tpu/obs/trace.py``), so that the
port imports nothing of the JAX package.

The :class:`Tracer` is the observability sink shared by the serving
engine (``dataplane/serving_engine.py``) and the fleet router
(``dataplane/router.py``). Design constraints, in order:

1. **Zero cost when absent.**  Every producer takes ``tracer=None``
   and guards each site with ``if tracer is not None``: one pointer
   comparison on the hot path, nothing else.
2. **Cheap when present.**  Recording a span is one tuple append into
   a bounded ``deque`` under a lock (uncontended in the single-threaded
   engine loop). No string formatting, no I/O, and no timestamps taken
   on behalf of the caller unless asked: producers that already read a
   clock pass their own ``t0``/``t1``. A span is host time: recording
   one never synchronizes the device or copies from it, so a traced run
   launches exactly the kernels an untraced run launches.
3. **Bounded.**  The ring keeps the most recent ``capacity`` spans;
   overflow increments ``spans_dropped`` (surfaced in
   ``ServingStats.summary()`` and the fleet summary) instead of growing
   without bound.

Export is the Chrome trace-event JSON format (the ``traceEvents``
dict flavour), loadable in Perfetto or ``chrome://tracing``:

* complete spans -> ``ph:"X"`` with ``ts``/``dur`` in microseconds,
* point events   -> ``ph:"i"`` (instant, thread-scoped),
* tracks (``dataplane`` / ``router`` / ``control``) -> one ``pid``
  each with a ``process_name`` metadata record,
* the ``rid`` -> one ``tid`` per distinct value with a ``thread_name``
  metadata record, so a request's lifecycle reads as one horizontal
  lane and a fleet request's router and engine hops stitch into one
  trace.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Span", "Tracer", "load_chrome_trace"]

# Track name -> stable pid. Unknown tracks get pids assigned after these.
_TRACK_PIDS = {"dataplane": 1, "router": 2, "control": 3}


@dataclass(frozen=True)
class Span:
    """One recorded interval (or instant, when ``t1 is None``)."""

    sid: int
    name: str
    t0: float
    t1: Optional[float]
    track: str
    rid: Optional[str]
    parent: Optional[int]
    attrs: Tuple[Tuple[str, Any], ...] = ()

    @property
    def dur_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0


class Tracer:
    """Thread-safe bounded span ring with Chrome-trace export.

    Parameters
    ----------
    capacity:
        Max retained spans; the oldest are evicted (and counted in
        ``spans_dropped``) once full.
    clock:
        Monotonic clock used for ``span()``/``add_event()`` when the
        caller doesn't pass explicit timestamps.  Producers that
        record retrospective spans (the engine) must pass timestamps
        from the *same* clock so lanes line up in the export.
    path:
        Optional default destination for :meth:`flush`.
    """

    def __init__(
        self,
        capacity: int = 65536,
        clock: Callable[[], float] = time.perf_counter,
        path: Optional[str] = None,
    ) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.path = path
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._next_sid = 1
        self._recorded = 0
        self._dropped = 0
        self._epoch = clock()  # ts origin for export
        self._tls = threading.local()  # per-thread parent stack for span()

    # ------------------------------------------------------------------
    # Recording

    @property
    def spans_recorded(self) -> int:
        return self._recorded

    @property
    def spans_dropped(self) -> int:
        return self._dropped

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        track: str = "dataplane",
        rid: Optional[str] = None,
        parent: Optional[int] = None,
        sid: Optional[int] = None,
        **attrs: Any,
    ) -> int:
        """Record a completed interval with caller-supplied timestamps.

        Returns the span id, usable as ``parent=`` for children.  A
        pre-reserved ``sid`` (from a live ``span()`` context) may be
        supplied so children recorded before the parent closes can
        still link to it.
        """
        with self._lock:
            if sid is None:
                sid = self._next_sid
                self._next_sid += 1
            if len(self._spans) == self.capacity:
                self._dropped += 1
            self._spans.append(
                Span(sid, name, t0, t1, track, rid, parent, tuple(attrs.items()))
            )
            self._recorded += 1
        return sid

    def _reserve_sid(self) -> int:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        return sid

    def add_event(
        self,
        name: str,
        t: Optional[float] = None,
        *,
        track: str = "dataplane",
        rid: Optional[str] = None,
        **attrs: Any,
    ) -> int:
        """Record an instant (zero-duration) event."""
        if t is None:
            t = self.clock()
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            if len(self._spans) == self.capacity:
                self._dropped += 1
            self._spans.append(
                Span(sid, name, t, None, track, rid, None, tuple(attrs.items()))
            )
            self._recorded += 1
        return sid

    def span(
        self,
        name: str,
        *,
        track: str = "control",
        rid: Optional[str] = None,
        **attrs: Any,
    ) -> "_SpanCtx":
        """Context manager for live spans (control plane / router).

        Nesting is tracked per-thread: a ``span()`` opened inside
        another becomes its child automatically.  Attrs may be added
        after entry via ``ctx.set(key=value)`` (e.g. an outcome known
        only at the end of a sync).
        """
        return _SpanCtx(self, name, track, rid, attrs)

    # ------------------------------------------------------------------
    # Reading / export

    def snapshot(self) -> List[Span]:
        """Copy of the retained spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def export(self) -> Dict[str, Any]:
        """Chrome trace-event JSON dict (``{"traceEvents": [...]}``)."""
        spans = self.snapshot()
        events: List[Dict[str, Any]] = []
        pids: Dict[str, int] = dict(_TRACK_PIDS)
        tids: Dict[Tuple[int, Optional[str]], int] = {}
        for s in spans:
            pid = pids.setdefault(s.track, len(pids) + 1)
            tkey = (pid, s.rid)
            tid = tids.get(tkey)
            if tid is None:
                tid = len(tids) + 1
                tids[tkey] = tid
            args = {k: v for k, v in s.attrs}
            if s.rid is not None:
                # rid in args (not just the tid grouping) is what lets a
                # cross-process audit stitch router and engine spans for
                # the same request back together.
                args["rid"] = s.rid
            if s.parent is not None:
                args["parent"] = s.parent
            ev: Dict[str, Any] = {
                "name": s.name,
                "cat": s.track,
                "pid": pid,
                "tid": tid,
                "ts": (s.t0 - self._epoch) * 1e6,
                "args": args,
            }
            if s.t1 is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = max(0.0, (s.t1 - s.t0) * 1e6)
            events.append(ev)
        meta: List[Dict[str, Any]] = []
        for track, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            meta.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": track},
                }
            )
        for (pid, rid), tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": rid if rid is not None else "-"},
                }
            )
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "spans_recorded": self._recorded,
                "spans_dropped": self._dropped,
            },
        }

    def export_json(self, path: str) -> None:
        """Write the Chrome trace to ``path`` (atomic-ish: whole dump)."""
        doc = self.export()
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")

    def flush(self) -> Optional[str]:
        """Export to the configured ``path``; no-op when path is None.

        Idempotent and safe to call from multiple exit paths (drain,
        SIGTERM handler, DrainError unwind): each call rewrites the
        full file, so the last writer wins and the file is always a
        complete JSON document.
        """
        if self.path is None:
            return None
        self.export_json(self.path)
        return self.path

    # ------------------------------------------------------------------
    # Per-thread parent stack (for the span() context manager)

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st


class _SpanCtx:
    """Live span handle from :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "name", "track", "rid", "_attrs", "_t0", "sid")

    def __init__(
        self,
        tracer: Tracer,
        name: str,
        track: str,
        rid: Optional[str],
        attrs: Dict[str, Any],
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.track = track
        self.rid = rid
        self._attrs = dict(attrs)
        self._t0 = 0.0
        self.sid = 0

    def set(self, **attrs: Any) -> None:
        self._attrs.update(attrs)

    def __enter__(self) -> "_SpanCtx":
        self._t0 = self._tracer.clock()
        self.sid = self._tracer._reserve_sid()
        self._tracer._stack().append(self.sid)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = self._tracer.clock()
        stack = self._tracer._stack()
        stack.pop()
        parent = stack[-1] if stack else None
        if exc_type is not None:
            self._attrs.setdefault("error", exc_type.__name__)
        self._tracer.add_span(
            self.name,
            self._t0,
            t1,
            track=self.track,
            rid=self.rid,
            parent=parent,
            sid=self.sid,
            **self._attrs,
        )


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Load + validate a Chrome trace file; raises on malformed input.

    Checks the invariants Perfetto relies on: a ``traceEvents`` list
    whose entries carry ``ph``/``pid``/``tid``/``ts`` and, for
    ``ph:"X"``, a non-negative ``dur``.
    """
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError(f"{path}: not a Chrome trace (missing traceEvents list)")
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: non-dict trace event: {ev!r}")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E"):
            raise ValueError(f"{path}: unknown phase {ph!r}")
        if ph == "M":
            continue
        for k in ("pid", "tid", "ts"):
            if not isinstance(ev.get(k), (int, float)):
                raise ValueError(f"{path}: event missing numeric {k}: {ev!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{path}: X event with bad dur: {ev!r}")
    return doc
