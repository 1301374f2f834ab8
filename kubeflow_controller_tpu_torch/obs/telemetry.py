"""Process-wide metrics registry and bounded percentile reservoirs.

The PyTorch port keeps its own copy of this framework-neutral module
(the counterpart of ``kubeflow_controller_tpu/obs/telemetry.py``) so
that the port imports nothing of the JAX package.

``MetricsRegistry`` replaces the pattern of each subsystem keeping
private lists of samples: producers grab a named instrument once
(``registry().counter("requests", subsystem="serving")``) and bump it;
consumers (``ServingStats.summary()``, the benches, the fleet JSONL)
read one flat deterministic ``snapshot()``.

Three instrument kinds, all thread-safe (one lock per instrument —
writers on different instruments never contend):

* :class:`Counter` — monotonically increasing float.
* :class:`Gauge` — last-write-wins float.
* :class:`Histogram` — fixed power-of-two buckets.  The bucket for a
  value ``v`` is ``ceil(log2(v))`` clamped to ``[lo_exp, hi_exp]``,
  so boundaries are exact binary numbers (…, 0.25, 0.5, 1, 2, 4, …)
  and bucketing is a single ``frexp`` — no per-observation search.

Naming convention (docs/observability.md): instrument names are
``snake_case`` with a unit suffix (``_ms``, ``_s``, ``_tokens``);
subsystems are ``serving`` / ``router`` / ``control``.  Snapshot keys
are ``"{subsystem}.{name}"`` (or bare ``name`` with no subsystem),
plus ``.count/.sum/.min/.max`` and ``.bucket_le_{boundary}`` for
histograms.

:class:`Reservoir` is the bounded sample store that replaced the
unbounded ``ServingStats.ttfts_s`` / ``tpots_s`` / ``queue_waits_s``
lists: a deterministic ring that keeps the most recent ``cap``
samples — percentiles are *exact* below the cap (bench gates
unchanged) and sliding-window above it, with the shed count surfaced
as ``samples_dropped``.  It keeps enough of the list API
(``append`` / ``extend`` / ``len`` / iteration / slicing via
``list()``) that existing consumers work unchanged, and adds
``total`` / ``since(n)`` so windowed readers (the fleet router's
health hysteresis) survive eviction.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Reservoir",
    "registry",
    "reset_registry",
]


class Counter:
    """Monotonic counter. ``inc()`` is lost-update-free across threads."""

    __slots__ = ("name", "subsystem", "_lock", "_value")

    def __init__(self, name: str, subsystem: str = "") -> None:
        self.name = name
        self.subsystem = subsystem
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snapshot(self, out: Dict[str, float], prefix: str) -> None:
        out[prefix] = self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "subsystem", "_lock", "_value")

    def __init__(self, name: str, subsystem: str = "") -> None:
        self.name = name
        self.subsystem = subsystem
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snapshot(self, out: Dict[str, float], prefix: str) -> None:
        out[prefix] = self.value


class Histogram:
    """Fixed power-of-two bucket histogram.

    Bucket ``i`` (for ``lo_exp <= i <= hi_exp``) counts observations
    with ``2**(i-1) < v <= 2**i``; values at or below ``2**(lo_exp-1)``
    land in the lowest bucket, values above ``2**hi_exp`` in a final
    overflow bucket.  Defaults cover 1 µs … ~131 s when observing
    seconds (exponents -20 … 17).
    """

    __slots__ = (
        "name", "subsystem", "lo_exp", "hi_exp",
        "_lock", "_buckets", "_count", "_sum", "_min", "_max",
    )

    def __init__(
        self,
        name: str,
        subsystem: str = "",
        lo_exp: int = -20,
        hi_exp: int = 17,
    ) -> None:
        if hi_exp <= lo_exp:
            raise ValueError(f"histogram {name}: hi_exp must exceed lo_exp")
        self.name = name
        self.subsystem = subsystem
        self.lo_exp = lo_exp
        self.hi_exp = hi_exp
        self._lock = threading.Lock()
        # buckets[0..n-1] = exponents lo..hi, buckets[n] = overflow
        self._buckets = [0] * (hi_exp - lo_exp + 2)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def bucket_index(self, v: float) -> int:
        """Index of the bucket ``v`` falls into (no lock; pure)."""
        if v <= 0 or not math.isfinite(v):
            return 0 if v <= 0 else len(self._buckets) - 1
        m, e = math.frexp(v)  # v = m * 2**e, 0.5 <= m < 1 -> v <= 2**e
        # frexp gives the smallest e with v <= 2**e except exact powers
        # of two, where m == 0.5 and v == 2**(e-1).
        if m == 0.5:
            e -= 1
        if e <= self.lo_exp:
            return 0
        if e > self.hi_exp:
            return len(self._buckets) - 1
        return e - self.lo_exp

    def observe(self, v: float) -> None:
        v = float(v)
        idx = self.bucket_index(v)
        with self._lock:
            self._buckets[idx] += 1
            self._count += 1
            if math.isfinite(v):
                self._sum += v
                if v < self._min:
                    self._min = v
                if v > self._max:
                    self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _snapshot(self, out: Dict[str, float], prefix: str) -> None:
        with self._lock:
            buckets = list(self._buckets)
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        out[f"{prefix}.count"] = float(count)
        out[f"{prefix}.sum"] = total
        if count:
            out[f"{prefix}.min"] = mn
            out[f"{prefix}.max"] = mx
        for i, c in enumerate(buckets[:-1]):
            if c:
                out[f"{prefix}.bucket_le_2e{self.lo_exp + i}"] = float(c)
        if buckets[-1]:
            out[f"{prefix}.bucket_overflow"] = float(buckets[-1])


class MetricsRegistry:
    """Get-or-create instrument registry with a flat snapshot.

    Instruments are keyed ``(subsystem, name)``; asking twice returns
    the same object, asking for an existing key with a different kind
    raises.  ``snapshot()`` returns a flat ``dict`` with sorted keys —
    deterministic given the same observations, safe to ``json.dumps``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, str], Any] = {}

    def _get(self, kind: type, name: str, subsystem: str, **kwargs: Any) -> Any:
        key = (subsystem, name)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = kind(name, subsystem, **kwargs)
                self._instruments[key] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {subsystem!r}/{name!r} already registered as "
                    f"{type(inst).__name__}, requested {kind.__name__}"
                )
            return inst

    def counter(self, name: str, subsystem: str = "") -> Counter:
        return self._get(Counter, name, subsystem)

    def gauge(self, name: str, subsystem: str = "") -> Gauge:
        return self._get(Gauge, name, subsystem)

    def histogram(
        self, name: str, subsystem: str = "",
        lo_exp: int = -20, hi_exp: int = 17,
    ) -> Histogram:
        return self._get(Histogram, name, subsystem, lo_exp=lo_exp, hi_exp=hi_exp)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            instruments = sorted(self._instruments.items())
        out: Dict[str, float] = {}
        for (subsystem, name), inst in instruments:
            prefix = f"{subsystem}.{name}" if subsystem else name
            inst._snapshot(out, prefix)
        return dict(sorted(out.items()))

    def reset(self) -> None:
        """Drop every instrument (tests / bench legs)."""
        with self._lock:
            self._instruments.clear()


_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _DEFAULT


def reset_registry() -> None:
    """Clear the default registry (test isolation)."""
    _DEFAULT.reset()


class Reservoir:
    """Bounded deterministic sample store (most-recent ``cap`` kept).

    Below the cap it *is* the full sample list, so percentiles over it
    are exact; at the cap it is a sliding window and ``dropped``
    counts the evicted prefix.  ``total`` is the logical append count
    and ``since(n)`` returns the retained samples with logical index
    ``>= n`` — windowed readers track ``seen = r.total`` instead of
    ``seen = len(r)`` so eviction can't replay or skip samples.
    """

    __slots__ = ("cap", "_buf", "_start", "_total")

    def __init__(self, cap: int = 4096, items: Optional[Iterable[float]] = None):
        if cap <= 0:
            raise ValueError(f"reservoir cap must be positive, got {cap}")
        self.cap = cap
        self._buf: List[float] = []
        self._start = 0  # ring head when full
        self._total = 0
        if items is not None:
            self.extend(items)

    @property
    def total(self) -> int:
        """Logical number of samples ever appended."""
        return self._total

    @property
    def dropped(self) -> int:
        return self._total - len(self._buf)

    def append(self, v: float) -> None:
        if len(self._buf) < self.cap:
            self._buf.append(v)
        else:
            self._buf[self._start] = v
            self._start += 1
            if self._start == self.cap:
                self._start = 0
        self._total += 1

    def extend(self, items: Iterable[float]) -> None:
        for v in items:
            self.append(v)

    def since(self, n: int) -> List[float]:
        """Retained samples with logical index ``>= n``, in order."""
        first_kept = self._total - len(self._buf)
        skip = max(0, n - first_kept)
        items = list(self)
        return items[skip:] if skip else items

    def clear(self) -> None:
        self._buf.clear()
        self._start = 0
        self._total = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)

    def __iter__(self) -> Iterator[float]:
        buf, start = self._buf, self._start
        for i in range(len(buf)):
            yield buf[(start + i) % len(buf)]

    def __getitem__(self, idx):
        return list(self)[idx]

    def __repr__(self) -> str:
        return (
            f"Reservoir(cap={self.cap}, len={len(self._buf)}, "
            f"total={self._total})"
        )
