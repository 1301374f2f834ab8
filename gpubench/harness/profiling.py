"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
seconds of the measured window, reduced to kernel intervals by name, the
device's busy time (the union of every device operation's interval),
the benchmark's own host spans, and the longest idle gaps named by what
the host was doing.

The slice begins and ends on a synchronised device, so the work the
recorders of :mod:`gpubench.harness.recorder` log inside it is the work
the kernels in it did.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


def span(name: str, on: bool):
    """A host span the profiler records (``record_function``) in a traced
    run, and nothing otherwise."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


@dataclass
class Trace:
    window_s: float
    kernels: List[Tuple[str, int, int]]           # (name, start ns, end ns)
    busy_s: float
    device_ops: List[List]                        # [[name, seconds], ...]
    idle_gaps: List[List]

    def time_s(self, *patterns: str) -> float:
        return sum(e - s for n, s, e in self.kernels
                   if any(p in n for p in patterns)) / 1e9


class Slice:
    """Start and stop the profiler around part of a window; the trace is
    reduced after the window (:meth:`finish`), so the reduction does not
    hold up the loop. ``warm()`` in set-up starts and stops the profiler
    once, so that its first start (CUPTI's set-up, seconds) does not fall
    inside the window."""

    def __init__(self):
        self.prof = None
        self.stopped = False
        self.t0 = self.t1 = 0.0
        self.trace: Optional[Trace] = None

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.stopped

    @staticmethod
    def warm() -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum()
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stopped = True

    def finish(self) -> Optional[Trace]:
        """The slice's trace, once it has stopped (``None`` if it never
        ran)."""
        if self.prof is not None and self.stopped and self.trace is None:
            self.trace = reduce(self.prof, self.t1 - self.t0)
            self.prof = None
        return self.trace


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of ``[start, end)`` intervals (rows sorted by start)."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def reduce(prof, window_s: float) -> Trace:
    from torch.autograd import DeviceType

    kernels, cpu, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type()
        s = int(ev.start_ns())
        e = s + int(ev.duration_ns())
        if dev == DeviceType.CUDA:
            if not ev.is_user_annotation():
                kernels.append((ev.name(), s, e))
        elif dev == DeviceType.CPU:
            (spans if ev.is_user_annotation() else cpu).append((ev.name(), s, e))
    kernels.sort(key=lambda k: k[1])
    by_name: Dict[str, int] = {}
    for n, s, e in kernels:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if kernels:
        merged = _merge(np.array([[s, e] for _, s, e in kernels], dtype=np.int64))
        busy = int((merged[:, 1] - merged[:, 0]).sum())
        gaps = np.stack([merged[:-1, 1], merged[1:, 0]], 1) if len(merged) > 1 \
            else np.zeros((0, 2), np.int64)
    else:
        busy, gaps = 0, np.zeros((0, 2), np.int64)
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:10]] if len(gaps) else gaps
    idle = [[_label(int((g0 + g1) // 2), spans, cpu), (g1 - g0) / 1e9]
            for g0, g1 in longest]
    return Trace(window_s=window_s, kernels=kernels, busy_s=busy / 1e9,
                 device_ops=[[n[:120], t / 1e9] for n, t in top],
                 idle_gaps=idle)


def _deepest(t: int, events) -> Optional[str]:
    """The innermost event (latest start) covering time ``t``."""
    best, best_s = None, -1
    for n, s, e in events:
        if s <= t < e and s > best_s:
            best, best_s = n, s
    return best


def _label(t: int, spans, cpu) -> str:
    """What the host was doing at ``t``: the benchmark's span and, inside
    it, the innermost operation or runtime call."""
    outer = _deepest(t, spans) or "outside spans"
    inner = _deepest(t, cpu)
    return outer if inner is None else f"{outer} > {inner}"[:120]
