"""What a run hands the per-layer readers (``layer_metrics/*.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from gpubench.harness.profiling import Trace


def p90(values: List[float]) -> Optional[float]:
    """Nearest-rank 90th percentile: the smallest value with at least 90%
    of the values at or below it."""
    if not values:
        return None
    s = sorted(values)
    k = max(0, -(-9 * len(s) // 10) - 1)
    return s[k]


@dataclass
class Records:
    cell: str
    port: Dict[str, Any]                 # the configuration's port sizes
    peaks: Dict[str, float]
    window_s: float
    trace: Optional[Trace] = None
    # serving: one dict a request due (or sent) in the window, with its
    # due, admit, first and done times (s from the window's start) and
    # its prompt and served token counts
    requests: List[Dict[str, Any]] = field(default_factory=list)
    serving: Dict[str, float] = field(default_factory=dict)
    # the recorder's logs over the traced slice
    decode_contexts: List[List[int]] = field(default_factory=list)
    prefills: List[int] = field(default_factory=list)
    chunks: List[Any] = field(default_factory=list)
    # training: the rows' document lengths, the steps inside the traced
    # slice, the window's peak memory
    train: Dict[str, Any] = field(default_factory=dict)
