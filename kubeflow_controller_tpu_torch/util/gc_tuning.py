"""Garbage-collector tuning for the control-plane daemons.

At 5000 jobs / 10000 pods the profiler shows every function uniformly
~1.5x slower per call than at 1000 jobs — no single hot spot, the classic
signature of CPython's cyclic GC scanning an ever-larger live heap on a
fixed allocation budget (the reconcile path allocates heavily: the store
deep-copies on every get/list/update/emit). Measured on
``benchmarks/controlplane_bench.py --jobs 5000``: mean sync-handler time
421 us default, 325 us with gc fully disabled, 310 us with this tuning —
which keeps cycle collection alive (a long-running daemon must not leak
cycles) but makes it rare and exempts the boot-time heap:

- ``gc.freeze()`` moves everything allocated during process setup
  (imports, compiled regexes, informer caches primed by the initial
  list) into the permanent generation, so full collections stop
  re-scanning it;
- thresholds (200_000, 100, 100) make gen-0 collections ~300x rarer
  than the default 700-allocation cadence.

The domain dataclasses are acyclic by construction (owner references
carry uid strings, not object pointers), so surviving cycles are rare —
GC exists here as a leak backstop, not a steady-state reclaimer.

Counterpart of ``kubeflow_controller_tpu/util/gc_tuning.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import gc

TUNED_THRESHOLDS = (200_000, 100, 100)


def tune_for_control_plane() -> None:
    """Call once at daemon start, AFTER imports and initial cache priming
    (the later it runs, the more of the steady heap gc.freeze exempts)."""
    gc.collect()
    gc.freeze()
    gc.set_threshold(*TUNED_THRESHOLDS)
