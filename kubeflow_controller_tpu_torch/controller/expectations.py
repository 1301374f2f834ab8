"""ControllerExpectations — the cached-state race guard.

Semantics rebuilt from the vendored k8s utility the reference leans on
(``vendor/k8s.io/kubernetes/pkg/controller/controller_utils.go:125-287``;
usage ``pkg/controller/controller.go:262,357-411,451,531``): between issuing a
create and observing it through the watch cache, a controller must not act on
the stale cache or it will create duplicates. Each job key tracks how many
creations/deletions are still unobserved; a sync is allowed only when both hit
zero or the record is older than a TTL (liveness backstop: a lost watch event
can only stall a job for the TTL, 5 min in the reference,
``controller_utils.go:205-207``).

Counterpart of ``kubeflow_controller_tpu/controller/expectations.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

EXPECTATION_TTL_SECONDS = 5 * 60.0


@dataclass
class _Expectation:
    adds: int = 0
    dels: int = 0
    timestamp: float = field(default_factory=time.monotonic)

    def fulfilled(self) -> bool:
        return self.adds <= 0 and self.dels <= 0

    def expired(self, ttl: float) -> bool:
        return time.monotonic() - self.timestamp > ttl


class ControllerExpectations:
    def __init__(self, ttl: float = EXPECTATION_TTL_SECONDS):
        self._ttl = ttl
        self._lock = threading.Lock()
        self._store: Dict[str, _Expectation] = {}

    def satisfied(self, key: str) -> bool:
        """True when the controller may trust its cache for this key."""
        with self._lock:
            exp = self._store.get(key)
            if exp is None:
                return True
            return exp.fulfilled() or exp.expired(self._ttl)

    def expect_creations(self, key: str, count: int) -> None:
        with self._lock:
            self._store[key] = _Expectation(adds=count)

    def expect_deletions(self, key: str, count: int) -> None:
        with self._lock:
            self._store[key] = _Expectation(dels=count)

    def creation_observed(self, key: str) -> None:
        self._lower(key, adds=1)

    def deletion_observed(self, key: str) -> None:
        self._lower(key, dels=1)

    def _lower(self, key: str, adds: int = 0, dels: int = 0) -> None:
        with self._lock:
            exp = self._store.get(key)
            if exp is None:
                return
            exp.adds -= adds
            exp.dels -= dels

    def delete_expectations(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)

    def pending(self, key: str) -> Optional[tuple]:
        with self._lock:
            exp = self._store.get(key)
            return None if exp is None else (exp.adds, exp.dels)
