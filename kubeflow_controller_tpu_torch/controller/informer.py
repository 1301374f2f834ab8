"""Informer: cached watch stream + event handler dispatch.

The in-process equivalent of client-go's SharedIndexInformer + Lister as the
reference wires them (``cmd/controller/main.go:46-52``,
``pkg/controller/controller.go:122-149``): subscribe to a store's watch feed,
maintain a local read cache, dispatch add/update/delete handlers, and offer a
periodic resync that re-delivers everything (the level-trigger safety net; the
reference uses a 30s resync).

The cache holds **frozen** objects (client-go's Lister contract, enforced):
every event object is frozen on ingest — a no-op for frozen-mode store
events (already sealed snapshots), one seal pass for the private parses a
wire watch source (REST/kube) delivers — and ``get``/``list`` hand the
cached reference out uncopied. The cache is still *state-separate* from
the store (it lags the watch stream), so the cache-staleness race the
expectations machinery guards against stays reproducible in tests.

Counterpart of ``kubeflow_controller_tpu/controller/informer.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from kubeflow_controller_tpu_torch.api.core import is_frozen
from kubeflow_controller_tpu_torch.cluster.events import EventType, WatchEvent
from kubeflow_controller_tpu_torch.cluster.store import ObjectStore, selector_matches

Handler = Callable[[WatchEvent], None]


class Informer:
    def __init__(self, store: ObjectStore, resync_period: float = 0.0,
                 injector=None):
        self._store = store
        self.kind = store.kind
        # Fault injection (docs/chaos.md): an injected hang at
        # "informer.deliver" models a stalled watch delivery — the cache
        # still updates (the apiserver stream arrived) but handlers are
        # not notified, exactly the edge-trigger loss a periodic
        # resync() exists to heal. None = off, byte-identical path.
        # Mutable attribute so the controller can thread one injector
        # through informers it did not construct.
        self.injector = injector
        self.deliveries_suppressed = 0
        self._cache: Dict[str, Any] = {}
        self._lock = threading.RLock()
        self._handlers: List[Handler] = []
        self._resync_period = resync_period
        self._resync_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._synced = False
        # Mirror the store's label indexes (client-go Indexer): selector
        # lists on an indexed key touch only matching cache entries instead
        # of scanning everything. Wire-backed sources (REST/kube watch)
        # advertise no indexes — the scan fallback still works.
        self._index_labels = tuple(getattr(store, "_index_labels", ()))
        self._index: Dict[str, Dict[str, set]] = {
            lk: {} for lk in self._index_labels
        }

    # -- wiring --------------------------------------------------------------

    def add_handler(self, handler: Handler) -> None:
        self._handlers.append(handler)

    def start(self) -> None:
        """List+watch: replay existing objects as ADDED, then follow."""
        self._store.subscribe(self._on_event, replay=True)
        self._synced = True
        if self._resync_period > 0:
            self._resync_thread = threading.Thread(
                target=self._resync_loop, daemon=True,
                name=f"informer-resync-{self.kind}",
            )
            self._resync_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._store.unsubscribe(self._on_event)

    def has_synced(self) -> bool:
        return self._synced

    def flush(self, timeout: float = 10.0) -> bool:
        """Quiesce the watch pipeline feeding this informer: after this,
        every completed store write has passed through ``_on_event`` (cache
        + handlers). No-op (True) for watch sources without a flush hook."""
        fl = getattr(self._store, "flush", None)
        return fl(timeout) if fl is not None else True

    # -- label index maintenance (caller holds self._lock) -------------------

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

    # -- event path ----------------------------------------------------------

    def _on_event(self, ev: WatchEvent) -> None:
        # Freeze on ingest: the cache (and every handler) only ever sees a
        # sealed snapshot, so a thawed object can never leak into the read
        # path. Idempotent for frozen-store events; seals the private parse
        # a wire source delivers.
        if not is_frozen(ev.obj):
            ev.obj.freeze()
        key = f"{ev.obj.metadata.namespace}/{ev.obj.metadata.name}"
        with self._lock:
            old = self._cache.get(key)
            if old is not None:
                self._index_remove(key, old)
            if ev.type == EventType.DELETED:
                self._cache.pop(key, None)
            else:
                self._cache[key] = ev.obj
                self._index_add(key, ev.obj)
        inj = self.injector
        if inj is not None and inj.fires(
                "control", "informer.deliver", target=self.kind,
                kinds=("hang",)) is not None:
            # Delivery stalls AFTER the cache update: listers stay
            # fresh, but no handler enqueues work for this event.
            # resync() (the level-trigger sweep) re-delivers from the
            # cache and heals the loss — which is why injection never
            # touches the resync path.
            self.deliveries_suppressed += 1
            return
        for h in list(self._handlers):
            h(ev)

    def _resync_loop(self) -> None:
        while not self._stop.wait(self._resync_period):
            self.resync()

    def resync(self) -> None:
        """Re-deliver every cached object as a MODIFIED event (old == new),
        exactly what a periodic informer resync does."""
        with self._lock:
            objs = list(self._cache.values())
        for obj in objs:
            ev = WatchEvent(EventType.MODIFIED, self.kind, obj, obj)
            for h in list(self._handlers):
                h(ev)

    # -- lister --------------------------------------------------------------

    def get(self, namespace: str, name: str) -> Optional[Any]:
        """Shared frozen reference (zero-copy); ``thaw()`` before mutating."""
        with self._lock:
            return self._cache.get(f"{namespace}/{name}")

    def list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Any]:
        """Shared frozen references (zero-copy); ``thaw()`` before mutating."""
        with self._lock:
            candidates = self._cache
            if label_selector:
                for lk in self._index_labels:
                    if lk in label_selector:
                        keys = self._index[lk].get(label_selector[lk], set())
                        candidates = {k: self._cache[k] for k in keys}
                        break
            out = []
            for obj in candidates.values():
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if label_selector and not selector_matches(
                    label_selector, obj.metadata.labels
                ):
                    continue
                out.append(obj)
            return out
