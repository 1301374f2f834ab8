"""TPU slice inventory and gang allocation.

The piece with no reference analog at all (SURVEY.md §2.5 "Gang semantics:
No"): the reference schedules pods one-by-one onto generic nodes
(``controller.go:396-421``); a TPU pod-slice is useless partially scheduled,
so admission here is all-or-nothing per gang. This module models the node-pool
side: which physical slices exist, which jobs hold them, and preemption.

Counterpart of ``kubeflow_controller_tpu/cluster/slices.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubeflow_controller_tpu_torch.api.topology import SliceShape, slice_shape


@dataclass
class TPUSlice:
    """One physical pod-slice in a node pool.

    ``holder``/``healthy`` are owned by ``SlicePool``, which mirrors them
    into allocation indexes: mutate them ONLY through pool methods
    (``allocate_gang``/``release``/``mark_unhealthy``/``preempt``/
    ``restore``) — writing the fields directly on an object returned by
    ``list``/``free``/``holdings`` desyncs the indexes.
    """

    name: str                      # e.g. "pool-v5e-16/slice-0"
    shape: SliceShape
    # Job uid currently holding the slice ("" = free).
    holder: str = ""
    healthy: bool = True
    # Host VM DNS-ish names, one per host process.
    hosts: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.hosts:
            self.hosts = [
                f"{self.name.replace('/', '-')}-host-{i}"
                for i in range(self.shape.num_hosts)
            ]


class InsufficientCapacity(RuntimeError):
    pass


def slice_to_dict(s: TPUSlice) -> dict:
    """Wire-JSON shape for a slice. The single source of truth for every
    server that serves slice state (apiserver-shaped ``rest_server`` and the
    CLI daemon) — ``checker._slice_health`` reads this shape back, so the
    two servers must never drift."""
    return {
        "name": s.name,
        "accelerator": s.shape.accelerator_type,
        "healthy": s.healthy,
        "hosts": list(s.hosts),
    }


class SlicePool:
    """Inventory of TPU slices, grouped by accelerator type.

    ``allocate_gang`` is atomic: either every requested slice is reserved for
    the job or none is. This is the cluster-side half of gang scheduling; the
    controller-side half (create all pods of the gang in one sync or none)
    lives in ``kubeflow_controller_tpu_torch.tpu.gang``.
    """

    def __init__(self, mirror=None):
        self._lock = threading.Lock()
        self._slices: Dict[str, TPUSlice] = {}
        # Optional native slice-health mirror (NativeObjectIndex): every
        # holder/health mutation writes through (under this lock) so the
        # controller's fingerprint probe composes the slice-health term in
        # the C++ core instead of traversing holdings() per probe. Duck-
        # typed on slice_set/slice_clear; None == Python-only.
        self._mirror = mirror
        # Indexes (insertion-ordered dict-sets, deterministic but NOT
        # provisioning-order after churn: a released slice re-enters the
        # free index at the back, so reuse is approximately
        # least-recently-released rather than lowest-numbered):
        # accelerator type -> names; free+healthy per type; holder -> names.
        # At 5000-job scale the full-pool scans in allocate_gang/holdings
        # were the control plane's top cost (controlplane_bench profile); every
        # holder/health mutation funnels through _set_holder/_set_healthy
        # so the indexes cannot drift.
        self._by_type: Dict[str, Dict[str, None]] = {}
        self._free: Dict[str, Dict[str, None]] = {}
        self._by_holder: Dict[str, Dict[str, None]] = {}

    # -- index maintenance (call with lock held) -----------------------------

    def _refresh_free(self, s: TPUSlice) -> None:
        free = self._free.setdefault(s.shape.accelerator_type, {})
        if not s.holder and s.healthy:
            free[s.name] = None
        else:
            free.pop(s.name, None)

    def _set_holder(self, s: TPUSlice, holder: str) -> None:
        if s.holder:
            held = self._by_holder.get(s.holder)
            if held is not None:
                held.pop(s.name, None)
                if not held:
                    del self._by_holder[s.holder]
            if self._mirror is not None:
                self._mirror.slice_clear(s.holder, s.name)
        s.holder = holder
        if holder:
            self._by_holder.setdefault(holder, {})[s.name] = None
            if self._mirror is not None:
                self._mirror.slice_set(holder, s.name, s.healthy)
        self._refresh_free(s)

    def _set_healthy(self, s: TPUSlice, healthy: bool) -> None:
        s.healthy = healthy
        if s.holder and self._mirror is not None:
            self._mirror.slice_set(s.holder, s.name, healthy)
        self._refresh_free(s)

    def add_pool(self, accelerator_type: str, count: int, pool_name: str = "") -> List[str]:
        """Provision ``count`` slices of a type; returns their names."""
        shape = slice_shape(accelerator_type)
        pool = pool_name or f"pool-{accelerator_type}"
        names = []
        with self._lock:
            base = len(self._by_type.get(accelerator_type, {}))
            for i in range(count):
                name = f"{pool}/slice-{base + i}"
                s = TPUSlice(name=name, shape=shape)
                self._slices[name] = s
                self._by_type.setdefault(
                    shape.accelerator_type, {})[name] = None
                self._refresh_free(s)
                names.append(name)
        return names

    def get(self, name: str) -> TPUSlice:
        with self._lock:
            return self._slices[name]

    def list(self, accelerator_type: Optional[str] = None) -> List[TPUSlice]:
        with self._lock:
            if accelerator_type is None:
                return list(self._slices.values())
            return [
                self._slices[n]
                for n in self._by_type.get(accelerator_type, {})
            ]

    def free(self, accelerator_type: str) -> List[TPUSlice]:
        with self._lock:
            return [
                self._slices[n]
                for n in self._free.get(accelerator_type, {})
            ]

    def allocate_gang(
        self, job_uid: str, accelerator_type: str, num_slices: int
    ) -> List[TPUSlice]:
        """Atomically reserve ``num_slices`` healthy free slices for a job.

        Idempotent per job: slices already held by ``job_uid`` count toward
        the request (so a re-sync after partial observation cannot
        double-allocate — the expectations-race discipline of
        ``controller.go:259-262`` applied to slices).
        """
        with self._lock:
            # Holdings of a DIFFERENT accelerator type (spec change) are
            # useless to this job: release them up front — before the
            # capacity check — so they can never be leaked by an
            # InsufficientCapacity exit, nor deadlock two type-swapping jobs.
            for name in list(self._by_holder.get(job_uid, {})):
                s = self._slices[name]
                if s.shape.accelerator_type != accelerator_type:
                    self._set_holder(s, "")
            held = [
                self._slices[n]
                for n in self._by_holder.get(job_uid, {})
                if self._slices[n].healthy
            ]
            if len(held) >= num_slices:
                keep = held[:num_slices]
            else:
                need = num_slices - len(held)
                avail_names = list(self._free.get(accelerator_type, {}))
                if len(avail_names) < need:
                    raise InsufficientCapacity(
                        f"need {need} more {accelerator_type} slices for job "
                        f"{job_uid}, only {len(avail_names)} free"
                    )
                granted = [self._slices[n] for n in avail_names[:need]]
                for s in granted:
                    self._set_holder(s, job_uid)
                keep = held + granted
            # Surplus same-type holdings (scale-down) go back to the pool —
            # a resized gang must not leak capacity mid-job.
            keep_names = {s.name for s in keep}
            for name in list(self._by_holder.get(job_uid, {})):
                if name not in keep_names:
                    self._set_holder(self._slices[name], "")
            return keep

    def release(self, job_uid: str) -> int:
        """Free every slice a job holds; returns count released."""
        with self._lock:
            names = list(self._by_holder.get(job_uid, {}))
            for name in names:
                self._set_holder(self._slices[name], "")
            return len(names)

    def holdings(self, job_uid: str) -> List[TPUSlice]:
        with self._lock:
            return [
                self._slices[n] for n in self._by_holder.get(job_uid, {})
            ]

    # -- fault injection ----------------------------------------------------

    def mark_unhealthy(self, name: str) -> str:
        """Degrade a slice WITHOUT evicting its holder or touching pods —
        the 'sick but not dead' state the checker exists to catch before
        the kubelet does (ICI link flaps, HBM ECC storms). Returns the
        holder uid ("" if free). The next ``allocate_gang`` for that holder
        replaces the slice (unhealthy holdings don't count as held)."""
        with self._lock:
            s = self._slices[name]
            self._set_healthy(s, False)
            return s.holder

    def preempt(self, name: str) -> str:
        """Simulate slice preemption: mark unhealthy, evict holder.
        Returns the evicted job uid ("" if free)."""
        with self._lock:
            s = self._slices[name]
            evicted = s.holder
            self._set_holder(s, "")
            self._set_healthy(s, False)
            return evicted

    def restore(self, name: str) -> None:
        """Bring a preempted/unhealthy slice back into service."""
        with self._lock:
            self._set_healthy(self._slices[name], True)
