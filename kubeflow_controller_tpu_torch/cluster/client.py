"""ClusterClient — the effector seam.

The exact boundary the reference drew with ``HelperInterface`` /
``PodControlInterface`` / ``ServiceControlInterface``
(``pkg/controller/helper.go:42-47``, ``pkg/controller/control/service.go:32-39``):
everything above this interface is testable against the fake cluster;
a real-cluster (GKE) adapter implements the same protocol.

Counterpart of ``kubeflow_controller_tpu/cluster/client.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol

from kubeflow_controller_tpu_torch.api.core import Pod, Service, thaw
from kubeflow_controller_tpu_torch.api.types import LMService, TPUJob
from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster


class PodCreateRefused(RuntimeError):
    """Injected or real apiserver-side create failure."""


class ClusterClient(Protocol):
    """Effector + read API the reconcile core is written against."""

    def create_pod(self, pod: Pod) -> Pod: ...
    def delete_pod(self, namespace: str, name: str) -> None: ...
    def list_pods(self, namespace: str, selector: Dict[str, str]) -> List[Pod]: ...
    def update_pod(self, pod: Pod) -> Pod: ...

    def create_service(self, svc: Service) -> Service: ...
    def delete_service(self, namespace: str, name: str) -> None: ...
    def list_services(self, namespace: str, selector: Dict[str, str]) -> List[Service]: ...
    def update_service(self, svc: Service) -> Service: ...

    def get_job(self, namespace: str, name: str) -> Optional[TPUJob]: ...
    # Read-only job fetch: backends with a frozen store hand out the shared
    # snapshot (zero-copy); wire backends return their private parse.
    # Callers must treat the result as immutable (thaw() before writing).
    def get_job_snapshot(self, namespace: str, name: str) -> Optional[TPUJob]: ...
    def update_job(self, job: TPUJob) -> TPUJob: ...
    # Status-subresource write: persists only .status under the caller's
    # resourceVersion. Spec/metadata in the passed job are never written,
    # so frozen (shared) spec/metadata are legal there.
    def update_job_status(self, job: TPUJob) -> TPUJob: ...
    def delete_job(self, namespace: str, name: str) -> None: ...

    # LMService mirrors the job read/write surface (same snapshot/thaw and
    # status-subresource contracts).
    def get_lmservice(self, namespace: str, name: str) -> Optional[LMService]: ...
    def get_lmservice_snapshot(
        self, namespace: str, name: str) -> Optional[LMService]: ...
    def update_lmservice(self, svc: LMService) -> LMService: ...
    def update_lmservice_status(self, svc: LMService) -> LMService: ...
    def delete_lmservice(self, namespace: str, name: str) -> None: ...

    # namespace: the involved object's namespace (a real apiserver rejects
    # Events whose namespace differs from involvedObject.namespace);
    # backends without namespacing may ignore it.
    def record_event(self, kind: str, name: str, reason: str,
                     message: str, namespace: str = "") -> None: ...
    def release_slices(self, job_uid: str) -> int: ...
    # job_name is an optional routing hint: backends that resolve slices
    # through pod queries (the real-k8s adapter) use it for a server-side
    # equality selector; inventory-backed backends key on uid alone.
    def job_slices(self, job_uid: str, job_name: str = ""): ...


class FakeClusterClient:
    """ClusterClient over the in-process FakeCluster."""

    def __init__(self, cluster: FakeCluster):
        self.cluster = cluster

    @property
    def native_index(self):
        """The cluster's shared native object index (or None). The
        controller duck-types on this attribute to route its no-op-sync
        fingerprint probe through the C++ core; clients without it (wire
        backends) get the pure-Python fingerprint path."""
        return self.cluster.native_index

    # -- pods ---------------------------------------------------------------

    def create_pod(self, pod: Pod) -> Pod:
        if (
            self.cluster.faults.fail_pod_creates > 0
            and self.cluster.faults.fail_pod_creates_after <= 0
        ):
            self.cluster.faults.fail_pod_creates -= 1
            self.record_event("Pod", pod.metadata.name or pod.metadata.generate_name,
                              "FailedCreate", "injected create failure",
                              namespace=pod.metadata.namespace)
            raise PodCreateRefused("injected pod create failure")
        if self.cluster.faults.fail_pod_creates_after > 0:
            self.cluster.faults.fail_pod_creates_after -= 1
        created = self.cluster.pods.create(pod)
        self.record_event("Pod", created.metadata.name, "SuccessfulCreate",
                          f"created pod {created.metadata.name}",
                          namespace=created.metadata.namespace)
        return created

    def delete_pod(self, namespace: str, name: str) -> None:
        self.cluster.pods.delete(namespace, name)
        self.record_event("Pod", name, "SuccessfulDelete",
                          f"deleted pod {name}", namespace=namespace)

    def list_pods(self, namespace: str, selector: Dict[str, str]) -> List[Pod]:
        return self.cluster.pods.list(namespace, selector or None)

    def update_pod(self, pod: Pod) -> Pod:
        return self.cluster.pods.update(pod)

    # -- services -----------------------------------------------------------

    def create_service(self, svc: Service) -> Service:
        created = self.cluster.services.create(svc)
        self.record_event("Service", created.metadata.name, "SuccessfulCreate",
                          f"created service {created.metadata.name}",
                          namespace=created.metadata.namespace)
        return created

    def delete_service(self, namespace: str, name: str) -> None:
        self.cluster.services.delete(namespace, name)
        self.record_event("Service", name, "SuccessfulDelete",
                          f"deleted service {name}", namespace=namespace)

    def list_services(self, namespace: str, selector: Dict[str, str]) -> List[Service]:
        return self.cluster.services.list(namespace, selector or None)

    def update_service(self, svc: Service) -> Service:
        return self.cluster.services.update(svc)

    # -- jobs ---------------------------------------------------------------

    def get_job(self, namespace: str, name: str) -> Optional[TPUJob]:
        # Thawed owned copy: get_job callers (status updaters, RMW loops in
        # controller._mutate_job) mutate what they get — same contract as
        # the wire clients, whose responses are fresh private parses.
        return thaw(self.cluster.jobs.try_get(namespace, name))

    def get_job_snapshot(self, namespace: str, name: str) -> Optional[TPUJob]:
        # Shared frozen snapshot, zero-copy: the store raises if a caller
        # tries to write through it.
        return self.cluster.jobs.try_get(namespace, name)

    def update_job(self, job: TPUJob) -> TPUJob:
        return self.cluster.jobs.update(job)

    def update_job_status(self, job: TPUJob) -> TPUJob:
        return self.cluster.jobs.update_status(job)

    def delete_job(self, namespace: str, name: str) -> None:
        self.cluster.jobs.delete(namespace, name)
        self.record_event("TPUJob", name, "SuccessfulDelete",
                          f"deleted job {name}", namespace=namespace)

    # -- lmservices ---------------------------------------------------------

    def get_lmservice(self, namespace: str, name: str) -> Optional[LMService]:
        return thaw(self.cluster.lmservices.try_get(namespace, name))

    def get_lmservice_snapshot(
        self, namespace: str, name: str
    ) -> Optional[LMService]:
        return self.cluster.lmservices.try_get(namespace, name)

    def update_lmservice(self, svc: LMService) -> LMService:
        return self.cluster.lmservices.update(svc)

    def update_lmservice_status(self, svc: LMService) -> LMService:
        return self.cluster.lmservices.update_status(svc)

    def delete_lmservice(self, namespace: str, name: str) -> None:
        self.cluster.lmservices.delete(namespace, name)
        self.record_event("LMService", name, "SuccessfulDelete",
                          f"deleted lmservice {name}", namespace=namespace)

    # -- misc ---------------------------------------------------------------

    def record_event(self, kind: str, name: str, reason: str,
                     message: str, namespace: str = "") -> None:
        self.cluster.record_event(kind, name, reason, message,
                                  namespace=namespace)

    def release_slices(self, job_uid: str) -> int:
        return self.cluster.slice_pool.release(job_uid)

    def job_slices(self, job_uid: str, job_name: str = ""):
        return self.cluster.slice_pool.holdings(job_uid)
