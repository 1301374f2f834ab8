"""RestClusterClient — the ClusterClient over apiserver-style REST.

The real-cluster swap-in at the effector seam (a real-GKE adapter as a
thin swap-in at the client boundary). The reconcile core is
written against ``ClusterClient`` (``cluster/client.py``); this
implementation speaks the Kubernetes resource REST shape over HTTP —
against ``rest_server.RestServer`` in tests, against a real apiserver (URL +
bearer token) in deployment. Framework-specific surfaces with no core-k8s
analog (event recording and TPU slice-pool bookkeeping) live under
``/framework/v1/...`` extension paths — on a real cluster those map to the
Events API and the cloud provider's node-pool API respectively.

Error mapping: 404 -> NotFound, 409 -> AlreadyExists/Conflict, other
non-2xx -> RuntimeError. The store layer's optimistic-concurrency semantics
(resourceVersion enforcement) therefore survive the HTTP hop — an
update-conflict test drives that end to end.

Counterpart of ``kubeflow_controller_tpu/cluster/rest_client.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

from kubeflow_controller_tpu_torch.api.core import Pod, Service
from kubeflow_controller_tpu_torch.api.serialization import (
    job_from_dict, job_to_dict, pod_from_dict, pod_to_dict,
    service_from_dict, service_to_dict,
)
from kubeflow_controller_tpu_torch.api.types import TPUJob
from kubeflow_controller_tpu_torch.cluster.store import (
    AlreadyExists, Conflict, NotFound,
)

JOB_GROUP = "/apis/tpu.kubeflow.dev/v1alpha1"


class RestClusterClient:
    def __init__(self, base_url: str, token: str = "", timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout

    # -- transport -----------------------------------------------------------

    def _req(
        self, method: str, path: str, payload: Optional[Dict] = None,
    ) -> Dict[str, Any]:
        url = self.base_url + path
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except json.JSONDecodeError:
                body = {}
            msg = body.get("error", str(e))
            if e.code == 404:
                raise NotFound(msg) from None
            if e.code == 409:
                if body.get("reason") == "AlreadyExists":
                    raise AlreadyExists(msg) from None
                raise Conflict(msg) from None
            raise RuntimeError(f"{method} {path}: HTTP {e.code}: {msg}")

    @staticmethod
    def _selector_q(selector: Dict[str, str]) -> str:
        if not selector:
            return ""
        joined = ",".join(f"{k}={v}" for k, v in sorted(selector.items()))
        return "?labelSelector=" + urllib.parse.quote(joined)

    # -- pods ---------------------------------------------------------------

    def create_pod(self, pod: Pod) -> Pod:
        out = self._req(
            "POST",
            f"/api/v1/namespaces/{pod.metadata.namespace}/pods",
            pod_to_dict(pod),
        )
        self.record_event("Pod", out["metadata"]["name"], "SuccessfulCreate",
                          f"created pod {out['metadata']['name']}",
                          namespace=pod.metadata.namespace)
        return pod_from_dict(out)

    def delete_pod(self, namespace: str, name: str) -> None:
        self._req("DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}")
        self.record_event("Pod", name, "SuccessfulDelete",
                          f"deleted pod {name}", namespace=namespace)

    def list_pods(self, namespace: str, selector: Dict[str, str]) -> List[Pod]:
        out = self._req(
            "GET",
            f"/api/v1/namespaces/{namespace}/pods"
            + self._selector_q(selector),
        )
        return [pod_from_dict(d) for d in out["items"]]

    def update_pod(self, pod: Pod) -> Pod:
        out = self._req(
            "PUT",
            f"/api/v1/namespaces/{pod.metadata.namespace}/pods/"
            f"{pod.metadata.name}",
            pod_to_dict(pod),
        )
        return pod_from_dict(out)

    # -- services -----------------------------------------------------------

    def create_service(self, svc: Service) -> Service:
        out = self._req(
            "POST",
            f"/api/v1/namespaces/{svc.metadata.namespace}/services",
            service_to_dict(svc),
        )
        self.record_event(
            "Service", out["metadata"]["name"], "SuccessfulCreate",
            f"created service {out['metadata']['name']}",
            namespace=svc.metadata.namespace,
        )
        return service_from_dict(out)

    def delete_service(self, namespace: str, name: str) -> None:
        self._req(
            "DELETE", f"/api/v1/namespaces/{namespace}/services/{name}"
        )
        self.record_event("Service", name, "SuccessfulDelete",
                          f"deleted service {name}", namespace=namespace)

    def list_services(
        self, namespace: str, selector: Dict[str, str]
    ) -> List[Service]:
        out = self._req(
            "GET",
            f"/api/v1/namespaces/{namespace}/services"
            + self._selector_q(selector),
        )
        return [service_from_dict(d) for d in out["items"]]

    def update_service(self, svc: Service) -> Service:
        out = self._req(
            "PUT",
            f"/api/v1/namespaces/{svc.metadata.namespace}/services/"
            f"{svc.metadata.name}",
            service_to_dict(svc),
        )
        return service_from_dict(out)

    # -- watch ---------------------------------------------------------------

    _KIND_PATHS = {
        "Pod": ("/api/v1", "pods"),
        "Service": ("/api/v1", "services"),
        "TPUJob": (JOB_GROUP, "tpujobs"),
    }
    # Plain dict lookups, no attribute binding: values stay raw functions.
    _KIND_FROM = {
        "Pod": pod_from_dict,
        "Service": service_from_dict,
        "TPUJob": job_from_dict,
    }

    def watch(
        self,
        kind: str,
        namespace: str,
        selector: Optional[Dict[str, str]] = None,
        timeout_seconds: float = 0,
        heartbeat_seconds: float = 5,
    ):
        """Stream watch events for one kind: the verb the reference's
        informers are built on (``vendor/.../informers/.../tfjob.go:56``).

        Yields ``None`` once when the server finishes replaying current
        state (the list+watch sync point), then ``WatchEvent``s. Returns
        when the server expires the watch (``timeout_seconds``) or the
        connection drops — callers re-watch.
        """
        from kubeflow_controller_tpu_torch.cluster.events import EventType, WatchEvent

        group, plural = self._KIND_PATHS[kind]
        from_dict = self._KIND_FROM[kind]
        q = [f"watch=true&heartbeatSeconds={heartbeat_seconds}"]
        if timeout_seconds:
            q.append(f"timeoutSeconds={timeout_seconds}")
        if selector:
            joined = ",".join(f"{k}={v}" for k, v in sorted(selector.items()))
            q.append("labelSelector=" + urllib.parse.quote(joined))
        url = (
            f"{self.base_url}{group}/namespaces/{namespace}/{plural}?"
            + "&".join(q)
        )
        req = urllib.request.Request(url, method="GET")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        # Read timeout must outlast the heartbeat cadence, not the watch.
        with urllib.request.urlopen(
            req, timeout=max(heartbeat_seconds * 3, 10)
        ) as resp:
            for raw in resp:
                line = json.loads(raw)
                etype = line["type"]
                if etype == "BOOKMARK":
                    continue
                if etype == "SYNC":
                    yield None
                    continue
                obj = from_dict(line["object"])
                yield WatchEvent(EventType(etype), kind, obj)

    # -- jobs ---------------------------------------------------------------

    def create_job(self, job: TPUJob) -> TPUJob:
        out = self._req(
            "POST",
            f"{JOB_GROUP}/namespaces/{job.metadata.namespace}/tpujobs",
            job_to_dict(job),
        )
        return job_from_dict(out)

    def delete_job(self, namespace: str, name: str) -> None:
        self._req(
            "DELETE", f"{JOB_GROUP}/namespaces/{namespace}/tpujobs/{name}"
        )

    def list_jobs(self, namespace: str) -> List[TPUJob]:
        out = self._req("GET", f"{JOB_GROUP}/namespaces/{namespace}/tpujobs")
        return [job_from_dict(d) for d in out["items"]]

    def get_job(self, namespace: str, name: str) -> Optional[TPUJob]:
        try:
            out = self._req(
                "GET", f"{JOB_GROUP}/namespaces/{namespace}/tpujobs/{name}"
            )
        except NotFound:
            return None
        return job_from_dict(out)

    def get_job_snapshot(self, namespace: str, name: str) -> Optional[TPUJob]:
        # Wire responses are already private parses — nothing shared to
        # protect, so the "snapshot" is just a get.
        return self.get_job(namespace, name)

    def update_job(self, job: TPUJob) -> TPUJob:
        out = self._req(
            "PUT",
            f"{JOB_GROUP}/namespaces/{job.metadata.namespace}/tpujobs/"
            f"{job.metadata.name}",
            job_to_dict(job),
        )
        return job_from_dict(out)

    def update_job_status(self, job: TPUJob) -> TPUJob:
        # Framework-mode servers apply status on the main PUT; the strict
        # k8s surface (kube_client) routes through /status instead.
        return self.update_job(job)

    def apply_job(self, job: TPUJob) -> TPUJob:
        """kubectl-apply over the wire: create-or-update-spec-only with
        conflict retry (shared semantics: api.apply.apply_job_spec)."""
        from kubeflow_controller_tpu_torch.api.apply import apply_job_spec

        return apply_job_spec(
            get=lambda: self.get_job(
                job.metadata.namespace, job.metadata.name
            ),
            create=self.create_job,
            update=self.update_job,
            new=job,
        )

    # -- framework extensions ------------------------------------------------

    def record_event(self, kind: str, name: str, reason: str,
                     message: str, namespace: str = "") -> None:
        self._req("POST", "/framework/v1/events", {
            "kind": kind, "name": name, "reason": reason, "message": message,
            "namespace": namespace,
        })

    def release_slices(self, job_uid: str) -> int:
        return self._req(
            "DELETE", f"/framework/v1/slices/{job_uid}"
        )["released"]

    def job_slices(self, job_uid: str, job_name: str = ""):
        # Deserialize to TPUSlice at the client boundary (the inverse of the
        # server's slice_to_dict) so every consumer — the checker above all —
        # sees ONE type regardless of backend.
        from kubeflow_controller_tpu_torch.api.topology import slice_shape
        from kubeflow_controller_tpu_torch.cluster.slices import TPUSlice

        items = self._req("GET", f"/framework/v1/slices/{job_uid}")["items"]
        return [
            TPUSlice(
                name=d["name"],
                shape=slice_shape(d["accelerator"]),
                healthy=bool(d["healthy"]),
                hosts=list(d.get("hosts") or []),
            )
            for d in items
        ]


class RestWatchSource:
    """Informer-compatible watch source over RestClusterClient.watch.

    Duck-types ``ObjectStore``'s informer surface (``kind`` +
    ``subscribe``), so ``controller.informer.Informer`` binds to a remote
    apiserver exactly as it binds to an in-process store — the last seam
    that would keep the controller from running over the wire.

    ``subscribe`` blocks until the first replay completes (so
    ``Informer.has_synced`` keeps its meaning), then a daemon thread
    follows the stream, re-watching on expiry/disconnect forever. Each
    re-watch replays current state; objects that vanished between watches
    are synthesized as DELETED (client-go's DeltaFIFO Replace semantics),
    so informer caches never leak deleted objects across reconnects.
    """

    def __init__(
        self,
        client: RestClusterClient,
        kind: str,
        namespace: str,
        selector: Optional[Dict[str, str]] = None,
        rewatch_backoff: float = 0.5,
        timeout_seconds: float = 0,
        heartbeat_seconds: float = 5,
    ):
        self.client = client
        self.kind = kind
        self.namespace = namespace
        self.selector = selector
        self.rewatch_backoff = rewatch_backoff
        self.timeout_seconds = timeout_seconds
        self.heartbeat_seconds = heartbeat_seconds
        self._stop = False
        self._dead: set = set()

    def stop(self) -> None:
        self._stop = True

    def unsubscribe(self, listener) -> None:
        """Detach one listener: its pump thread exits at the next event or
        re-watch, and no further events are delivered to it."""
        self._dead.add(listener)

    def subscribe(self, listener, replay: bool = True) -> None:
        import threading

        self._dead.discard(listener)  # re-subscribing revives a listener

        from kubeflow_controller_tpu_torch.cluster.events import (
            EventType, WatchEvent,
        )

        synced = threading.Event()
        live: Dict[str, Any] = {}  # key -> last obj, for tombstones

        def pump() -> None:
            while not (self._stop or listener in self._dead):
                replayed: Dict[str, Any] = {}
                in_replay = True
                try:
                    for ev in self.client.watch(
                        self.kind, self.namespace, self.selector,
                        timeout_seconds=self.timeout_seconds,
                        heartbeat_seconds=self.heartbeat_seconds,
                    ):
                        if self._stop or listener in self._dead:
                            return
                        if ev is None:  # SYNC: replay complete
                            if in_replay:
                                for key, obj in list(live.items()):
                                    if key not in replayed:
                                        live.pop(key)
                                        listener(WatchEvent(
                                            EventType.DELETED, self.kind, obj
                                        ))
                                in_replay = False
                            synced.set()
                            continue
                        key = (f"{ev.obj.metadata.namespace}/"
                               f"{ev.obj.metadata.name}")
                        if ev.type == EventType.DELETED:
                            live.pop(key, None)
                        else:
                            live[key] = ev.obj
                            if in_replay:
                                replayed[key] = ev.obj
                        listener(ev)
                except Exception:
                    if self._stop:
                        return
                time.sleep(self.rewatch_backoff)

        threading.Thread(
            target=pump, daemon=True,
            name=f"rest-watch-{self.kind.lower()}",
        ).start()
        if not synced.wait(timeout=30):
            raise TimeoutError(
                f"watch on {self.kind} did not sync within 30s "
                f"({self.client.base_url})"
            )
