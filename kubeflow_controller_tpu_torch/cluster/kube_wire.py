"""Genuine Kubernetes wire JSON <-> internal object model.

The reference's controller speaks real ``core/v1`` to a real apiserver —
every effector call in ``pkg/controller/helper.go:90-179`` serializes
``k8s.io/api/core/v1`` objects over HTTPS, and the TFJob CRD rides the
apiextensions machinery (``examples/crd/crd.yml``). This module is that
boundary for the rebuild: pure converters between the framework's internal
dataclasses (``api/core.py``, ``api/types.py``) and byte-accurate Kubernetes
wire JSON:

- ``Pod``     <-> ``core/v1 Pod``  — camelCase, env as name/value lists,
  resources split into requests/limits (``google.com/tpu`` as an extended
  resource in both, as k8s requires), GKE TPU node selectors untouched,
  RFC3339 timestamps, string resourceVersions, exit codes in
  ``containerStatuses[].state.terminated``.
- ``Service`` <-> ``core/v1 Service`` — headless (``clusterIP: None``) by
  default, matching the stable-DNS coordinator services the planner creates.
- ``TPUJob``  <-> CRD wire form under ``tpu.kubeflow.dev/v1alpha1``
  (the group/version ``examples/crd/tpujob-crd.yml`` registers).
- Cluster events -> ``core/v1 Event`` with ``involvedObject``.
- GKE TPU ``Node`` lists -> ``TPUSlice`` health (node pools grouped by
  ``cloud.google.com/gke-nodepool``; slice health = every node Ready).

Framework-only pod fields with no ``core/v1`` home (the gang scheduling
group and the bound slice) travel as ``tpu.kubeflow.dev/*`` annotations —
exactly how gang schedulers on real clusters (Kueue, JobSet) carry their
metadata — and are folded back into typed fields on the way in, so a
round-trip is identity.

Everything here is pure data transformation: no I/O, no clients. The HTTP
half lives in ``kube_client.py``; the hermetic strict-k8s server mode in
``rest_server.py`` uses these same converters, so client and server cannot
drift.

Counterpart of ``kubeflow_controller_tpu/cluster/kube_wire.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

from kubeflow_controller_tpu_torch.api import core
from kubeflow_controller_tpu_torch.api.core import (
    Container, ObjectMeta, OwnerReference, Pod, PodPhase, PodSpec, PodStatus,
    Service, ServicePort, ServiceSpec,
)
from kubeflow_controller_tpu_torch.api.types import API_GROUP, API_VERSION, TPUJob

# GKE's TPU node labels (the node-selector surface a real TPU pod targets).
GKE_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
GKE_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
TPU_RESOURCE = "google.com/tpu"

# Internal PodSpec fields with no core/v1 field: carried as annotations.
ANNOTATION_SCHEDULING_GROUP = "tpu.kubeflow.dev/scheduling-group"
ANNOTATION_ASSIGNED_SLICE = "tpu.kubeflow.dev/assigned-slice"

JOB_API_VERSION = f"{API_GROUP}/{API_VERSION}"

EVENT_SOURCE_COMPONENT = "tpujob-controller"


# -- timestamps ---------------------------------------------------------------

def rfc3339(ts: float) -> str:
    """Seconds-since-epoch -> k8s metav1.Time wire form (RFC3339, UTC)."""
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%SZ")


def from_rfc3339(s: str) -> float:
    dt = datetime.datetime.strptime(s, "%Y-%m-%dT%H:%M:%SZ")
    return dt.replace(tzinfo=datetime.timezone.utc).timestamp()


def _rv_to_int(rv: Any) -> int:
    """k8s resourceVersions are opaque strings, but every real apiserver
    emits decimal integers (etcd revisions) — and this framework's stores
    need ordering. Reject anything else loudly rather than corrupting
    optimistic concurrency silently."""
    if rv in (None, ""):
        return 0
    try:
        return int(rv)
    except (TypeError, ValueError):
        raise ValueError(
            f"non-numeric resourceVersion {rv!r}: this adapter requires "
            "etcd-style numeric resourceVersions (every production "
            "apiserver emits them)"
        ) from None


# -- ObjectMeta ---------------------------------------------------------------

def meta_to_k8s(meta: ObjectMeta, extra_annotations: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if meta.name:
        out["name"] = meta.name
    if meta.generate_name:
        out["generateName"] = meta.generate_name
    out["namespace"] = meta.namespace
    if meta.uid:
        out["uid"] = meta.uid
    if meta.resource_version:
        out["resourceVersion"] = str(meta.resource_version)
    if meta.labels:
        out["labels"] = dict(sorted(meta.labels.items()))
    annotations = dict(meta.annotations)
    if extra_annotations:
        annotations.update(extra_annotations)
    if annotations:
        out["annotations"] = dict(sorted(annotations.items()))
    if meta.creation_timestamp:
        out["creationTimestamp"] = rfc3339(meta.creation_timestamp)
    if meta.deletion_timestamp is not None:
        out["deletionTimestamp"] = rfc3339(meta.deletion_timestamp)
    if meta.owner_references:
        out["ownerReferences"] = [
            {
                "apiVersion": r.api_version,
                "kind": r.kind,
                "name": r.name,
                "uid": r.uid,
                "controller": r.controller,
                "blockOwnerDeletion": r.block_owner_deletion,
            }
            for r in meta.owner_references
        ]
    return out


def meta_from_k8s(d: Dict[str, Any]) -> ObjectMeta:
    meta = ObjectMeta(
        name=d.get("name", ""),
        generate_name=d.get("generateName", ""),
        namespace=d.get("namespace", "default"),
        uid=d.get("uid", ""),
        resource_version=_rv_to_int(d.get("resourceVersion")),
        labels=dict(d.get("labels") or {}),
        annotations=dict(d.get("annotations") or {}),
    )
    if d.get("creationTimestamp"):
        meta.creation_timestamp = from_rfc3339(d["creationTimestamp"])
    if d.get("deletionTimestamp"):
        meta.deletion_timestamp = from_rfc3339(d["deletionTimestamp"])
    for r in d.get("ownerReferences") or []:
        meta.owner_references.append(OwnerReference(
            api_version=r.get("apiVersion", ""),
            kind=r.get("kind", ""),
            name=r.get("name", ""),
            uid=r.get("uid", ""),
            controller=bool(r.get("controller", False)),
            block_owner_deletion=bool(r.get("blockOwnerDeletion", False)),
        ))
    return meta


# -- Pod ----------------------------------------------------------------------

def _quantity(v: Any) -> str:
    """Resource quantity wire form. Integers stay integers ("4" not "4.0")."""
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    return str(v)


def _container_to_k8s(c: Container) -> Dict[str, Any]:
    out: Dict[str, Any] = {"name": c.name}
    if c.image:
        out["image"] = c.image
    if c.command:
        out["command"] = list(c.command)
    if c.args:
        out["args"] = list(c.args)
    if c.env:
        out["env"] = [
            {"name": k, "value": str(v)} for k, v in sorted(c.env.items())
        ]
    if c.ports:
        out["ports"] = [{"containerPort": p} for p in c.ports]
    if c.resources:
        # Extended resources (anything namespaced, like google.com/tpu) must
        # set limits, with requests == limits; cpu/memory ride requests.
        requests = {k: _quantity(v) for k, v in sorted(c.resources.items())}
        limits = {
            k: _quantity(v) for k, v in sorted(c.resources.items())
            if "/" in k
        }
        resources: Dict[str, Any] = {"requests": requests}
        if limits:
            resources["limits"] = limits
        out["resources"] = resources
    return out


def _container_from_k8s(d: Dict[str, Any]) -> Container:
    resources: Dict[str, Any] = {}
    res = d.get("resources") or {}
    for bucket in ("requests", "limits"):
        for k, v in (res.get(bucket) or {}).items():
            try:
                num = int(v)
            except (TypeError, ValueError):
                try:
                    num = float(v)
                except (TypeError, ValueError):
                    num = v
            resources[k] = num
    return Container(
        name=d.get("name", ""),
        image=d.get("image", ""),
        command=list(d.get("command") or []),
        args=list(d.get("args") or []),
        env={e["name"]: e.get("value", "") for e in d.get("env") or []},
        ports=[p["containerPort"] for p in d.get("ports") or []],
        resources=resources,
    )


def pod_to_k8s(pod: Pod) -> Dict[str, Any]:
    extra: Dict[str, str] = {}
    if pod.spec.scheduling_group:
        extra[ANNOTATION_SCHEDULING_GROUP] = pod.spec.scheduling_group
    if pod.spec.assigned_slice:
        extra[ANNOTATION_ASSIGNED_SLICE] = pod.spec.assigned_slice
    spec: Dict[str, Any] = {
        "restartPolicy": pod.spec.restart_policy,
        "containers": [_container_to_k8s(c) for c in pod.spec.containers],
    }
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(sorted(pod.spec.node_selector.items()))
    status: Dict[str, Any] = {"phase": pod.status.phase.value}
    if pod.status.reason:
        status["reason"] = pod.status.reason
    if pod.status.message:
        status["message"] = pod.status.message
    if pod.status.pod_ip:
        status["podIP"] = pod.status.pod_ip
    if pod.status.host_ip:
        status["hostIP"] = pod.status.host_ip
    if pod.status.start_time is not None:
        status["startTime"] = rfc3339(pod.status.start_time)
    if pod.status.exit_code is not None and pod.spec.containers:
        terminated: Dict[str, Any] = {"exitCode": pod.status.exit_code}
        if pod.status.finish_time is not None:
            terminated["finishedAt"] = rfc3339(pod.status.finish_time)
        if pod.status.reason:
            terminated["reason"] = pod.status.reason
        status["containerStatuses"] = [{
            "name": pod.spec.containers[0].name,
            "state": {"terminated": terminated},
        }]
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta_to_k8s(pod.metadata, extra),
        "spec": spec,
        "status": status,
    }


def pod_from_k8s(d: Dict[str, Any]) -> Pod:
    meta = meta_from_k8s(d.get("metadata") or {})
    scheduling_group = meta.annotations.pop(ANNOTATION_SCHEDULING_GROUP, "")
    assigned_slice = meta.annotations.pop(ANNOTATION_ASSIGNED_SLICE, "")
    spec_d = d.get("spec") or {}
    spec = PodSpec(
        containers=[
            _container_from_k8s(c) for c in spec_d.get("containers") or []
        ],
        restart_policy=spec_d.get("restartPolicy", "OnFailure"),
        node_selector=dict(spec_d.get("nodeSelector") or {}),
        scheduling_group=scheduling_group,
        assigned_slice=assigned_slice,
    )
    status_d = d.get("status") or {}
    status = PodStatus(
        phase=PodPhase(status_d.get("phase", "Pending")),
        reason=status_d.get("reason", ""),
        message=status_d.get("message", ""),
        pod_ip=status_d.get("podIP", ""),
        host_ip=status_d.get("hostIP", ""),
    )
    if status_d.get("startTime"):
        status.start_time = from_rfc3339(status_d["startTime"])
    for cs in status_d.get("containerStatuses") or []:
        term = (cs.get("state") or {}).get("terminated")
        if term is not None:
            status.exit_code = term.get("exitCode")
            if term.get("finishedAt"):
                status.finish_time = from_rfc3339(term["finishedAt"])
            if term.get("reason") and not status.reason:
                status.reason = term["reason"]
    return Pod(metadata=meta, spec=spec, status=status)


# -- Service ------------------------------------------------------------------

def service_to_k8s(svc: Service) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if svc.spec.selector:
        spec["selector"] = dict(sorted(svc.spec.selector.items()))
    if svc.spec.ports:
        ports = []
        for p in svc.spec.ports:
            pd: Dict[str, Any] = {"port": p.port}
            if p.name:
                pd["name"] = p.name
            if p.target_port is not None:
                pd["targetPort"] = p.target_port
            ports.append(pd)
        spec["ports"] = ports
    # Coordinator services exist for stable DNS, not load balancing:
    # headless unless the internal object pinned a ClusterIP.
    spec["clusterIP"] = svc.spec.cluster_ip or "None"
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": meta_to_k8s(svc.metadata),
        "spec": spec,
    }


def service_from_k8s(d: Dict[str, Any]) -> Service:
    spec_d = d.get("spec") or {}
    cluster_ip = spec_d.get("clusterIP", "")
    return Service(
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=ServiceSpec(
            selector=dict(spec_d.get("selector") or {}),
            ports=[
                ServicePort(
                    port=p["port"],
                    name=p.get("name", ""),
                    target_port=p.get("targetPort"),
                )
                for p in spec_d.get("ports") or []
            ],
            cluster_ip="" if cluster_ip == "None" else cluster_ip,
        ),
    )


# -- TPUJob (CRD wire form) ---------------------------------------------------

def job_to_k8s(job: TPUJob) -> Dict[str, Any]:
    """CRD wire JSON: the spec/status camelCase the YAML loader already
    speaks (api/serialization.py), under a genuine k8s ObjectMeta."""
    from kubeflow_controller_tpu_torch.api.serialization import job_to_dict

    out = job_to_dict(job)
    out["apiVersion"] = JOB_API_VERSION
    out["metadata"] = meta_to_k8s(job.metadata)
    return out


def job_from_k8s(d: Dict[str, Any]) -> TPUJob:
    from kubeflow_controller_tpu_torch.api.serialization import job_from_dict

    meta = meta_from_k8s(d.get("metadata") or {})
    body = dict(d)
    body.pop("metadata", None)
    body.pop("apiVersion", None)
    job = job_from_dict(body)
    job.metadata = meta
    return job


# -- Events -------------------------------------------------------------------

_WARNING_PREFIXES = ("Failed", "Unhealthy", "Preempted", "BackOff", "Exceeded")


def event_to_k8s(
    kind: str, name: str, namespace: str, reason: str, message: str,
    ts: float, seq: int = 0,
) -> Dict[str, Any]:
    """core/v1 Event for an involved object (the wire form of the
    record.EventRecorder events the reference emits, controller.go:91-94)."""
    return {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {
            "generateName": f"{name}.",
            "namespace": namespace,
        },
        "involvedObject": {
            "kind": kind,
            "name": name,
            "namespace": namespace,
        },
        "reason": reason,
        "message": message,
        "type": (
            "Warning" if reason.startswith(_WARNING_PREFIXES) else "Normal"
        ),
        "source": {"component": EVENT_SOURCE_COMPONENT},
        "firstTimestamp": rfc3339(ts),
        "lastTimestamp": rfc3339(ts),
        "count": 1,
    }


# -- Nodes -> slices ----------------------------------------------------------

def node_to_k8s(
    name: str, pool: str, accelerator: str, topology: str, ready: bool,
    ts: float = 0.0,
) -> Dict[str, Any]:
    """A GKE-shaped TPU node (used by the hermetic strict-k8s server to
    express the slice pool the way a real cluster would)."""
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {
            "name": name,
            "labels": {
                GKE_NODEPOOL_LABEL: pool,
                GKE_ACCELERATOR_LABEL: accelerator,
                GKE_TOPOLOGY_LABEL: topology,
            },
            "creationTimestamp": rfc3339(ts),
        },
        "status": {
            "conditions": [{
                "type": "Ready",
                "status": "True" if ready else "False",
            }],
        },
    }


def _node_ready(node: Dict[str, Any]) -> bool:
    for cond in (node.get("status") or {}).get("conditions") or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


def slices_from_nodes(nodes: List[Dict[str, Any]], pools: List[str]):
    """Group TPU nodes by node pool into TPUSlice health views.

    The real-cluster realization of the checker's slice-health input
    (``checker/checker.py``): a slice is the node pool its pods landed on;
    it is healthy iff every node in the pool is Ready. This turns node
    NotReady — the earliest kubelet-visible sign of a sick slice — into
    the same proactive gang-recovery signal the fake cluster's
    ``degrade_slice`` produces.
    """
    from kubeflow_controller_tpu_torch.api.topology import shape_from_gke
    from kubeflow_controller_tpu_torch.cluster.slices import TPUSlice

    by_pool: Dict[str, List[Dict[str, Any]]] = {}
    for node in nodes:
        labels = (node.get("metadata") or {}).get("labels") or {}
        pool = labels.get(GKE_NODEPOOL_LABEL)
        if pool:
            by_pool.setdefault(pool, []).append(node)
    out = []
    for pool in pools:
        members = by_pool.get(pool)
        if not members:
            # The job's pods reference a pool that no longer has nodes:
            # that IS an unhealthy slice (preempted/deprovisioned) — the
            # caller synthesizes it as such.
            continue
        labels = (members[0].get("metadata") or {}).get("labels") or {}
        try:
            # GKE labels name the generation + topology, not a catalog type.
            shape = shape_from_gke(
                labels.get(GKE_ACCELERATOR_LABEL, ""),
                labels.get(GKE_TOPOLOGY_LABEL, ""),
            )
        except (KeyError, ValueError):
            continue
        out.append(TPUSlice(
            name=pool,
            shape=shape,
            # Healthy needs BOTH every surviving node Ready AND the pool at
            # full strength: a partially-deprovisioned pool (some nodes
            # deleted, survivors Ready) is a sick slice — the gang cannot
            # run on fewer than shape.num_hosts hosts.
            healthy=(
                len(members) >= shape.num_hosts
                and all(_node_ready(n) for n in members)
            ),
            hosts=[
                (n.get("metadata") or {}).get("name", "") for n in members
            ],
        ))
    return out
