"""The port's REST adapter: client <-> apiserver facade over a real socket.

The first part is ``tests/test_rest.py`` on the port's ``RestServer`` and
``RestClusterClient``: CRUD + label selectors + resourceVersion conflicts
surviving the HTTP hop, the claim/ownership metadata round-tripping, the
watch stream and the controller reconciling over the wire.

The second part is a wire-parity script: one list of HTTP requests goes to
a JAX ``RestServer`` and to a port ``RestServer``, in the framework mode and
in ``k8s_mode``, each over its own package's ``FakeCluster``; every status
code, JSON body and watch frame must be equal once uids, resourceVersions
and timestamps are mapped to the order in which they first appear.

Every server binds 127.0.0.1 port 0 and is stopped in a ``finally``; every
read and join has its own timeout. The control plane imports no torch, so
neither does this file.
"""

import http.client
import importlib
import json
import re
import threading
import time
import urllib.parse

import pytest

from kubeflow_controller_tpu_torch.api.core import (
    Container, ObjectMeta, OwnerReference, Pod, PodPhase, PodSpec, Service,
    ServicePort, ServiceSpec,
)
from kubeflow_controller_tpu_torch.api.serialization import pod_from_dict, pod_to_dict
from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster
from kubeflow_controller_tpu_torch.cluster.rest_client import RestClusterClient
from kubeflow_controller_tpu_torch.cluster.rest_server import RestServer
from kubeflow_controller_tpu_torch.cluster.store import AlreadyExists, Conflict


@pytest.fixture()
def cluster():
    return FakeCluster()


@pytest.fixture()
def client(cluster):
    server = RestServer(cluster).start()
    yield RestClusterClient(server.url)
    server.stop()


def make_pod(name, labels=None):
    return Pod(
        metadata=ObjectMeta(
            name=name, namespace="default", labels=labels or {},
            owner_references=[OwnerReference(
                api_version="tpu.kubeflow.dev/v1alpha1", kind="TPUJob",
                name="j", uid="u1", controller=True,
            )],
        ),
        spec=PodSpec(containers=[Container(name="c", image="i",
                                           command=["python", "-c", "pass"])]),
    )


def test_pod_wire_roundtrip():
    pod = make_pod("p1", {"a": "b"})
    pod.status.phase = PodPhase.RUNNING
    pod.status.start_time = 12.5
    d = pod_to_dict(pod)
    back = pod_from_dict(d)
    assert back.metadata.name == "p1"
    assert back.metadata.labels == {"a": "b"}
    assert back.metadata.owner_references[0].uid == "u1"
    assert back.status.phase == PodPhase.RUNNING
    assert back.status.start_time == 12.5
    assert back.spec.containers[0].command == ["python", "-c", "pass"]


def test_pod_crud_over_http(client, cluster):
    created = client.create_pod(make_pod("p1", {"role": "worker"}))
    assert created.metadata.uid
    client.create_pod(make_pod("p2", {"role": "ps"}))
    got = client.list_pods("default", {"role": "worker"})
    assert [p.metadata.name for p in got] == ["p1"]
    # server-side state is the same store the fake kubelet runs on
    assert len(cluster.pods.list("default")) == 2
    client.delete_pod("default", "p2")
    assert len(client.list_pods("default", {})) == 1


def test_duplicate_create_409(client):
    client.create_pod(make_pod("p1"))
    with pytest.raises(AlreadyExists):
        client.create_pod(make_pod("p1"))


def test_update_conflict_over_http(client):
    created = client.create_pod(make_pod("p1"))
    stale = created.deepcopy()
    created.metadata.labels["x"] = "1"
    client.update_pod(created)          # bumps resourceVersion server-side
    stale.metadata.labels["x"] = "2"
    with pytest.raises(Conflict):
        client.update_pod(stale)        # stale resourceVersion -> 409


def test_service_and_events(client, cluster):
    svc = Service(
        metadata=ObjectMeta(name="s1", namespace="default"),
        spec=ServiceSpec(
            selector={"app": "x"},
            ports=[ServicePort(port=8476, name="coord")],
        ),
    )
    out = client.create_service(svc)
    assert out.spec.ports[0].port == 8476
    assert any(
        r == "SuccessfulCreate" for (_, _, _, r, _) in cluster.cluster_events
    )
    client.delete_service("default", "s1")
    assert client.list_services("default", {}) == []


def test_job_get_update_roundtrip(client, cluster):
    from kubeflow_controller_tpu_torch.api import (
        JobPhase, TPUJob, TPUJobSpec, ObjectMeta as OM,
    )

    cluster.jobs.create(TPUJob(metadata=OM(name="j1", namespace="default"),
                               spec=TPUJobSpec()))
    job = client.get_job("default", "j1")
    assert job is not None
    job.status.phase = JobPhase.RUNNING
    out = client.update_job(job)
    assert out.status.phase == JobPhase.RUNNING
    assert client.get_job("default", "missing") is None


def test_slices_extension(client, cluster):
    cluster.slice_pool.add_pool("v5p-8", 2)
    cluster.slice_pool.allocate_gang("uid-1", "v5p-8", 1)
    held = client.job_slices("uid-1")
    # Deserialized to TPUSlice at the client boundary (one type for every
    # consumer — the checker above all).
    assert len(held) == 1
    assert held[0].shape.accelerator_type == "v5p-8"
    assert held[0].healthy and held[0].hosts
    assert client.release_slices("uid-1") == 1
    assert client.job_slices("uid-1") == []


# -- watch + over-the-wire controller ----------------------------------------

def test_watch_stream_replay_sync_live(client, cluster):
    import threading
    import time

    from kubeflow_controller_tpu_torch.cluster.events import EventType

    cluster.pods.create(make_pod("p0"))
    seen = []
    done = threading.Event()

    def consume():
        for ev in client.watch("Pod", "default", timeout_seconds=3,
                               heartbeat_seconds=0.5):
            seen.append(ev)
        done.set()

    threading.Thread(target=consume, daemon=True).start()
    deadline = time.time() + 5
    while time.time() < deadline and len(seen) < 2:  # replay + SYNC
        time.sleep(0.01)
    client.create_pod(make_pod("p1"))
    client.delete_pod("default", "p0")
    assert done.wait(10), "watch did not expire via timeoutSeconds"
    tagged = [
        ev if ev is None else (ev.type, ev.obj.metadata.name) for ev in seen
    ]
    assert tagged[0] == (EventType.ADDED, "p0")      # replay
    assert tagged[1] is None                          # SYNC marker
    assert (EventType.ADDED, "p1") in tagged[2:]      # live create
    assert (EventType.DELETED, "p0") in tagged[2:]    # live delete


def test_informer_over_rest_watch(client, cluster):
    import time

    from kubeflow_controller_tpu_torch.cluster.rest_client import RestWatchSource
    from kubeflow_controller_tpu_torch.controller.informer import Informer

    cluster.pods.create(make_pod("p0"))
    src = RestWatchSource(client, "Pod", "default", heartbeat_seconds=0.5)
    inf = Informer(src)
    inf.start()  # blocks until the wire replay synced
    assert inf.has_synced()
    assert inf.get("default", "p0") is not None
    client.create_pod(make_pod("p1"))
    deadline = time.time() + 5
    while time.time() < deadline and inf.get("default", "p1") is None:
        time.sleep(0.01)
    assert inf.get("default", "p1") is not None
    client.delete_pod("default", "p0")
    deadline = time.time() + 5
    while time.time() < deadline and inf.get("default", "p0") is not None:
        time.sleep(0.01)
    assert inf.get("default", "p0") is None
    src.stop()


def test_rewatch_synthesizes_deletes_after_disconnect(cluster):
    """Objects deleted while no watch is connected surface as DELETED on the
    next replay (DeltaFIFO Replace semantics) — informer caches must not
    leak deleted objects across reconnects/server restarts."""
    import socket
    import time

    from kubeflow_controller_tpu_torch.cluster.events import EventType
    from kubeflow_controller_tpu_torch.cluster.rest_client import (
        RestClusterClient, RestWatchSource,
    )

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    server = RestServer(cluster, port=port).start()
    client = RestClusterClient(f"http://127.0.0.1:{port}")
    cluster.pods.create(make_pod("p0"))
    cluster.pods.create(make_pod("p1"))

    seen = []
    src = RestWatchSource(client, "Pod", "default", rewatch_backoff=0.1,
                          heartbeat_seconds=0.5)
    src.subscribe(seen.append)
    assert {ev.obj.metadata.name for ev in seen} == {"p0", "p1"}

    server.stop()  # watch drops; deletion happens while disconnected
    cluster.pods.delete("default", "p0")
    server2 = RestServer(cluster, port=port).start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not any(
            ev.type == EventType.DELETED and ev.obj.metadata.name == "p0"
            for ev in seen
        ):
            time.sleep(0.05)
        assert any(
            ev.type == EventType.DELETED and ev.obj.metadata.name == "p0"
            for ev in seen
        ), [(ev.type, ev.obj.metadata.name) for ev in seen]
    finally:
        src.stop()
        server2.stop()


def test_controller_over_the_wire_local_job(cluster):
    """Full local-job lifecycle with the controller connected ONLY via REST
    (client effects + watch-driven informers) — the reference's operator
    topology (controller process <-> apiserver, cmd/controller/main.go)."""
    import time

    from kubeflow_controller_tpu_torch.api import (
        Container as C, JobPhase, ObjectMeta as OM, PodSpec as PS,
        PodTemplateSpec, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec,
    )
    from kubeflow_controller_tpu_torch.api.validation import validate_job
    from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
    from kubeflow_controller_tpu_torch.runtime import RemoteRuntime

    cluster.default_policy = PodRunPolicy(start_delay=0.1, run_duration=0.3)
    server = RestServer(cluster).start()
    rt = RemoteRuntime(server.url, resync_period=1.0)
    try:
        rt.start(workers=2)
        job = TPUJob(
            metadata=OM(name="loc", namespace="default"),
            spec=TPUJobSpec(replica_specs=[ReplicaSpec(
                replica_type=ReplicaType.LOCAL,
                template=PodTemplateSpec(spec=PS(containers=[
                    C(name="trainer", image="jax:latest")
                ])),
            )]),
        )
        validate_job(job)
        rt.client.create_job(job)
        phases = set()
        deadline = time.time() + 30
        while time.time() < deadline:
            cluster.tick(0.05)
            j = rt.client.get_job("default", "loc")
            if j:
                phases.add(j.status.phase)
                if j.status.phase == JobPhase.SUCCEEDED:
                    break
            time.sleep(0.02)
        j = rt.client.get_job("default", "loc")
        assert j is not None and j.status.phase == JobPhase.SUCCEEDED, (
            j and j.status)
        assert JobPhase.RUNNING in phases
        # the controller's only path to the cluster was HTTP: the pod it
        # created exists server-side and reached Succeeded
        pods = cluster.pods.list("default")
        assert len(pods) == 1
        assert pods[0].status.phase.value == "Succeeded"
    finally:
        rt.stop()
        server.stop()


def test_apply_job_over_rest(client, cluster):
    """kubectl-apply semantics at the REST seam: create-or-update SPEC only
    — status and runtime id survive, conflicts retried client-side."""
    from kubeflow_controller_tpu_torch.api import (
        Container as C, ObjectMeta as OM, PodSpec as PS,
        PodTemplateSpec, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec,
        TPUSliceSpec,
    )

    def manifest(num_slices):
        return TPUJob(
            metadata=OM(name="apl", namespace="default"),
            spec=TPUJobSpec(replica_specs=[ReplicaSpec(
                replica_type=ReplicaType.WORKER,
                template=PodTemplateSpec(spec=PS(containers=[
                    C(name="t", image="i")
                ])),
                tpu=TPUSliceSpec(
                    accelerator_type="v5p-8", num_slices=num_slices),
            )]),
        )

    created = client.apply_job(manifest(1))
    assert created.spec.replica_specs[0].tpu.num_slices == 1

    # controller-side writes land in between: runtime id + status
    # (store snapshots are frozen; thaw into an owned copy to write)
    from kubeflow_controller_tpu_torch.api.core import thaw

    j = thaw(cluster.jobs.get("default", "apl"))
    j.spec.runtime_id = "rid42"
    j.status.restarts = 1
    cluster.jobs.update(j)

    updated = client.apply_job(manifest(2))
    assert updated.spec.replica_specs[0].tpu.num_slices == 2
    assert updated.spec.runtime_id == "rid42"      # controller-owned: kept
    assert updated.status.restarts == 1            # status untouched


# -- wire parity: the same requests to the JAX server and the port's ---------

PACKAGES = ("kubeflow_controller_tpu", "kubeflow_controller_tpu_torch")
JOBS = "/apis/tpu.kubeflow.dev/v1alpha1/namespaces/default/tpujobs"
PODS = "/api/v1/namespaces/default/pods"
SVCS = "/api/v1/namespaces/default/services"
EVENTS = "/api/v1/namespaces/default/events"
_UID = re.compile(r"\b[a-z]+-\d{8}-[0-9a-f]{4}\b")
_VOLATILE = {"uid": "uid", "resourceVersion": "rv", "resource_version": "rv"}
#: A watch stream's server-side timeout: a guard only, since the script
#: closes each stream at the frame of its last mutation; no heartbeat
#: falls inside it.
WATCH_S = 10


def _http(url, method, path, body=None, timeout=10.0):
    """One request; (status, parsed JSON body or None)."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        headers = {"Content-Type": "application/json"}
        if data is not None:
            headers["Content-Length"] = str(len(data))
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        if "watch=true" in path.partition("?")[2] and resp.status == 200:
            return resp.status, [json.loads(x) for x in raw.splitlines() if x]
        return resp.status, (json.loads(raw) if raw else None)
    finally:
        conn.close()


def _read_watch(url, path, frames, ready, last):
    """Read a watch stream's status and frames into ``frames``; set
    ``ready`` once the response's head came (the server subscribes the
    watch, its replay queued, before it sends the head), stop after the
    frame ``last`` accepts (or at the stream's end)."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=WATCH_S + 5)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        frames.append(resp.status)
        ready.set()
        while True:
            line = resp.readline()
            if not line:
                break
            frames.append(json.loads(line))
            if last(frames[-1]):
                break
    finally:
        ready.set()
        conn.close()


class _Norm:
    """Maps uids, resourceVersions and timestamps to their order of first
    appearance on one side."""

    def __init__(self):
        self.seen = {}

    def _tag(self, cls, v):
        key = (cls, json.dumps(v))
        if key not in self.seen:
            self.seen[key] = f"<{cls}{sum(1 for k in self.seen if k[0] == cls)}>"
        return self.seen[key]

    def __call__(self, v, key=""):
        if isinstance(v, dict):
            return {k: self(x, k) for k, x in sorted(v.items())}
        if isinstance(v, (list, tuple)):
            return [self(x, key) for x in v]
        if v is None or isinstance(v, bool):
            return v
        cls = _VOLATILE.get(key)
        if cls is None and ("time" in key.lower()):
            cls = "t"
        if cls is not None:
            return self._tag(cls, v)
        if isinstance(v, str):
            return _UID.sub(lambda m: self._tag("uid", m.group(0)), v)
        return v


class _Side:
    """One package's FakeCluster behind its RestServer."""

    def __init__(self, pkg, k8s_mode):
        imp = importlib.import_module
        self.pkg = pkg
        self.cluster = imp(f"{pkg}.cluster.cluster").FakeCluster(
            default_policy=imp(f"{pkg}.cluster.cluster").PodRunPolicy(
                start_delay=1.0, run_duration=1e9))
        self.cluster.slice_pool.add_pool("v5p-8", 2)
        self.server = imp(f"{pkg}.cluster.rest_server").RestServer(
            self.cluster, k8s_mode=k8s_mode).start()
        self.ctx = {}
        self.norm = _Norm()

    def run(self, step):
        kind = step[0]
        if kind == "tick":
            self.cluster.tick(step[1])
            return None
        if kind == "alloc":
            uid = self.ctx["created_uid"]
            return [s.name for s in self.cluster.slice_pool.allocate_gang(
                uid, "v5p-8", 1)]
        if kind == "watch":
            # A stream opened; once it is subscribed, the mutations; read
            # until the last one's frame, then closed.
            _, path, mutations = step
            frames, ready = [], threading.Event()
            t = threading.Thread(target=_read_watch, daemon=True, args=(
                self.server.url, path, frames, ready,
                lambda f: f.get("type") == "DELETED"
                and f["object"]["metadata"]["name"] == "p3"))
            t.start()
            try:
                assert ready.wait(10.0), "the watch was not answered"
                results = [self.run(m) for m in mutations]
            finally:
                t.join(timeout=WATCH_S + 10.0)
            assert not t.is_alive(), "watch stream did not end"
            return [frames, results]
        method, path, body = step[1:4]
        save = step[4] if len(step) > 4 else None
        path = path.format(**{k: v for k, v in self.ctx.items()
                              if isinstance(v, str)})
        if callable(body):
            body = body(self.ctx)
        status, payload = _http(self.server.url, method, path, body)
        if save:
            # Saved for later steps' bodies, and its uid, name and
            # resourceVersion for their paths.
            self.ctx[save] = payload
            meta = payload.get("metadata") or {}
            for k in ("uid", "name", "resourceVersion"):
                self.ctx[f"{save}_{k}"] = str(meta.get(k, ""))
        return [status, payload]

    def stop(self):
        self.server.stop()


def _job_dict(pkg, k8s):
    """A Worker job on one v5p-8 slice, in the package's wire JSON."""
    imp = importlib.import_module
    core, types = imp(f"{pkg}.api.core"), imp(f"{pkg}.api.types")
    job = types.TPUJob(
        metadata=core.ObjectMeta(name="wire", namespace="default",
                                 labels={"team": "a"}),
        spec=types.TPUJobSpec(model_dir="/ckpt/wire", replica_specs=[
            types.ReplicaSpec(
                replica_type=types.ReplicaType.WORKER,
                template=core.PodTemplateSpec(spec=core.PodSpec(containers=[
                    core.Container(name="t", image="img",
                                   command=["python", "-c", "pass"])])),
                tpu=types.TPUSliceSpec(accelerator_type="v5p-8"))]))
    if k8s:
        return imp(f"{pkg}.cluster.kube_wire").job_to_k8s(job)
    return imp(f"{pkg}.api.serialization").job_to_dict(job)


def _pod_dict(pkg, k8s, name, labels):
    imp = importlib.import_module
    core = imp(f"{pkg}.api.core")
    pod = core.Pod(
        metadata=core.ObjectMeta(
            name=name, namespace="default", labels=labels,
            annotations={"note": name},
            owner_references=[core.OwnerReference(
                api_version="tpu.kubeflow.dev/v1alpha1", kind="TPUJob",
                name="wire", uid="owner-uid", controller=True)]),
        spec=core.PodSpec(containers=[core.Container(
            name="c", image="i", command=["python", "-c", "pass"],
            env={"A": "1"})]))
    if k8s:
        return imp(f"{pkg}.cluster.kube_wire").pod_to_k8s(pod)
    return imp(f"{pkg}.api.serialization").pod_to_dict(pod)


def _svc_dict(pkg, k8s):
    imp = importlib.import_module
    core = imp(f"{pkg}.api.core")
    svc = core.Service(
        metadata=core.ObjectMeta(name="coord", namespace="default",
                                 labels={"a": "b"}),
        spec=core.ServiceSpec(selector={"a": "b"},
                              ports=[core.ServicePort(name="c", port=8476)]))
    if k8s:
        return imp(f"{pkg}.cluster.kube_wire").service_to_k8s(svc)
    return imp(f"{pkg}.api.serialization").service_to_dict(svc)


def _annotated(key):
    def body(ctx):
        out = json.loads(json.dumps(ctx[key]))
        out["metadata"].setdefault("annotations", {})["edited"] = "yes"
        return out
    return body


def _script(k8s):
    """The request list. Bodies are built by the JAX package's serializers
    once, so both servers parse the same bytes."""
    pkg = PACKAGES[0]
    job = _job_dict(pkg, k8s)
    p1 = _pod_dict(pkg, k8s, "p1", {"a": "b", "tpu.kubeflow.dev/job": "wire"})
    p2 = _pod_dict(pkg, k8s, "p2", {"a": "c"})
    p3 = _pod_dict(pkg, k8s, "p3", {"a": "b"})
    watch_q = f"watch=true&timeoutSeconds={WATCH_S}&heartbeatSeconds=30"
    steps = [
        ("http", "POST", JOBS, job, "created"),
        ("http", "POST", JOBS, job),                       # 409 exists
        ("http", "GET", JOBS, None),
        ("http", "GET", JOBS + "/wire", None, "job"),
        ("http", "PUT", JOBS + "/wire", _annotated("job"), "job2"),
        ("http", "PUT", JOBS + "/wire", _annotated("job")),  # stale rv: 409
        ("http", "GET", JOBS + "/missing", None),          # 404
        ("http", "POST", PODS, p1),
        ("http", "POST", PODS, p2),
        ("http", "POST", PODS, p1),                        # 409
        ("http", "GET", PODS + "?labelSelector=a%3Db", None),
        ("http", "GET", PODS + "?labelSelector=tpu.kubeflow.dev%2Fjob", None),
        ("http", "GET", PODS + "?labelSelector=a%21%3Db", None),
        ("tick", 1.5),
        ("http", "GET", PODS + "/p1", None, "pod1"),
        ("http", "PUT", PODS + "/p1", _annotated("pod1")),
        ("http", "PUT", PODS + "/p1", _annotated("pod1")),  # stale rv: 409
        ("http", "POST", SVCS, _svc_dict(pkg, k8s)),
        ("http", "GET", SVCS + "?labelSelector=a%3Db", None),
        ("http", "DELETE", PODS + "/p2", None),
        ("http", "DELETE", PODS + "/p2", None),            # 404
        ("http", "POST", "/framework/v1/events",
         {"kind": "TPUJob", "name": "wire", "reason": "Tested",
          "message": "over the wire", "namespace": "default"}),
        ("alloc",),
        ("http", "GET", "/framework/v1/slices/{created_uid}", None),
        ("http", "DELETE", "/framework/v1/slices/{created_uid}", None),
        ("http", "GET", "/framework/v1/slices/{created_uid}", None),
        ("http", "GET", "/no/such/route", None),           # 404
        ("http", "POST", PODS, b"{not json"),              # 500
        ("http", "PATCH", PODS + "/p1",
         {"metadata": {"labels": {"patched": "1", "a": None}}}),
        ("watch", PODS + "?" + watch_q, [
            ("http", "POST", PODS, p3, "p3"),
            ("http", "PUT", PODS + "/p3", lambda ctx: dict(
                ctx["p3"], metadata=dict(ctx["p3"]["metadata"],
                                         labels={"a": "x"}))),
            ("http", "DELETE", PODS + "/p3", None)]),
        ("watch", PODS + "?labelSelector=a%3Db&" + watch_q, [
            ("http", "POST", PODS, p3),
            ("http", "DELETE", PODS + "/p3", None)]),
        ("http", "DELETE", JOBS + "/wire", None),
        ("http", "GET", JOBS, None),
    ]
    if k8s:
        steps += [
            ("http", "POST", JOBS, job, "k"),
            ("http", "GET", JOBS + "/wire", None, "kjob"),
            ("http", "PUT", JOBS + "/wire/status",
             lambda ctx: dict(ctx["kjob"], status=dict(
                 ctx["kjob"].get("status") or {}, phase="Running"))),
            # The main resource's PUT keeps the stored status.
            ("http", "GET", JOBS + "/wire", None, "kjob2"),
            ("http", "PUT", JOBS + "/wire", lambda ctx: dict(
                ctx["kjob2"], status={"phase": "Failed"})),
            ("http", "GET", JOBS + "/wire", None),
            ("http", "POST", EVENTS, {
                "metadata": {"generateName": "wire."},
                "involvedObject": {"kind": "TPUJob", "name": "wire",
                                   "namespace": "default"},
                "reason": "Tested", "message": "k8s event", "count": 1,
                "type": "Normal"}, "ev"),
            ("http", "POST", EVENTS, {
                "metadata": {"name": "elsewhere"},
                "involvedObject": {"kind": "Pod", "name": "x",
                                   "namespace": "other"},
                "reason": "Bad", "message": "m"}),     # 400
            ("http", "PATCH", EVENTS + "/{ev_name}",
             {"count": 2, "message": "k8s event again"}),
            ("http", "PATCH", EVENTS + "/missing", {"count": 2}),  # 404
            ("http", "GET", EVENTS, None),
            ("http", "GET", "/api/v1/nodes", None),
            ("http", "GET", PODS, None, "podlist"),
            ("http", "DELETE", PODS + "/p1", None),
            # A delete after the list: a watch from the list's rv is 410.
            ("http", "GET",
             PODS + "?watch=true&resourceVersion={podlist_resourceVersion}",
             None),
        ]
    return steps


def _wire_run(pkg, k8s):
    side = _Side(pkg, k8s)
    out = []
    try:
        for step in _script(k8s):
            out.append(side.norm(side.run(step)))
    finally:
        side.stop()
    return out


@pytest.mark.parametrize("k8s", [False, True], ids=["framework", "k8s_mode"])
def test_wire_parity_with_the_jax_server(k8s):
    jax = _wire_run(PACKAGES[0], k8s)
    port = _wire_run(PACKAGES[1], k8s)
    for i, (a, b) in enumerate(zip(jax, port)):
        assert a == b, (i, _script(k8s)[i][:3], a, b)
    assert len(jax) == len(port)
