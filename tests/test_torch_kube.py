"""The port's real-Kubernetes adapter: ``tests/test_kube.py`` on the port,
then the port held to the JAX package.

Three layers of proof that the controller can drive a genuine apiserver
(the reference's entire operating mode, ``cmd/controller/main.go:31-43``):

1. **Golden wire fixtures** — the exact JSON ``kube_wire`` emits for a
   planner-built TPU worker pod, a coordinator service, a TPUJob CR, and an
   Event is pinned byte-for-byte in ``tests/fixtures/k8s/``. Those files are
   themselves valid ``kubectl apply`` manifests (core/v1 + the CRD group
   from ``examples/crd/tpujob-crd.yml``).
2. **Protocol** — KubeClusterClient against ``RestServer(k8s_mode=True)``:
   CRUD with k8s List envelopes, optimistic-concurrency conflicts, the
   status subresource split, existence label selectors, list-then-watch
   with resourceVersion resume, node-pool slice health.
3. **The controller unmodified** — a full job lifecycle reconciled over
   strict k8s wire: RemoteRuntime(k8s=True) takes a TPUJob CR to Succeeded
   through gang scheduling on the hermetic cluster.

The golden fixtures are the JAX package's (``tests/fixtures/k8s/``): the
port's ``kube_wire`` must write them byte for byte, so this file never
regenerates them (``REGEN_K8S_FIXTURES`` is ``tests/test_kube.py``'s).

4. **The JAX package** (the last section) — ``kube_wire``'s JSON and round
   trips equal to the JAX module's for the same objects; ``kubeconfig``
   resolving the same files to the same ``KubeContext`` (merge, exec
   plugin, token-file rotation, the 401 refresh); and the cross-pairs: the
   port's ``RemoteRuntime`` against the JAX server and the JAX one against
   the port's, each taking a Local job and a gang job to Succeeded.

Every server binds 127.0.0.1 port 0 and is stopped in a ``finally``; every
wait has its own deadline. The control plane imports no torch, so neither
does this file.
"""

import dataclasses
import importlib
import json
import os
import threading
import time
import types as pytypes

import pytest

from kubeflow_controller_tpu_torch.api.core import (
    Container, ObjectMeta, OwnerReference, Pod, PodPhase, PodSpec,
    PodTemplateSpec, Service, ServicePort, ServiceSpec,
)
from kubeflow_controller_tpu_torch.api.types import (
    JobPhase, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec, TPUSliceSpec,
)
from kubeflow_controller_tpu_torch.cluster import kube_wire
from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster, PodRunPolicy
from kubeflow_controller_tpu_torch.cluster.kube_client import (
    KubeClusterClient, KubeWatchSource,
)
from kubeflow_controller_tpu_torch.cluster.kubeconfig import (
    KubeconfigError, load_kubeconfig,
)
from kubeflow_controller_tpu_torch.cluster.rest_server import RestServer
from kubeflow_controller_tpu_torch.cluster.store import Conflict, NotFound
from kubeflow_controller_tpu_torch.tpu.plan import plan_job

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "k8s")


# -- deterministic objects ----------------------------------------------------

def fixture_job() -> TPUJob:
    """A v5e-16 2-host worker job exactly as validation+defaulting leaves
    it, with the identity fields a live job carries."""
    job = TPUJob(
        metadata=ObjectMeta(
            name="bert-pretrain", namespace="default",
            uid="uid-00000042-beef", resource_version=7,
            creation_timestamp=1000.0,
        ),
        spec=TPUJobSpec(
            runtime_id="r1a2b",
            model_dir="/ckpt/bert-pretrain",
            replica_specs=[ReplicaSpec(
                replica_type=ReplicaType.WORKER,
                template=PodTemplateSpec(spec=PodSpec(containers=[
                    Container(
                        name="trainer", image="tpujob/bert:latest",
                        command=["python", "-m",
                                 "kubeflow_controller_tpu.dataplane."
                                 "entrypoints.bert"],
                    ),
                ])),
                tpu=TPUSliceSpec(accelerator_type="v5e-16", num_slices=1),
                max_restarts=3,
            )],
        ),
    )
    job.status.phase = JobPhase.PENDING
    job.status.submit_time = 1000.0
    return job


def fixture_pod() -> Pod:
    """The FIRST worker pod the planner actually emits for fixture_job —
    the golden fixture pins what the controller would POST to a real
    apiserver, not a hand-written approximation."""
    plan = plan_job(fixture_job(), [], [])
    pod = plan.create_pods[0]
    return pod


def fixture_service() -> Service:
    plan = plan_job(fixture_job(), [], [])
    assert plan.create_services, "planner should create a coordinator service"
    return plan.create_services[0]


def _golden(name: str, payload: dict) -> None:
    path = os.path.join(FIXTURES, name)
    text = json.dumps(payload, indent=2, sort_keys=True) + "\n"
    with open(path) as f:
        assert f.read() == text, (
            f"the port's wire JSON for {name} drifted from the golden "
            "fixture that the JAX package's kube_wire writes")


class TestGoldenWire:
    def test_pod_fixture(self):
        _golden("pod.json", kube_wire.pod_to_k8s(fixture_pod()))

    def test_service_fixture(self):
        _golden("service.json", kube_wire.service_to_k8s(fixture_service()))

    def test_job_fixture(self):
        _golden("tpujob.json", kube_wire.job_to_k8s(fixture_job()))

    def test_event_fixture(self):
        _golden("event.json", kube_wire.event_to_k8s(
            "Pod", "bert-pretrain-r1a2b-worker-e0-0", "default",
            "FailedCreate", "injected create failure", ts=1000.0,
        ))

    def test_pod_fixture_is_core_v1(self):
        """Structural invariants a real apiserver would enforce."""
        wire = kube_wire.pod_to_k8s(fixture_pod())
        assert wire["apiVersion"] == "v1" and wire["kind"] == "Pod"
        c = wire["spec"]["containers"][0]
        # env is a name/value LIST on the wire, not a mapping
        assert isinstance(c["env"], list) and all(
            set(e) <= {"name", "value"} for e in c["env"]
        )
        # extended resources must appear in limits with requests == limits
        assert c["resources"]["limits"]["google.com/tpu"] == \
            c["resources"]["requests"]["google.com/tpu"]
        # GKE TPU placement contract: REAL label values (generation name +
        # topology), not framework catalog names
        sel = wire["spec"]["nodeSelector"]
        assert sel["cloud.google.com/gke-tpu-accelerator"] == \
            "tpu-v5-lite-podslice"
        assert sel["cloud.google.com/gke-tpu-topology"] == "4x4"
        # ownership: a controller ref pointing at the TPUJob CR
        ref = wire["metadata"]["ownerReferences"][0]
        assert ref["kind"] == "TPUJob" and ref["controller"] is True
        assert ref["apiVersion"] == "tpu.kubeflow.dev/v1alpha1"

    def test_pod_roundtrip_identity(self):
        pod = fixture_pod()
        back = kube_wire.pod_from_k8s(kube_wire.pod_to_k8s(pod))
        assert back == pod

    def test_pod_roundtrip_with_status(self):
        pod = fixture_pod()
        pod.metadata.uid = "uid-1"
        pod.metadata.resource_version = 3
        pod.status.phase = PodPhase.FAILED
        pod.status.reason = "Preempted"
        pod.status.host_ip = "pool-v5e-16-slice-0-host-1"
        pod.status.start_time = 5.0
        pod.status.finish_time = 9.0
        pod.status.exit_code = 137
        pod.spec.assigned_slice = "pool-v5e-16/slice-0"
        back = kube_wire.pod_from_k8s(kube_wire.pod_to_k8s(pod))
        assert back == pod
        wire = kube_wire.pod_to_k8s(pod)
        term = wire["status"]["containerStatuses"][0]["state"]["terminated"]
        assert term["exitCode"] == 137

    def test_service_roundtrip(self):
        svc = fixture_service()
        back = kube_wire.service_from_k8s(kube_wire.service_to_k8s(svc))
        assert back == svc
        # coordinator services are headless on the wire
        assert kube_wire.service_to_k8s(svc)["spec"]["clusterIP"] == "None"

    def test_job_roundtrip(self):
        job = fixture_job()
        back = kube_wire.job_from_k8s(kube_wire.job_to_k8s(job))
        assert back == job

    def test_non_numeric_resource_version_rejected(self):
        with pytest.raises(ValueError, match="resourceVersion"):
            kube_wire.meta_from_k8s({"name": "x", "resourceVersion": "abc"})


# -- kubeconfig ---------------------------------------------------------------

KUBECONFIG_YAML = """\
apiVersion: v1
kind: Config
current-context: gke-tpu
contexts:
- name: gke-tpu
  context: {cluster: tpu-cluster, user: controller, namespace: training}
- name: other
  context: {cluster: plain, user: tokenless}
clusters:
- name: tpu-cluster
  cluster:
    server: https://34.1.2.3
    certificate-authority-data: {ca64}
- name: plain
  cluster:
    server: http://127.0.0.1:8378
    insecure-skip-tls-verify: true
users:
- name: controller
  user: {token: sekrit-token}
- name: tokenless
  user: {}
"""


class TestKubeconfig:
    def _write(self, tmp_path):
        import base64

        ca = "-----BEGIN CERTIFICATE-----\nZZZZ\n-----END CERTIFICATE-----\n"
        text = KUBECONFIG_YAML.replace(
            "{ca64}", base64.b64encode(ca.encode()).decode()
        )
        path = tmp_path / "config"
        path.write_text(text)
        return str(path), ca

    def test_current_context(self, tmp_path):
        path, ca = self._write(tmp_path)
        ctx = load_kubeconfig(path)
        assert ctx.server == "https://34.1.2.3"
        assert ctx.token == "sekrit-token"
        assert ctx.namespace == "training"
        assert ctx.ca_data == ca

    def test_multi_path_kubeconfig_merge(self, tmp_path, monkeypatch):
        """$KUBECONFIG may be a pathsep-separated
        LIST merged with clientcmd precedence — first definition of a
        name wins, scalars (current-context) take the first non-empty
        value, missing files are skipped."""
        import os as _os

        first = tmp_path / "first"
        second = tmp_path / "second"
        first.write_text(
            "apiVersion: v1\nkind: Config\ncurrent-context: a\n"
            "clusters:\n- name: c1\n  cluster: {server: https://first}\n"
            "contexts:\n- name: a\n  context: {cluster: c1, user: u1}\n"
            "users:\n- name: u1\n  user: {token: tok-first}\n"
        )
        second.write_text(
            "apiVersion: v1\nkind: Config\ncurrent-context: b\n"
            "clusters:\n"
            "- name: c1\n  cluster: {server: https://shadowed}\n"
            "- name: c2\n  cluster: {server: https://second}\n"
            "contexts:\n"
            "- name: a\n  context: {cluster: c2, user: u2}\n"
            "- name: b\n  context: {cluster: c2, user: u2}\n"
            "users:\n- name: u2\n  user: {token: tok-second}\n"
        )
        joined = _os.pathsep.join(
            [str(first), str(tmp_path / "missing"), str(second)]
        )
        monkeypatch.setenv("KUBECONFIG", joined)
        # current-context from the FIRST file; its context/cluster/user
        # definitions shadow the second file's same-named entries.
        ctx = load_kubeconfig()
        assert ctx.server == "https://first"
        assert ctx.token == "tok-first"
        # names only the second file defines are still reachable
        ctx = load_kubeconfig(context="b")
        assert ctx.server == "https://second"
        assert ctx.token == "tok-second"
        # every file missing -> a clear error naming the whole list
        monkeypatch.setenv("KUBECONFIG", str(tmp_path / "nope"))
        with pytest.raises(KubeconfigError, match="not found"):
            load_kubeconfig()

    def test_stale_token_served_during_slow_refresh(self, monkeypatch):
        """A slow/hung exec plugin must not stall every request
        thread — while one thread refreshes, others get the stale cached
        token immediately; after invalidate (401) the refresh is a
        blocking single flight again."""
        import threading as _t
        import time as _time

        from kubeflow_controller_tpu_torch.cluster import kubeconfig as kc

        ctx = kc.KubeContext(
            server="https://x", exec_config={"command": "unused"},
        )
        ctx._cached_token = "stale"
        ctx._cached_expiry = _time.time() - 1      # expired
        started, release = _t.Event(), _t.Event()

        def slow_exec(cfg, server="", ca_data=""):
            started.set()
            assert release.wait(5)
            return "fresh", 0.0

        monkeypatch.setattr(kc, "run_exec_plugin", slow_exec)
        got = {}
        t = _t.Thread(target=lambda: got.update(a=ctx.bearer_token()))
        t.start()
        assert started.wait(5)
        t0 = _time.time()
        assert ctx.bearer_token() == "stale"       # no blocking
        assert _time.time() - t0 < 1.0
        release.set()
        t.join(5)
        assert got["a"] == "fresh"
        assert ctx.bearer_token() == "fresh"
        # 401 path: cache dropped, no stale left -> blocking single flight
        ctx.invalidate_token()
        monkeypatch.setattr(
            kc, "run_exec_plugin", lambda *a, **k: ("fresh2", 0.0))
        assert ctx.bearer_token() == "fresh2"

    def test_auth_provider_stanza_rejected_with_guidance(self, tmp_path):
        path = tmp_path / "legacy"
        path.write_text(
            "apiVersion: v1\nkind: Config\ncurrent-context: a\n"
            "clusters:\n- name: c\n  cluster: {server: https://x}\n"
            "contexts:\n- name: a\n  context: {cluster: c, user: u}\n"
            "users:\n- name: u\n  user:\n    auth-provider: {name: gcp}\n"
        )
        with pytest.raises(KubeconfigError, match="exec credential plugin"):
            load_kubeconfig(str(path))

    def test_ssl_context_with_real_ca(self, tmp_path):
        import base64
        import shutil
        import subprocess

        if shutil.which("openssl") is None:
            pytest.skip("openssl not available to mint a test CA")
        key = tmp_path / "ca.key"
        crt = tmp_path / "ca.crt"
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(crt), "-days", "1",
             "-subj", "/CN=test-ca"],
            check=True, capture_output=True,
        )
        ca_pem = crt.read_text()
        text = KUBECONFIG_YAML.replace(
            "{ca64}", base64.b64encode(ca_pem.encode()).decode()
        )
        path = tmp_path / "config"
        path.write_text(text)
        ctx = load_kubeconfig(str(path))
        ssl_ctx = ctx.ssl_context()
        assert ssl_ctx is not None
        import ssl as ssl_mod

        assert ssl_ctx.verify_mode == ssl_mod.CERT_REQUIRED

    def test_named_context_http(self, tmp_path):
        path, _ = self._write(tmp_path)
        ctx = load_kubeconfig(path, context="other")
        assert ctx.server == "http://127.0.0.1:8378"
        assert ctx.token == ""
        assert ctx.namespace == "default"
        assert ctx.ssl_context() is None  # http: no TLS

    def test_unknown_context(self, tmp_path):
        path, _ = self._write(tmp_path)
        with pytest.raises(KubeconfigError, match="no context"):
            load_kubeconfig(path, context="nope")

    def test_missing_file(self, tmp_path):
        with pytest.raises(KubeconfigError, match="not found"):
            load_kubeconfig(str(tmp_path / "absent"))

    def test_client_builds_from_context(self, tmp_path):
        path, _ = self._write(tmp_path)
        ctx = load_kubeconfig(path)
        # skip CA verification here: the fixture CA is a placeholder (the
        # real-CA path is covered by test_ssl_context_with_real_ca)
        ctx.ca_data = ""
        ctx.insecure_skip_tls_verify = True
        client = KubeClusterClient(kube_context=ctx)
        assert client.base_url == "https://34.1.2.3"
        # Tokens resolve dynamically through the context (rotation-safe),
        # not as a boot-time snapshot.
        assert client._bearer_token() == "sekrit-token"
        assert client.namespace == "training"


FAKE_EXEC_PLUGIN = """\
import json, os, sys, time
count_file = sys.argv[1]
n = (int(open(count_file).read()) if os.path.exists(count_file) else 0) + 1
open(count_file, "w").write(str(n))
# The client must speak the ExecCredential protocol: KUBERNETES_EXEC_INFO
# carries the request envelope.
info = json.loads(os.environ["KUBERNETES_EXEC_INFO"])
assert info["kind"] == "ExecCredential", info
exp = time.strftime(
    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + float(sys.argv[2]))
)
print(json.dumps({
    "apiVersion": "client.authentication.k8s.io/v1beta1",
    "kind": "ExecCredential",
    "status": {"token": "tok-%d" % n, "expirationTimestamp": exp},
}))
"""


class TestRotatingAuth:
    """Exec credential plugins + SA token rotation."""

    def _exec_kubeconfig(self, tmp_path, lifetime: float):
        import sys as _sys

        plugin = tmp_path / "fake_gke_auth.py"
        plugin.write_text(FAKE_EXEC_PLUGIN)
        counter = tmp_path / "calls"
        doc = {
            "apiVersion": "v1", "kind": "Config",
            "current-context": "gke",
            "clusters": [{"name": "c", "cluster": {
                "server": "https://34.1.2.3"}}],
            "contexts": [{"name": "gke", "context": {
                "cluster": "c", "user": "gke-user"}}],
            "users": [{"name": "gke-user", "user": {"exec": {
                "apiVersion": "client.authentication.k8s.io/v1beta1",
                "command": _sys.executable,
                "args": [str(plugin), str(counter), str(lifetime)],
                "provideClusterInfo": True,
            }}}],
        }
        import yaml as _yaml

        path = tmp_path / "config"
        path.write_text(_yaml.safe_dump(doc))
        return str(path), counter

    def test_exec_plugin_token_and_expiry_refresh(self, tmp_path):
        # The plugin's expirationTimestamp has whole seconds: a lifetime of
        # 2 s leaves at least 1 s of validity however slowly the plugin
        # starts on a loaded host, and the wait below ends past the expiry
        # the context actually cached.
        path, counter = self._exec_kubeconfig(tmp_path, lifetime=2.0)
        ctx = load_kubeconfig(path)
        assert ctx.exec_config is not None
        assert ctx.bearer_token() == "tok-1"
        # Cached while fresh: no second spawn.
        assert ctx.bearer_token() == "tok-1"
        assert counter.read_text() == "1"
        time.sleep(max(0.0, ctx._cached_expiry - time.time()) + 0.1)
        assert ctx.bearer_token() == "tok-2"   # past it -> re-exec

    def test_exec_plugin_invalidate_forces_refresh(self, tmp_path):
        path, counter = self._exec_kubeconfig(tmp_path, lifetime=3600.0)
        ctx = load_kubeconfig(path)
        assert ctx.bearer_token() == "tok-1"
        ctx.invalidate_token()  # the 401 path
        assert ctx.bearer_token() == "tok-2"

    def test_exec_plugin_failure_is_kubeconfig_error(self, tmp_path):
        from kubeflow_controller_tpu_torch.cluster.kubeconfig import (
            run_exec_plugin,
        )

        with pytest.raises(KubeconfigError, match="not found"):
            run_exec_plugin({"command": "/nonexistent/fake-auth-plugin"})

    def test_token_file_rotation(self, tmp_path):
        from kubeflow_controller_tpu_torch.cluster.kubeconfig import KubeContext

        tok = tmp_path / "token"
        tok.write_text("boot-token")
        ctx = KubeContext(
            server="http://127.0.0.1:1", token_file=str(tok),
            token_file_ttl=0.2,
        )
        assert ctx.bearer_token() == "boot-token"
        tok.write_text("rotated-token")  # kubelet refreshed the projection
        assert ctx.bearer_token() == "boot-token"  # still inside TTL
        time.sleep(0.25)
        assert ctx.bearer_token() == "rotated-token"

    def test_401_triggers_refresh_and_retry(self, tmp_path):
        """End to end over HTTP: the server rejects stale bearer tokens
        with 401; the client must re-read the rotated SA token and retry
        the request transparently (long-running-controller survival)."""
        import http.server
        import threading

        from kubeflow_controller_tpu_torch.cluster.kubeconfig import KubeContext

        tok = tmp_path / "token"
        tok.write_text("epoch-1")

        class AuthedHandler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                expect = f"Bearer {tok.read_text()}"
                if self.headers.get("Authorization") != expect:
                    body = b'{"reason": "Unauthorized"}'
                    self.send_response(401)
                else:
                    body = b'{"items": []}'
                    self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), AuthedHandler
        )
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            ctx = KubeContext(
                server=f"http://127.0.0.1:{server.server_address[1]}",
                token_file=str(tok), token_file_ttl=3600.0,
            )
            client = KubeClusterClient(kube_context=ctx)
            assert client.list_pods("default", {}) == []
            tok.write_text("epoch-2")  # rotation; client cache is stale
            assert client.list_pods("default", {}) == []  # 401 -> refresh
        finally:
            server.shutdown()


# -- protocol against the strict-k8s server -----------------------------------

@pytest.fixture()
def cluster():
    return FakeCluster(default_policy=PodRunPolicy(
        start_delay=1.0, run_duration=3.0
    ))


@pytest.fixture()
def kube(cluster):
    server = RestServer(cluster, k8s_mode=True).start()
    yield KubeClusterClient(server.url, namespace="default")
    server.stop()


def make_pod(name, labels=None, annotations=None):
    return Pod(metadata=ObjectMeta(
        name=name, namespace="default", labels=labels or {},
        annotations=annotations or {},
    ), spec=PodSpec(containers=[Container(name="c", image="img")]))


class TestKubeProtocol:
    def test_pod_crud(self, kube, cluster):
        created = kube.create_pod(make_pod("p1", labels={"a": "1"}))
        assert created.metadata.resource_version > 0
        assert [p.metadata.name for p in kube.list_pods("default", {"a": "1"})] == ["p1"]
        assert kube.list_pods("default", {"a": "2"}) == []
        kube.delete_pod("default", "p1")
        assert kube.list_pods("default", {}) == []
        # SuccessfulCreate/SuccessfulDelete events arrived as core/v1 Events
        reasons = [e[3] for e in cluster.cluster_events]
        assert "SuccessfulCreate" in reasons and "SuccessfulDelete" in reasons

    def test_update_pod_is_conflict_free_metadata_patch(self, kube):
        """Pod updates are claim writes (adopt/release): they go over the
        wire as an ownerReferences merge-patch with NO resourceVersion,
        so a stale local copy can never conflict — the
        write just lands on the live object. Optimistic concurrency still
        guards full-object updates (jobs; see
        test_job_update_conflict)."""
        created = kube.create_pod(make_pod("p1"))
        stale = created.deepcopy()
        created.metadata.owner_references.append(OwnerReference(
            api_version="v1", kind="TPUJob", name="a", uid="uid-a"))
        kube.update_pod(created)
        stale.metadata.owner_references.append(OwnerReference(
            api_version="v1", kind="TPUJob", name="b", uid="uid-b"))
        out = kube.update_pod(stale)  # resource_version is stale: no 409
        assert [r.uid for r in out.metadata.owner_references] == ["uid-b"]

    def test_job_update_conflict(self, kube):
        job = fixture_job()
        job.metadata.resource_version = 0
        job.metadata.uid = ""
        created = kube.create_job(job)
        stale = created.deepcopy()
        created.spec.log_dir = "/a"
        kube.update_job(created)
        stale.spec.log_dir = "/b"
        with pytest.raises(Conflict):
            kube.update_job(stale)

    def test_job_status_subresource_split(self, kube):
        job = fixture_job()
        job.metadata.resource_version = 0
        job.metadata.uid = ""
        created = kube.create_job(job)

        # A main-resource PUT cannot smuggle status past the subresource.
        tampered = created.deepcopy()
        tampered.status.phase = JobPhase.SUCCEEDED
        wire = kube_wire.job_to_k8s(tampered)
        kube._request(
            "PUT",
            f"/apis/tpu.kubeflow.dev/v1alpha1/namespaces/default/tpujobs/"
            f"{created.metadata.name}",
            wire,
        )
        got = kube.get_job("default", created.metadata.name)
        assert got.status.phase != JobPhase.SUCCEEDED

        # update_job (spec PUT + status PUT) lands both.
        got.spec.priority = 7
        got.status.phase = JobPhase.RUNNING
        updated = kube.update_job(got)
        assert updated.spec.priority == 7
        assert updated.status.phase == JobPhase.RUNNING
        persisted = kube.get_job("default", created.metadata.name)
        assert persisted.status.phase == JobPhase.RUNNING

    def test_list_then_watch_resume(self, kube, cluster):
        kube.create_pod(make_pod("pre"))
        items, rv = kube.list_raw("Pod", "default")
        assert [p.metadata.name for p in items] == ["pre"]
        events = []
        done = threading.Event()

        def consume():
            for ev in kube.watch("Pod", "default", resource_version=rv,
                                 timeout_seconds=3):
                events.append(ev)
                if len(events) >= 2:
                    break
            done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.3)
        kube.create_pod(make_pod("post"))
        kube.delete_pod("default", "post")
        assert done.wait(10)
        names = [(e.type.value, e.obj.metadata.name) for e in events]
        # pre-list object must NOT replay; post-list mutations must arrive
        assert ("ADDED", "post") == names[0]
        assert names[1][1] == "post"

    def test_watch_delivers_delete_of_old_object(self, kube):
        """A pod created long before the List must still produce a DELETED
        watch event (tombstones carry the deletion revision, so the
        replay-suppression filter cannot eat them)."""
        kube.create_pod(make_pod("old"))
        # bump the store revision well past the pod's own RV
        for i in range(3):
            kube.create_pod(make_pod(f"fill{i}"))
        _, rv = kube.list_raw("Pod", "default")
        got = []
        done = threading.Event()

        def consume():
            for ev in kube.watch("Pod", "default", resource_version=rv,
                                 timeout_seconds=5):
                got.append(ev)
                break
            done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.3)
        kube.delete_pod("default", "old")
        assert done.wait(10)
        assert got[0].type.value == "DELETED"
        assert got[0].obj.metadata.name == "old"

    def test_watch_from_pre_delete_rv_gets_410(self, kube):
        """Resuming a watch from before a delete cannot be served (no event
        history) — the server must 410 so the client relists instead of
        keeping a phantom object."""
        from kubeflow_controller_tpu_torch.cluster.kube_client import WatchExpired

        kube.create_pod(make_pod("doomed"))
        _, rv = kube.list_raw("Pod", "default")
        kube.delete_pod("default", "doomed")
        with pytest.raises(WatchExpired):
            for _ in kube.watch("Pod", "default", resource_version=rv,
                                timeout_seconds=2):
                pass

    def test_update_pod_preserves_unknown_spec_fields(self, kube):
        """Claiming's metadata update must not strip server-populated spec
        fields our dataclasses don't model (volumes, nodeName,
        tolerations, ... — a real apiserver 422s a PUT that drops them).
        Intercept the transport: the write must be a merge-PATCH that
        carries ONLY metadata.ownerReferences (never spec, and never the
        labels/annotations maps — patching those from a stale informer
        copy would revert concurrent edits) and no resourceVersion
        (conflict-free adoption)."""
        pod = make_pod("adoptee", labels={"a": "1"})
        pod.metadata.resource_version = 9
        calls = []

        def fake_request(method, path, payload=None, **kw):
            calls.append((method, path, payload, kw))
            assert method == "PATCH"
            return kube_wire.pod_to_k8s(pod)

        kube._request = fake_request
        desired = pod.deepcopy()
        desired.metadata.owner_references.append(OwnerReference(
            api_version="v1", kind="TPUJob", name="j", uid="uid-j"))
        kube.update_pod(desired)
        method, path, body, kw = calls[-1]
        assert kw.get("content_type") == "application/merge-patch+json"
        assert set(body) == {"metadata"}, body  # no spec, no status
        assert set(body["metadata"]) == {"ownerReferences"}, body
        assert body["metadata"]["ownerReferences"][0]["uid"] == "uid-j"

    def test_informer_over_kube_watch(self, kube, cluster):
        from kubeflow_controller_tpu_torch.controller.informer import Informer

        src = KubeWatchSource(kube, "Pod", "default")
        informer = Informer(src, resync_period=0.0)
        seen = []
        informer.add_handler(lambda ev: seen.append(
            (ev.type.value, ev.obj.metadata.name)
        ))
        kube.create_pod(make_pod("w1"))
        informer.start()
        assert informer.has_synced()
        kube.create_pod(make_pod("w2"))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if {"w1", "w2"} <= {n for _, n in seen}:
                break
            time.sleep(0.05)
        assert {"w1", "w2"} <= {n for _, n in seen}
        src.stop()

    def test_node_pool_slice_health(self, kube, cluster):
        cluster.slice_pool.add_pool("v5e-16", 2)
        slices = cluster.slice_pool.list("v5e-16")
        owner = OwnerReference(
            api_version="tpu.kubeflow.dev/v1alpha1", kind="TPUJob",
            name="j", uid="uid-slicejob",
        )
        pod = make_pod(
            "sp0",
            labels={"tpu.kubeflow.dev/job": "j",
                    "tpu.kubeflow.dev/runtime-id": "r"},
        )
        pod.metadata.owner_references = [owner]
        pod.spec.assigned_slice = slices[0].name
        pod.spec.node_selector = {
            "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
            "cloud.google.com/gke-tpu-topology": "4x4",
        }
        kube.create_pod(pod)

        # with the job-name hint: a server-side equality selector
        held = kube.job_slices("uid-slicejob", "j")
        assert [s.name for s in held] == [slices[0].name]
        assert held[0].healthy
        assert len(held[0].hosts) == slices[0].shape.num_hosts
        # without the hint: presence selector + client-side uid filter
        assert [s.name for s in kube.job_slices("uid-slicejob")] == \
            [slices[0].name]

        # NotReady nodes (degraded slice) surface as unhealthy
        cluster.slice_pool.mark_unhealthy(slices[0].name)
        kube._node_cache = (0.0, [])  # drop the client's node cache
        held = kube.job_slices("uid-slicejob", "j")
        assert not held[0].healthy

    def test_release_slices_is_noop(self, kube):
        assert kube.release_slices("whatever") == 0

    def test_adoption_lands_under_status_write_contention(self, kube, cluster):
        """A status writer (kubelet) hammering the pod must
        not starve adoption. The claim write is a metadata merge-patch
        without a resourceVersion, so it lands in ONE attempt regardless
        of how many times the object's RV moved underneath — and the
        concurrent status writes survive it (nothing is stomped)."""
        import threading as _threading

        created = kube.create_pod(make_pod(
            "contended", labels={"tpu.kubeflow.dev/job": "j"}))
        stop = _threading.Event()
        writes = [0]

        def hammer():
            from kubeflow_controller_tpu_torch.api.core import PodPhase as _PP

            while not stop.is_set():
                def bump(o):
                    o.status.phase = (
                        _PP.RUNNING if o.status.phase != _PP.RUNNING
                        else _PP.PENDING
                    )
                cluster.pods.mutate("default", "contended", bump)
                writes[0] += 1

        t = _threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            time.sleep(0.05)  # let the RV start moving
            adopted = created.deepcopy()
            adopted.metadata.owner_references.append(OwnerReference(
                api_version="tpu.kubeflow.dev/v1alpha1", kind="TPUJob",
                name="j", uid="uid-contended", controller=True,
            ))
            out = kube.update_pod(adopted)  # single call: must not raise
            assert any(
                r.uid == "uid-contended" for r in
                out.metadata.owner_references
            )
        finally:
            stop.set()
            t.join(timeout=5)
        assert writes[0] > 0, "the contention thread never wrote"
        live = kube.list_pods("default", {"tpu.kubeflow.dev/job": "j"})[0]
        assert any(
            r.uid == "uid-contended" for r in live.metadata.owner_references
        )

    def test_partially_deprovisioned_pool_is_unhealthy(self):
        """A pool whose surviving nodes are all Ready but which
        has FEWER nodes than the slice shape needs must read unhealthy —
        the gang cannot run on a partial slice."""
        nodes = [
            kube_wire.node_to_k8s(
                f"host-{i}", pool="pool-a",
                accelerator="tpu-v5-lite-podslice", topology="4x4",
                ready=True,
            )
            for i in range(4)
        ]
        full = kube_wire.slices_from_nodes(nodes, ["pool-a"])
        assert full[0].healthy and full[0].shape.num_hosts == 4
        partial = kube_wire.slices_from_nodes(nodes[:2], ["pool-a"])
        assert not partial[0].healthy
        assert len(partial[0].hosts) == 2

    def test_event_aggregation_on_k8s_wire(self, kube, cluster):
        """A crash-looping job must not spam the
        events API — repeats of an identical event PATCH the stored
        Event's count/lastTimestamp (record.EventRecorder semantics)."""
        for _ in range(5):
            kube.record_event(
                "TPUJob", "looper", "BackOff", "restarting failed gang",
                namespace="default",
            )
        out = kube._request("GET", "/api/v1/namespaces/default/events")
        evs = [e for e in out["items"] if e["reason"] == "BackOff"]
        assert len(evs) == 1, [e["reason"] for e in out["items"]]
        assert evs[0]["count"] == 5
        assert evs[0]["lastTimestamp"] >= evs[0]["firstTimestamp"]
        # The fake cluster's aggregate view stayed bounded too.
        assert cluster.event_count(
            "TPUJob", "looper", "BackOff", "restarting failed gang",
            namespace="default",
        ) == 5
        rows = [e for e in cluster.cluster_events if e[3] == "BackOff"]
        assert len(rows) == 1

    def test_similar_event_aggregation_bounds_api_writes(self, kube, cluster):
        """A crash-looping job whose MESSAGE varies
        per pod (same object+reason) must stop creating one Event per
        variant — after the client-go threshold (10 distinct messages)
        the recorder collapses onto ONE combined record, and the wire
        carries it."""
        for i in range(40):
            kube.record_event(
                "TPUJob", "flaky", "BackOff", f"pod flaky-{i} crashed",
                namespace="default",
            )
        out = kube._request("GET", "/api/v1/namespaces/default/events")
        evs = [e for e in out["items"] if e["reason"] == "BackOff"]
        # 9 distinct-message rows before the threshold + 1 combined row;
        # every occurrence past the threshold PATCHes the combined row.
        combined = [
            e for e in evs
            if e["message"].startswith("(combined from similar events): ")
        ]
        assert len(combined) == 1, [e["message"] for e in evs]
        assert len(evs) <= 10, f"{len(evs)} rows for one (object, reason)"
        assert combined[0]["count"] >= 2

    def test_event_spam_filter_token_bucket(self):
        """client-go NewEventSourceObjectSpamFilter parity: one object can
        burst 25 events; the flood beyond that is dropped client-side
        until the bucket refills (1 token / 5 min)."""
        from kubeflow_controller_tpu_torch.cluster.event_recorder import (
            EventAggregator,
        )

        agg = EventAggregator()
        admitted = sum(
            agg.observe("ns", "TPUJob", "noisy", f"R{i}", "m", now=0.0)
            is not None
            for i in range(60)
        )
        assert admitted == 25
        # 5 simulated minutes later exactly one more token exists.
        assert agg.observe("ns", "TPUJob", "noisy", "late", "m", 300.0)
        assert agg.observe("ns", "TPUJob", "noisy", "late2", "m", 300.0) is None
        # other objects are unaffected (per source+object buckets)
        assert agg.observe("ns", "TPUJob", "quiet", "R", "m", 300.0)

    def test_first_occurrence_race_single_creator(self):
        """Two threads observing the same new key concurrently
        must elect exactly ONE creator (the old protocol let both POST,
        leaving duplicate Event objects)."""
        import threading as _t

        from kubeflow_controller_tpu_torch.cluster.event_recorder import (
            EventAggregator,
        )

        agg = EventAggregator()
        created = []
        barrier = _t.Barrier(8)

        def run():
            barrier.wait()
            obs = agg.observe("ns", "Pod", "p", "Fail", "boom", 1.0)
            created.append(obs.created)

        ts = [_t.Thread(target=run) for _ in range(8)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert sum(created) == 1
        assert agg.get("ns", "Pod", "p", "Fail", "boom").count == 8

    def test_failed_event_create_is_recoverable(self):
        """If the creating POST fails, the key must not be
        silenced forever — a later occurrence can claim creation
        (begin_create), exactly one at a time, and abort_create releases
        the claim for the next retry."""
        from kubeflow_controller_tpu_torch.cluster.event_recorder import (
            EventAggregator,
        )

        agg = EventAggregator()
        obs1 = agg.observe("ns", "Pod", "p", "Fail", "boom", 1.0)
        assert obs1.created            # owns creation; POST "fails" here
        obs2 = agg.observe("ns", "Pod", "p", "Fail", "boom", 2.0)
        assert not obs2.created and obs2.record.handle is None
        # creator still (nominally) in flight: claim denied
        assert not agg.begin_create(obs2.key)
        agg.abort_create(obs1.key)     # the failed creator releases
        assert agg.begin_create(obs2.key)       # recovery claim granted
        assert not agg.begin_create(obs2.key)   # ...to exactly one caller
        agg.set_handle(obs2.key, "ev-1")        # retry POST succeeded
        assert not agg.begin_create(obs2.key)   # handle set: no claims
        assert agg.observe(
            "ns", "Pod", "p", "Fail", "boom", 3.0
        ).record.handle == "ev-1"

    def test_aggregated_event_count_reachable_by_raw_message(self):
        """Once similar-event aggregation trips, get() for a
        raw message that collapsed onto the combined record must reach
        the combined count instead of returning nothing."""
        from kubeflow_controller_tpu_torch.cluster.event_recorder import (
            EventAggregator,
        )

        agg = EventAggregator()
        for i in range(14):
            agg.observe("ns", "TPUJob", "j", "BackOff", f"pod {i} died", i)
        rec = agg.get("ns", "TPUJob", "j", "BackOff", "pod 13 died")
        assert rec is not None and rec.count >= 2   # the combined record
        # pre-threshold messages keep their own records
        assert agg.get("ns", "TPUJob", "j", "BackOff", "pod 0 died").count == 1

    def test_event_posted_to_involved_objects_namespace(self, kube, cluster):
        """Events for an object in another namespace must land
        in THAT namespace (a real apiserver rejects a mismatch between the
        Event's namespace and involvedObject.namespace)."""
        pod = make_pod("other-ns-pod")
        pod.metadata.namespace = "training"
        kube.create_pod(pod)  # client namespace is "default"
        out = kube._request("GET", "/api/v1/namespaces/training/events")
        reasons = [e["reason"] for e in out["items"]]
        assert "SuccessfulCreate" in reasons
        ev = next(e for e in out["items"] if e["reason"] == "SuccessfulCreate")
        assert ev["metadata"]["namespace"] == "training"
        assert ev["involvedObject"]["namespace"] == "training"


# -- the controller, unmodified, over strict k8s wire -------------------------

class TestControllerOverKube:
    def test_local_job_to_succeeded(self, cluster):
        from kubeflow_controller_tpu_torch.runtime import RemoteRuntime

        server = RestServer(cluster, k8s_mode=True).start()
        rt = RemoteRuntime(server.url, k8s=True, resync_period=1.0)
        stop = threading.Event()

        def ticker():
            while not stop.wait(0.05):
                cluster.tick(0.05)

        threading.Thread(target=ticker, daemon=True).start()
        try:
            rt.start(workers=2)
            job = TPUJob(
                metadata=ObjectMeta(name="k8s-local", namespace="default"),
                spec=TPUJobSpec(replica_specs=[ReplicaSpec(
                    replica_type=ReplicaType.LOCAL,
                    template=PodTemplateSpec(spec=PodSpec(containers=[
                        Container(name="t", image="img"),
                    ])),
                )]),
            )
            rt.client.create_job(job)
            deadline = time.monotonic() + 60
            phase = None
            while time.monotonic() < deadline:
                got = rt.client.get_job("default", "k8s-local")
                phase = got.status.phase if got else None
                if phase == JobPhase.SUCCEEDED:
                    break
                time.sleep(0.1)
            assert phase == JobPhase.SUCCEEDED
        finally:
            stop.set()
            rt.stop()
            server.stop()

    def test_gang_job_to_succeeded(self, cluster):
        """A 2-host v5e-16 gang through real wire: all-or-nothing admission
        on the slice pool, coordinator service, Succeeded."""
        from kubeflow_controller_tpu_torch.runtime import RemoteRuntime

        cluster.slice_pool.add_pool("v5e-16", 1)
        server = RestServer(cluster, k8s_mode=True).start()
        rt = RemoteRuntime(server.url, k8s=True, resync_period=1.0)
        stop = threading.Event()

        def ticker():
            while not stop.wait(0.05):
                cluster.tick(0.05)

        threading.Thread(target=ticker, daemon=True).start()
        try:
            rt.start(workers=2)
            job = fixture_job()
            job.metadata = ObjectMeta(name="k8s-gang", namespace="default")
            job.spec.runtime_id = ""
            job.status.phase = JobPhase.NONE
            job.status.submit_time = None
            rt.client.create_job(job)
            deadline = time.monotonic() + 60
            phase = None
            while time.monotonic() < deadline:
                got = rt.client.get_job("default", "k8s-gang")
                phase = got.status.phase if got else None
                if phase == JobPhase.SUCCEEDED:
                    break
                time.sleep(0.1)
            assert phase == JobPhase.SUCCEEDED
            # the gang really rode the slice pool
            reasons = [e[3] for e in cluster.cluster_events]
            assert "GangScheduled" in reasons
        finally:
            stop.set()
            rt.stop()
            server.stop()


# -- the port against the JAX package ----------------------------------------

PACKAGES = ("kubeflow_controller_tpu", "kubeflow_controller_tpu_torch")


def _mods(pkg):
    imp = importlib.import_module
    return pytypes.SimpleNamespace(**{
        k: imp(f"{pkg}.{v}") for k, v in (
            ("core", "api.core"), ("types", "api.types"),
            ("wire", "cluster.kube_wire"), ("kc", "cluster.kubeconfig"),
            ("plan", "tpu.plan"), ("cluster", "cluster.cluster"),
            ("server", "cluster.rest_server"),
            ("client", "cluster.kube_client"), ("runtime", "runtime"),
            ("slices", "cluster.slices"))})


def _objects(m):
    """The same objects built from one package's classes: the fixture job
    (status filled in), every pod and service its plan creates (one given
    a live status), a Local job, and an LMService-free service."""
    c, t = m.core, m.types
    job = t.TPUJob(
        metadata=c.ObjectMeta(
            name="bert-pretrain", namespace="default",
            uid="uid-00000042-beef", resource_version=7,
            creation_timestamp=1000.0, labels={"team": "nlp"},
            annotations={"note": "x"}),
        spec=t.TPUJobSpec(
            runtime_id="r1a2b", model_dir="/ckpt/bert-pretrain", priority=3,
            replica_specs=[t.ReplicaSpec(
                replica_type=t.ReplicaType.WORKER,
                template=c.PodTemplateSpec(spec=c.PodSpec(containers=[
                    c.Container(name="trainer", image="tpujob/bert:latest",
                                command=["python", "-m", "trainer"],
                                env={"A": "1"})])),
                tpu=t.TPUSliceSpec(accelerator_type="v5e-16", num_slices=2),
                max_restarts=3)]))
    job.status.phase = t.JobPhase.RUNNING
    job.status.submit_time = 1000.0
    job.status.all_running_time = 1012.5
    job.status.restarts = 2
    plan = m.plan.plan_job(job, [], [])
    pods, svcs = list(plan.create_pods), list(plan.create_services)
    pods[0].status.phase = c.PodPhase.RUNNING
    pods[0].status.start_time = 1003.25
    pods[0].spec.assigned_slice = "pool-v5e-16-slice-0"
    local = t.TPUJob(
        metadata=c.ObjectMeta(name="local", namespace="ml"),
        spec=t.TPUJobSpec(replica_specs=[t.ReplicaSpec(
            replica_type=t.ReplicaType.LOCAL,
            template=c.PodTemplateSpec(spec=c.PodSpec(containers=[
                c.Container(name="t", image="img")])))]))
    return [("job", job), ("job", local)] + [("pod", p) for p in pods] + [
        ("service", s) for s in svcs]


def _to(m, kind, obj):
    return getattr(m.wire, f"{kind}_to_k8s")(obj)


def _from(m, kind, d):
    return getattr(m.wire, f"{kind}_from_k8s")(d)


def test_kube_wire_matches_jax_for_the_same_objects():
    jm, pm = _mods(PACKAGES[0]), _mods(PACKAGES[1])
    jobs, pobs = _objects(jm), _objects(pm)
    assert len(jobs) == len(pobs) > 4
    for (kind, jo), (_, po) in zip(jobs, pobs):
        jd, pd = _to(jm, kind, jo), _to(pm, kind, po)
        assert json.dumps(jd, sort_keys=True) == json.dumps(pd, sort_keys=True)
        # Round trips: each package's parse of the other's JSON writes it
        # back unchanged.
        assert _to(pm, kind, _from(pm, kind, jd)) == jd
        assert _to(jm, kind, _from(jm, kind, pd)) == pd
    for ts in (0.0, 1000.0, 1700000000.125, 1.5e9):
        assert jm.wire.rfc3339(ts) == pm.wire.rfc3339(ts)
        assert jm.wire.from_rfc3339(jm.wire.rfc3339(ts)) == \
            pm.wire.from_rfc3339(pm.wire.rfc3339(ts))
    for args in (("Pod", "p-0", "default", "FailedCreate", "boom"),
                 ("TPUJob", "j", "ml", "GangScheduled", "ok")):
        assert jm.wire.event_to_k8s(*args, ts=1234.5) == \
            pm.wire.event_to_k8s(*args, ts=1234.5)
    nodes = [dict(jm.wire.node_to_k8s(f"n{i}", pool=f"pool-{i // 2}",
                                      accelerator="tpu-v5-lite-podslice",
                                      topology="4x4", ready=i != 3))
             for i in range(6)]
    assert nodes == [pm.wire.node_to_k8s(f"n{i}", pool=f"pool-{i // 2}",
                                         accelerator="tpu-v5-lite-podslice",
                                         topology="4x4", ready=i != 3)
                     for i in range(6)]
    pools = ["pool-0", "pool-1", "pool-2", "pool-gone"]
    js = [jm.slices.slice_to_dict(s)
          for s in jm.wire.slices_from_nodes(nodes, pools)]
    ps = [pm.slices.slice_to_dict(s)
          for s in pm.wire.slices_from_nodes(nodes, pools)]
    assert js == ps and len(js) == 3


def _ctx_fields(ctx):
    """A KubeContext's public fields, with the key and cert files it wrote
    from ``*-data`` replaced by their contents."""
    out = {f.name: getattr(ctx, f.name) for f in dataclasses.fields(ctx)
           if not f.name.startswith("_")}
    for k in ("client_cert_file", "client_key_file"):
        if out[k] and os.path.exists(out[k]):
            with open(out[k]) as f:
                out[k] = ("contents", f.read())
    return out


def test_kubeconfig_resolves_the_same_contexts_as_jax(tmp_path, monkeypatch):
    import base64

    jm, pm = _mods(PACKAGES[0]), _mods(PACKAGES[1])
    ca = "-----BEGIN CERTIFICATE-----\nZZZZ\n-----END CERTIFICATE-----\n"
    b64 = lambda t: base64.b64encode(t.encode()).decode()  # noqa: E731
    main = tmp_path / "config"
    main.write_text(
        KUBECONFIG_YAML.replace("{ca64}", b64(ca))
        + "- name: mtls\n  user:\n"
        + f"    client-certificate-data: {b64('CERT')}\n"
        + f"    client-key-data: {b64('KEY')}\n"
        + "- name: filetok\n  user: {tokenFile: " + str(tmp_path / "tok") + "}\n")
    (tmp_path / "tok").write_text("file-token\n")
    extra = tmp_path / "extra"
    extra.write_text(
        "apiVersion: v1\nkind: Config\ncurrent-context: m\n"
        "clusters:\n- name: tpu-cluster\n  cluster: {server: https://shadowed}\n"
        "contexts:\n"
        "- name: m\n  context: {cluster: tpu-cluster, user: mtls}\n"
        "- name: f\n  context: {cluster: plain, user: filetok, namespace: x}\n")
    joined = os.pathsep.join([str(main), str(tmp_path / "missing"), str(extra)])
    cases = [(str(main), None), (str(main), "other"), (joined, None),
             (joined, "m"), (joined, "f")]
    for path, context in cases:
        got = [_ctx_fields(m.kc.load_kubeconfig(path, context))
               for m in (jm, pm)]
        assert got[0] == got[1], (path, context)
    monkeypatch.setenv("KUBECONFIG", joined)
    assert _ctx_fields(jm.kc.load_kubeconfig()) == \
        _ctx_fields(pm.kc.load_kubeconfig())
    errors = []
    for m in (jm, pm):
        for path, context in ((str(main), "nope"), (str(tmp_path / "no"), None)):
            with pytest.raises(m.kc.KubeconfigError) as e:
                m.kc.load_kubeconfig(path, context)
            errors.append(str(e.value))
    assert errors[:2] == errors[2:]
    # No YAML: a parsed document resolves the same way, and without the
    # service-account mount there is no in-cluster context.
    doc = {"current-context": "c", "contexts": [{"name": "c", "context": {
        "cluster": "k", "user": "u", "namespace": "n"}}],
        "clusters": [{"name": "k", "cluster": {"server": "http://h:1"}}],
        "users": [{"name": "u", "user": {"token": "t"}}]}
    assert _ctx_fields(jm.kc.resolve_context(doc, None)) == \
        _ctx_fields(pm.kc.resolve_context(doc, None))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    assert jm.kc.in_cluster_context() is None and pm.kc.in_cluster_context() is None


def test_rotating_credentials_match_jax(tmp_path):
    """The exec plugin's tokens and their refresh on expiry and on a 401,
    and a token file's rotation, step for step in both packages."""
    import http.server

    # Both packages in lockstep, so that one wait past the expiry serves
    # both (the plugin's expirationTimestamp has whole seconds).
    ms = [_mods(pkg) for pkg in PACKAGES]
    ctxs, counters, toks, fctxs = [], [], [], []
    for i, m in enumerate(ms):
        d = tmp_path / str(i)
        d.mkdir()
        path, counter = TestRotatingAuth()._exec_kubeconfig(d, lifetime=2.0)
        ctxs.append(m.kc.load_kubeconfig(path))
        counters.append(counter)
        toks.append(d / "token")
        toks[-1].write_text("boot")
        fctxs.append(m.kc.KubeContext(server="http://127.0.0.1:1",
                                      token_file=str(toks[-1]),
                                      token_file_ttl=0.2))
    seqs = [[c.bearer_token(), c.bearer_token()] for c in ctxs]
    for seq, f, tok in zip(seqs, fctxs, toks):
        # Read, rotate, read again at once: inside the file's TTL.
        seq.append(f.bearer_token())
        tok.write_text("rotated")
        seq.append(f.bearer_token())
    time.sleep(2.1)
    for seq, c, f, counter in zip(seqs, ctxs, fctxs, counters):
        seq += [f.bearer_token(), c.bearer_token()]
        c.invalidate_token()
        seq += [c.bearer_token(), counter.read_text()]
    assert seqs[0] == seqs[1] == [
        "tok-1", "tok-1", "boot", "boot", "rotated", "tok-2", "tok-3", "3"]

    # The 401 refresh over HTTP: each client sees the same answers and
    # sends the same Authorization headers.
    tok = tmp_path / "sa-token"
    seen = []

    class AuthedHandler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            got = self.headers.get("Authorization")
            seen.append(got)
            ok = got == f"Bearer {tok.read_text()}"
            body = b'{"items": []}' if ok else b'{"reason": "Unauthorized"}'
            self.send_response(200 if ok else 401)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), AuthedHandler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    logs = []
    try:
        for pkg in PACKAGES:
            m = _mods(pkg)
            seen.clear()
            tok.write_text("epoch-1")
            ctx = m.kc.KubeContext(
                server=f"http://127.0.0.1:{server.server_address[1]}",
                token_file=str(tok), token_file_ttl=3600.0)
            client = m.client.KubeClusterClient(kube_context=ctx)
            out = [client.list_pods("default", {})]
            tok.write_text("epoch-2")
            out.append(client.list_pods("default", {}))
            logs.append((out, list(seen)))
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert logs[0] == logs[1]
    assert logs[0][1] == ["Bearer epoch-1", "Bearer epoch-1", "Bearer epoch-2"]


def _cross_run(client_pkg, server_pkg, k8s):
    """``client_pkg``'s RemoteRuntime reconciling ``server_pkg``'s
    apiserver over its FakeCluster (a wall-clock ticker drives the pods):
    a Local job and a two-host gang, both to Succeeded."""
    cm, sm = _mods(client_pkg), _mods(server_pkg)
    cluster = sm.cluster.FakeCluster(default_policy=sm.cluster.PodRunPolicy(
        start_delay=0.5, run_duration=1.0))
    cluster.slice_pool.add_pool("v5e-16", 1)
    server = sm.server.RestServer(cluster, k8s_mode=k8s).start()
    rt = cm.runtime.RemoteRuntime(server.url, k8s=k8s, resync_period=1.0)
    stop = threading.Event()

    def ticker():
        while not stop.wait(0.05):
            cluster.tick(0.05)

    tick = threading.Thread(target=ticker, daemon=True)
    tick.start()
    try:
        rt.start(workers=2)
        c, t = cm.core, cm.types
        local = t.TPUJob(
            metadata=c.ObjectMeta(name="cross-local", namespace="default"),
            spec=t.TPUJobSpec(replica_specs=[t.ReplicaSpec(
                replica_type=t.ReplicaType.LOCAL,
                template=c.PodTemplateSpec(spec=c.PodSpec(containers=[
                    c.Container(name="t", image="img")])))]))
        gang = _objects(cm)[0][1]
        gang.metadata = c.ObjectMeta(name="cross-gang", namespace="default")
        gang.spec.runtime_id = ""
        gang.spec.replica_specs[0].tpu.num_slices = 1
        gang.status = t.TPUJobStatus()
        rt.client.create_job(local)
        rt.client.create_job(gang)
        deadline = time.monotonic() + 60
        phases = {}
        while time.monotonic() < deadline:
            for name in ("cross-local", "cross-gang"):
                got = rt.client.get_job("default", name)
                phases[name] = got.status.phase.value if got else None
            if set(phases.values()) == {"Succeeded"}:
                break
            time.sleep(0.1)
        reasons = [e[3] for e in cluster.cluster_events]
        pods = [p.metadata.name for p in cluster.pods.list("default")]
    finally:
        stop.set()
        rt.stop()
        server.stop()
        tick.join(timeout=10)
    return phases, reasons, pods


@pytest.mark.parametrize("k8s", [True, False], ids=["k8s_wire", "framework_wire"])
@pytest.mark.parametrize("client_pkg,server_pkg", [PACKAGES, PACKAGES[::-1]],
                         ids=["jax_client_port_server", "port_client_jax_server"])
def test_cross_package_client_and_server(client_pkg, server_pkg, k8s):
    phases, reasons, pods = _cross_run(client_pkg, server_pkg, k8s)
    assert phases == {"cross-local": "Succeeded", "cross-gang": "Succeeded"}
    assert "GangScheduled" in reasons
    assert any(p.startswith("cross-gang-") for p in pods)
