"""The port's tpujobctl (``python -m kubeflow_controller_tpu_torch.cli``).

The first part is ``tests/test_cli.py`` on the port: the one-shot run mode
and the daemon/client flow against an in-process server. Then the port held
to the JAX CLI: the parser takes every subcommand and option with the same
defaults; ``validate``, ``run`` and every daemon verb print what the JAX CLI
prints against a daemon of its own package (both driven on the simulated
clock); the deployment manifest's command line parses and its RBAC covers
every call the port's adapter makes; ``kube_wire``'s job passes the CRD's
schema. Last, the processes: ``apiserver`` and ``serve --cluster-url
--k8s-wire`` as two processes taking a job to Succeeded, and the two-strike
SIGINT/SIGTERM handler in a process that imports no torch, and in
``serve_lm.main``.

Every server binds 127.0.0.1 port 0 and is stopped in a ``finally``; every
subprocess and join has its own timeout. Only the ``serve_lm`` case imports
torch, in its own subprocess.
"""

import importlib
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer

import pytest
import yaml
from test_deploy_manifest import _by_kind, _docs, _granted

from kubeflow_controller_tpu_torch import cli
from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
from kubeflow_controller_tpu_torch.runtime import LocalRuntime

JOB_YML = """
apiVersion: tpu.kubeflow.dev/v1alpha1
kind: TPUJob
metadata: {name: clitest, namespace: default}
spec:
  replicaSpecs:
  - replicaType: Worker
    tpu: {acceleratorType: v5p-8, numSlices: 1}
    template:
      spec:
        containers:
        - name: train
          image: jax:latest
          command: [python, -c, "pass"]
"""


@pytest.fixture()
def manifest(tmp_path):
    p = tmp_path / "job.yml"
    p.write_text(JOB_YML)
    return str(p)


@pytest.fixture()
def daemon():
    rt = LocalRuntime(PodRunPolicy(start_delay=0.2, run_duration=2))
    rt.cluster.slice_pool.add_pool("v5p-8", 2)
    rt.start_threads(workers=2, tick_interval=0.02)
    server = ThreadingHTTPServer(("127.0.0.1", 0), cli._make_handler(rt))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server.server_address[1]
    server.shutdown()
    rt.stop()


def test_serve_k8s_wire_without_target_errors(capsys):
    """--k8s-wire with no remote target must error, not silently start the
    local in-process runtime."""
    assert cli.main(["serve", "--k8s-wire"]) == 2
    assert "--k8s-wire requires a remote cluster target" in (
        capsys.readouterr().err
    )


def test_validate_ok(manifest, capsys):
    assert cli.main(["validate", "-f", manifest]) == 0
    assert "valid" in capsys.readouterr().out


def test_validate_bad(tmp_path, capsys):
    p = tmp_path / "bad.yml"
    p.write_text(JOB_YML.replace("v5p-8", "v999-1"))
    assert cli.main(["validate", "-f", str(p)]) == 1
    assert "not a known slice shape" in capsys.readouterr().out


def test_run_one_shot(manifest, capsys):
    rc = cli.main([
        "run", "-f", manifest, "--pool", "v5p-8x2", "--timeout", "30",
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Succeeded" in out
    assert "submit -> all-running" in out


def test_daemon_submit_describe_delete(daemon, manifest, capsys):
    port = str(daemon)
    assert cli.main(["submit", "--port", port, "-f", manifest]) == 0
    assert cli.main(["list", "--port", port]) == 0
    out = capsys.readouterr().out
    assert "clitest" in out

    import time
    deadline = time.time() + 20
    phase = ""
    while time.time() < deadline and phase != "Succeeded":
        cli.main(["describe", "clitest", "--port", port])
        out = capsys.readouterr().out
        for line in out.splitlines():
            if line.startswith("Phase:"):
                phase = line.split()[1]
        time.sleep(0.2)
    assert phase == "Succeeded", out

    assert cli.main(["pools", "--port", port]) == 0
    assert "v5p-8" in capsys.readouterr().out
    assert cli.main(["traces", "--port", port]) == 0
    assert "executed" in capsys.readouterr().out
    assert cli.main(["delete", "clitest", "--port", port]) == 0
    assert "deleted" in capsys.readouterr().out


def test_logs_verb(daemon, manifest, capsys):
    port = str(daemon)
    assert cli.main(["submit", "--port", port, "-f", manifest]) == 0
    capsys.readouterr()
    import time
    deadline = time.time() + 20
    rc = 1
    while time.time() < deadline:
        rc = cli.main(["logs", "clitest", "--port", port])
        out = capsys.readouterr().out
        if rc == 0 and "exited: code 0" in out:
            break
        time.sleep(0.3)
    assert rc == 0, out
    assert "scheduled: slice" in out
    assert "started:" in out


def test_apply_creates_then_resizes(daemon, tmp_path, capsys):
    """kubectl-apply analog: first apply creates; a spec edit on a live job
    triggers a voluntary gang resize (new gang, new env contract)."""
    import time

    port = str(daemon)
    p = tmp_path / "apply.yml"
    p.write_text(JOB_YML)
    assert cli.main(["apply", "--port", port, "-f", str(p)]) == 0
    assert "applied" in capsys.readouterr().out

    # live resize: 1 slice -> 2 slices
    p.write_text(JOB_YML.replace("numSlices: 1", "numSlices: 2"))
    deadline = time.time() + 20
    ok = False
    while time.time() < deadline and not ok:
        assert cli.main(["apply", "--port", port, "-f", str(p)]) == 0
        capsys.readouterr()
        cli.main(["get", "clitest", "--port", port])
        out = capsys.readouterr().out
        import json as _json
        j = _json.loads(out)
        ok = (j.get("status", {}).get("resizes", 0) >= 1)
        time.sleep(0.2)
    assert ok, out


def test_logs_follow_streams_and_exits_on_delete(daemon, manifest, capsys):
    """logs -f: prints lines as they appear and returns once the job is
    deleted and the stream drains."""
    import threading as _threading
    import time

    port = str(daemon)
    assert cli.main(["submit", "--port", port, "-f", manifest]) == 0
    capsys.readouterr()

    rc = {}
    t = _threading.Thread(target=lambda: rc.update(code=cli.main(
        ["logs", "clitest", "--port", port, "-f", "--poll-interval", "0.05"]
    )))
    t.start()
    # let the job run to completion, then delete it -> follower must exit
    deadline = time.time() + 20
    while time.time() < deadline:
        out = capsys.readouterr().out  # drain target: scheduled+exited lines
        if "exited" in out:
            break
        time.sleep(0.1)
    cli.main(["delete", "clitest", "--port", port])
    t.join(timeout=15)
    assert not t.is_alive(), "follower did not exit after job deletion"
    assert rc.get("code") == 0


def test_log_level_flags_wire_the_root_logger():
    """The serve/apiserver daemons take -v (glog
    scale: the reference runs `-logtostderr -v 4`) and --log-level, and
    setup_logging installs the level on the root logger."""
    import logging

    p = cli.build_parser()
    args = p.parse_args(["serve", "-v", "4"])
    assert cli.setup_logging(args) == logging.DEBUG
    assert logging.getLogger().level == logging.DEBUG

    args = p.parse_args(["apiserver", "-v", "0"])
    assert cli.setup_logging(args) == logging.WARNING

    args = p.parse_args(["serve", "-v", "4", "--log-level", "warning"])
    assert cli.setup_logging(args) == logging.WARNING  # name beats -v

    args = p.parse_args(["serve"])
    assert cli.setup_logging(args) == logging.INFO     # default
    assert logging.getLogger().handlers, "no handler installed"
    logging.basicConfig(level=logging.WARNING, force=True)


# -- the port's CLI against the JAX CLI ---------------------------------------

PACKAGES = ("kubeflow_controller_tpu", "kubeflow_controller_tpu_torch")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_UID = re.compile(r"\b[a-z]+-\d{8}-[0-9a-f]{4}\b")


def _parser_table(parser):
    """Every subcommand's options: flags, dest, default, type, choices,
    nargs, required, action class, and the handler's name."""
    import argparse

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    table = {}
    for name, sp in sub.choices.items():
        rows = []
        for a in sp._actions:
            rows.append((tuple(a.option_strings), a.dest, repr(a.default),
                         getattr(a.type, "__name__", repr(a.type)),
                         a.choices, a.nargs, a.required, type(a).__name__))
        table[name] = (sorted(rows, key=repr),
                       sp.get_default("fn").__name__)
    return table


def test_parser_takes_every_jax_subcommand_and_option():
    jax_cli = importlib.import_module(f"{PACKAGES[0]}.cli")
    want = _parser_table(jax_cli.build_parser())
    got = _parser_table(cli.build_parser())
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert len(want) == 18      # serve ... version


def _drive(pkg, manifest, bad):
    """One package's CLI against a daemon of its own package, driven on the
    simulated clock between verbs; returns every verb's (rc, output)."""
    mcli = importlib.import_module(f"{pkg}.cli")
    rtm = importlib.import_module(f"{pkg}.runtime")
    clm = importlib.import_module(f"{pkg}.cluster.cluster")
    rt = rtm.LocalRuntime(clm.PodRunPolicy(start_delay=1.0, run_duration=3.0))
    rt.controller.opts.rng = random.Random(11)
    rt.cluster.slice_pool.add_pool("v5p-8", 2)
    server = ThreadingHTTPServer(("127.0.0.1", 0), mcli._make_handler(rt))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    port = str(server.server_address[1])
    outs = []

    def run(*argv):
        import contextlib
        import io

        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            try:
                rc = mcli.main(list(argv))
            except SystemExit as e:
                rc = str(e)
        text = _UID.sub("<uid>", buf.getvalue() + err.getvalue())
        outs.append((argv[0], rc, re.sub(r"\d+\.\d+ms", "<ms>", text)))

    try:
        run("version")
        run("validate", "-f", manifest)
        run("validate", "-f", bad)
        run("add-pool", "v5e-8", "--count", "1", "--port", port)
        run("pools", "--port", port)
        run("submit", "-f", manifest, "--port", port)
        run("submit", "-f", bad, "--port", port)
        run("list", "--port", port)
        rt.step(dt=1.0, steps=2)
        run("describe", "clitest", "--port", port)
        run("logs", "clitest", "--port", port)
        run("events", "--port", port)
        run("events", "clitest", "--port", port)
        run("suspend", "clitest", "--port", port)
        rt.step(dt=1.0, steps=2)
        run("describe", "clitest", "--port", port)
        run("resume", "clitest", "--port", port)
        rt.step(dt=1.0, steps=8)
        run("get", "clitest", "--port", port)
        run("describe", "clitest", "--port", port)
        run("list", "--port", port)
        run("traces", "--port", port)
        run("apply", "-f", manifest, "--port", port)
        run("delete", "clitest", "--port", port)
        run("get", "clitest", "--port", port)
        run("logs", "nothing", "--port", port)
        run("run", "-f", manifest, "--pool", "v5p-8x2", "--timeout", "30")
    finally:
        server.shutdown()
        server.server_close()
        rt.stop()
        t.join(timeout=10)
    return outs


def test_verbs_print_what_the_jax_cli_prints(manifest, tmp_path):
    bad = tmp_path / "bad.yml"
    bad.write_text(JOB_YML.replace("v5p-8", "v999-1"))
    jax = _drive(PACKAGES[0], manifest, str(bad))
    port = _drive(PACKAGES[1], manifest, str(bad))
    for a, b in zip(jax, port):
        assert a == b
    assert len(jax) == len(port)
    got = dict((verb, text) for verb, _, text in port)
    assert "Phase:      Succeeded" in got["describe"]
    assert "final: Succeeded" in got["run"]


def test_deployment_command_line_parses_to_the_in_cluster_path():
    dep = _by_kind(_docs(), "Deployment")
    c = dep["spec"]["template"]["spec"]["containers"][0]
    args = cli.build_parser().parse_args([str(a) for a in c["args"]])
    assert args.cmd == "serve"
    assert args.in_cluster is True and args.k8s_wire is True
    assert args.fn is cli.cmd_serve


_CALL = re.compile(
    r"^(?:/api/v1(?:/namespaces/[^/]+)?/(?P<core>pods|services|events|nodes)"
    r"|/apis/(?P<group>[^/]+)/v1alpha1/namespaces/[^/]+/(?P<crd>tpujobs))"
    r"(?:/(?P<name>[^/?]+))?(?:/(?P<sub>status))?(?:\?(?P<q>.*))?$")


def _rbac_need(method, path):
    m = _CALL.match(path)
    assert m, path
    group = m.group("group") or ""
    resource = m.group("core") or m.group("crd")
    if m.group("sub"):
        resource += "/" + m.group("sub")
    if method == "GET":
        if m.group("name"):
            verb = "get"
        else:
            verb = "watch" if "watch=" in (m.group("q") or "") else "list"
    else:
        verb = {"POST": "create", "PUT": "update", "PATCH": "patch",
                "DELETE": "delete"}[method]
    return group, resource, verb


def test_rbac_covers_every_call_the_port_adapter_makes(monkeypatch):
    """Record every request the port's KubeClusterClient sends while a
    RemoteRuntime takes a Local job and a gang through a pod crash to
    Succeeded over the strict-k8s wire; the ClusterRole grants each."""
    from kubeflow_controller_tpu_torch.api.core import (
        Container, ObjectMeta, PodSpec, PodTemplateSpec,
    )
    from kubeflow_controller_tpu_torch.api.types import (
        ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec, TPUSliceSpec,
    )
    from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster
    from kubeflow_controller_tpu_torch.cluster.kube_client import (
        KubeClusterClient,
    )
    from kubeflow_controller_tpu_torch.cluster.rest_server import RestServer
    from kubeflow_controller_tpu_torch.runtime import RemoteRuntime

    calls = set()
    orig = KubeClusterClient._request

    def record(self, method, path, *a, **kw):
        calls.add(_rbac_need(method, path))
        return orig(self, method, path, *a, **kw)

    monkeypatch.setattr(KubeClusterClient, "_request", record)
    cluster = FakeCluster(default_policy=PodRunPolicy(start_delay=0.5,
                                                      run_duration=1.5))
    cluster.slice_pool.add_pool("v5p-8", 1)
    server = RestServer(cluster, k8s_mode=True).start()
    rt = RemoteRuntime(server.url, k8s=True, resync_period=1.0)
    stop = threading.Event()

    def ticker():
        while not stop.wait(0.05):
            cluster.tick(0.05)

    tick = threading.Thread(target=ticker, daemon=True)
    tick.start()
    template = PodTemplateSpec(spec=PodSpec(containers=[
        Container(name="t", image="img")]))
    try:
        rt.start(workers=2)
        rt.client.create_job(TPUJob(
            metadata=ObjectMeta(name="rbac-local", namespace="default"),
            spec=TPUJobSpec(replica_specs=[ReplicaSpec(
                replica_type=ReplicaType.LOCAL, template=template)])))
        rt.client.create_job(TPUJob(
            metadata=ObjectMeta(name="rbac-gang", namespace="default"),
            spec=TPUJobSpec(replica_specs=[ReplicaSpec(
                replica_type=ReplicaType.WORKER, template=template,
                tpu=TPUSliceSpec(accelerator_type="v5p-8"))])))
        crashed = False
        deadline = time.monotonic() + 60
        done = set()
        while time.monotonic() < deadline and len(done) < 2:
            pods = [p for p in cluster.pods.list("default")
                    if p.metadata.name.startswith("rbac-gang")
                    and p.status.phase.value == "Running"]
            if pods and not crashed:
                cluster.crash_pod("default", pods[0].metadata.name)
                crashed = True
            done = {n for n in ("rbac-local", "rbac-gang")
                    if (rt.client.get_job("default", n) or None) is not None
                    and rt.client.get_job("default", n).status.phase.value
                    == "Succeeded"}
            time.sleep(0.1)
        rt.client.job_slices(rt.client.get_job("default", "rbac-gang").metadata.uid,
                             "rbac-gang")
        rt.client.delete_job("default", "rbac-local")
    finally:
        stop.set()
        rt.stop()
        server.stop()
        tick.join(timeout=10)
    assert done == {"rbac-local", "rbac-gang"} and crashed
    role = _by_kind(_docs(), "ClusterRole")
    missing = sorted(c for c in calls if not _granted(role["rules"], *c))
    assert not missing, f"ClusterRole misses the port's calls {missing}"
    # The run reached every family of call the adapter makes.
    for need in (("", "pods", "create"), ("", "pods", "watch"),
                 ("", "pods", "delete"), ("", "services", "create"),
                 ("", "events", "create"), ("", "nodes", "list"),
                 ("tpu.kubeflow.dev", "tpujobs", "watch"),
                 ("tpu.kubeflow.dev", "tpujobs/status", "update"),
                 ("tpu.kubeflow.dev", "tpujobs", "delete")):
        assert need in calls, (need, sorted(calls))


def test_port_kube_wire_job_passes_the_crd_schema():
    """The CRD schema check of ``tests/test_crd_schema.py`` over the port's
    ``kube_wire.job_to_k8s`` of a job with every spec field set."""
    from kubeflow_controller_tpu_torch.api.core import (
        Container, ObjectMeta, PodSpec, PodTemplateSpec,
    )
    from kubeflow_controller_tpu_torch.api.types import (
        ChiefSpec, ReplicaSpec, ReplicaType, TerminationPolicySpec, TPUJob,
        TPUJobSpec, TPUSliceSpec,
    )
    from kubeflow_controller_tpu_torch.cluster import kube_wire
    from test_crd_schema import load_schema, validate

    job = TPUJob(
        metadata=ObjectMeta(name="full", namespace="default"),
        spec=TPUJobSpec(
            runtime_id="r1", data_dir="/data", model_dir="/ckpt",
            log_dir="/log", export_dir="/export", suspend=True, priority=7,
            ttl_seconds_after_finished=300,
            replica_specs=[ReplicaSpec(
                replica_type=ReplicaType.WORKER, replicas=2,
                template=PodTemplateSpec(spec=PodSpec(containers=[
                    Container(name="t", image="img")])),
                tpu=TPUSliceSpec(accelerator_type="v5p-32", num_slices=2,
                                 topology="2x4x4", provisioning="spot"),
                termination_policy=TerminationPolicySpec(
                    chief=ChiefSpec(replica_name="Worker", replica_index=0)),
                max_restarts=5)]))
    doc = kube_wire.job_to_k8s(job)
    schema = load_schema()
    errors = []
    validate(doc["spec"], schema["properties"]["spec"], "spec", errors)
    assert not errors, errors
    from kubeflow_controller_tpu_torch.cluster.kube_client import JOB_BASE

    with open(os.path.join(ROOT, "examples", "crd", "tpujob-crd.yml")) as f:
        crd = yaml.safe_load(f)
    assert JOB_BASE == (f"/apis/{crd['spec']['group']}/"
                        f"{crd['spec']['versions'][0]['name']}")
    assert doc["apiVersion"] == JOB_BASE[len("/apis/"):]


# -- the processes -------------------------------------------------------------

def _env(**extra):
    env = {**os.environ, "PYTHONPATH": ROOT, **extra}
    env.pop("KUBECONFIG", None)
    return env


def _stop(p, sig=signal.SIGTERM, timeout=15):
    """Signal a process and collect its output; kill it if it hangs."""
    if p.poll() is None:
        p.send_signal(sig)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        out, _ = p.communicate(timeout=timeout)
    return p.returncode, out


def test_apiserver_and_remote_controller_processes_run_a_job():
    """``apiserver --k8s-wire`` and ``serve --cluster-url URL --k8s-wire``
    as two processes of the port's CLI; a TPUJob created over the wire goes
    to Succeeded; SIGTERM stops both cleanly. Neither process imports
    torch or PyYAML."""
    from kubeflow_controller_tpu_torch.api.core import (
        Container, ObjectMeta, PodSpec, PodTemplateSpec,
    )
    from kubeflow_controller_tpu_torch.api.types import (
        ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec,
    )
    from kubeflow_controller_tpu_torch.cluster.kube_client import (
        KubeClusterClient,
    )

    # Blocks torch and PyYAML, then runs the CLI as ``-m`` would.
    launch = ("import runpy, sys\n"
              "sys.modules['torch'] = None\nsys.modules['yaml'] = None\n"
              "sys.argv = ['tpujobctl'] + sys.argv[1:]\n"
              "runpy.run_module('kubeflow_controller_tpu_torch.cli', "
              "run_name='__main__')\n")
    api = subprocess.Popen(
        [sys.executable, "-c", launch, "apiserver", "--listen", "0",
         "--k8s-wire", "--pool", "v5p-8x1", "--pod-start-delay", "0.2",
         "--pod-run-duration", "0.5"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=_env())
    ctl = None
    try:
        line = api.stdout.readline()
        assert "listening on http://127.0.0.1:" in line, line
        url = line.split("listening on ")[1].strip()
        ctl = subprocess.Popen(
            [sys.executable, "-c", launch, "serve", "--cluster-url", url,
             "--k8s-wire", "--workers", "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=_env())
        assert "reconciling 'default'" in ctl.stdout.readline()
        client = KubeClusterClient(url, namespace="default")
        client.create_job(TPUJob(
            metadata=ObjectMeta(name="procs", namespace="default"),
            spec=TPUJobSpec(replica_specs=[ReplicaSpec(
                replica_type=ReplicaType.LOCAL,
                template=PodTemplateSpec(spec=PodSpec(containers=[
                    Container(name="t", image="img")])))])))
        deadline = time.monotonic() + 60
        phase = None
        while time.monotonic() < deadline and phase != "Succeeded":
            job = client.get_job("default", "procs")
            phase = job.status.phase.value if job else None
            time.sleep(0.1)
        assert phase == "Succeeded"
    finally:
        results = [_stop(p) for p in (ctl, api) if p is not None]
    for rc, out in results:
        assert rc == 0 and "stopped" in out, out


def test_serve_daemon_sigterm_clean_shutdown():
    p = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_controller_tpu_torch.cli", "serve",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=_env())
    try:
        line = p.stdout.readline()
        assert "listening" in line, line
    finally:
        rc, out = _stop(p)
    assert rc == 0 and "stopped" in out, out


_TWO_STRIKE = r"""
import sys, time
sys.modules['torch'] = None
from kubeflow_controller_tpu_torch.util.signals import setup_signal_handler
stop = setup_signal_handler()
try:
    setup_signal_handler()
except RuntimeError:
    print("rejected", flush=True)
print("ready", flush=True)
stop.wait(30)
print("graceful", flush=True)
time.sleep(30)   # the second signal must hard-exit(1) in this window
"""


@pytest.mark.parametrize("first,second", [
    (signal.SIGTERM, signal.SIGTERM), (signal.SIGINT, signal.SIGTERM),
    (signal.SIGINT, signal.SIGINT)], ids=["term_term", "int_term", "int_int"])
def test_two_strike_semantics_in_a_process_without_torch(first, second):
    p = subprocess.Popen([sys.executable, "-c", _TWO_STRIKE],
                         stdout=subprocess.PIPE, text=True, cwd=ROOT, env=_env())
    try:
        assert p.stdout.readline().strip() == "rejected"
        assert p.stdout.readline().strip() == "ready"
        p.send_signal(first)
        assert p.stdout.readline().strip() == "graceful"
        p.send_signal(second)
        assert p.wait(timeout=15) == 1
    finally:
        if p.poll() is None:
            p.kill()
        p.communicate(timeout=15)


_SERVE_LM = r"""
import json, signal, sys, time
from kubeflow_controller_tpu_torch.dataplane.entrypoints import serve_lm
mode = sys.argv[1]
if mode == "owned":
    # The embedding process installed the handler first: main serves
    # without one (stop=None) instead of failing.
    from kubeflow_controller_tpu_torch.util.signals import setup_signal_handler
    setup_signal_handler()

def serve(**kw):
    stop = kw["stop"]
    same = signal.getsignal(signal.SIGINT) is signal.getsignal(signal.SIGTERM)
    print(json.dumps({"stop": stop is not None, "same_handler": same}),
          flush=True)
    if stop is None:
        return {"prompts": 1}
    stop.wait(30)
    print("draining", flush=True)
    time.sleep(30)   # a second signal exits at once with code 1
    return {"prompts": 1}

serve_lm.serve = serve
sys.exit(serve_lm.main(["--config", "tiny", "--device", "cpu"]))
"""


def test_serve_lm_main_drains_on_the_first_signal_and_exits_on_the_second():
    """``serve_lm.main`` installs the two-strike handler on SIGINT and
    SIGTERM (one handler for both) and hands its stop event to ``serve``:
    the first signal (SIGINT) sets it, so the engine drains; the second
    (SIGTERM) exits at once with code 1."""
    p = subprocess.Popen([sys.executable, "-c", _SERVE_LM, "own"],
                         stdout=subprocess.PIPE, text=True, cwd=ROOT, env=_env())
    try:
        info = json.loads(p.stdout.readline())
        assert info == {"stop": True, "same_handler": True}
        p.send_signal(signal.SIGINT)
        assert p.stdout.readline().strip() == "draining"
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) == 1
    finally:
        if p.poll() is None:
            p.kill()
        p.communicate(timeout=30)


def test_serve_lm_main_serves_without_a_handler_when_one_is_installed():
    """The reference's RuntimeError branch: when the embedding process
    already owns signal handling, ``main`` serves with ``stop=None``."""
    owned = subprocess.run([sys.executable, "-c", _SERVE_LM, "owned"],
                           capture_output=True, text=True, cwd=ROOT,
                           env=_env(), timeout=120)
    assert owned.returncode == 0, owned.stderr
    assert json.loads(owned.stdout.splitlines()[0]) == {
        "stop": False, "same_handler": True}


def test_wire_modules_import_no_torch_no_yaml_and_no_jax():
    """The CLI, the runtimes, the wire adapters, the native core's faces
    and the util helpers import with torch, PyYAML, JAX and the JAX package
    blocked; the native core still loads, and ``--cluster-url URL
    --k8s-wire`` and ``in_cluster_context()`` need no YAML."""
    mods = ["kubeflow_controller_tpu_torch.cli",
            "kubeflow_controller_tpu_torch.runtime",
            "kubeflow_controller_tpu_torch.native",
            "kubeflow_controller_tpu_torch.native.queue",
            "kubeflow_controller_tpu_torch.native.objindex",
            "kubeflow_controller_tpu_torch.util.signals",
            "kubeflow_controller_tpu_torch.util.gc_tuning"] + [
        f"kubeflow_controller_tpu_torch.cluster.{m}" for m in (
            "rest_server", "rest_client", "kube_wire", "kubeconfig",
            "kube_client")]
    code = (
        "import sys, importlib\n"
        "for name in ('torch', 'yaml', 'jax', 'jaxlib', 'kubeflow_controller_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "from kubeflow_controller_tpu_torch import native\n"
        "assert native.available(), native.load_error()\n"
        "from kubeflow_controller_tpu_torch.cluster.kubeconfig import in_cluster_context\n"
        "assert in_cluster_context() is None\n"
        "args = importlib.import_module('kubeflow_controller_tpu_torch.cli')"
        ".build_parser().parse_args(['serve', '--cluster-url', 'http://h:1', '--k8s-wire'])\n"
        "assert args.k8s_wire and args.cluster_url == 'http://h:1'\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       m.split('.')[0] in ('torch', 'yaml', 'jax', 'numpy')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = _env()
    env.pop("KUBERNETES_SERVICE_HOST", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
