"""Executed two-process rendezvous of the port: REAL subprocesses take the
env the controller builds (``tpu/naming.py:coordinator_env``), join one
gloo process group through the port's ``initialize_from_env`` and train
MNIST together on the CPU — by hand, and through the controller and the
fake cluster. The port's counterparts of ``test_rendezvous.py`` and
``test_e2e_gang_rendezvous.py``.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

from kubeflow_controller_tpu.api import (
    Container,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicaSpec,
    ReplicaType,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
)
from kubeflow_controller_tpu.api.topology import slice_shape
from kubeflow_controller_tpu.api.types import JobPhase
from kubeflow_controller_tpu.cluster.cluster import PodRunPolicy
from kubeflow_controller_tpu.runtime import LocalRuntime
from kubeflow_controller_tpu.tpu.naming import coordinator_env

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# What each gang process runs: bootstrap from env as a pod would, then
# train MNIST data-parallel over the gang and report.
WORKER = """
import json, sys
import torch
import torch.distributed as dist
from kubeflow_controller_tpu_torch.dataplane.dist import destroy, initialize_from_env
from kubeflow_controller_tpu_torch.dataplane.entrypoints.mnist import train

torch.set_num_threads(1)
ctx = initialize_from_env(device="cpu")
m = train(ctx, total_steps=10, batch_size=16, device="cpu")
print("RESULT " + json.dumps({
    "process_id": ctx.process_id,
    "world_size": dist.get_world_size(),
    "loss": m["loss"],
    "final_step": m["final_step"],
}))
destroy()
sys.exit(0)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gang_env(process_env: dict, port: int) -> dict:
    env = dict(os.environ)
    env.update(process_env)
    # The controller hands out the coordinator Service's cluster DNS name;
    # outside a cluster the same endpoint is on loopback.
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _job(name: str, runtime_id: str = "") -> TPUJob:
    return TPUJob(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=TPUJobSpec(
            runtime_id=runtime_id,
            replica_specs=[ReplicaSpec(
                replica_type=ReplicaType.WORKER,
                template=PodTemplateSpec(spec=PodSpec(containers=[
                    Container(name="trainer", image="torch:latest")
                ])),
                # v5p-8 = 2 host VMs = a 2-process gang.
                tpu=TPUSliceSpec(accelerator_type="v5p-8", num_slices=1),
            )],
        ),
    )


def _result(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert line, out[-2000:]
    return json.loads(line[-1][len("RESULT "):])


def test_two_process_gang_rendezvous_and_training():
    shape = slice_shape("v5p-8")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER],
        env=_gang_env(coordinator_env(_job("mnist-dist", "t2test"), shape,
                                      num_slices=1, slice_id=0, host_id=h), port),
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for h in range(shape.num_hosts)]
    results = {}
    for rank, p in enumerate(procs):
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}\n{err[-4000:]}"
        results[rank] = _result(out)
    assert [results[r]["process_id"] for r in (0, 1)] == [0, 1]
    for r in results.values():
        assert r["world_size"] == 2
        assert r["final_step"] == 10
    # Data parallelism: both ranks report the same global-batch loss.
    assert results[0]["loss"] == pytest.approx(results[1]["loss"], rel=1e-6)


def test_gang_rendezvous_through_controller():
    """A 2-worker TPUJob: the controller gangs 2 pods on the fake cluster,
    each pod's run_fn starts a REAL subprocess with the pod's injected
    env, the two join one process group and train, and the job goes
    Succeeded."""
    port = _free_port()
    rt = LocalRuntime(None)
    cluster = rt.cluster

    def run_fn(pod):
        env = _gang_env(pod.spec.containers[0].env, port)
        p = subprocess.Popen([sys.executable, "-c", WORKER], env=env, cwd=REPO_ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out, err = p.communicate(timeout=240)
        for ln in out.splitlines():
            if ln.startswith("RESULT "):
                cluster.append_pod_log(pod.metadata.name, ln)
        if p.returncode:
            cluster.append_pod_log(pod.metadata.name, err[-1500:])
        return p.returncode

    cluster.default_policy = PodRunPolicy(start_delay=0, run_fn=run_fn)
    cluster.slice_pool.add_pool("v5p-8", 1)
    rt.submit(_job("torch-dist-e2e"))
    assert rt.wait_for_phase("default", "torch-dist-e2e", JobPhase.SUCCEEDED,
                             max_steps=600)
    res = {}
    for lines in cluster.pod_logs.values():
        for _, ln in lines:
            if ln.startswith("RESULT "):
                r = json.loads(ln[len("RESULT "):])
                res[r["process_id"]] = r
    assert set(res) == {0, 1}
    for r in res.values():
        assert r["world_size"] == 2 and r["final_step"] == 10
    assert res[0]["loss"] == pytest.approx(res[1]["loss"], rel=1e-6)
