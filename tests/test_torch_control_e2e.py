"""The port's data plane launched by the port's controller, on the CPU.

(i) A ``Local`` TPUJob whose pod's ``run_fn`` runs the port's
``lm.train`` in process, from the env the controller injected, reaches
``Succeeded`` with its checkpoint in ``TPUJOB_MODEL_DIR``.

(ii) A ``v5p-8`` gang (two hosts, so two pods): each pod's ``run_fn``
starts one subprocess with the pod's env; the two join one gloo group
from it, train the tiny decoder at fsdp=2, and epoch 0 exits 137 after a
checkpoint; the controller gang-restarts the pods and epoch 1's two ranks
both resume from that checkpoint. The counterpart of
``tests/test_e2e_gang_rendezvous.py``.

No wall-clock bound: each pod's ``run_fn_join`` covers its whole
``run_fn``, so a tick of the fake kubelet waits for the workload and the
simulated clock needs only a few steps (``run_until`` is given far more).
The Local job's workload waits on an event until the test has seen the
job Running (its first ticks do not wait on it).
"""

import json
import os
import socket
import subprocess
import sys
import threading

import torch

from kubeflow_controller_tpu_torch.api import (
    Container, ObjectMeta, PodSpec, PodTemplateSpec, ReplicaSpec, ReplicaType,
    TPUJob, TPUJobSpec, TPUSliceSpec,
)
from kubeflow_controller_tpu_torch.api.types import JobPhase
from kubeflow_controller_tpu_torch.cluster.cluster import PodRunPolicy
from kubeflow_controller_tpu_torch.dataplane.dist import ProcessContext
from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm
from kubeflow_controller_tpu_torch.runtime import LocalRuntime
from kubeflow_controller_tpu_torch.tpu import naming

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Far above what either run needs: the kubelet waits on the workload.
RUN_FN_JOIN_S = 600.0
STEP_BOUND = 200


def _template():
    return PodTemplateSpec(spec=PodSpec(containers=[
        Container(name="trainer", image="trainer:latest")]))


def test_local_job_trains_to_succeeded_with_checkpoint(tmp_path):
    mdir = str(tmp_path / "ckpt")
    seen = {}
    go = threading.Event()

    def run_fn(pod):
        env = pod.spec.containers[0].env
        seen["env"] = dict(env)
        go.wait()           # until the test has seen the job Running
        m = lm.train(ProcessContext.from_env(env), config="tiny",
                     total_steps=3, per_data_shard_batch=2, seq_len=32,
                     device="cpu")
        seen["metrics"] = m
        return 0 if m["final_step"] == 3 else 1

    # The first ticks do not wait on the workload, so the controller sees
    # the pod Running; then each tick waits for it to end.
    policy = PodRunPolicy(start_delay=0, run_fn=run_fn, run_fn_join=0.0)
    rt = LocalRuntime(policy)
    rt.submit(TPUJob(
        metadata=ObjectMeta(name="lm-local", namespace="default"),
        spec=TPUJobSpec(model_dir=mdir, replica_specs=[ReplicaSpec(
            replica_type=ReplicaType.LOCAL, template=_template())])))
    job = lambda: rt.get_job("default", "lm-local")  # noqa: E731
    try:
        rt.controller.drain()
        assert job().status.phase == JobPhase.PENDING
        assert rt.wait_for_phase("default", "lm-local", JobPhase.RUNNING,
                                 max_steps=5)
        policy.run_fn_join = RUN_FN_JOIN_S
        go.set()
        assert rt.run_until(lambda: job().is_done(), max_steps=STEP_BOUND)
    finally:
        go.set()
        rt.stop()
    assert job().status.phase == JobPhase.SUCCEEDED, job().status
    assert seen["env"]["TPUJOB_MODEL_DIR"] == mdir
    assert seen["env"]["JAX_NUM_PROCESSES"] == "1"
    assert seen["metrics"]["start_step"] == 0
    assert os.path.exists(os.path.join(mdir, "3", "index.pt"))


# What each gang pod's subprocess runs: join the group from the pod's env,
# report the step it resumed from, train, exit with the scripted code.
WORKER = """
import json, os, sys
import torch
torch.set_num_threads(1)
from kubeflow_controller_tpu_torch.dataplane.dist import (
    destroy, initialize_from_env)
from kubeflow_controller_tpu_torch.dataplane.entrypoints import lm
from kubeflow_controller_tpu_torch.parallel.mesh import MeshConfig

ctx = initialize_from_env(device="cpu")
m = lm.train(ctx, config="tiny", total_steps=int(os.environ["E2E_TOTAL_STEPS"]),
             per_data_shard_batch=1, seq_len=32,
             mesh_config=MeshConfig(fsdp=2), checkpoint_every=2,
             device="cpu")
print("RESULT " + json.dumps({
    "epoch": int(os.environ["E2E_EPOCH"]),
    "process_id": ctx.process_id,
    "world": torch.distributed.get_world_size(),
    "num_processes": os.environ["JAX_NUM_PROCESSES"],
    "resumed_from": m["start_step"],
    "final_step": m["final_step"],
    "loss": m["loss"],
}), flush=True)
destroy()
sys.exit(int(os.environ.get("E2E_EXIT_CODE", "0")))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_gang_rendezvous_restart_and_resume(tmp_path):
    mdir = str(tmp_path / "ckpt")
    ports = {"0": _free_port(), "1": _free_port()}
    results, errors = {}, []

    def run_fn(pod):
        env = dict(os.environ)
        env.update(pod.spec.containers[0].env)
        epoch = pod.metadata.labels[naming.LABEL_EPOCH]
        # No cluster DNS: the coordinator service's address becomes
        # loopback; everything else is the env the controller built.
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{ports[epoch]}"
        env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env["E2E_EPOCH"] = epoch
        env["E2E_TOTAL_STEPS"] = "2" if epoch == "0" else "4"
        env["E2E_EXIT_CODE"] = "137" if epoch == "0" else "0"
        p = subprocess.run([sys.executable, "-c", WORKER], env=env,
                           cwd=REPO_ROOT, capture_output=True, text=True,
                           timeout=RUN_FN_JOIN_S)
        for ln in p.stdout.splitlines():
            if ln.startswith("RESULT "):
                r = json.loads(ln[len("RESULT "):])
                results[(r["epoch"], r["process_id"])] = r
        if p.returncode not in (0, 137):
            errors.append(p.stderr[-2000:])
        return p.returncode

    rt = LocalRuntime(None)
    rt.cluster.default_policy = PodRunPolicy(
        start_delay=0, run_fn=run_fn, run_fn_join=RUN_FN_JOIN_S)
    rt.cluster.slice_pool.add_pool("v5p-8", 1)
    rt.submit(TPUJob(
        metadata=ObjectMeta(name="gang", namespace="default"),
        spec=TPUJobSpec(model_dir=mdir, replica_specs=[ReplicaSpec(
            replica_type=ReplicaType.WORKER, template=_template(),
            tpu=TPUSliceSpec(accelerator_type="v5p-8", num_slices=1))])))
    assert rt.run_until(
        lambda: (j := rt.get_job("default", "gang")) is not None
        and j.is_done(), max_steps=STEP_BOUND), errors
    rt.stop()
    job = rt.get_job("default", "gang")
    assert job.status.phase == JobPhase.SUCCEEDED, (job.status, errors)
    assert job.status.restarts == 1
    assert set(results) == {(0, 0), (0, 1), (1, 0), (1, 1)}, errors
    for (epoch, rank), r in results.items():
        assert r["world"] == 2 and r["num_processes"] == "2"
        assert r["resumed_from"] == (0 if epoch == 0 else 2)
        assert r["final_step"] == (2 if epoch == 0 else 4)
    for epoch in (0, 1):
        assert results[(epoch, 0)]["loss"] == results[(epoch, 1)]["loss"]
