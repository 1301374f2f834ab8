"""Naming, labels, and the runtime contract injected into training processes.

Descendant of the reference's identity labels
(``pkg/tensorflow/distributed.go:221-228``: ``kubeflow.caicloud.io``,
``job_type``, ``runtime_id``, ``tf_job_name`` + ``index``) and of
``generateTFClusterSpec`` (``distributed.go:127-159``), which rewrote each
worker's CLI args to ``--worker_hosts=...,--ps_hosts=...,--job_name,
--task_index``. On TPU the contract collapses to *env*, because XLA
collectives need only a coordinator rendezvous, not full host lists:

    JAX_COORDINATOR_ADDRESS   worker-0's stable service DNS + port
    JAX_NUM_PROCESSES         gang size (hosts x slices)
    JAX_PROCESS_ID            global process index
    TPU_SLICE_ID / TPU_HOST_ID  position within the job's slice set
    MEGASCALE_*               multi-slice (DCN) coordination, config #5

plus the job spec's data/model/log/export dirs — declared-but-unread in the
reference (``types.go:41-55``), consumed for real here (orbax checkpoint root
etc.).

Counterpart of ``kubeflow_controller_tpu/tpu/naming.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict

from kubeflow_controller_tpu_torch.api.topology import SliceShape
from kubeflow_controller_tpu_torch.api.types import LMService, ReplicaType, TPUJob

PREFIX = "tpu.kubeflow.dev"
LABEL_JOB = f"{PREFIX}/job"
LABEL_LMSERVICE = f"{PREFIX}/lmservice"
LABEL_RUNTIME_ID = f"{PREFIX}/runtime-id"
LABEL_REPLICA_TYPE = f"{PREFIX}/replica-type"
LABEL_INDEX = f"{PREFIX}/index"
LABEL_EPOCH = f"{PREFIX}/epoch"
#: serving-replica role for prefill/decode disaggregation
#: ("prefill" / "decode" / "mixed" — docs/lmservice.md).
LABEL_ROLE = f"{PREFIX}/role"

COORDINATOR_PORT = 8476  # jax.distributed default coordinator port


def job_selector(job: TPUJob) -> Dict[str, str]:
    """The ownership selector — pods/services carrying these labels belong to
    this job's current runtime (claiming also checks ownerReferences)."""
    return {
        LABEL_JOB: job.metadata.name,
        LABEL_RUNTIME_ID: job.spec.runtime_id,
    }


def pod_labels(
    job: TPUJob, replica_type: ReplicaType, index: int, epoch: int
) -> Dict[str, str]:
    return {
        LABEL_JOB: job.metadata.name,
        LABEL_RUNTIME_ID: job.spec.runtime_id,
        LABEL_REPLICA_TYPE: replica_type.value.lower(),
        LABEL_INDEX: str(index),
        LABEL_EPOCH: str(epoch),
    }


def pod_name(job: TPUJob, replica_type: ReplicaType, index: int, epoch: int) -> str:
    # Deterministic names (job-runtime-role-epoch-index) rather than the
    # reference's GenerateName randomness — idempotent creates become
    # AlreadyExists no-ops, which is the stronger duplicate guard.
    return (
        f"{job.metadata.name}-{job.spec.runtime_id}-"
        f"{replica_type.value.lower()}-e{epoch}-{index}"
    )


def lmservice_selector(svc: LMService) -> Dict[str, str]:
    """Ownership selector for an LMService's replica pods (claiming also
    checks ownerReferences, same as job pods)."""
    return {
        LABEL_LMSERVICE: svc.metadata.name,
        LABEL_RUNTIME_ID: svc.spec.runtime_id,
    }


def lmservice_pod_role(svc: LMService, index: int) -> str:
    """The serving role replica ``index`` plays. With
    ``spec.prefill_replicas == 0`` (the default) every replica is
    "mixed" — byte-identical labels to before the field existed. With
    P > 0, the first P indices are "prefill" and the rest "decode"
    (index-stable names make the split stable across pod churn)."""
    p = getattr(svc.spec, "prefill_replicas", 0)
    if not p:
        return "mixed"
    return "prefill" if index < p else "decode"


def lmservice_pod_labels(svc: LMService, index: int) -> Dict[str, str]:
    return {
        LABEL_LMSERVICE: svc.metadata.name,
        LABEL_RUNTIME_ID: svc.spec.runtime_id,
        LABEL_REPLICA_TYPE: "serving",
        LABEL_INDEX: str(index),
        LABEL_ROLE: lmservice_pod_role(svc, index),
    }


def lmservice_pod_name(svc: LMService, index: int) -> str:
    # Deterministic, index-stable names: a crashed replica is replaced by a
    # same-named pod (new uid), so the router's replica identity survives
    # chaos kills and rolling restarts.
    return f"{svc.metadata.name}-{svc.spec.runtime_id}-serve-{index}"


def coordinator_service_name(job: TPUJob) -> str:
    return f"{job.metadata.name}-{job.spec.runtime_id}-coord"


def coordinator_address(job: TPUJob, namespace: str) -> str:
    return f"{coordinator_service_name(job)}.{namespace}.svc:{COORDINATOR_PORT}"


def coordinator_env(
    job: TPUJob,
    shape: SliceShape,
    num_slices: int,
    slice_id: int,
    host_id: int,
) -> Dict[str, str]:
    """Env for one worker process = (slice_id, host_id) in the gang."""
    num_processes = shape.num_hosts * num_slices
    process_id = slice_id * shape.num_hosts + host_id
    env = {
        "TPUJOB_NAME": job.metadata.name,
        "TPUJOB_RUNTIME_ID": job.spec.runtime_id,
        "JAX_COORDINATOR_ADDRESS": coordinator_address(job, job.metadata.namespace),
        "JAX_NUM_PROCESSES": str(num_processes),
        "JAX_PROCESS_ID": str(process_id),
        "TPU_SLICE_ID": str(slice_id),
        "TPU_HOST_ID": str(host_id),
        "TPU_ACCELERATOR_TYPE": shape.accelerator_type,
        "TPU_TOPOLOGY": shape.topology_str,
        "TPU_HOSTS_PER_SLICE": str(shape.num_hosts),
        "TPU_CHIPS_PER_HOST": str(shape.chips_per_host),
    }
    if num_slices > 1:
        # Multi-slice (DCN) coordination, the reference-free territory of
        # BASELINE config #5 (SURVEY.md §7 hard part 4).
        env.update({
            "MEGASCALE_COORDINATOR_ADDRESS": coordinator_address(
                job, job.metadata.namespace),
            "MEGASCALE_NUM_SLICES": str(num_slices),
            "MEGASCALE_SLICE_ID": str(slice_id),
        })
    for var, val in (
        ("TPUJOB_DATA_DIR", job.spec.data_dir),
        ("TPUJOB_MODEL_DIR", job.spec.model_dir),
        ("TPUJOB_LOG_DIR", job.spec.log_dir),
        ("TPUJOB_EXPORT_DIR", job.spec.export_dir),
    ):
        if val:
            env[var] = val
    return env
