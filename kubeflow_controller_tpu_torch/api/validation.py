"""Admission-time validation of TPUJob specs.

The reference has no admission validation at all — ``Action()`` indexes arrays
with -1 and dereferences nil ``Replicas`` on malformed specs
(``pkg/tensorflow/distributed.go:60,65,198-206``; SURVEY.md §8). Validation
here rejects those shapes up front so the reconcile core only ever sees
well-formed jobs.

Counterpart of ``kubeflow_controller_tpu/api/validation.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import List

from kubeflow_controller_tpu_torch.api import types
from kubeflow_controller_tpu_torch.api.topology import TPU_SLICE_CATALOG


class ValidationError(ValueError):
    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


def validate_job(job: types.TPUJob) -> None:
    """Raise ValidationError listing every problem (not just the first)."""
    errs: List[str] = []

    if not job.metadata.name and not job.metadata.generate_name:
        errs.append("metadata.name is required")
    if not job.metadata.namespace:
        errs.append("metadata.namespace is required")

    ttl = job.spec.ttl_seconds_after_finished
    if ttl is not None and ttl < 0:
        errs.append("spec.ttlSecondsAfterFinished must be >= 0")
    if type(job.spec.priority) is not int:
        errs.append("spec.priority must be an integer")

    specs = job.spec.replica_specs
    if not specs:
        errs.append("spec.replicaSpecs must not be empty")

    n_local = sum(1 for s in specs if s.replica_type == types.ReplicaType.LOCAL)
    n_worker = sum(1 for s in specs if s.replica_type == types.ReplicaType.WORKER)
    if n_local and n_worker:
        errs.append("a job may not mix Local and Worker replica specs")
    if n_local > 1 or n_worker > 1:
        errs.append("at most one replica spec per replica type")

    for i, rs in enumerate(specs):
        where = f"spec.replicaSpecs[{i}]"
        if rs.template is None or not rs.template.spec.containers:
            errs.append(f"{where}.template with >=1 container is required")
        if rs.replica_type == types.ReplicaType.LOCAL:
            if rs.replicas not in (None, 1):
                errs.append(f"{where}.replicas must be 1 for Local jobs")
        else:
            tpu = rs.tpu
            if tpu.accelerator_type not in TPU_SLICE_CATALOG:
                errs.append(
                    f"{where}.tpu.acceleratorType {tpu.accelerator_type!r} "
                    f"is not a known slice shape"
                )
            if tpu.num_slices < 1:
                errs.append(f"{where}.tpu.numSlices must be >= 1")
            if tpu.provisioning not in ("on-demand", "spot", "reserved"):
                errs.append(
                    f"{where}.tpu.provisioning must be on-demand|spot|reserved"
                )
            if tpu.topology:
                shape = TPU_SLICE_CATALOG.get(tpu.accelerator_type)
                if shape is not None and tpu.topology != shape.topology_str:
                    errs.append(
                        f"{where}.tpu.topology {tpu.topology!r} does not match "
                        f"{tpu.accelerator_type} ({shape.topology_str})"
                    )
        if rs.max_restarts < 0:
            errs.append(f"{where}.maxRestarts must be >= 0")
        tp = rs.termination_policy
        if tp is not None and tp.chief is not None:
            if tp.chief.replica_index < 0:
                errs.append(f"{where}.terminationPolicy.chief.replicaIndex must be >= 0")

    if errs:
        raise ValidationError(errs)


def validate_lmservice(svc: types.LMService) -> None:
    """Raise ValidationError listing every problem (not just the first).

    Same collect-all contract as validate_job: the LMService reconcile core
    only ever sees well-formed services. Model-name resolution is left to the
    data plane (the control plane must not import torch to validate a spec)."""
    errs: List[str] = []

    if not svc.metadata.name and not svc.metadata.generate_name:
        errs.append("metadata.name is required")
    if not svc.metadata.namespace:
        errs.append("metadata.namespace is required")

    if not svc.spec.model:
        errs.append("spec.model is required")
    if type(svc.spec.replicas) is not int or svc.spec.replicas < 1:
        errs.append("spec.replicas must be an integer >= 1")
    if type(svc.spec.max_queue) is not int or svc.spec.max_queue < 1:
        errs.append("spec.maxQueue must be an integer >= 1")
    if (type(svc.spec.prefill_replicas) is not int
            or svc.spec.prefill_replicas < 0):
        errs.append("spec.prefillReplicas must be an integer >= 0")
    elif (type(svc.spec.replicas) is int
            and svc.spec.prefill_replicas >= max(svc.spec.replicas, 1)
            and svc.spec.prefill_replicas > 0):
        errs.append("spec.prefillReplicas must be < spec.replicas "
                    "(some replica has to decode)")
    if svc.spec.slo.ttft_p99_ms < 0:
        errs.append("spec.slo.ttftP99Ms must be >= 0")
    if svc.spec.slo.deadline_s < 0:
        errs.append("spec.slo.deadlineS must be >= 0")

    if errs:
        raise ValidationError(errs)


def expected_worker_pods(rs: types.ReplicaSpec) -> int:
    """Number of pods (=host processes) a Worker replica spec implies.

    Derived from slice geometry — the TPU analog of the reference reading
    ``*spec.Replicas`` (``distributed.go:60``): one pod per TPU host VM per
    slice, times the number of slices.
    """
    shape = TPU_SLICE_CATALOG[rs.tpu.accelerator_type]
    return shape.num_hosts * rs.tpu.num_slices
