"""The pure gang planner: job + observed pods/services -> Plan (data only).

Architectural descendant of ``DistributedJob.Action()`` / ``LocalJob.Action()``
(reference ``pkg/tensorflow/distributed.go:56-114``, ``local.go:50-73``) —
side-effect-free decisions consumed by the reconcile loop — with the two
reference properties SURVEY.md §7 says must NOT survive the port fixed:

1. **All-or-nothing creation.** The reference creates pods incrementally
   across syncs (``controller.go:374-425``); here a missing gang is planned as
   one batch of fully-specified pods, and the cluster-side scheduler admits
   the gang atomically.
2. **Stable identity.** The reference regenerates ``RuntimeID`` per sync and
   rebuilds service-name state it may not have (``serviceNames`` bug,
   ``distributed.go:131-159``); here runtime id is stamped once and every name
   is a pure function of (job, runtime id, epoch, index).

Recovery (no reference analog, SURVEY.md §5.3): pod failure or slice
preemption in the current epoch triggers a *gang restart* — delete the whole
epoch's pods, bump the epoch (= ``status.restarts``), re-create the full gang
— provided restart budget remains; otherwise the job is marked Failed (a phase
the reference could never reach, SURVEY.md §8).

Counterpart of ``kubeflow_controller_tpu/tpu/plan.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from kubeflow_controller_tpu_torch.api.core import (
    OwnerReference,
    Pod,
    PodPhase,
    Service,
    ServicePort,
    ServiceSpec,
)
from kubeflow_controller_tpu_torch.api.topology import slice_shape
from kubeflow_controller_tpu_torch.api.types import (
    ReplicaSpec,
    ReplicaType,
    TPUJob,
)
from kubeflow_controller_tpu_torch.api.validation import expected_worker_pods
from kubeflow_controller_tpu_torch.checker import HealthReport, is_local_job
from kubeflow_controller_tpu_torch.cluster.cluster import (
    ANNOTATION_ACCELERATOR,
    ANNOTATION_GANG_SIZE,
    ANNOTATION_HOST_INDEX,
    ANNOTATION_NUM_SLICES,
    ANNOTATION_PRIORITY,
    ANNOTATION_SLICE_INDEX,
    ANNOTATION_SUBMITTED,
)
from kubeflow_controller_tpu_torch.tpu import naming


@dataclass
class Plan:
    """What the reconcile loop should do — pure data, like the reference's
    ``[]Event`` (``pkg/tensorflow/types.go:20-34``) but complete: deletes and
    failure verdicts exist (the reference declared ``ActionShouldDelete`` and
    never emitted it)."""

    create_services: List[Service] = field(default_factory=list)
    create_pods: List[Pod] = field(default_factory=list)
    delete_pods: List[str] = field(default_factory=list)      # names
    delete_services: List[str] = field(default_factory=list)  # names
    # Gang restart initiated: controller bumps status.restarts + Recovering.
    gang_restart: bool = False
    restart_reason: str = ""
    # This restart is a voluntary spec resize: bump status.resizes too so it
    # does not count against the failure budget.
    resize: bool = False
    # Recovery (or terminal failure) triggered by the checker's slice-health
    # signal — pods still Running on an unhealthy slice. The controller
    # emits SliceUnhealthy alongside the restart or failure event.
    health_restart: bool = False
    # Terminal failure verdict (budget exhausted).
    fail_reason: str = ""
    # Job reached a terminal phase: release slices, delete services.
    recycle: bool = False
    # spec.suspend: tear down pods/services, release slices, keep the job.
    suspend: bool = False
    needs_runtime_id: bool = False
    note: str = ""

    def is_noop(self) -> bool:
        return not (
            self.create_services or self.create_pods or self.delete_pods
            or self.delete_services or self.gang_restart or self.fail_reason
            or self.recycle or self.needs_runtime_id
        )


def _owner_ref(job: TPUJob) -> OwnerReference:
    return OwnerReference(
        api_version=job.api_version,
        kind=job.kind,
        name=job.metadata.name,
        uid=job.metadata.uid,
    )


def _epoch_of(pod: Pod) -> int:
    try:
        return int(pod.metadata.labels.get(naming.LABEL_EPOCH, "0"))
    except ValueError:
        return 0


def _index_of(pod: Pod) -> int:
    try:
        return int(pod.metadata.labels.get(naming.LABEL_INDEX, "-1"))
    except ValueError:
        return -1


def _gang_size_of(pod: Pod, default: int) -> int:
    """Guarded like _epoch_of/_index_of: a corrupt annotation must degrade,
    not wedge the job in requeue-backoff forever."""
    try:
        return int(pod.metadata.annotations.get(
            ANNOTATION_GANG_SIZE, str(default)
        ))
    except ValueError:
        return default


def plan_job(
    job: TPUJob,
    pods: List[Pod],
    services: List[Service],
    health: Optional[HealthReport] = None,
) -> Plan:
    """Top-level pure decision: mode dispatch via ``checker.is_local_job``
    (reference ``pkg/checker/checker.go:8-14``), plus the checker's
    slice-health signal (``health``) driving PROACTIVE gang restarts — the
    ``TFJobRecovering`` flow the reference declared but never implemented
    (``types.go:152``)."""
    if not job.spec.runtime_id:
        return Plan(needs_runtime_id=True, note="runtime id not yet stamped")

    if job.is_done():
        return _plan_recycle(job, pods, services)

    if job.spec.suspend:
        # Voluntary pause (k8s Job / training-operator spec.suspend): tear
        # everything down but keep the job object and its checkpoint;
        # unsuspending replans the same epoch's gang from scratch.
        plan = Plan(suspend=True, note="suspended by spec")
        plan.delete_pods = [p.metadata.name for p in pods]
        plan.delete_services = [s.metadata.name for s in services]
        return plan

    if is_local_job(job):
        return _plan_replicas(
            job, job.local_spec(), pods, services, is_local=True
        )
    worker = job.worker_spec()
    if worker is not None:
        return _plan_replicas(
            job, worker, pods, services, is_local=False, health=health
        )
    return Plan(note="no replica specs")


def _plan_recycle(job: TPUJob, pods: List[Pod], services: List[Service]) -> Plan:
    """Terminal job: tear down services + release slices, keep terminal pods
    for log retrieval. (The reference's Recycling condition existed but nothing
    implemented it, ``types.go:153-156``.)"""
    plan = Plan(recycle=True, note="terminal: recycling")
    plan.delete_services = [s.metadata.name for s in services]
    # Non-terminal stragglers (e.g. job marked Failed while a pod still runs).
    plan.delete_pods = [
        p.metadata.name for p in pods
        if p.status.phase not in (PodPhase.SUCCEEDED, PodPhase.FAILED)
    ]
    return plan


def _plan_replicas(
    job: TPUJob,
    spec: ReplicaSpec,
    pods: List[Pod],
    services: List[Service],
    is_local: bool,
    health: Optional[HealthReport] = None,
) -> Plan:
    plan = Plan()
    epoch = job.status.restarts
    expected = 1 if is_local else expected_worker_pods(spec)

    stale = [p for p in pods if _epoch_of(p) != epoch]
    current = [p for p in pods if _epoch_of(p) == epoch]
    plan.delete_pods.extend(p.metadata.name for p in stale)

    failed = [p for p in current if p.status.phase == PodPhase.FAILED]
    # The checker's PROACTIVE signal: current-epoch pods still Pending or
    # Running on a slice that has gone unhealthy. Restarting the gang now —
    # before the kubelet notices and fails the pods — is the whole point of
    # the checker (SURVEY.md §7.5; reference TFJobRecovering, types.go:152).
    # Pod failure takes precedence (strictly more information).
    at_risk: List[Pod] = []
    if not failed and health is not None and health.at_risk_pods:
        risk_names = set(health.at_risk_pods)
        at_risk = [p for p in current if p.metadata.name in risk_names]
    if failed or at_risk:
        if failed:
            preempted = [p for p in failed if p.status.reason == "Preempted"]
            reason = (
                f"slice preempted ({len(preempted)} pods)" if preempted
                else f"{len(failed)} pod(s) failed"
            )
        else:
            reason = (
                f"slice(s) {', '.join(health.unhealthy_slices)} unhealthy "
                f"({len(at_risk)} pods at risk): proactive recovery"
            )
            plan.health_restart = True
        # Budget counts FAILURE restarts only: voluntary resizes advanced
        # the epoch but must not make a later routine recovery terminal.
        # Health restarts are involuntary and consume the same budget (a
        # flapping slice must not restart-loop forever).
        failures = epoch - job.status.resizes
        if failures + 1 <= spec.max_restarts:
            # Gang restart: the whole epoch dies together. Slices are NOT
            # released — allocate_gang is idempotent per job uid, so healthy
            # held slices are reused warm and only the preempted/unhealthy
            # one is replaced (unhealthy holdings don't count as held).
            plan.gang_restart = True
            plan.restart_reason = reason
            plan.delete_pods.extend(p.metadata.name for p in current)
            plan.note = f"gang restart (epoch {epoch} -> {epoch + 1}): {reason}"
        else:
            plan.fail_reason = (
                f"{reason}; restart budget exhausted "
                f"({spec.max_restarts} restarts)"
            )
            plan.note = f"terminal failure: {plan.fail_reason}"
        return plan

    # Spec resize: a gang whose pods were built for a different size or
    # accelerator type cannot be patched incrementally — every pod's
    # injected rendezvous contract (JAX_NUM_PROCESSES, slice/host ids, TPU
    # resources, node selectors) is stale — so resize IS a gang restart.
    # Detected from the annotations the pods were stamped with, or
    # (scale-down) from any pod holding an out-of-range index. Voluntary:
    # does not consume the failure budget (plan.resize).
    accel = "" if is_local else spec.tpu.accelerator_type
    prio = str(job.spec.priority)
    # A priority edit only matters while the gang is still QUEUED (the
    # scheduler reads the annotation at admission time); recreating the
    # pods of a running job for it would be a de-facto self-preemption.
    gang_unscheduled = bool(current) and all(
        p.status.phase == PodPhase.PENDING and not p.spec.assigned_slice
        for p in current
    )
    stale_spec = [
        p for p in current
        if (not is_local and (
            _gang_size_of(p, expected) != expected
            or p.metadata.annotations.get(ANNOTATION_ACCELERATOR, accel)
            != accel
            or (
                gang_unscheduled
                and p.metadata.annotations.get(ANNOTATION_PRIORITY, prio)
                != prio
            )
        )) or _index_of(p) >= expected
    ]
    if stale_spec:
        reason = (
            f"gang resized to {expected} pods on {accel or 'local'} "
            f"({len(stale_spec)} pods built for the old spec)"
        )
        plan.gang_restart = True
        plan.resize = True
        plan.restart_reason = reason
        plan.delete_pods.extend(p.metadata.name for p in current)
        plan.note = f"gang restart (epoch {epoch} -> {epoch + 1}): {reason}"
        return plan

    # Healthy path: level-triggered completion toward the full gang.
    have = {_index_of(p) for p in current}
    missing = [i for i in range(expected) if i not in have]
    if missing:
        if not is_local:
            plan.create_services.extend(_missing_services(job, services))
        shape = None if is_local else slice_shape(spec.tpu.accelerator_type)
        for i in missing:
            plan.create_pods.append(
                _build_pod(job, spec, i, epoch, expected, is_local, shape)
            )
        plan.note = f"creating {len(missing)}/{expected} pods (epoch {epoch})"
    return plan


def _missing_services(job: TPUJob, services: List[Service]) -> List[Service]:
    name = naming.coordinator_service_name(job)
    if any(s.metadata.name == name for s in services):
        return []
    svc = Service()
    svc.metadata.name = name
    svc.metadata.namespace = job.metadata.namespace
    svc.metadata.labels = dict(naming.job_selector(job))
    svc.metadata.owner_references = [_owner_ref(job)]
    svc.spec = ServiceSpec(
        selector={
            **naming.job_selector(job),
            naming.LABEL_REPLICA_TYPE: ReplicaType.WORKER.value.lower(),
            naming.LABEL_INDEX: "0",
        },
        ports=[ServicePort(port=naming.COORDINATOR_PORT, name="jax-coordinator")],
    )
    return [svc]


def _build_pod(
    job: TPUJob,
    spec: ReplicaSpec,
    index: int,
    epoch: int,
    gang_size: int,
    is_local: bool,
    shape,
) -> Pod:
    """Stamp one fully-specified pod from the template. Deep-copies the
    template (the reference mutates it in place — cache-corruption bug,
    ``distributed.go:117-125``)."""
    template = spec.template.deepcopy()
    rtype = ReplicaType.LOCAL if is_local else ReplicaType.WORKER
    pod = Pod(metadata=template.metadata, spec=template.spec)
    pod.metadata.namespace = job.metadata.namespace
    pod.metadata.name = naming.pod_name(job, rtype, index, epoch)
    pod.metadata.labels = {**pod.metadata.labels, **naming.pod_labels(job, rtype, index, epoch)}
    pod.metadata.owner_references = [_owner_ref(job)]

    if is_local:
        env = {
            "TPUJOB_NAME": job.metadata.name,
            "TPUJOB_RUNTIME_ID": job.spec.runtime_id,
            "JAX_NUM_PROCESSES": "1",
            "JAX_PROCESS_ID": "0",
        }
        for var, val in (
            ("TPUJOB_DATA_DIR", job.spec.data_dir),
            ("TPUJOB_MODEL_DIR", job.spec.model_dir),
            ("TPUJOB_LOG_DIR", job.spec.log_dir),
            ("TPUJOB_EXPORT_DIR", job.spec.export_dir),
        ):
            if val:
                env[var] = val
    else:
        slice_id, host_id = divmod(index, shape.num_hosts)
        env = naming.coordinator_env(
            job, shape, spec.tpu.num_slices, slice_id, host_id
        )
        pod.metadata.annotations = {
            **pod.metadata.annotations,
            ANNOTATION_GANG_SIZE: str(gang_size),
            ANNOTATION_ACCELERATOR: shape.accelerator_type,
            ANNOTATION_NUM_SLICES: str(spec.tpu.num_slices),
            ANNOTATION_SLICE_INDEX: str(slice_id),
            ANNOTATION_HOST_INDEX: str(host_id),
            ANNOTATION_PRIORITY: str(job.spec.priority),
            # job-level submission time: the scheduler's FIFO tie-break
            # must survive pod recreation (suspend/resume, restarts)
            ANNOTATION_SUBMITTED: str(
                job.status.submit_time
                or job.metadata.creation_timestamp or 0.0
            ),
        }
        # Gang id = job uid: the slice pool allocates per holder uid, making
        # re-admission after partial observation idempotent.
        pod.spec.scheduling_group = job.metadata.uid
        # TPU resources + topology selectors — the GKE TPU contract
        # (north star: google.com/tpu instead of nvidia.com/gpu).
        main = pod.spec.main_container()
        main.resources = {
            **main.resources,
            "google.com/tpu": shape.chips_per_host,
        }
        # Real GKE label values: the accelerator label names the TPU
        # generation (e.g. tpu-v5-lite-podslice); the chip count rides the
        # topology label. Emitting catalog names here would produce pods no
        # real GKE node could ever satisfy.
        from kubeflow_controller_tpu_torch.api.topology import gke_accelerator

        pod.spec.node_selector = {
            **pod.spec.node_selector,
            "cloud.google.com/gke-tpu-accelerator": gke_accelerator(shape),
            "cloud.google.com/gke-tpu-topology": shape.topology_str,
        }
    main = pod.spec.main_container()
    main.env = {**main.env, **env}
    return pod
