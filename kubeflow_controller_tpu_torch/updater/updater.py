"""Status updater: observed pods -> job status. Pure (mutates only the passed
deep copy; the caller persists conflict-safely).

Descendant of ``pkg/controller/updater`` (reference ``distributed.go:41-66``,
``local.go:50-78``, ``util.go:25-58``) with the declared-but-dead surface made
real (SURVEY.md §8):

- ``Failed`` is reachable (failure verdict from the planner);
- conditions are populated (GangScheduled/Ready/Recovering/Recycling);
- chief termination policy is honored (reference declared it at
  ``types.go:81-89``, never read it);
- submit->all-running latency is stamped (north-star metric #2).

Counterpart of ``kubeflow_controller_tpu/updater/updater.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from kubeflow_controller_tpu_torch.api.core import Pod, PodPhase
from kubeflow_controller_tpu_torch.api.types import (
    ConditionStatus,
    ConditionType,
    JobPhase,
    ReplicaSpec,
    ReplicaState,
    ReplicaStatus,
    ReplicaType,
    TPUJob,
)
from kubeflow_controller_tpu_torch.api.validation import expected_worker_pods
from kubeflow_controller_tpu_torch.tpu import naming

_POD_TO_REPLICA_STATE: Dict[PodPhase, ReplicaState] = {
    PodPhase.PENDING: ReplicaState.WAITING,
    PodPhase.RUNNING: ReplicaState.RUNNING,
    PodPhase.SUCCEEDED: ReplicaState.SUCCEEDED,
    PodPhase.FAILED: ReplicaState.FAILED,
    PodPhase.UNKNOWN: ReplicaState.UNKNOWN,
}


def _epoch_of(pod: Pod) -> int:
    try:
        return int(pod.metadata.labels.get(naming.LABEL_EPOCH, "0"))
    except ValueError:
        return 0


def _chief_index(spec: ReplicaSpec) -> Optional[int]:
    tp = spec.termination_policy
    if tp is not None and tp.chief is not None:
        return tp.chief.replica_index
    return None


def compute_status(
    job: TPUJob,
    pods: Sequence[Pod],
    now: float,
    fail_reason: str = "",
    recovering: bool = False,
    suspended: bool = False,
) -> bool:
    """Recompute ``job.status`` in place from current-epoch pods.

    Returns True when anything changed (the reference's ``ShouldUpdate``
    contract). ``fail_reason``/``recovering`` carry the planner's verdicts.
    """
    st = job.status
    before = (
        st.phase, st.reason,
        tuple((c.type, c.status, c.reason, c.message) for c in st.conditions),
        tuple(
            (r.type, r.state, tuple(sorted(r.states.items())))
            for r in st.replica_statuses
        ),
        st.all_running_time, st.completion_time, st.submit_time,
        st.observed_generation,
    )

    # observedGeneration: status has now been computed against this spec
    # (training-operator JobStatus.ObservedGeneration). The no-op sync
    # short-circuit only trusts fingerprints once this catches up.
    st.observed_generation = job.metadata.generation

    if not st.submit_time:
        st.submit_time = job.metadata.creation_timestamp or now

    spec = job.local_spec() or job.worker_spec()
    rtype = spec.replica_type if spec else ReplicaType.WORKER
    expected = (
        1 if spec is None or spec.replica_type == ReplicaType.LOCAL
        else expected_worker_pods(spec)
    )
    epoch = st.restarts
    current = [p for p in pods if _epoch_of(p) == epoch]

    # Replica state histogram (reference updateTFReplicaStatuses,
    # updater/util.go:25-58).
    hist: Dict[ReplicaState, int] = {}
    for p in current:
        state = _POD_TO_REPLICA_STATE[p.status.phase]
        hist[state] = hist.get(state, 0) + 1
    n_running = hist.get(ReplicaState.RUNNING, 0)
    n_succeeded = hist.get(ReplicaState.SUCCEEDED, 0)
    n_failed = hist.get(ReplicaState.FAILED, 0)

    overall = ReplicaState.UNKNOWN
    if n_failed:
        overall = ReplicaState.FAILED
    elif n_succeeded == expected:
        overall = ReplicaState.SUCCEEDED
    elif n_running:
        overall = ReplicaState.RUNNING
    elif current:
        overall = ReplicaState.WAITING
    st.replica_statuses = [ReplicaStatus(type=rtype, state=overall, states=hist)]

    # Success: chief policy if declared, else all replicas succeeded
    # (reference: succeeded workers == expected, updater/distributed.go:41-66).
    chief = _chief_index(spec) if spec else None
    if chief is not None:
        succeeded = any(
            p.status.phase == PodPhase.SUCCEEDED
            and p.metadata.labels.get(naming.LABEL_INDEX) == str(chief)
            for p in current
        )
    else:
        succeeded = expected > 0 and n_succeeded == expected

    gang_scheduled = bool(current) and len(current) == expected and all(
        p.spec.assigned_slice or p.status.phase != PodPhase.PENDING
        or rtype == ReplicaType.LOCAL
        for p in current
    )
    all_running = len(current) == expected and n_running == expected

    # Phase state machine. Terminal phases are sticky.
    if st.phase not in (JobPhase.SUCCEEDED, JobPhase.FAILED):
        if fail_reason:
            st.phase = JobPhase.FAILED
            st.reason = fail_reason
            st.completion_time = now
        elif succeeded:
            st.phase = JobPhase.SUCCEEDED
            st.reason = ""
            st.completion_time = now
            st.set_condition(
                ConditionType.RECYCLING, ConditionStatus.TRUE,
                "JobSucceeded", "releasing slices and services", now=now)
        elif suspended:
            st.phase = JobPhase.SUSPENDED
            st.set_condition(
                ConditionType.SUSPENDED, ConditionStatus.TRUE,
                "SpecSuspended", "pods torn down, slices released", now=now)
        elif recovering:
            st.phase = JobPhase.RECOVERING
            st.set_condition(
                ConditionType.RECOVERING, ConditionStatus.TRUE,
                "GangRestart", "re-ganging after failure/preemption", now=now)
        elif all_running:
            st.phase = JobPhase.RUNNING
            if not st.all_running_time:
                st.all_running_time = now
            st.set_condition(
                ConditionType.RECOVERING, ConditionStatus.FALSE, "Healthy", now=now)
        else:
            # Recovering is sticky until the new gang is fully running.
            rec = st.get_condition(ConditionType.RECOVERING)
            if rec is not None and rec.status == ConditionStatus.TRUE:
                st.phase = JobPhase.RECOVERING
            else:
                st.phase = JobPhase.PENDING
        if not suspended:
            sus = st.get_condition(ConditionType.SUSPENDED)
            if sus is not None and sus.status == ConditionStatus.TRUE:
                st.set_condition(
                    ConditionType.SUSPENDED, ConditionStatus.FALSE,
                    "Resumed", now=now)

    if st.phase in (JobPhase.PENDING, JobPhase.RUNNING, JobPhase.RECOVERING,
                    JobPhase.SUSPENDED):
        st.set_condition(
            ConditionType.GANG_SCHEDULED,
            ConditionStatus.TRUE if gang_scheduled else ConditionStatus.FALSE,
            "AllPodsBound" if gang_scheduled else "WaitingForGang", now=now)
        st.set_condition(
            ConditionType.READY,
            ConditionStatus.TRUE if all_running else ConditionStatus.FALSE,
            "AllReplicasRunning" if all_running else "NotAllRunning", now=now)

    after = (
        st.phase, st.reason,
        tuple((c.type, c.status, c.reason, c.message) for c in st.conditions),
        tuple(
            (r.type, r.state, tuple(sorted(r.states.items())))
            for r in st.replica_statuses
        ),
        st.all_running_time, st.completion_time, st.submit_time,
        st.observed_generation,
    )
    return before != after
