"""TPUJob API types — the declarative job contract.

Descendant of the reference's TFJob CRD schema
(``vendor/github.com/caicloud/kubeflow-clientset/apis/kubeflow/v1alpha1/types.go:30-174``)
with the PS role deleted (XLA collectives over ICI absorb the parameter-server
function, SURVEY.md §2.5-2.6) and TPU slice geometry added. Unlike the
reference, the declared-but-inert surface is real here:

- ``Failed`` phase is reachable (reference never sets it, SURVEY.md §8).
- Conditions are populated (reference TODO at ``updater/distributed.go:49-50``).
- ``TerminationPolicy``/chief semantics are enforced (reference declares them
  at ``types.go:81-89`` and never reads them).
- ``data_dir``/``model_dir``/``log_dir``/``export_dir`` are consumed by the
  data plane (env injection + orbax checkpoint root).

Counterpart of ``kubeflow_controller_tpu/api/types.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubeflow_controller_tpu_torch.api.core import (
    ObjectMeta, PodTemplateSpec, Sealable, _FrozenDict, _FrozenList,
    _note_deepcopy,
)

API_GROUP = "tpu.kubeflow.dev"
API_VERSION = "v1alpha1"
KIND = "TPUJob"

# How many of the most recent conditions a status retains
# (reference comment "keeps ten most recent", types.go:97).
MAX_CONDITIONS = 10


class ReplicaType(str, enum.Enum):
    """Replica roles. The reference's PS role (``types.go:72-79``) is gone:
    there is no parameter-server protocol on TPU — gradients all-reduce over
    ICI inside the compiled program."""

    WORKER = "Worker"
    LOCAL = "Local"


class JobPhase(str, enum.Enum):
    # Mirrors reference TFJobPhase (types.go:106-133) plus Recovering:
    # slice preemption puts a job into Recovering until it re-gangs and
    # resumes from checkpoint (SURVEY.md §7.5).
    NONE = ""
    UNKNOWN = "Unknown"
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    RECOVERING = "Recovering"
    # Voluntarily paused via spec.suspend (Kueue-style): pods deleted,
    # slices released, checkpoint kept; unsuspending re-gangs and resumes.
    SUSPENDED = "Suspended"


class ConditionType(str, enum.Enum):
    # Reference condition types (types.go:149-156) plus GangScheduled:
    # the all-or-nothing admission event unique to slice scheduling.
    SCHEDULED = "Scheduled"
    GANG_SCHEDULED = "GangScheduled"
    READY = "Ready"
    RECOVERING = "Recovering"
    # Voluntarily paused via spec.suspend (Kueue-style): pods deleted,
    # slices released, checkpoint kept; unsuspending re-gangs and resumes.
    SUSPENDED = "Suspended"
    RECYCLING = "Recycling"


class ConditionStatus(str, enum.Enum):
    TRUE = "True"
    FALSE = "False"
    UNKNOWN = "Unknown"


class ReplicaState(str, enum.Enum):
    # Mirrors reference TFReplicaState (types.go:167-174).
    UNKNOWN = "Unknown"
    WAITING = "Waiting"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class TPUSliceSpec(Sealable):
    """TPU geometry for a worker replica group — the new surface that replaces
    the reference's free-form replica counts with physical slice shapes."""

    # Accelerator type names the pod-slice, e.g. "v5e-16" (16 chips, 4 hosts).
    accelerator_type: str = "v5e-8"
    # Number of identical slices ganged into one job (multi-slice over DCN).
    num_slices: int = 1
    # Optional explicit topology override, e.g. "4x4"; normally derived
    # from the catalog (api/topology.py).
    topology: str = ""
    # Reserved / spot / on-demand; spot slices are preemptible and drive the
    # checker's preemption-recovery path.
    provisioning: str = "on-demand"

    def deepcopy(self) -> "TPUSliceSpec":
        return TPUSliceSpec(
            self.accelerator_type, self.num_slices,
            self.topology, self.provisioning,
        )

    def __deepcopy__(self, memo) -> "TPUSliceSpec":
        return self.deepcopy()

    # freeze() mirrors deepcopy() field-for-field across this module
    # (coverage guarded by tests/test_deepcopy.py + tests/test_cow_store.py):
    # idempotent, stops at already-sealed children, wraps containers.
    def freeze(self) -> "TPUSliceSpec":
        if not self._sealed:
            self._seal()
        return self


@dataclass
class ChiefSpec(Sealable):
    # Reference ChiefSpec (types.go:86-89): which replica's exit decides
    # job completion.
    replica_name: str = "Worker"
    replica_index: int = 0

    def deepcopy(self) -> "ChiefSpec":
        return ChiefSpec(self.replica_name, self.replica_index)

    def __deepcopy__(self, memo) -> "ChiefSpec":
        return self.deepcopy()

    def freeze(self) -> "ChiefSpec":
        if not self._sealed:
            self._seal()
        return self


@dataclass
class TerminationPolicySpec(Sealable):
    chief: Optional[ChiefSpec] = None

    def deepcopy(self) -> "TerminationPolicySpec":
        return TerminationPolicySpec(
            self.chief.deepcopy() if self.chief else None
        )

    def __deepcopy__(self, memo) -> "TerminationPolicySpec":
        return self.deepcopy()

    def freeze(self) -> "TerminationPolicySpec":
        if self._sealed:
            return self
        if self.chief is not None:
            self.chief.freeze()
        self._seal()
        return self


@dataclass
class ReplicaSpec(Sealable):
    """One replica group. For WORKER the effective pod count is derived from
    slice geometry (hosts-per-slice x num_slices), not from ``replicas`` —
    TPU hosts are not free-form. For LOCAL, ``replicas`` must be 1."""

    replica_type: ReplicaType = ReplicaType.WORKER
    replicas: Optional[int] = None
    template: Optional[PodTemplateSpec] = None
    tpu: TPUSliceSpec = field(default_factory=TPUSliceSpec)
    termination_policy: Optional[TerminationPolicySpec] = None
    # Job-level restart budget for failed pods before the job goes Failed
    # (reference has only pod-level restartPolicy, SURVEY.md §5.3).
    max_restarts: int = 3

    def deepcopy(self) -> "ReplicaSpec":
        return ReplicaSpec(
            replica_type=self.replica_type,
            replicas=self.replicas,
            template=self.template.deepcopy() if self.template else None,
            tpu=self.tpu.deepcopy(),
            termination_policy=(
                self.termination_policy.deepcopy()
                if self.termination_policy else None
            ),
            max_restarts=self.max_restarts,
        )

    def __deepcopy__(self, memo) -> "ReplicaSpec":
        return self.deepcopy()

    def freeze(self) -> "ReplicaSpec":
        if self._sealed:
            return self
        if self.template is not None:
            self.template.freeze()
        self.tpu.freeze()
        if self.termination_policy is not None:
            self.termination_policy.freeze()
        self._seal()
        return self


@dataclass
class TPUJobSpec(Sealable):
    # RuntimeID: stamped once at first reconcile, then immutable — the
    # reference regenerates it per sync, orphaning prior resources
    # (distributed.go:208-209, SURVEY.md §8).
    runtime_id: str = ""
    data_dir: str = ""
    model_dir: str = ""
    log_dir: str = ""
    export_dir: str = ""
    replica_specs: List[ReplicaSpec] = field(default_factory=list)
    # Pause the job without deleting it (k8s Job / training-operator
    # spec.suspend): pods are torn down and slices released; flipping back
    # re-gangs the same epoch and resumes from the model_dir checkpoint.
    suspend: bool = False
    # Gang admission priority: when slices free up, higher-priority pending
    # gangs admit first (ties: submission order). Ordering only — running
    # jobs are never preempted by priority.
    priority: int = 0
    # Auto-delete the job (and thus its pods/services, via the deleted-job
    # cleanup path) this many controller-clock seconds after it reaches a
    # terminal phase. None = keep forever (the k8s Job / training-operator
    # ttlSecondsAfterFinished semantics).
    ttl_seconds_after_finished: Optional[int] = None

    def deepcopy(self) -> "TPUJobSpec":
        return TPUJobSpec(
            runtime_id=self.runtime_id,
            data_dir=self.data_dir,
            model_dir=self.model_dir,
            log_dir=self.log_dir,
            export_dir=self.export_dir,
            replica_specs=[rs.deepcopy() for rs in self.replica_specs],
            suspend=self.suspend,
            priority=self.priority,
            ttl_seconds_after_finished=self.ttl_seconds_after_finished,
        )

    def __deepcopy__(self, memo) -> "TPUJobSpec":
        return self.deepcopy()

    def freeze(self) -> "TPUJobSpec":
        if self._sealed:
            return self
        self.replica_specs = _FrozenList(
            rs.freeze() for rs in self.replica_specs)
        self._seal()
        return self


@dataclass
class Condition(Sealable):
    type: ConditionType = ConditionType.SCHEDULED
    status: ConditionStatus = ConditionStatus.UNKNOWN
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0

    def deepcopy(self) -> "Condition":
        return Condition(
            self.type, self.status, self.reason, self.message,
            self.last_transition_time,
        )

    def __deepcopy__(self, memo) -> "Condition":
        return self.deepcopy()

    def freeze(self) -> "Condition":
        if not self._sealed:
            self._seal()
        return self


@dataclass
class ReplicaStatus(Sealable):
    type: ReplicaType = ReplicaType.WORKER
    state: ReplicaState = ReplicaState.UNKNOWN
    # Histogram of pod states, mirror of TFReplicasStates (types.go:163-165).
    states: Dict[ReplicaState, int] = field(default_factory=dict)

    def deepcopy(self) -> "ReplicaStatus":
        return ReplicaStatus(self.type, self.state, dict(self.states))

    def __deepcopy__(self, memo) -> "ReplicaStatus":
        return self.deepcopy()

    def freeze(self) -> "ReplicaStatus":
        if self._sealed:
            return self
        self.states = _FrozenDict(self.states)
        self._seal()
        return self


@dataclass
class TPUJobStatus(Sealable):
    phase: JobPhase = JobPhase.NONE
    reason: str = ""
    conditions: List[Condition] = field(default_factory=list)
    replica_statuses: List[ReplicaStatus] = field(default_factory=list)
    # Observability for the submit->all-running north-star metric
    # (BASELINE.md): stamped by the status updater.
    submit_time: float = 0.0
    all_running_time: float = 0.0
    completion_time: float = 0.0
    # Count of gang restarts consumed (preemption recovery). Every restart
    # bumps this — it is the gang EPOCH counter (pod identity).
    restarts: int = 0
    # How many of those restarts were voluntary spec resizes: they advance
    # the epoch but must not consume the failure budget (max_restarts).
    resizes: int = 0
    # When the last gang restart fired (controller clock) — drives the
    # exponential failure-restart backoff.
    last_restart_time: float = 0.0
    # metadata.generation of the spec this status was computed from
    # (training-operator observedGeneration): the no-op sync short-circuit
    # trusts a steady fingerprint only once status has caught up to spec.
    observed_generation: int = 0

    def deepcopy(self) -> "TPUJobStatus":
        return TPUJobStatus(
            phase=self.phase,
            reason=self.reason,
            conditions=[c.deepcopy() for c in self.conditions],
            replica_statuses=[r.deepcopy() for r in self.replica_statuses],
            submit_time=self.submit_time,
            all_running_time=self.all_running_time,
            completion_time=self.completion_time,
            restarts=self.restarts,
            resizes=self.resizes,
            last_restart_time=self.last_restart_time,
            observed_generation=self.observed_generation,
        )

    def __deepcopy__(self, memo) -> "TPUJobStatus":
        return self.deepcopy()

    def freeze(self) -> "TPUJobStatus":
        if self._sealed:
            return self
        self.conditions = _FrozenList(
            c.freeze() for c in self.conditions)
        self.replica_statuses = _FrozenList(
            r.freeze() for r in self.replica_statuses)
        self._seal()
        return self

    def set_condition(
        self,
        ctype: ConditionType,
        status: ConditionStatus,
        reason: str = "",
        message: str = "",
        now: Optional[float] = None,
    ) -> bool:
        """Upsert a condition; returns True if anything changed. Keeps at most
        MAX_CONDITIONS entries, newest last."""
        now = time.time() if now is None else now
        existing = self.get_condition(ctype)
        if (
            existing is not None
            and existing.status == status
            and existing.reason == reason
            and existing.message == message
        ):
            return False
        if existing is not None:
            # Transition time only moves when status flips, matching k8s
            # lastTransitionTime semantics; reason/message refreshes keep it.
            if existing.status != status:
                existing.last_transition_time = now
            existing.status = status
            existing.reason = reason
            existing.message = message
            updated = existing
        else:
            updated = Condition(ctype, status, reason, message,
                                last_transition_time=now)
        # Newest-last invariant: the touched condition moves to the tail, so
        # the cap trims oldest first and can never trim what was just set
        # (duplicate types from direct manipulation get squeezed out too).
        self.conditions = [
            c for c in self.conditions if c is not updated and c.type != ctype
        ]
        self.conditions.append(updated)
        del self.conditions[:-MAX_CONDITIONS]
        return True

    def get_condition(self, ctype: ConditionType) -> Optional[Condition]:
        for cond in self.conditions:
            if cond.type == ctype:
                return cond
        return None


@dataclass
class TPUJob(Sealable):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TPUJobSpec = field(default_factory=TPUJobSpec)
    status: TPUJobStatus = field(default_factory=TPUJobStatus)

    kind: str = KIND
    api_version: str = f"{API_GROUP}/{API_VERSION}"

    def deepcopy(self) -> "TPUJob":
        _note_deepcopy()
        return TPUJob(
            metadata=self.metadata.deepcopy(),
            spec=self.spec.deepcopy(),
            status=self.status.deepcopy(),
            kind=self.kind,
            api_version=self.api_version,
        )

    def __deepcopy__(self, memo) -> "TPUJob":
        return self.deepcopy()

    def freeze(self) -> "TPUJob":
        if self._sealed:
            return self
        self.metadata.freeze()
        self.spec.freeze()
        self.status.freeze()
        self._seal()
        return self

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def worker_spec(self) -> Optional[ReplicaSpec]:
        for rs in self.spec.replica_specs:
            if rs.replica_type == ReplicaType.WORKER:
                return rs
        return None

    def local_spec(self) -> Optional[ReplicaSpec]:
        for rs in self.spec.replica_specs:
            if rs.replica_type == ReplicaType.LOCAL:
                return rs
        return None

    def is_done(self) -> bool:
        return self.status.phase in (JobPhase.SUCCEEDED, JobPhase.FAILED)


# ---------------------------------------------------------------------------
# LMService — a declarative serving fleet.
#
# Where TPUJob describes a finite training run, LMService describes a
# long-running pool of continuous-batching engine replicas
# (dataplane/serving_engine.py) the controller keeps at spec.replicas.
# Replica pods are claimed through the same owner-ref machinery as job pods;
# the request-side semantics (prefix-affinity dispatch, retries, shedding)
# live in dataplane/router.py.
# ---------------------------------------------------------------------------

KIND_LMSERVICE = "LMService"


class LMServicePhase(str, enum.Enum):
    NONE = ""
    PENDING = "Pending"
    # All spec.replicas pods are Running.
    READY = "Ready"
    # Some but not all replicas are Running (rollout, crash recovery).
    DEGRADED = "Degraded"


@dataclass
class SLOSpec(Sealable):
    """Service-level objectives the router and autoscaling signals key off.
    Zero disables the corresponding objective."""

    # TTFT p99 target; breaching it marks a replica unhealthy for dispatch.
    ttft_p99_ms: float = 0.0
    # Per-request completion deadline stamped onto admitted requests.
    deadline_s: float = 0.0

    def deepcopy(self) -> "SLOSpec":
        return SLOSpec(self.ttft_p99_ms, self.deadline_s)

    def __deepcopy__(self, memo) -> "SLOSpec":
        return self.deepcopy()

    def freeze(self) -> "SLOSpec":
        if not self._sealed:
            self._seal()
        return self


@dataclass
class LMServiceSpec(Sealable):
    # Model preset name (models/config.py CONFIGS key) each replica loads.
    model: str = "tiny"
    replicas: int = 1
    slo: SLOSpec = field(default_factory=SLOSpec)
    # Per-replica bounded admission queue depth (engine.max_queue).
    max_queue: int = 8
    # Prefill/decode disaggregation (docs/lmservice.md): the first
    # ``prefill_replicas`` indices run as dedicated prefill replicas and
    # the rest as decode replicas. 0 (the default) keeps every replica
    # "mixed" — the pre-disaggregation behavior. Must be < replicas when
    # set: a fleet of only-prefill replicas could never decode a token.
    prefill_replicas: int = 0
    # Stamped once at first reconcile, immutable after — same contract as
    # TPUJobSpec.runtime_id.
    runtime_id: str = ""

    def deepcopy(self) -> "LMServiceSpec":
        return LMServiceSpec(
            model=self.model,
            replicas=self.replicas,
            slo=self.slo.deepcopy(),
            max_queue=self.max_queue,
            prefill_replicas=self.prefill_replicas,
            runtime_id=self.runtime_id,
        )

    def __deepcopy__(self, memo) -> "LMServiceSpec":
        return self.deepcopy()

    def freeze(self) -> "LMServiceSpec":
        if self._sealed:
            return self
        self.slo.freeze()
        self._seal()
        return self


@dataclass
class LMServiceStatus(Sealable):
    phase: LMServicePhase = LMServicePhase.NONE
    reason: str = ""
    # Replica pods currently Running.
    ready_replicas: int = 0
    conditions: List[Condition] = field(default_factory=list)
    observed_generation: int = 0

    def deepcopy(self) -> "LMServiceStatus":
        return LMServiceStatus(
            phase=self.phase,
            reason=self.reason,
            ready_replicas=self.ready_replicas,
            conditions=[c.deepcopy() for c in self.conditions],
            observed_generation=self.observed_generation,
        )

    def __deepcopy__(self, memo) -> "LMServiceStatus":
        return self.deepcopy()

    def freeze(self) -> "LMServiceStatus":
        if self._sealed:
            return self
        self.conditions = _FrozenList(c.freeze() for c in self.conditions)
        self._seal()
        return self

    # Same upsert semantics as TPUJobStatus.set_condition (shared helper
    # would need a mixin through Sealable; duplication keeps both statuses
    # flat dataclasses).
    set_condition = TPUJobStatus.set_condition
    get_condition = TPUJobStatus.get_condition


@dataclass
class LMService(Sealable):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LMServiceSpec = field(default_factory=LMServiceSpec)
    status: LMServiceStatus = field(default_factory=LMServiceStatus)

    kind: str = KIND_LMSERVICE
    api_version: str = f"{API_GROUP}/{API_VERSION}"

    def deepcopy(self) -> "LMService":
        _note_deepcopy()
        return LMService(
            metadata=self.metadata.deepcopy(),
            spec=self.spec.deepcopy(),
            status=self.status.deepcopy(),
            kind=self.kind,
            api_version=self.api_version,
        )

    def __deepcopy__(self, memo) -> "LMService":
        return self.deepcopy()

    def freeze(self) -> "LMService":
        if self._sealed:
            return self
        self.metadata.freeze()
        self.spec.freeze()
        self.status.freeze()
        self._seal()
        return self

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"
