"""Checker: job-mode classification and TPU slice health assessment.

``is_local_job`` is capability parity with the reference's entire checker
package (``pkg/checker/checker.go:8-14``). The rest is the growth area
SURVEY.md §7.5 calls for: preemption and unhealthy-slice detection feeding the
Recovering flow, which the reference declared (``TFJobRecovering`` condition,
``types.go:152``) but never implemented.

Counterpart of ``kubeflow_controller_tpu/checker/checker.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

from kubeflow_controller_tpu_torch.api.core import Pod, PodPhase
from kubeflow_controller_tpu_torch.api.types import TPUJob
from kubeflow_controller_tpu_torch.cluster.cluster import REASON_PREEMPTED
from kubeflow_controller_tpu_torch.cluster.slices import TPUSlice


def is_local_job(job: TPUJob) -> bool:
    """A job is local iff it declares a Local replica spec. Unlike the
    reference (which only checks ``Specs[0]``), validation already guarantees
    roles aren't mixed, so any-position lookup is safe."""
    return job.local_spec() is not None


@dataclass
class HealthReport:
    """Slice/pod health snapshot for one job at one observation."""

    preempted_pods: List[str] = field(default_factory=list)
    failed_pods: List[str] = field(default_factory=list)       # non-preempted
    unhealthy_slices: List[str] = field(default_factory=list)  # held but sick
    # Pods bound to a slice that has gone unhealthy but haven't failed yet —
    # detecting these *before* the kubelet notices is the point of a checker.
    at_risk_pods: List[str] = field(default_factory=list)

    @property
    def needs_recovery(self) -> bool:
        return bool(
            self.preempted_pods or self.failed_pods
            or self.unhealthy_slices or self.at_risk_pods
        )


def assess_health(
    pods: Sequence[Pod], held_slices: Sequence[TPUSlice]
) -> HealthReport:
    """Every ClusterClient's ``job_slices`` returns TPUSlice (the REST
    client deserializes the wire dicts at its boundary), so the checker
    reads one type regardless of backend."""
    report = HealthReport()
    sick = {s.name for s in held_slices if not s.healthy}
    report.unhealthy_slices = sorted(sick)
    for pod in pods:
        if pod.status.phase == PodPhase.FAILED:
            if pod.status.reason == REASON_PREEMPTED:
                report.preempted_pods.append(pod.metadata.name)
            else:
                report.failed_pods.append(pod.metadata.name)
        elif (
            pod.status.phase in (PodPhase.PENDING, PodPhase.RUNNING)
            and pod.spec.assigned_slice in sick
        ):
            # Only live pods are at risk: a SUCCEEDED pod on a since-degraded
            # slice already finished its work — restarting it would re-run a
            # completed gang.
            report.at_risk_pods.append(pod.metadata.name)
    return report
