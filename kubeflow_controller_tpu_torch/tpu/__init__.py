"""TPU job semantics: naming/labels/env contracts and the pure gang planner.

The rethought descendant of ``pkg/tensorflow`` (reference
``distributed.go``/``local.go``): same architectural role — a side-effect-free
decision core consumed by the reconcile loop — but the decisions are
slice-gang decisions, not PS/worker host-list decisions.

Counterpart of ``kubeflow_controller_tpu/tpu/__init__.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from kubeflow_controller_tpu_torch.tpu.naming import (
    LABEL_EPOCH,
    LABEL_INDEX,
    LABEL_JOB,
    LABEL_REPLICA_TYPE,
    LABEL_RUNTIME_ID,
    coordinator_env,
    coordinator_service_name,
    job_selector,
    pod_labels,
    pod_name,
)
from kubeflow_controller_tpu_torch.tpu.plan import Plan, plan_job
