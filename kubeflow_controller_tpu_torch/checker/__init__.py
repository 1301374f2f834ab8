"""Counterpart of ``kubeflow_controller_tpu/checker/__init__.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""
from kubeflow_controller_tpu_torch.checker.checker import (
    HealthReport,
    assess_health,
    is_local_job,
)
