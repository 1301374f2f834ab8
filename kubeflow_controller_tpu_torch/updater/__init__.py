"""Counterpart of ``kubeflow_controller_tpu/updater/__init__.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""
from kubeflow_controller_tpu_torch.updater.updater import compute_status
