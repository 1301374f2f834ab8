"""Reconcile core: workqueue, expectations, informers, ownership, controller.

The TPU-native rebuild of ``pkg/controller`` (reference
``pkg/controller/controller.go``): a level-triggered, expectation-guarded
reconcile loop whose domain decisions are pure functions and whose effects
happen only at the ClusterClient seam.

Counterpart of ``kubeflow_controller_tpu/controller/__init__.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from kubeflow_controller_tpu_torch.controller.workqueue import RateLimitingQueue
from kubeflow_controller_tpu_torch.controller.expectations import ControllerExpectations
from kubeflow_controller_tpu_torch.controller.informer import Informer
from kubeflow_controller_tpu_torch.controller.controller import Controller, ControllerOptions
