"""In-process cluster: object store with watch streams, TPU slice inventory,
gang-aware pod scheduler/lifecycle, and the effector-client seam.

This is the framework's stand-in for the kube-apiserver + kubelet + GKE TPU
provisioner that the reference talks to over HTTPS (SURVEY.md §2.2 L0). The
reconcile core only touches the ``ClusterClient`` interface, so a real-cluster
adapter swaps in at exactly the seam the reference drew with
``HelperInterface`` (``pkg/controller/helper.go:42-47``).

Counterpart of ``kubeflow_controller_tpu/cluster/__init__.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from kubeflow_controller_tpu_torch.cluster.events import EventType, WatchEvent
from kubeflow_controller_tpu_torch.cluster.store import Conflict, NotFound, AlreadyExists, ObjectStore
from kubeflow_controller_tpu_torch.cluster.slices import SlicePool, TPUSlice
from kubeflow_controller_tpu_torch.cluster.cluster import FakeCluster, FaultInjector, PodRunPolicy
from kubeflow_controller_tpu_torch.cluster.client import ClusterClient
