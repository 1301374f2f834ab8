"""Job API layer: TPUJob spec/status types, core object model, topology catalog.

Counterpart of ``kubeflow_controller_tpu/api/__init__.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from kubeflow_controller_tpu_torch.api.core import (
    Container,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
    PodStatus,
    PodTemplateSpec,
    Service,
    ServicePort,
    ServiceSpec,
)
from kubeflow_controller_tpu_torch.api.topology import (
    SliceShape,
    TPU_SLICE_CATALOG,
    slice_shape,
)
from kubeflow_controller_tpu_torch.api.types import (
    ChiefSpec,
    Condition,
    ConditionStatus,
    ConditionType,
    JobPhase,
    ReplicaSpec,
    ReplicaState,
    ReplicaStatus,
    ReplicaType,
    TerminationPolicySpec,
    TPUJob,
    TPUJobSpec,
    TPUJobStatus,
    TPUSliceSpec,
)
from kubeflow_controller_tpu_torch.api.serialization import (
    job_from_dict,
    job_to_dict,
    load_job_yaml,
    dump_job_yaml,
)
from kubeflow_controller_tpu_torch.api.validation import ValidationError, validate_job
