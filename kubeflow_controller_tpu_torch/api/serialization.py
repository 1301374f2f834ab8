"""YAML/dict (de)serialization for TPUJob manifests.

The reference registers a CRD and lets the apiserver+client-gen do this
(``examples/crd/crd.yml``, vendored deepcopy/scheme); here the manifest format
is first-party. Field names are camelCase on the wire to keep kubectl-style
manifests familiar (compare ``examples/tfjob/dist.yml`` in the reference).

Malformed manifests fail with ``ValidationError`` carrying *every* problem
found, each prefixed with its manifest path — the same contract as admission
validation (``api/validation.py``).

Counterpart of ``kubeflow_controller_tpu/api/serialization.py``. PyYAML is
imported inside :func:`load_job_yaml` and :func:`dump_job_yaml` only: the
dict round trips need no YAML, and a host without PyYAML still imports the
API (``api/__init__.py`` re-exports this module).
"""

from __future__ import annotations

import enum
from dataclasses import fields, is_dataclass
from typing import Any, Dict, IO, List, Union

from kubeflow_controller_tpu_torch.api import core, types
from kubeflow_controller_tpu_torch.api.validation import ValidationError


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w.capitalize() for w in rest)


_SNAKE_CACHE: Dict[type, Dict[str, str]] = {}


def _field_map(cls: type) -> Dict[str, str]:
    """camelCase wire name -> snake_case attr name for a dataclass."""
    if cls not in _SNAKE_CACHE:
        _SNAKE_CACHE[cls] = {_camel(f.name): f.name for f in fields(cls)}
    return _SNAKE_CACHE[cls]


def _to_wire(obj: Any, top: bool = False) -> Any:
    if is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in fields(obj):
            val = getattr(obj, f.name)
            # Elide empties and scalar defaults so dumped manifests stay as
            # terse as what a user would write by hand.
            if val is None or val == [] or val == {} or val == "":
                continue
            if isinstance(val, (int, float, bool)) and val == f.default:
                continue
            # kind/apiVersion of the TOP object form the envelope (emitted by
            # the *_to_dict wrappers); nested dataclasses (OwnerReference)
            # carry theirs as ordinary data.
            if top and f.name in ("kind", "api_version"):
                continue
            out[_camel(f.name)] = _to_wire(val)
        return out
    if isinstance(obj, dict):
        return {
            (k.value if isinstance(k, enum.Enum) else k): _to_wire(v)
            for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [_to_wire(v) for v in obj]
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


def job_to_dict(job: types.TPUJob) -> Dict[str, Any]:
    out = {"apiVersion": job.api_version, "kind": job.kind}
    out.update(_to_wire(job, top=True))
    return out


# Nested dataclass/enum field types, by (owner class, attr name).
_NESTED = {
    (types.TPUJob, "metadata"): core.ObjectMeta,
    (types.TPUJob, "spec"): types.TPUJobSpec,
    (types.TPUJob, "status"): types.TPUJobStatus,
    (types.TPUJobSpec, "replica_specs"): types.ReplicaSpec,
    (types.ReplicaSpec, "template"): core.PodTemplateSpec,
    (types.ReplicaSpec, "tpu"): types.TPUSliceSpec,
    (types.ReplicaSpec, "termination_policy"): types.TerminationPolicySpec,
    (types.ReplicaSpec, "replica_type"): types.ReplicaType,
    (types.TerminationPolicySpec, "chief"): types.ChiefSpec,
    (types.TPUJobStatus, "phase"): types.JobPhase,
    (types.TPUJobStatus, "conditions"): types.Condition,
    (types.TPUJobStatus, "replica_statuses"): types.ReplicaStatus,
    (types.Condition, "type"): types.ConditionType,
    (types.Condition, "status"): types.ConditionStatus,
    (types.ReplicaStatus, "type"): types.ReplicaType,
    (types.ReplicaStatus, "state"): types.ReplicaState,
    (core.PodTemplateSpec, "metadata"): core.ObjectMeta,
    (core.PodTemplateSpec, "spec"): core.PodSpec,
    (core.PodSpec, "containers"): core.Container,
    (core.ObjectMeta, "owner_references"): core.OwnerReference,
    # Pod/Service wire forms (REST adapter, cluster/rest_client.py):
    (core.Pod, "metadata"): core.ObjectMeta,
    (core.Pod, "spec"): core.PodSpec,
    (core.Pod, "status"): core.PodStatus,
    (core.PodStatus, "phase"): core.PodPhase,
    (core.Service, "metadata"): core.ObjectMeta,
    (core.Service, "spec"): core.ServiceSpec,
    (core.ServiceSpec, "ports"): core.ServicePort,
}


def pod_to_dict(pod: core.Pod) -> Dict[str, Any]:
    out = {"apiVersion": pod.api_version, "kind": pod.kind}
    out.update(_to_wire(pod, top=True))
    return out


def pod_from_dict(data: Dict[str, Any]) -> core.Pod:
    errs: List[str] = []
    pod = _build(core.Pod, {
        k: v for k, v in data.items() if k not in ("apiVersion", "kind")
    }, "", errs)
    if errs:
        raise ValidationError(errs)
    return pod


def service_to_dict(svc: core.Service) -> Dict[str, Any]:
    out = {"apiVersion": svc.api_version, "kind": svc.kind}
    out.update(_to_wire(svc, top=True))
    return out


def service_from_dict(data: Dict[str, Any]) -> core.Service:
    errs: List[str] = []
    svc = _build(core.Service, {
        k: v for k, v in data.items() if k not in ("apiVersion", "kind")
    }, "", errs)
    if errs:
        raise ValidationError(errs)
    return svc


def _build(cls: type, data: Dict[str, Any], path: str, errs: List[str]) -> Any:
    fmap = _field_map(cls)
    kwargs: Dict[str, Any] = {}
    for wire_key, val in data.items():
        attr = fmap.get(wire_key)
        if attr is None:
            continue  # tolerate unknown fields, like the apiserver's pruning
        coerced = _coerce(cls, attr, val, f"{path}.{wire_key}" if path else wire_key, errs)
        if coerced is not _SKIP:
            kwargs[attr] = coerced
    try:
        return cls(**kwargs)
    except TypeError as e:
        errs.append(f"{path or cls.__name__}: {e}")
        return cls()


_SKIP = object()


def _coerce(owner: type, attr: str, val: Any, path: str, errs: List[str]) -> Any:
    target = _NESTED.get((owner, attr))
    if target is None:
        if owner is types.ReplicaStatus and attr == "states" and isinstance(val, dict):
            out = {}
            for k, v in val.items():
                try:
                    out[types.ReplicaState(k)] = v
                except ValueError:
                    errs.append(f"{path}: unknown replica state {k!r}")
            return out
        return val
    if isinstance(target, type) and issubclass(target, enum.Enum):
        try:
            return target(val)
        except ValueError:
            valid = ", ".join(m.value for m in target if m.value)
            errs.append(f"{path}: {val!r} is not one of [{valid}]")
            return _SKIP
    if isinstance(val, list):
        out = []
        for i, v in enumerate(val):
            if isinstance(v, dict):
                out.append(_build(target, v, f"{path}[{i}]", errs))
            else:
                errs.append(f"{path}[{i}]: expected a mapping, got {type(v).__name__}")
        return out
    if isinstance(val, dict):
        return _build(target, val, path, errs)
    errs.append(f"{path}: expected a mapping, got {type(val).__name__}")
    return _SKIP


def job_from_dict(data: Dict[str, Any]) -> types.TPUJob:
    errs: List[str] = []
    kind = data.get("kind", types.KIND)
    if kind != types.KIND:
        errs.append(f"kind: expected {types.KIND}, got {kind!r}")
    job = _build(types.TPUJob, data, "", errs)
    if errs:
        raise ValidationError(errs)
    return job


def load_job_yaml(src: Union[str, IO[str]]) -> types.TPUJob:
    """Load a TPUJob from a YAML string or open file. Raises ValidationError
    (with manifest paths) on anything malformed, including YAML syntax."""
    import yaml

    try:
        data = yaml.safe_load(src)
    except yaml.YAMLError as e:
        raise ValidationError([f"invalid YAML: {e}"]) from None
    if not isinstance(data, dict):
        raise ValidationError(["manifest did not parse to a mapping"])
    return job_from_dict(data)


def dump_job_yaml(job: types.TPUJob) -> str:
    import yaml

    return yaml.safe_dump(job_to_dict(job), sort_keys=False)
