"""Core cluster object model: the minimal Kubernetes-shaped primitives the
controller reconciles against.

The reference consumes these from ``k8s.io/api/core/v1`` (vendored); here they
are first-party dataclasses because the framework ships its own in-process
cluster (see ``kubeflow_controller_tpu_torch.cluster``) for hermetic development and
testing, with a real-cluster adapter as a thin swap-in at the effector seam
(mirroring how ``HelperInterface`` isolates the apiserver in the reference,
``pkg/controller/helper.go:42-47``).

Only the fields the control plane actually reads/writes exist — this is an
object model, not a Kubernetes client.

Counterpart of ``kubeflow_controller_tpu/api/core.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class PodPhase(str, enum.Enum):
    """Pod lifecycle phase (mirror of k8s core/v1 PodPhase semantics)."""

    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


class FrozenObjectError(TypeError):
    """Raised on any write to a frozen (sealed) API object.

    Frozen objects are shared snapshots handed out by the copy-on-write
    store/informer read path (client-go's "objects from a Lister MUST NOT
    be mutated" contract, enforced). Thaw first: ``api.core.thaw(obj)``.
    """


class _FrozenDict(dict):
    """Dict whose Python-level mutators raise once handed out frozen.

    Built via the C-level ``dict`` constructor (which also shallow-copies,
    severing aliasing with the caller's dict at freeze time). ``dict(fd)``
    and ``fd.copy()`` still produce plain mutable dicts, so the hand-rolled
    ``deepcopy()`` methods work unchanged on frozen objects.
    """

    def _raise(self, *a, **k):
        raise FrozenObjectError(
            "dict belongs to a frozen API object; thaw() the object first")

    __setitem__ = __delitem__ = _raise
    clear = pop = popitem = setdefault = update = _raise
    __ior__ = _raise

    def __reduce__(self):
        return (dict, (dict(self),))


class _FrozenList(list):
    """List counterpart of :class:`_FrozenDict` (same escape hatches)."""

    def _raise(self, *a, **k):
        raise FrozenObjectError(
            "list belongs to a frozen API object; thaw() the object first")

    __setitem__ = __delitem__ = __iadd__ = __imul__ = _raise
    append = extend = insert = pop = remove = clear = sort = reverse = _raise

    def __reduce__(self):
        return (list, (list(self),))


class Sealable:
    """Mixin giving API dataclasses a one-way freeze switch.

    ``_sealed`` is a plain class attribute (not an annotated field) so it
    stays out of ``dataclasses.fields()`` — generated ``__init__``/
    ``__eq__``/``repr`` are unaffected, and fresh instances construct
    normally against the inherited ``False``.

    Sealing swaps the instance's class to a cached frozen variant whose
    ``__setattr__``/``__delattr__`` raise. The alternative — a guard in a
    Python-level ``__setattr__`` on this mixin — taxes EVERY field write
    on every unsealed object (construction, deepcopy, kubelet/scheduler
    mutation), which measured ~15% of control-plane bench wall time; the
    class swap keeps unsealed writes at C speed and charges only sealed
    objects, which raise anyway. The variant's ``__class__`` property
    reports the base class, so dataclass ``__eq__`` (which compares
    ``__class__``), ``repr``, and ``isinstance`` treat frozen and thawed
    objects identically; only ``type(obj)`` reveals the variant.
    """

    _sealed = False

    def _seal(self) -> None:
        object.__setattr__(self, "__class__", _frozen_variant(type(self)))


_FROZEN_VARIANTS: Dict[type, type] = {}


def _frozen_variant(cls: type) -> type:
    variant = _FROZEN_VARIANTS.get(cls)
    if variant is None:
        if cls.__dict__.get("_sealed"):
            return cls  # already a frozen variant (double-seal)

        def _raise(self, name, value=None):
            raise FrozenObjectError(
                f"{cls.__name__} is frozen (shared store snapshot); "
                "thaw() it into an owned copy before mutating")

        variant = type("_Frozen" + cls.__name__, (cls,), {
            "_sealed": True,
            "__setattr__": _raise,
            "__delattr__": _raise,
            "__class__": property(lambda self: cls),
        })
        _FROZEN_VARIANTS[cls] = variant
    return variant


def is_frozen(obj) -> bool:
    """True when ``obj`` is a sealed API-object snapshot."""
    return getattr(obj, "_sealed", False)


def thaw(obj):
    """Owned, mutable copy of ``obj`` — with copy elision.

    Frozen input: one deepcopy (the mutation-boundary copy). Already-owned
    input: returned as-is, no copy — so unconditional ``thaw()`` at a write
    site costs nothing when the caller already holds a private object.
    """
    if obj is not None and is_frozen(obj):
        return obj.deepcopy()
    return obj


# Top-level (Pod/Service/TPUJob) deepcopy counter — the bench samples it to
# attribute control-plane wins to eliminated copies (deepcopies_per_sync in
# benchmarks/controlplane_bench.py). Unlocked increment: exact under the
# deterministic runtime, GIL-approximate (diagnostic-only) under threads.
_deepcopies = 0


def _note_deepcopy() -> None:
    global _deepcopies
    _deepcopies += 1


def deepcopy_count() -> int:
    """Process-wide count of top-level API-object deepcopies so far."""
    return _deepcopies


@dataclass
class OwnerReference(Sealable):
    """Ownership link from a dependent object to its controller.

    Same contract the reference builds in ``newControllerRef``
    (``pkg/controller/util.go:44-55``): apiVersion/kind/name/uid plus
    ``controller=True`` so adopt/release logic can find the managing job.
    """

    api_version: str
    kind: str
    name: str
    uid: str
    controller: bool = True
    block_owner_deletion: bool = True

    # Hand-rolled copies throughout this module: the cluster store
    # deep-copies on every get/list/update/emit, which made generic
    # copy.deepcopy ~90% of control-plane wall time at 1000-job scale
    # (benchmarks/controlplane_bench.py). Field coverage is guarded by
    # tests/test_deepcopy.py, which fails loudly when a field is added
    # without updating its copy method.
    def deepcopy(self) -> "OwnerReference":
        return OwnerReference(
            self.api_version, self.kind, self.name, self.uid,
            self.controller, self.block_owner_deletion,
        )

    def __deepcopy__(self, memo) -> "OwnerReference":
        return self.deepcopy()

    # freeze() mirrors deepcopy() field-for-field (coverage guarded by
    # tests/test_deepcopy.py + tests/test_cow_store.py): idempotent, stops
    # at already-sealed children, wraps containers in _Frozen* and severs
    # aliasing with the caller's containers in the process.
    def freeze(self) -> "OwnerReference":
        if not self._sealed:
            self._seal()
        return self


@dataclass
class ObjectMeta(Sealable):
    name: str = ""
    generate_name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    # Spec revision (k8s metadata.generation): the store bumps it only when
    # .spec changes; status-subresource writes keep it. Paired with
    # status.observed_generation it powers the controller's no-op sync
    # short-circuit (docs/watch_pipeline.md).
    generation: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None

    def controller_ref(self) -> Optional[OwnerReference]:
        """Return the managing controller's OwnerReference, if any.

        Mirrors ``metav1.GetControllerOf`` as used by ``resolveControllerRef``
        (reference ``pkg/controller/controller.go:595-611``).
        """
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None

    def deepcopy(self) -> "ObjectMeta":
        return ObjectMeta(
            name=self.name,
            generate_name=self.generate_name,
            namespace=self.namespace,
            uid=self.uid,
            resource_version=self.resource_version,
            generation=self.generation,
            labels=dict(self.labels),
            annotations=dict(self.annotations),
            owner_references=[r.deepcopy() for r in self.owner_references],
            creation_timestamp=self.creation_timestamp,
            deletion_timestamp=self.deletion_timestamp,
        )

    def __deepcopy__(self, memo) -> "ObjectMeta":
        return self.deepcopy()

    def freeze(self) -> "ObjectMeta":
        if self._sealed:
            return self
        self.labels = _FrozenDict(self.labels)
        self.annotations = _FrozenDict(self.annotations)
        self.owner_references = _FrozenList(
            r.freeze() for r in self.owner_references)
        self._seal()
        return self


@dataclass
class Container(Sealable):
    name: str
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    ports: List[int] = field(default_factory=list)
    # Resource requests: scalar quantities keyed by resource name, e.g.
    # {"google.com/tpu": 4, "cpu": 8} (scalars only — deepcopy relies on it).
    resources: Dict[str, Any] = field(default_factory=dict)

    def deepcopy(self) -> "Container":
        return Container(
            name=self.name,
            image=self.image,
            command=list(self.command),
            args=list(self.args),
            env=dict(self.env),
            ports=list(self.ports),
            resources=dict(self.resources),
        )

    def __deepcopy__(self, memo) -> "Container":
        return self.deepcopy()

    def freeze(self) -> "Container":
        if self._sealed:
            return self
        self.command = _FrozenList(self.command)
        self.args = _FrozenList(self.args)
        self.env = _FrozenDict(self.env)
        self.ports = _FrozenList(self.ports)
        self.resources = _FrozenDict(self.resources)
        self._seal()
        return self


@dataclass
class PodSpec(Sealable):
    containers: List[Container] = field(default_factory=list)
    restart_policy: str = "OnFailure"
    node_selector: Dict[str, str] = field(default_factory=dict)
    # Gang-scheduling group: pods sharing a scheduling_group are admitted
    # all-or-nothing by the (fake or real) scheduler. No analog in the
    # reference — it creates pods incrementally (controller.go:396-421),
    # which SURVEY.md flags as exactly wrong for TPU slices.
    scheduling_group: str = ""
    # Name of the TPU slice this pod is pinned to once scheduled.
    assigned_slice: str = ""

    def main_container(self) -> Container:
        return self.containers[0]

    def deepcopy(self) -> "PodSpec":
        return PodSpec(
            containers=[c.deepcopy() for c in self.containers],
            restart_policy=self.restart_policy,
            node_selector=dict(self.node_selector),
            scheduling_group=self.scheduling_group,
            assigned_slice=self.assigned_slice,
        )

    def __deepcopy__(self, memo) -> "PodSpec":
        return self.deepcopy()

    def freeze(self) -> "PodSpec":
        if self._sealed:
            return self
        self.containers = _FrozenList(c.freeze() for c in self.containers)
        self.node_selector = _FrozenDict(self.node_selector)
        self._seal()
        return self


@dataclass
class PodStatus(Sealable):
    phase: PodPhase = PodPhase.PENDING
    reason: str = ""
    message: str = ""
    pod_ip: str = ""
    host_ip: str = ""
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    exit_code: Optional[int] = None

    def deepcopy(self) -> "PodStatus":
        return PodStatus(
            phase=self.phase,
            reason=self.reason,
            message=self.message,
            pod_ip=self.pod_ip,
            host_ip=self.host_ip,
            start_time=self.start_time,
            finish_time=self.finish_time,
            exit_code=self.exit_code,
        )

    def __deepcopy__(self, memo) -> "PodStatus":
        return self.deepcopy()

    def freeze(self) -> "PodStatus":
        if not self._sealed:
            self._seal()
        return self


@dataclass
class Pod(Sealable):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind: str = "Pod"
    api_version: str = "v1"

    def deepcopy(self) -> "Pod":
        _note_deepcopy()
        return Pod(
            metadata=self.metadata.deepcopy(),
            spec=self.spec.deepcopy(),
            status=self.status.deepcopy(),
            kind=self.kind,
            api_version=self.api_version,
        )

    def __deepcopy__(self, memo) -> "Pod":
        return self.deepcopy()

    def freeze(self) -> "Pod":
        if self._sealed:
            return self
        self.metadata.freeze()
        self.spec.freeze()
        self.status.freeze()
        self._seal()
        return self


@dataclass
class PodTemplateSpec(Sealable):
    """Template stamped out (deep-copied — the reference's in-place template
    mutation at ``pkg/tensorflow/distributed.go:117-125`` is a known cache
    corruption bug, SURVEY.md §8) for each replica pod."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)

    def deepcopy(self) -> "PodTemplateSpec":
        return PodTemplateSpec(
            metadata=self.metadata.deepcopy(), spec=self.spec.deepcopy(),
        )

    def __deepcopy__(self, memo) -> "PodTemplateSpec":
        return self.deepcopy()

    def freeze(self) -> "PodTemplateSpec":
        if self._sealed:
            return self
        self.metadata.freeze()
        self.spec.freeze()
        self._seal()
        return self


@dataclass
class ServicePort(Sealable):
    port: int
    name: str = ""
    target_port: Optional[int] = None

    def deepcopy(self) -> "ServicePort":
        return ServicePort(self.port, self.name, self.target_port)

    def __deepcopy__(self, memo) -> "ServicePort":
        return self.deepcopy()

    def freeze(self) -> "ServicePort":
        if not self._sealed:
            self._seal()
        return self


@dataclass
class ServiceSpec(Sealable):
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    cluster_ip: str = ""

    def deepcopy(self) -> "ServiceSpec":
        return ServiceSpec(
            selector=dict(self.selector),
            ports=[p.deepcopy() for p in self.ports],
            cluster_ip=self.cluster_ip,
        )

    def __deepcopy__(self, memo) -> "ServiceSpec":
        return self.deepcopy()

    def freeze(self) -> "ServiceSpec":
        if self._sealed:
            return self
        self.selector = _FrozenDict(self.selector)
        self.ports = _FrozenList(p.freeze() for p in self.ports)
        self._seal()
        return self


@dataclass
class Service(Sealable):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)

    kind: str = "Service"
    api_version: str = "v1"

    def deepcopy(self) -> "Service":
        _note_deepcopy()
        return Service(
            metadata=self.metadata.deepcopy(),
            spec=self.spec.deepcopy(),
            kind=self.kind,
            api_version=self.api_version,
        )

    def __deepcopy__(self, memo) -> "Service":
        return self.deepcopy()

    def freeze(self) -> "Service":
        if self._sealed:
            return self
        self.metadata.freeze()
        self.spec.freeze()
        self._seal()
        return self

    def dns_name(self) -> str:
        return f"{self.metadata.name}.{self.metadata.namespace}.svc"


_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    """Monotonic process-unique uid (fake-cluster stand-in for k8s UIDs)."""
    return f"{prefix}-{next(_uid_counter):08d}-{int(time.time()) & 0xFFFF:04x}"
