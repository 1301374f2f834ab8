"""Watch events — the level-triggering signal feeding informers.

Mirror of the watch semantics the reference gets from client-go's
SharedIndexInformer (``pkg/controller/controller.go:122-149`` registers
Added/Updated/Deleted handlers for tfjobs, pods, and services).

Counterpart of ``kubeflow_controller_tpu/cluster/events.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any


class EventType(str, enum.Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


@dataclass
class WatchEvent:
    type: EventType
    kind: str          # "Pod" | "Service" | "TPUJob"
    obj: Any           # deep copy of the object at event time
    old_obj: Any = None  # previous copy for MODIFIED
