"""kubectl-apply semantics, shared by every server/client topology.

Apply = create-or-update-SPEC-only: status and the stamped ``runtime_id``
are controller-owned and must survive a re-applied manifest (a spec change
on a live job then triggers the planner's voluntary gang resize). The
read-merge-write loop retries on resourceVersion conflicts — the
controller writes status concurrently, which is exactly the window a
single-shot update would lose (reference punts with an unguarded
whole-object PUT, ``pkg/controller/controller.go:630-636``).

Counterpart of ``kubeflow_controller_tpu/api/apply.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

from kubeflow_controller_tpu_torch.api.core import thaw
from kubeflow_controller_tpu_torch.api.types import TPUJob
from kubeflow_controller_tpu_torch.cluster.store import AlreadyExists, Conflict


def apply_job_spec(
    get: Callable[[], Optional[TPUJob]],
    create: Callable[[TPUJob], TPUJob],
    update: Callable[[TPUJob], TPUJob],
    new: TPUJob,
    retries: int = 10,
) -> TPUJob:
    """Create ``new`` if absent, else replace the existing job's spec with
    ``new.spec`` (keeping the stamped runtime id). Conflict-retried."""
    for _ in range(retries):
        # get() may hand back a frozen store snapshot (cli serves straight
        # off the store); thaw is free when it is already a private parse.
        cur = thaw(get())
        if cur is None:
            try:
                return create(new)
            except AlreadyExists:
                # A concurrent creator won the race between get() and
                # create(); the next iteration takes the update path.
                continue
        rid = cur.spec.runtime_id
        cur.spec = copy.deepcopy(new.spec)
        cur.spec.runtime_id = rid
        try:
            return update(cur)
        except Conflict:
            continue
    raise Conflict(f"apply of {new.metadata.name}: retries exhausted")
