"""Ownership claiming: adopt/release of pods and services.

Semantics rebuilt from the reference's claim pipeline — vendored
``PodControllerRefManager.ClaimPods``
(``controller_ref_manager.go:172``) plus the first-party service ref manager
(``pkg/controller/ref/base.go:59-112``, ``ref/service.go:84-119``) as driven by
``GetPodsForTFJob``/``GetServicesForTFJob`` (``helper.go:110-179``):

- owned by us (controllerRef uid matches) + selector matches -> keep;
- owned by us + selector no longer matches -> release (drop ownerRef);
- orphan + selector matches -> adopt (stamp ownerRef), unless the job is
  being deleted;
- owned by someone else -> ignore.

Counterpart of ``kubeflow_controller_tpu/controller/claim.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

from kubeflow_controller_tpu_torch.api.core import OwnerReference, thaw
from kubeflow_controller_tpu_torch.api.types import TPUJob
from kubeflow_controller_tpu_torch.cluster.store import selector_matches


def claim_objects(
    job: TPUJob,
    selector: Dict[str, str],
    candidates: List[Any],
    update_fn: Callable[[Any], Any],
) -> List[Any]:
    """Generic adopt/release over pods or services; returns the claimed set.

    ``update_fn`` persists an ownership patch (adopt/release); failures of an
    individual patch skip that object — level-triggering retries next sync.
    """
    claimed = []
    for obj in candidates:
        ref = obj.metadata.controller_ref()
        if ref is not None:
            if ref.uid != job.metadata.uid:
                continue  # owned by someone else
            if selector_matches(selector, obj.metadata.labels):
                claimed.append(obj)
            else:
                # Release: labels diverged from our selector. Candidates are
                # frozen informer/store snapshots — thaw before patching.
                obj = thaw(obj)
                obj.metadata.owner_references = [
                    r for r in obj.metadata.owner_references
                    if r.uid != job.metadata.uid
                ]
                try:
                    update_fn(obj)
                except Exception:
                    pass
        else:
            if not selector_matches(selector, obj.metadata.labels):
                continue
            if job.metadata.deletion_timestamp is not None:
                continue  # deleting jobs adopt nothing (RecheckDeletionTimestamp)
            obj = thaw(obj)  # adopting stamps an ownerRef on the snapshot
            obj.metadata.owner_references.append(
                OwnerReference(
                    api_version=job.api_version,
                    kind=job.kind,
                    name=job.metadata.name,
                    uid=job.metadata.uid,
                )
            )
            try:
                claimed.append(update_fn(obj))
            except Exception:
                pass
    return claimed
