"""TPU slice topology catalog.

The reference's job geometry is ``N workers x M parameter servers`` chosen
freely per job (``pkg/tensorflow/distributed.go:56-114``). TPU geometry is not
free: an accelerator type names a pod-slice with a fixed chip count, a fixed
ICI topology, and a fixed number of host VMs (= JAX processes). The controller
must therefore derive process count / chips-per-host from the accelerator type
rather than letting the user pick replica counts that cannot exist.

This catalog is the single source of truth for that derivation; the fake
cluster's node pools and the gang scheduler both consume it.

Counterpart of ``kubeflow_controller_tpu/api/topology.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class SliceShape:
    """Physical shape of one TPU pod-slice."""

    accelerator_type: str  # e.g. "v5e-16"
    generation: str        # "v5e" | "v5p" | "v4" | "v6e"
    num_chips: int         # total chips in the slice
    topology: Tuple[int, ...]  # ICI mesh topology, e.g. (4, 4)
    chips_per_host: int    # chips attached to each host VM
    # Per-chip core count: v4/v5p chips expose 1 megacore; v5e/v6e 1 core.
    cores_per_chip: int = 1

    @property
    def hbm_gib_per_chip(self) -> int:
        """HBM capacity per chip (GiB), per the public TPU system specs:
        v4 32, v5e 16, v5p 95, v6e 32. Drives the pre-admission memory
        feasibility gate (parallel/memory.py)."""
        return {"v4": 32, "v5e": 16, "v5p": 95, "v6e": 32}[self.generation]

    @property
    def num_hosts(self) -> int:
        return max(1, self.num_chips // self.chips_per_host)

    @property
    def topology_str(self) -> str:
        return "x".join(str(d) for d in self.topology)

    @property
    def devices_per_host(self) -> int:
        return self.chips_per_host * self.cores_per_chip


def _v5e(chips: int, topo: Tuple[int, ...]) -> SliceShape:
    # v5e ("v5 lite"): single-host slices pack up to 8 chips on one VM
    # (ct5lp-hightpu-8t); multi-host slices (16 chips and up) attach 4 chips
    # per host VM.
    return SliceShape(f"v5e-{chips}", "v5e", chips, topo, 8 if chips <= 8 else 4)


def _v5p(chips: int, topo: Tuple[int, ...]) -> SliceShape:
    # v5p hosts carry 4 chips.
    return SliceShape(f"v5p-{chips}", "v5p", chips, topo, min(chips, 4))


def _v4(chips: int, topo: Tuple[int, ...]) -> SliceShape:
    return SliceShape(f"v4-{chips}", "v4", chips, topo, min(chips, 4))


def _v6e(chips: int, topo: Tuple[int, ...]) -> SliceShape:
    # v6e (Trillium): same host geometry as v5e — 8-chip single-host slices,
    # 4 chips per host for multi-host.
    return SliceShape(f"v6e-{chips}", "v6e", chips, topo, 8 if chips <= 8 else 4)


TPU_SLICE_CATALOG: Dict[str, SliceShape] = {
    s.accelerator_type: s
    for s in [
        _v5e(1, (1, 1)),
        _v5e(4, (2, 2)),
        _v5e(8, (2, 4)),
        _v5e(16, (4, 4)),
        _v5e(32, (4, 8)),
        _v5e(64, (8, 8)),
        _v5e(128, (8, 16)),
        _v5e(256, (16, 16)),
        _v5p(4, (2, 2, 1)),
        _v5p(8, (2, 2, 2)),
        _v5p(16, (2, 2, 4)),
        _v5p(32, (2, 4, 4)),
        _v5p(64, (4, 4, 4)),
        _v5p(128, (4, 4, 8)),
        _v5p(256, (4, 8, 8)),
        _v4(8, (2, 2, 2)),
        _v4(16, (2, 2, 4)),
        _v4(32, (2, 4, 4)),
        _v4(64, (4, 4, 4)),
        _v6e(1, (1, 1)),
        _v6e(4, (2, 2)),
        _v6e(8, (2, 4)),
        _v6e(16, (4, 4)),
        _v6e(32, (4, 8)),
        _v6e(64, (8, 8)),
        _v6e(256, (16, 16)),
    ]
}


def slice_shape(accelerator_type: str) -> SliceShape:
    """Look up a slice shape; raises KeyError with the known set on miss."""
    try:
        return TPU_SLICE_CATALOG[accelerator_type]
    except KeyError:
        known = ", ".join(sorted(TPU_SLICE_CATALOG))
        raise KeyError(
            f"unknown accelerator type {accelerator_type!r}; known: {known}"
        ) from None


# GKE's cloud.google.com/gke-tpu-accelerator label values per TPU
# generation: what real TPU node pools are labeled with (and what pod
# nodeSelectors must request). The chip count is NOT in this label — GKE
# encodes it in cloud.google.com/gke-tpu-topology — so the pair
# (accelerator label, topology) identifies a catalog entry.
GKE_ACCELERATOR_BY_GENERATION: Dict[str, str] = {
    "v4": "tpu-v4-podslice",
    "v5e": "tpu-v5-lite-podslice",
    "v5p": "tpu-v5p-slice",
    "v6e": "tpu-v6e-slice",
}
_GENERATION_BY_GKE = {v: k for k, v in GKE_ACCELERATOR_BY_GENERATION.items()}


def gke_accelerator(shape: SliceShape) -> str:
    """The gke-tpu-accelerator label value for a slice shape."""
    return GKE_ACCELERATOR_BY_GENERATION[shape.generation]


def shape_from_gke(gke_type: str, topology: str) -> SliceShape:
    """Resolve (gke-tpu-accelerator, gke-tpu-topology) node labels back to
    the catalog entry — the inverse of the nodeSelector the planner emits.
    Raises KeyError on an unknown generation or a topology not in the
    catalog."""
    gen = _GENERATION_BY_GKE.get(gke_type)
    if gen is None:
        raise KeyError(f"unknown gke-tpu-accelerator {gke_type!r}")
    chips = 1
    for dim in topology.split("x"):
        chips *= int(dim)
    return slice_shape(f"{gen}-{chips}")
