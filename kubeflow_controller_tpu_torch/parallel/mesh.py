"""The job's six-axis process mesh over ``torch.distributed`` ranks.

Counterpart of ``kubeflow_controller_tpu/parallel/mesh.py``. One process
drives one GPU, so the mesh is a grid of ranks: ``(pp, dp, fsdp, ep,
sp, tp)``, tp innermost, ranks laid out row-major
(``np.arange(world).reshape(shape)``, as the JAX package reshapes its
device list). :class:`Mesh` holds that grid, this rank's coordinates
and the process groups the train loop and the layers ask for
(:data:`GROUP_AXES`: ``mesh.group("fsdp")``, ``mesh.group(*DATA_AXES)``),
created when the mesh is built, by every rank in the same order;
``mesh.device_mesh`` is the same grid as a ``torch.distributed``
``DeviceMesh``, for DTensor interop (the train step does not use it).
Without a process group the mesh is a world of one rank and every
group is ``None``.

:func:`use_mesh` makes a mesh the ambient one while a train step runs
(the JAX package's ``jax.set_mesh``): the layers' collectives
(``parallel/collectives.py``) read their groups from it.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

#: The axes the global batch is split over (ep carries data outside the
#: expert banks); sp and tp groups see the same rows.
DATA_AXES = ("dp", "fsdp", "ep")

#: The axes whose ranks each compute a part of one global loss, which is
#: the mean of their losses: the data axes (each rank's rows), sp (each
#: rank's slice of the sequence) and pp (every stage computes the loss
#: of the replicated last-stage output). A gradient is summed over the
#: ranks of these axes that hold its leaf whole, and divided by their
#: count. tp ranks compute the same loss once between them.
LOSS_AXES = ("pp", "dp", "fsdp", "ep", "sp")


def grad_sum_axes(scattered: bool = False, stage: bool = False) -> Tuple[str, ...]:
    """The loss axes a gradient is all-reduced over
    (``sharding.reduce_grad``): all of them but fsdp where fsdp's
    reduce-scatter has summed the leaf (``scattered``), and but pp where
    the leaf is a stage's layers (``stage``)."""
    return tuple(a for a in LOSS_AXES
                 if not (a == "fsdp" and scattered or a == "pp" and stage))


#: The sets of axes a mesh makes groups over: each axis, the data axes
#: (BatchNorm's statistics) and those fsdp's reduce-scatter leaves to an
#: all-reduce, every set a gradient is all-reduced over
#: (:func:`grad_sum_axes`; all the loss axes for the loss and metrics'
#: means), fsdp with tp (a leaf sharded over both on one dimension), and
#: the whole mesh (barriers, checkpoints).
GROUP_AXES = tuple((a,) for a in AXES) + (DATA_AXES, ("dp", "ep")) + tuple(
    grad_sum_axes(scattered, stage)
    for scattered in (False, True) for stage in (False, True)) + (
    ("fsdp", "tp"), AXES)


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape; ``dp=-1`` absorbs the ranks the other axes
    leave."""

    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int, int]:
        fixed = self.pp * self.fsdp * self.ep * self.sp * self.tp
        if self.dp == -1:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"pp*fsdp*ep*sp*tp={fixed}"
                )
            return (self.pp, n_devices // fixed, self.fsdp, self.ep,
                    self.sp, self.tp)
        total = self.dp * fixed
        if total != n_devices:
            raise ValueError(
                f"mesh {self.pp}x{self.dp}x{self.fsdp}x{self.ep}x{self.sp}"
                f"x{self.tp}={total} != {n_devices} devices"
            )
        return (self.pp, self.dp, self.fsdp, self.ep, self.sp, self.tp)


def world() -> Tuple[int, int]:
    """``(world_size, rank)`` of the default process group, ``(1, 0)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A grid of ranks over :data:`AXES`. ``devices`` is the grid
    (global ranks); ``shape`` maps axis -> size; ``rank`` is this
    process's rank, ``coords`` its position (``None`` when the mesh is
    over other ranks than this one)."""

    def __init__(self, devices: np.ndarray, device_type: str = "cpu"):
        self.devices = np.asarray(devices, dtype=np.int64)
        if self.devices.ndim != len(AXES):
            raise ValueError(f"mesh grid must have {len(AXES)} axes")
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, self.devices.shape))
        self.device_type = device_type
        self.world_size, self.rank = world()
        where = np.argwhere(self.devices == self.rank)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(AXES, (int(c) for c in where[0]))) if len(where) else None)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._device_mesh = None
        if self.world_size > 1:
            self._make_groups()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, *axes: str) -> int:
        """This rank's row-major index over ``axes`` (its chunk along a
        dimension those axes shard)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _nontrivial(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in AXES if a in axes and self.shape[a] > 1)

    def _make_groups(self) -> None:
        """For each set of :data:`GROUP_AXES` (its non-trivial axes), one
        group per coordinate of the other axes; every rank of the world
        takes part in every ``new_group`` call, in the same order."""
        keys = dict.fromkeys(self._nontrivial(axes) for axes in GROUP_AXES)
        for axes in filter(None, keys):
            dims = [AXES.index(a) for a in axes]
            rest = [d for d in range(len(AXES)) if d not in dims]
            grid = np.transpose(self.devices, rest + dims).reshape(
                -1, math.prod(self.devices.shape[d] for d in dims))
            for ranks in grid:
                g = dist.new_group([int(r) for r in ranks])
                if self.rank in ranks:
                    self._groups[axes] = g

    def group(self, *axes: str):
        """The process group over ``axes`` that holds this rank (its
        ranks in row-major order of ``axes``), ``None`` when those axes
        hold one rank."""
        key = self._nontrivial(axes)
        if not key:
            return None
        if key not in self._groups:
            raise ValueError(
                f"no group over {key}: a mesh makes groups over the sets "
                f"of GROUP_AXES {GROUP_AXES}")
        return self._groups[key]

    @property
    def device_mesh(self):
        """The grid as a ``torch.distributed`` ``DeviceMesh`` with the
        six axis names (built on first use, by every rank of the mesh)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(
                self.device_type, torch.from_numpy(self.devices),
                mesh_dim_names=AXES)
        return self._device_mesh

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[int]] = None,
              device_type: str = "cpu") -> Mesh:
    """The mesh of ``config`` over ``devices`` (ranks; default the whole
    world, or a world of one without a process group), row-major."""
    config = config or MeshConfig()
    ranks = list(devices) if devices is not None else list(range(world()[0]))
    shape = config.resolve(len(ranks))
    return Mesh(np.array(ranks).reshape(shape), device_type)


def make_multislice_mesh(
    config: Optional[MeshConfig] = None,
    num_slices: int = 1,
    devices: Optional[Sequence[int]] = None,
    slice_ids: Optional[Sequence[int]] = None,
    device_type: str = "cpu",
) -> Mesh:
    """DCN-aware mesh of a multi-slice job: dp factors as ``(num_slices,
    dp // num_slices)`` with the slice factor outermost, so only the
    pure-dp gradient reduction crosses slices. Ranks are grouped by
    ``slice_ids`` (each rank's ``TPU_SLICE_ID``, in rank order) when
    given, else split evenly in rank order; pp must be 1."""
    config = config or MeshConfig()
    ranks = list(devices) if devices is not None else list(range(world()[0]))
    if num_slices <= 1:
        return make_mesh(config, ranks, device_type)
    if len(ranks) % num_slices:
        raise ValueError(
            f"{len(ranks)} devices not divisible into {num_slices} slices")
    per_slice = len(ranks) // num_slices
    if slice_ids is not None:
        by_slice: Dict[int, List[int]] = {}
        for r in ranks:
            by_slice.setdefault(int(slice_ids[r]), []).append(r)
        if len(by_slice) != num_slices:
            raise ValueError(
                f"platform reports {len(by_slice)} slices, job declares "
                f"{num_slices}")
        groups = [by_slice[k] for k in sorted(by_slice)]
        if {len(g) for g in groups} != {per_slice}:
            raise ValueError(
                f"uneven slice membership: got group sizes "
                f"{sorted(len(g) for g in groups)}, need {per_slice} each "
                f"({len(ranks)} devices / {num_slices} slices)")
    else:
        groups = [ranks[i * per_slice:(i + 1) * per_slice]
                  for i in range(num_slices)]
    pp, dp, fsdp, ep, sp, tp = config.resolve(len(ranks))
    if pp != 1:
        raise ValueError(
            "multi-slice meshes pin the DCN boundary to the dp axis; run "
            "pipeline stages inside a slice (pp=1 across slices)")
    if dp % num_slices:
        raise ValueError(
            f"dp={dp} must be divisible by num_slices={num_slices} "
            f"(fsdp/ep/sp/tp must not straddle the DCN)")
    arr = np.array(groups).reshape(
        num_slices, dp // num_slices, fsdp, ep, sp, tp,
    ).reshape(pp, dp, fsdp, ep, sp, tp)
    return Mesh(arr, device_type)


def serving_mesh(tp: int = 1, devices: Optional[Sequence[int]] = None):
    """The serving engine's mesh: ``None`` for ``tp <= 1`` (the engine
    runs its single-card path); a tensor-parallel engine is not ported."""
    if tp <= 1:
        return None
    raise NotImplementedError(
        f"serving over a tp={tp} mesh is not yet ported")


def mesh_for_context(ctx, config: Optional[MeshConfig] = None,
                     device_type: str = "cpu") -> Mesh:
    """The job's global mesh from its :class:`ProcessContext`: a
    multi-slice job (``MEGASCALE_NUM_SLICES > 1``) groups the ranks by
    their ``TPU_SLICE_ID``, gathered from every rank."""
    num_slices = max(1, getattr(ctx, "num_slices", 1))
    slice_ids = None
    size = world()[0]
    if num_slices > 1 and size > 1:
        slice_ids = [None] * size
        dist.all_gather_object(slice_ids, int(ctx.slice_id))
    return make_multislice_mesh(config, num_slices=num_slices,
                                slice_ids=slice_ids, device_type=device_type)


def row_source(mesh: Mesh) -> int:
    """The rank whose stream this rank's rows are drawn from: the first
    (pp, sp and tp at 0) of the ranks that hold the same rows. A stream
    seeded by process, as the JAX package seeds its corpus, takes this
    rank as its seed, so that the tp and sp ranks of one data shard
    draw the same rows; without them it is the rank itself."""
    c = mesh.coords
    return int(mesh.devices[0, c["dp"], c["fsdp"], c["ep"], 0, 0])


def seq_slice(mesh: Optional[Mesh], s: int) -> slice:
    """This rank's contiguous slice of a sequence of ``s`` positions
    split over sp (the whole sequence off a mesh or at sp=1): rank ``i``
    of the sp group holds ``[i * s / sp, (i + 1) * s / sp)``, as
    ``P(batch, "sp")`` splits it."""
    if mesh is None or mesh.shape["sp"] == 1:
        return slice(0, s)
    n = mesh.shape["sp"]
    if s % n:
        raise ValueError(f"sequence length {s} does not divide over sp={n}")
    i = mesh.coords["sp"]
    return slice(i * s // n, (i + 1) * s // n)


def data_shards(mesh: Mesh) -> int:
    """Distinct batch shards of the mesh (the global batch must divide)."""
    return mesh.axis_size(*DATA_AXES)


def batch_rows(mesh: Mesh, global_batch: int, grad_accum: int = 1) -> np.ndarray:
    """The rows of a ``global_batch``-row batch this rank holds, the
    counterpart of ``batch_sharding``: the batch splits evenly over the
    data axes (row-major over :data:`DATA_AXES`). Under ``grad_accum =
    A`` each of the A microbatches (contiguous ``global_batch / A`` rows)
    is split so, as the JAX loop constrains its ``[A, B/A]`` reshape;
    the rows come microbatch by microbatch."""
    n = data_shards(mesh)
    if global_batch % (n * grad_accum):
        raise ValueError(
            f"global batch {global_batch} not divisible by the mesh's "
            f"{n} data shards x grad_accum={grad_accum}; adjust batch size")
    micro = global_batch // grad_accum
    per = micro // n
    r = mesh.axis_index(*DATA_AXES)
    return np.concatenate([np.arange(i * micro + r * per, i * micro + (r + 1) * per)
                           for i in range(grad_accum)])


_AMBIENT: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the ambient mesh inside the block."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> Optional[Mesh]:
    """The ambient mesh, ``None`` outside :func:`use_mesh`."""
    return _AMBIENT[-1] if _AMBIENT else None
