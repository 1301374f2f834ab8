"""Per-rank memory arithmetic for sharded training.

Counterpart of ``kubeflow_controller_tpu/parallel/memory.py``: from a
model config, a mesh factorisation and a batch geometry, the per-device
high-water mark of a train step — fp32 master parameters, gradients and
the optimizer's two moments as their specs shard them, the
rematerialised activations and the logits peak. The parameter bytes are
exact (the port's ``param_shapes``, the same shapes ``init_params``
draws, and ``param_specs``); the activation terms are the JAX package's
upper-bound model, kept term for term so that the two plans agree byte
for byte.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from kubeflow_controller_tpu_torch.convert import tree_leaves

GiB = 1024 ** 3


def sharded_leaf_bytes(shape, dtype_bytes: int, spec,
                       axis_sizes: Dict[str, int]) -> int:
    """Per-device bytes of one array of ``shape`` placed by ``spec`` over
    mesh axes of the given sizes; uneven shards round up."""
    total = dtype_bytes
    entries = list(spec) if spec is not None else []
    for i, dim in enumerate(shape):
        div = 1
        if i < len(entries) and entries[i] is not None:
            names = entries[i]
            if isinstance(names, str):
                names = (names,)
            for name in names:
                div *= axis_sizes.get(name, 1)
        total *= math.ceil(dim / div)
    return total


@dataclass
class MemoryPlan:
    """Per-device budget, all in bytes."""

    params: int = 0
    grads: int = 0
    opt_state: int = 0
    activations: int = 0
    logits: int = 0
    mesh_axes: Dict[str, int] = field(default_factory=dict)
    global_batch: int = 0
    seq: int = 0

    @property
    def total(self) -> int:
        return (self.params + self.grads + self.opt_state
                + self.activations + self.logits)

    def fits(self, hbm_gib_per_chip: float, headroom: float = 0.9) -> bool:
        return self.total <= hbm_gib_per_chip * GiB * headroom

    def rows(self):
        return [
            ("params (fp32 master)", self.params),
            ("grads", self.grads),
            ("optimizer (adam m+v)", self.opt_state),
            ("activations (remat)", self.activations),
            ("logits/loss peak", self.logits),
            ("TOTAL", self.total),
        ]

    def table(self) -> str:
        out = [f"mesh={self.mesh_axes} global_batch={self.global_batch} "
               f"seq={self.seq}"]
        for name, b in self.rows():
            out.append(f"  {name:24s} {b / GiB:7.2f} GiB")
        return "\n".join(out)


def transformer_memory_plan(cfg, mesh_axes: Dict[str, int], global_batch: int,
                            seq: Optional[int] = None,
                            optimizer_slots: int = 2, pp: bool = False) -> MemoryPlan:
    """Per-device plan for the decoder's train step at ``mesh_axes``
    (axis name -> size), as the JAX package computes it. ``pp=True``
    places the parameters by ``param_specs(cfg, pp=True)`` (a pipeline
    stage stores its block of layers), which the JAX package's plan does
    not; the activation terms stay its."""
    from kubeflow_controller_tpu_torch.models import transformer as tfm

    seq = seq or cfg.max_seq
    shapes = tree_leaves(tfm.param_shapes(cfg))
    specs = tree_leaves(tfm.param_specs(cfg, pp=pp))
    assert len(shapes) == len(specs), "specs/params tree mismatch"
    pbytes = torch.empty((), dtype=cfg.param_dtype).element_size()
    params_bytes = sum(sharded_leaf_bytes(s, pbytes, sp, mesh_axes)
                       for s, sp in zip(shapes, specs))

    batch_div = mesh_axes.get("dp", 1) * mesh_axes.get("fsdp", 1)
    b_loc = math.ceil(global_batch / batch_div)
    s_loc = math.ceil(seq / mesh_axes.get("sp", 1))
    tp = mesh_axes.get("tp", 1)
    act_bytes = torch.empty((), dtype=cfg.dtype).element_size()

    checkpoints = cfg.n_layers * b_loc * s_loc * cfg.d_model * act_bytes
    attn_width = cfg.n_heads * cfg.head_dim
    kv_width = cfg.n_kv_heads * cfg.head_dim
    in_layer = (
        b_loc * s_loc * (
            math.ceil(attn_width / tp) * 2
            + math.ceil(kv_width / tp) * 2
            + math.ceil(cfg.d_ff / tp) * 3
            + cfg.d_model * 2
        ) * act_bytes
    ) * 2
    logits = b_loc * s_loc * cfg.vocab_size * 4 * 2
    return MemoryPlan(
        params=params_bytes, grads=params_bytes,
        opt_state=optimizer_slots * params_bytes,
        activations=checkpoints + in_layer, logits=logits,
        mesh_axes=dict(mesh_axes), global_batch=global_batch, seq=seq)
