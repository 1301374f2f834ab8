"""Pipeline parallelism: a GPipe schedule over the mesh's pp axis.

Counterpart of ``kubeflow_controller_tpu/parallel/pipeline.py``. Stage
``p`` is the pp rank ``p`` and holds layers ``[p L/P, (p+1) L/P)``
(``param_specs(cfg, pp=True)`` shards the stacked layer leaves' leading
axis over pp). :func:`gpipe` runs the reference's schedule: ``M + P -
1`` ticks, in each of which every stage runs its layers on the
microbatch it holds (stage 0 takes microbatch ``t``, zeros once the
batch is drained; the warm-up and cool-down ticks compute on zeros and
their outputs are discarded) and hands its output to the next stage
with :func:`~parallel.collectives.ring_shift` (JAX's ``ppermute`` with
``perm = [(i, (i + 1) % P)]``). The last stage's outputs come back to
every stage through a masked sum over pp, so the head downstream runs
on every stage as on one device.

The backward is autograd's: the shift's backward is the reverse shift
and the masked sum's is a sum over pp. Each rank's loss is the whole
batch's, the same on every stage, and the train loop divides the
gradients by the loss ranks (``mesh.LOSS_AXES``), so the last stage is
handed the gradient of one global loss. Every rank issues the shifts,
and the fsdp and tp collectives inside a stage, in the same order in
the forward, the recompute and the backward: stage 0 selects its feed
with ``torch.where``, so the shift it receives each tick stays in its
graph (with a zero gradient) as it does in the JAX package's. The last
tick's shift, whose result the JAX loop discards, is issued by no rank.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_controller_tpu_torch.parallel.collectives import axis_sum, ring_shift
from kubeflow_controller_tpu_torch.parallel.mesh import Mesh, current_mesh


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def gpipe(
    stage_fn: Callable[..., torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    n_microbatches: int,
    axis: str = "pp",
    remat: bool = True,
    extras: Any = None,
) -> torch.Tensor:
    """Run ``x [B, ...]`` through the P stages of the ambient mesh's
    ``axis``. ``stage_fn(stage_params, x_mb)`` (``stage_fn(stage_params,
    x_mb, extra_mb)`` with ``extras``) applies this stage's layers to one
    microbatch. ``extras``: a tuple of batch-leading side inputs (``None``
    entries allowed) that the stage holding microbatch ``t - p`` indexes
    for itself (clamped into range on the warm-up and cool-down ticks).
    ``remat``: the stage function runs under a checkpoint (its forward
    again in the backward); the shift stays outside it. ``B`` must divide
    into ``n_microbatches``."""
    mesh = current_mesh()
    p_idx = mesh.coords[axis] if mesh is not None else 0
    p_num = pp_stage_count(mesh)
    b = x.shape[0]
    assert b % n_microbatches == 0, (
        f"batch {b} must divide into {n_microbatches} microbatches")
    M = n_microbatches
    xs = x.reshape(M, b // M, *x.shape[1:])
    exs = _tree_map(lambda e: e.reshape(M, b // M, *e.shape[1:]), extras)
    fn = stage_fn
    if remat:
        def fn(*args):
            return checkpoint(stage_fn, *args, use_reentrant=False)
    first = torch.tensor(p_idx == 0, device=x.device)
    n_ticks = M + p_num - 1
    state = torch.zeros_like(xs[0])
    outs = []
    for t in range(n_ticks):
        feed = xs[min(t, M - 1)] if t < M else torch.zeros_like(xs[0])
        inp = torch.where(first, feed, state)
        if exs is None:
            y = fn(stage_params, inp)
        else:
            mb = min(max(t - p_idx, 0), M - 1)
            y = fn(stage_params, inp, _tree_map(lambda e: e[mb], exs))
        if t >= p_num - 1:
            outs.append(y)
        if t + 1 < n_ticks:
            state = ring_shift(y, axis, 1)
    # The last stage's ticks [P-1, P-1+M) are the M outputs: replicated
    # over the stages by a masked sum.
    out = torch.stack(outs)
    out = axis_sum(torch.where(torch.tensor(p_idx == p_num - 1, device=x.device),
                               out, torch.zeros_like(out)), axis)
    return out.reshape(b, *x.shape[1:])


def pp_stage_count(mesh: Optional[Mesh] = None) -> int:
    """Size of the given (or ambient) mesh's pp axis; 1 without one."""
    mesh = mesh or current_mesh()
    return 1 if mesh is None else mesh.shape["pp"]
