"""Walk a parameter tree, and carry one between the JAX package and the port.

The JAX package's ``init_params`` returns a nested dict of arrays with
every layer stacked on a leading ``[L, ...]`` axis; the port keeps that
layout (``models/transformer.py``). Tests hand the JAX tree across as
numpy arrays (``jax.device_get``), so both packages run the same
weights. Only numpy crosses: this module imports nothing of JAX.
:func:`tree_leaves` flattens a tree in sorted-key order (the order of
``jax.tree.leaves`` on a dict tree, and the optimizer's), and
:func:`tree_unflatten` puts such a list back into a tree's shape.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional

import numpy as np
import torch

from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device


def tree_leaves(tree) -> List[Any]:
    """A nested dict's leaves in sorted-key order, whatever order its
    dicts were built in."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves) -> dict:
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s structure."""
    it = iter(leaves)

    def conv(t):
        if isinstance(t, Mapping):
            return {k: conv(t[k]) for k in sorted(t)}
        return next(it)

    return conv(tree)


def params_from_numpy(
    tree: Mapping[str, Any], device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``. Floating arrays are cast to ``dtype`` when given (kept as
    they are otherwise); integer arrays keep their type."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, copy=True, order="C"))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)


def params_to_numpy(tree: Mapping[str, Any]) -> dict:
    """The inverse of :func:`params_from_numpy`: nested dict of tensors
    (any device, any dtype) -> the same nested dict of numpy arrays,
    bfloat16 widened to float32 (numpy has no bfloat16)."""
    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    return conv(tree)
