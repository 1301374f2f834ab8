"""Walk a parameter tree, and carry one between the JAX package and the port.

The JAX package's ``init_params`` returns a nested dict of arrays with
every layer stacked on a leading ``[L, ...]`` axis; the port keeps that
layout (``models/transformer.py``). Tests hand the JAX tree across as
numpy arrays (``jax.device_get``), so both packages run the same
weights. Only numpy crosses: this module imports nothing of JAX.

The other models: MNIST's flax ``Dense`` trees (``kernel [in, out]``)
and BERT's dict (layers stacked on ``[L, ...]``) keep their layout, so
:func:`params_from_numpy` carries them; ResNet's flax ``params`` and
``batch_stats`` need the conv kernels moved from HWIO to OIHW
(:func:`resnet_params_from_flax`, and back, :func:`resnet_params_to_flax`).
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


def mnist_params_from_flax(variables: Mapping[str, Any],
                           device: DeviceLike = None) -> dict:
    """A flax MNIST model's ``{"params": {...}}`` (numpy) -> the port's
    tree (``models/mnist.py``: the same names and layout)."""
    return params_from_numpy(variables.get("params", variables), device)


def _map_kernels(tree, fn):
    if isinstance(tree, Mapping):
        return {k: (fn(v) if k == "kernel" and np.ndim(v) == 4
                    else _map_kernels(v, fn)) for k, v in tree.items()}
    return tree


def resnet_params_from_flax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any],
                            device: DeviceLike = None):
    """A flax ResNet's ``params`` and ``batch_stats`` (numpy) -> the
    port's ``(params, batch_stats)`` (``models/resnet.py``): conv kernels
    HWIO -> OIHW, the BatchNorm ``scale``/``bias`` and ``mean``/``var``
    and the dense head as they are."""
    oihw = _map_kernels(params, lambda k: np.transpose(np.asarray(k), (3, 2, 0, 1)))
    return (params_from_numpy(oihw, device),
            params_from_numpy(batch_stats, device))


def resnet_params_to_flax(params: Mapping[str, Any],
                          batch_stats: Mapping[str, Any]):
    """The inverse of :func:`resnet_params_from_flax`: numpy trees in
    flax's layout (conv kernels OIHW -> HWIO)."""
    hwio = _map_kernels(params_to_numpy(params),
                        lambda k: np.ascontiguousarray(np.transpose(k, (2, 3, 1, 0))))
    return hwio, params_to_numpy(batch_stats)
