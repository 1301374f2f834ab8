"""Carry a parameter tree from the JAX package into the port.

The JAX package's ``init_params`` returns a nested dict of arrays with
every layer stacked on a leading ``[L, ...]`` axis; the port keeps that
layout (``models/transformer.py``). Tests hand the JAX tree across as
numpy arrays (``jax.device_get``), so both packages run the same
weights. Only numpy crosses: this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from kubeflow_controller_tpu_torch.device import DeviceLike, resolve_device


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
