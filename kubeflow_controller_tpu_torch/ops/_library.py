"""The kernels' entries as PyTorch operators, ``torch.ops.kfc.*``.

Each ``ctypes`` entry of ``ops/_build.py`` that a train step launches is
an operator of the ``kfc`` namespace with three implementations, and the
dispatcher picks one by the operands' device; the wrappers in
``ops/flash_attention.py`` and ``ops/quant_fused.py`` no longer do:

* ``CUDA`` checks the operands and launches the kernel (the wrapper's
  launch count is kept there, and only there);
* ``CPU`` is the kernel's plain PyTorch version;
* the fake (``torch.library.register_fake``) allocates what the CUDA
  implementation allocates and computes nothing, so that a train step
  traced on fake tensors (``parallel/aot_check.py``) takes the kernel
  route's memory, whatever device the fake tensors name;
* a meta tensor raises: it runs no kernel and no plain version
  (``register_fake`` serves the ``Meta`` key with the fake, which here
  computes only for a ``FakeTensor``).

The operators are registered through ``torch.library.Library.impl``,
not ``torch.library.custom_op``, whose Python layers add host time to
every call: ``chip_smoke.py`` times one call of each form against the
bare ``ctypes`` call. Nothing is launched or built at import: the
kernels load at a CUDA implementation's first call.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor

LIB = torch.library.Library("kfc", "FRAGMENT")


def define(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define ``kfc::<schema>`` with its CPU, CUDA and fake
    implementations; returns the operator's overload."""
    name = schema.split("(", 1)[0]

    def fake_only(*args, **kwargs):
        if not any(isinstance(a, FakeTensor) for a in args):
            raise RuntimeError(
                f"kfc::{name} runs its CUDA kernel on cuda tensors and its "
                "plain version on cpu tensors (got meta tensors)")
        return fake(*args, **kwargs)

    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"kfc::{name}", fake_only, lib=LIB)
    return getattr(torch.ops.kfc, name).default
