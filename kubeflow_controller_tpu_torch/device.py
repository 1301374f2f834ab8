"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU. A missing
card is an error, never a silent move to the CPU: a run that was meant
to measure the GPU must not report CPU numbers under a GPU's name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises ``RuntimeError`` when a CUDA
    device is asked for (explicitly or by default) and none is present;
    ``device="cpu"`` is the only way onto the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev
