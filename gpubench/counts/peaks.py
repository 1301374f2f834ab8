"""Published peaks of the chips the benchmark runs on.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the card's
full 700 W power limit: a card set lower runs slower under load, so every
result prints the card's ``power.limit`` beside these.
"""

H100 = {
    "bf16_flops": 989e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}


def peaks_for(device_name: str) -> dict:
    """The peaks of the card named ``device_name``; a card the table does
    not hold has no peaks, and its shares are not computed."""
    if "H100" in device_name:
        return H100
    raise KeyError(f"no published peaks for {device_name!r}")


def bound_s(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of the operations
    at the bf16 peak and the bytes at the HBM peak."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
