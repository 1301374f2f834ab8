"""Kernels: the flash forward (B1: ``rope_rotate`` and
``flash_fwd_wgmma``) in the traced slice, its least time over its
device time, in %."""

from gpubench.harness.readers import flash_roofline


def read(rec):
    return flash_roofline(rec, backward=False)
