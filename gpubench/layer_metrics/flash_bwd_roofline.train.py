"""Kernels: the two-pass flash backward (B3 and B4 with ``flash_bwd_prep``
and ``rope_rotate``) in the traced slice, its least time over its device
time, in %."""

from gpubench.harness.readers import flash_roofline


def read(rec):
    return flash_roofline(rec, backward=True)
