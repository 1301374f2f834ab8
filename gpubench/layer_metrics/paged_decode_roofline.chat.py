"""Kernels: the paged decode kernel (B5, ``paged_decode_mma_kernel``) in
the traced slice, its least time over its device time, in %."""

from gpubench.harness.readers import paged_decode_roofline


def read(rec):
    return paged_decode_roofline(rec)
