"""Model step: the model FLOPs of the prompt and decode tokens the traced
slice processed, over the slice, as a share of the bf16 peak, in %."""

from gpubench.harness.readers import serve_mfu


def read(rec):
    return serve_mfu(rec)
