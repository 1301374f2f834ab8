"""Model: the model FLOPs of the traced slice's steps (6 N a token with
the head and no embedding, attention over the rows' real documents,
no recompute) over the slice, as a share of the bf16 peak, in %."""

from gpubench.harness.readers import train_mfu


def read(rec):
    return train_mfu(rec)
