"""Device: the share of the traced slice in which no operation ran on
the card (one less the union of the device intervals), in %."""

from gpubench.harness.readers import idle_share


def read(rec):
    return idle_share(rec)
