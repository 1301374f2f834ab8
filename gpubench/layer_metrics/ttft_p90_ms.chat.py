"""Scheduler: the 90th percentile of the time from each request's due
instant to its first token, over the requests due before the traced slice,
in ms. Moves ``tpot_p90_ms``: the prefill that a first token waits for
stalls every decoding slot."""

from gpubench.harness.readers import ttft_p90_ms


def read(rec):
    return ttft_p90_ms(rec)
