"""Scheduler: the 90th percentile of the time the requests due in the
window waited from their due instant to admission into a slot (the
engine's admit time), in ms. Moves ``tpot_p90_ms``: a request waits for
the step that prefills it, and that step stalls every decoding slot."""

from gpubench.harness.readers import queue_wait_p90_ms


def read(rec):
    return queue_wait_p90_ms(rec)
