"""Graceful-shutdown signal handling.

Parity with the reference's ``pkg/util/signals`` (``signals.go:26-40``):
first SIGINT/SIGTERM sets a stop event so the controller can drain and
release cleanly; a second signal hard-exits (exit code 1) for operators who
really mean it.

Counterpart of ``kubeflow_controller_tpu/util/signals.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Iterable

_handler_installed = False

SHUTDOWN_SIGNALS = (signal.SIGINT, signal.SIGTERM)


def setup_signal_handler(
    signals: Iterable[signal.Signals] = SHUTDOWN_SIGNALS,
) -> threading.Event:
    """Install the two-strike handler; returns the stop event. Callable only
    once per process (like the reference's onlyOneSignalHandler channel
    trick, ``signals.go:21-24``)."""
    global _handler_installed
    if _handler_installed:
        raise RuntimeError("setup_signal_handler may only be called once")
    _handler_installed = True

    stop = threading.Event()

    def handle(signum, frame):
        if stop.is_set():
            os._exit(1)        # second signal: hard exit
        stop.set()

    for s in signals:
        signal.signal(s, handle)
    return stop
