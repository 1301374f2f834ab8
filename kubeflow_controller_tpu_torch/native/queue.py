"""Python faces of the C++ workqueue/expectations (same interfaces as
``controller.workqueue.RateLimitingQueue`` / ``controller.expectations.
ControllerExpectations``; see csrc/tpujob_native.cc for semantics).

Counterpart of ``kubeflow_controller_tpu/native/queue.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import ctypes
from typing import Hashable, Optional

from kubeflow_controller_tpu_torch import native

_KEY_BUF = 4096


def _b(item: Hashable) -> bytes:
    return item.encode() if isinstance(item, str) else str(item).encode()


class NativeRateLimitingQueue:
    def __init__(self, base_delay: float = 0.005, max_delay: float = 60.0):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.wq_new(base_delay, max_delay)

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.wq_free(h)
            self._h = None

    def add(self, item: Hashable) -> None:
        self._lib.wq_add(self._h, _b(item))

    def add_after(self, item: Hashable, delay: float) -> None:
        self._lib.wq_add_after(self._h, _b(item), delay)

    def add_rate_limited(self, item: Hashable) -> None:
        self._lib.wq_add_rate_limited(self._h, _b(item))

    def forget(self, item: Hashable) -> None:
        self._lib.wq_forget(self._h, _b(item))

    def num_requeues(self, item: Hashable) -> int:
        return self._lib.wq_num_requeues(self._h, _b(item))

    def get(self, timeout: Optional[float] = None) -> Optional[str]:
        buf = ctypes.create_string_buffer(_KEY_BUF)
        n = self._lib.wq_get(
            self._h, -1.0 if timeout is None else timeout, buf, _KEY_BUF
        )
        if n == -1:
            return None
        if n < -1:
            # -2: the C++ side already popped the key into its processing
            # set but it didn't fit the buffer — treating this as "empty"
            # would silently lose the item and wedge empty_and_idle().
            raise RuntimeError(
                f"workqueue key exceeds {_KEY_BUF - 1} bytes; item lost"
            )
        return buf.raw[:n].decode()

    def done(self, item: Hashable) -> None:
        self._lib.wq_done(self._h, _b(item))

    def shutdown(self) -> None:
        self._lib.wq_shutdown(self._h)

    def __len__(self) -> int:
        return self._lib.wq_len(self._h)

    def empty_and_idle(self) -> bool:
        return bool(self._lib.wq_empty_and_idle(self._h))


class NativeControllerExpectations:
    def __init__(self, ttl: float = 300.0):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.exp_new(ttl)

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.exp_free(h)
            self._h = None

    def satisfied(self, key: str) -> bool:
        return bool(self._lib.exp_satisfied(self._h, _b(key)))

    def expect_creations(self, key: str, count: int) -> None:
        self._lib.exp_expect_creations(self._h, _b(key), count)

    def expect_deletions(self, key: str, count: int) -> None:
        self._lib.exp_expect_deletions(self._h, _b(key), count)

    def creation_observed(self, key: str) -> None:
        self._lib.exp_creation_observed(self._h, _b(key))

    def deletion_observed(self, key: str) -> None:
        self._lib.exp_deletion_observed(self._h, _b(key))

    def delete_expectations(self, key: str) -> None:
        self._lib.exp_delete(self._h, _b(key))

    def pending(self, key: str):
        adds = ctypes.c_int()
        dels = ctypes.c_int()
        if not self._lib.exp_pending(
            self._h, _b(key), ctypes.byref(adds), ctypes.byref(dels)
        ):
            return None
        return (adds.value, dels.value)


def native_backoff_delay(
    base_delay: float, max_delay: float, item: Hashable, failures: int
) -> float:
    """The C++ core's backoff computation (parity-tested against
    ``controller.workqueue.backoff_delay``)."""
    lib = native.load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib.wq_backoff_delay(base_delay, max_delay, _b(item), failures)


def make_queue(base_delay: float = 0.005, max_delay: float = 60.0):
    """Best queue available: C++ when loadable, else the Python one."""
    if native.available():
        return NativeRateLimitingQueue(base_delay, max_delay)
    from kubeflow_controller_tpu_torch.controller.workqueue import RateLimitingQueue

    return RateLimitingQueue(base_delay, max_delay)


def make_expectations(ttl: float = 300.0):
    if native.available():
        return NativeControllerExpectations(ttl)
    from kubeflow_controller_tpu_torch.controller.expectations import (
        ControllerExpectations,
    )

    return ControllerExpectations(ttl)
