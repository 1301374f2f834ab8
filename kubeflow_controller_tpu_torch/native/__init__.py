"""ctypes loader for the C++ runtime core (``csrc/tpujob_native.cc``).

The reference's reconcile machinery is compiled native code (Go); here the
hot-path structures — the rate-limited workqueue, the expectations cache
and the object index with its no-op fingerprint probe — have a C++
implementation behind the same Python interface. Loading policy:

1. build the library at first use with the host C++ compiler (``$CXX``,
   else ``g++``, else ``c++``) into ``_build/`` inside the package (listed
   in ``.gitignore``), under a name keyed by the hash of the source and
   the flags, so an edited source never loads a stale library; the build
   writes a temporary name and ``os.replace``-s it into place, so
   concurrent processes see all of it or none;
2. if it cannot be built or loaded, :func:`load` returns None and
   :func:`load_error` says why: the consumers that were not asked for the
   native core (``use_native_index=None``) run the behaviour-identical
   pure-Python implementations, and one that was (``True``) raises.

``TPUJOB_NATIVE=0`` forces the Python path (used by tests to cover both).

Counterpart of ``kubeflow_controller_tpu/native/__init__.py``, which loads a
library built by ``csrc/Makefile`` next to itself; the port builds its own
copy of the source and imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "tpujob_native.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_error = ""


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_char_p = ctypes.c_char_p
    c_void_p = ctypes.c_void_p
    c_double = ctypes.c_double
    c_int = ctypes.c_int

    lib.wq_new.restype = c_void_p
    lib.wq_new.argtypes = [c_double, c_double]
    lib.wq_free.argtypes = [c_void_p]
    lib.wq_add.argtypes = [c_void_p, c_char_p]
    lib.wq_add_after.argtypes = [c_void_p, c_char_p, c_double]
    lib.wq_add_rate_limited.argtypes = [c_void_p, c_char_p]
    lib.wq_forget.argtypes = [c_void_p, c_char_p]
    lib.wq_num_requeues.restype = c_int
    lib.wq_num_requeues.argtypes = [c_void_p, c_char_p]
    lib.wq_get.restype = c_int
    lib.wq_get.argtypes = [c_void_p, c_double, c_char_p, c_int]
    lib.wq_done.argtypes = [c_void_p, c_char_p]
    lib.wq_shutdown.argtypes = [c_void_p]
    lib.wq_len.restype = c_int
    lib.wq_len.argtypes = [c_void_p]
    lib.wq_empty_and_idle.restype = c_int
    lib.wq_empty_and_idle.argtypes = [c_void_p]
    lib.wq_backoff_delay.restype = c_double
    lib.wq_backoff_delay.argtypes = [c_double, c_double, c_char_p, c_int]

    lib.exp_new.restype = c_void_p
    lib.exp_new.argtypes = [c_double]
    lib.exp_free.argtypes = [c_void_p]
    lib.exp_satisfied.restype = c_int
    lib.exp_satisfied.argtypes = [c_void_p, c_char_p]
    lib.exp_expect_creations.argtypes = [c_void_p, c_char_p, c_int]
    lib.exp_expect_deletions.argtypes = [c_void_p, c_char_p, c_int]
    lib.exp_creation_observed.argtypes = [c_void_p, c_char_p]
    lib.exp_deletion_observed.argtypes = [c_void_p, c_char_p]
    lib.exp_delete.argtypes = [c_void_p, c_char_p]
    lib.exp_pending.restype = c_int
    lib.exp_pending.argtypes = [
        c_void_p, c_char_p,
        ctypes.POINTER(c_int), ctypes.POINTER(c_int),
    ]

    c_longlong = ctypes.c_longlong
    lib.oix_new.restype = c_void_p
    lib.oix_new.argtypes = []
    lib.oix_free.argtypes = [c_void_p]
    lib.oix_upsert.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, c_longlong, c_longlong,
        c_char_p,
    ]
    lib.oix_remove.argtypes = [c_void_p, c_char_p, c_char_p]
    lib.oix_count.restype = c_int
    lib.oix_count.argtypes = [c_void_p, c_char_p]
    lib.oix_bucket_count.restype = c_int
    lib.oix_bucket_count.argtypes = [c_void_p, c_char_p, c_char_p]
    lib.oix_bucket_keys.restype = c_int
    lib.oix_bucket_keys.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, c_char_p, c_int,
    ]
    lib.oix_fp_probe.restype = c_int
    lib.oix_fp_probe.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, c_char_p, c_char_p,
        c_char_p, c_char_p, c_char_p, c_char_p, c_char_p,
    ]
    lib.oix_fp_commit.argtypes = [c_void_p, c_char_p]
    lib.oix_fp_forget.argtypes = [c_void_p, c_char_p]
    lib.oix_fp_counts.argtypes = [
        c_void_p, ctypes.POINTER(c_longlong), ctypes.POINTER(c_longlong),
    ]
    lib.oix_slice_set.argtypes = [c_void_p, c_char_p, c_char_p, c_int]
    lib.oix_slice_clear.argtypes = [c_void_p, c_char_p, c_char_p]
    lib.oix_fp_probe2.restype = c_int
    lib.oix_fp_probe2.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, c_char_p, c_char_p,
        c_char_p, c_char_p, c_char_p, c_char_p, c_char_p, c_int,
    ]
    return lib


def compiler() -> str:
    for cxx in (os.environ.get("CXX", ""), "g++", "c++"):
        found = shutil.which(cxx) if cxx else None
        if found:
            return found
    raise RuntimeError("no host C++ compiler (set $CXX, or install g++): the "
                       f"native core is built from {SOURCE} at first use")


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"tpujob_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this source's build already exists;
    returns its path. Raises RuntimeError with the compiler's output on a
    failed build."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        out = subprocess.run(
            [compiler(), *CXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"],
            capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed ({out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_attempted, _error
    if os.environ.get("TPUJOB_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            _lib = _configure(ctypes.CDLL(build()))
        except (OSError, AttributeError, RuntimeError,
                subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            _lib = None
        return _lib


def available() -> bool:
    return load() is not None


def load_error() -> str:
    """Why the library is unavailable: ``TPUJOB_NATIVE=0``, or the build's
    or the loader's error; empty when it loaded (or was never asked for)."""
    if os.environ.get("TPUJOB_NATIVE", "1") == "0":
        return "TPUJOB_NATIVE=0"
    return _error
