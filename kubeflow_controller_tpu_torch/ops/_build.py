"""Build and load the port's CUDA kernels.

``csrc/paged_attention.cu`` has a plain C interface, so it compiles with
``nvcc`` alone (no PyTorch headers: seconds, not minutes) into a shared
library that :func:`load` opens with ``ctypes``. The build happens at
first use, into ``_build/`` inside the package (listed in
``.gitignore``), under a name keyed by the source's and flags' hash, so
an edited source never loads a stale library. Nothing here runs at
import time: the CPU tests import every module of the port on a machine
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "paged_attention.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        f"{SOURCE} at first use and need the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"paged_attention-{h.hexdigest()[:16]}.so")


def build() -> Tuple[str, float, str]:
    """Compile the kernels unless this source's library already exists.
    Returns ``(path, seconds spent compiling, compiler log)``; the log
    carries ``ptxas``'s register and shared-memory report."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
    return path, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32
    bits)."""
    lib = ctypes.CDLL(build()[0])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kfc_paged_decode.argtypes = [P] * 8 + [I] * 8 + [F, I, I, P]
    lib.kfc_paged_decode.restype = I
    lib.kfc_paged_chunk.argtypes = [P] * 10 + [I] * 9 + [F, I, I, P]
    lib.kfc_paged_chunk.restype = I
    return lib
