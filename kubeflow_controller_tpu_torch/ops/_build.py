"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface, so each compiles with
``nvcc`` alone (no PyTorch headers: seconds, not minutes). The sources
compile in parallel, one ``nvcc`` each, and link into one shared library
that :func:`load` opens with ``ctypes``. The build happens at first use,
into ``_build/`` inside the package (listed in ``.gitignore``), under a
name keyed by the hash of every source, header and the flags, so an edited
source never loads a stale library. Nothing here runs at import time:
the CPU tests import every module of the port on a machine with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
HEADERS = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh"))))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
        f"{os.path.dirname(SOURCES[0])} at first use and need the CUDA "
        "toolkit")


def library_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"kernels-{h.hexdigest()[:16]}.so")


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build() -> Tuple[str, float, str]:
    """Compile the kernels unless this set of sources' library already
    exists. Returns ``(path, seconds spent compiling and linking,
    compiler log)``; the log carries ``ptxas``'s register and
    shared-memory report for every kernel."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{tag}.o")
            for s in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, p.returncode, out) for s, p, out in zip(SOURCES, procs, logs)
              if p.returncode != 0]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{s} ({rc}):\n{out}" for s, rc, out in failed))
        tmp = f"{path}.{tag}"
        link = _run([nvcc, "-shared", "-o", tmp, *objs])
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return path, time.perf_counter() - t0, "".join(logs)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32
    bits)."""
    lib = ctypes.CDLL(build()[0])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "kfc_paged_decode": [P] * 8 + [I] * 8 + [F, I, I, P],
        "kfc_paged_chunk": [P] * 10 + [I] * 9 + [F, I, I, P],
        "kfc_flash_fwd": [P] * 8 + [I] * 5 + [F, I, P],
        "kfc_rope_rotate": [P] * 6 + [I] * 4 + [P],
        "kfc_flash_bwd_kv": [P] * 12 + [I] * 5 + [F, I, P],
        "kfc_flash_bwd_dq": [P] * 10 + [I] * 5 + [F, I, P],
        "kfc_int8_quantize_rows": [P] * 3 + [I] * 2 + [P],
        "kfc_int8_matmul": [P] * 5 + [I] * 3 + [P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    return lib
