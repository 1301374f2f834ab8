"""Python face of the C++ object index (csrc/tpujob_native.cc, oix_*).

One ``NativeObjectIndex`` is shared by every ``ObjectStore`` in a cluster:
each store mirrors its sync-relevant state (uid, resourceVersion,
generation, indexed labels) into it write-through, and the controller's
no-op-sync fingerprint probe runs entirely inside the native core — a
steady resync touches zero Python object traversals. The Python store
remains authoritative; see docs/watch_pipeline.md ("Native mirror").

Counterpart of ``kubeflow_controller_tpu/native/objindex.py``; the port keeps its own
copy (it imports nothing of the JAX package).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

from kubeflow_controller_tpu_torch import native

_BUCKET_BUF = 1 << 20


def _b(s) -> bytes:
    # Hot-path callers (the controller's per-sync probe) pre-encode their
    # constant arguments; pass bytes through untouched.
    return s if isinstance(s, bytes) else s.encode()


def pack_labels(labels: Optional[Dict[str, str]]) -> bytes:
    """``k\\x1fv`` pairs joined by ``\\x1e`` (both bytes are illegal in
    Kubernetes label keys/values, so the packing is unambiguous)."""
    if not labels:
        return b""
    return "\x1e".join(f"{k}\x1f{v}" for k, v in labels.items()).encode()


class NativeObjectIndex:
    def __init__(self):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.oix_new()

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.oix_free(h)
            self._h = None

    # -- write-through mirror (called by ObjectStore under its lock) --------

    def upsert(
        self,
        kind: str,
        key: str,
        uid: str,
        rv: int,
        generation: int,
        labels: Optional[Dict[str, str]],
    ) -> None:
        self._lib.oix_upsert(
            self._h, _b(kind), _b(key), _b(uid), rv, generation,
            pack_labels(labels),
        )

    def remove(self, kind: str, key: str) -> None:
        self._lib.oix_remove(self._h, _b(kind), _b(key))

    # -- introspection (gauges + parity tests) ------------------------------

    def count(self, kind: str) -> int:
        return self._lib.oix_count(self._h, _b(kind))

    def bucket_count(self, kind: str, label_key: str) -> int:
        return self._lib.oix_bucket_count(self._h, _b(kind), _b(label_key))

    def bucket(self, kind: str, label_key: str, value: str) -> List[str]:
        buf = ctypes.create_string_buffer(_BUCKET_BUF)
        n = self._lib.oix_bucket_keys(
            self._h, _b(kind), _b(label_key), _b(value), buf, _BUCKET_BUF
        )
        if n < 0:
            raise RuntimeError("bucket exceeds buffer")
        if n == 0:
            return []
        return buf.raw[:n].decode().split("\n")

    # -- fingerprint probe/commit (called by Controller.sync) ---------------

    def fp_probe(
        self,
        job_key: str,
        ident: str,
        namespace: str,
        kind_a: str,
        label_key_a: str,
        label_val_a: str,
        kind_b: str,
        label_key_b: str,
        label_val_b: str,
        health: str,
    ) -> bool:
        return bool(
            self._lib.oix_fp_probe(
                self._h, _b(job_key), _b(ident), _b(namespace), _b(kind_a),
                _b(label_key_a), _b(label_val_a), _b(kind_b),
                _b(label_key_b), _b(label_val_b), _b(health),
            )
        )

    # -- slice-health mirror (written through by cluster/slices.SlicePool) --

    def slice_set(self, holder: str, name: str, healthy: bool) -> None:
        self._lib.oix_slice_set(self._h, _b(holder), _b(name),
                                1 if healthy else 0)

    def slice_clear(self, holder: str, name: str) -> None:
        self._lib.oix_slice_clear(self._h, _b(holder), _b(name))

    def fp_probe_mirrored(
        self,
        job_key: str,
        ident: str,
        namespace: str,
        kind_a: str,
        label_key_a: str,
        label_val_a: str,
        kind_b: str,
        label_key_b: str,
        label_val_b: str,
        health_uid: str,
        want_health: bool,
    ) -> bool:
        """fp_probe with the slice-health term composed natively from the
        mirror (keyed by the job uid) — the steady probe runs without any
        Python traversal of the slice pool."""
        return bool(
            self._lib.oix_fp_probe2(
                self._h, _b(job_key), _b(ident), _b(namespace), _b(kind_a),
                _b(label_key_a), _b(label_val_a), _b(kind_b),
                _b(label_key_b), _b(label_val_b), _b(health_uid),
                1 if want_health else 0,
            )
        )

    def fp_commit(self, job_key: str) -> None:
        self._lib.oix_fp_commit(self._h, _b(job_key))

    def fp_forget(self, job_key: str) -> None:
        self._lib.oix_fp_forget(self._h, _b(job_key))

    def fp_counts(self) -> Tuple[int, int]:
        hits = ctypes.c_longlong()
        misses = ctypes.c_longlong()
        self._lib.oix_fp_counts(self._h, ctypes.byref(hits),
                                ctypes.byref(misses))
        return (hits.value, misses.value)


def make_object_index() -> Optional[NativeObjectIndex]:
    """A shared native index, or None when the library is unavailable (the
    caller falls back to the pure-Python fingerprint/label paths)."""
    if native.available():
        return NativeObjectIndex()
    return None
