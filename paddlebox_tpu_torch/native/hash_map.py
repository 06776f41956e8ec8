"""ctypes wrapper over the native uint64→row hash (hash_shard.cc).

Copy of ``paddlebox_tpu/native/hash_map.py`` with the import paths
rewritten; ``keys_by_row`` comes from the JAX package's
``slot_parser.NativeHashShard``, which this port folds into this one
class.  Its user is PassKeyMapper (ps/embedding.py): pass-scope key→row
translation — the once-per-pass DedupKeysAndFillIdx equivalent
(box_wrapper_impl.h:129), threaded over read-only probes.  The port's
host table keeps its sorted-view index (ps/host_table.py says why).

Every uint64 key gets its own row, the all-ones key (2^64 − 1) too:
hash_shard.cc keeps that key, its empty-slot marker, beside the slots.
The JAX package's copy of the library neither stores nor finds it.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from paddlebox_tpu_torch.native import build

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # the build (under its own lock) and the library's path, which hashes
    # the sources, come before the loader's lock
    if not build.ensure_built():
        return None
    path = build.lib_path()
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(path)
        lib.pbox_hash_new.restype = ctypes.c_void_p
        lib.pbox_hash_new.argtypes = [ctypes.c_int64]
        lib.pbox_hash_free.restype = None
        lib.pbox_hash_free.argtypes = [ctypes.c_void_p]
        lib.pbox_hash_size.restype = ctypes.c_int64
        lib.pbox_hash_size.argtypes = [ctypes.c_void_p]
        for name in ("pbox_hash_upsert", "pbox_hash_find",
                     "pbox_hash_keys", "pbox_hash_find_rows1_i32"):
            getattr(lib, name).restype = None
        lib.pbox_hash_upsert.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.pbox_hash_find.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.pbox_hash_keys.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.pbox_hash_find_rows1_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeKeyHash:
    """uint64 key → dense row id (insertion order), native open addressing."""

    def __init__(self, capacity_hint: int = 16):
        lib = _load()
        if lib is None:
            raise RuntimeError("native hash library unavailable")
        self._lib = lib
        self._h = lib.pbox_hash_new(int(capacity_hint))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pbox_hash_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.pbox_hash_size(self._h))

    def upsert(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty((len(keys),), np.int64)
        self._lib.pbox_hash_upsert(
            self._h, keys.ctypes.data_as(ctypes.c_void_p), len(keys),
            out.ctypes.data_as(ctypes.c_void_p))
        return out

    def find(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty((len(keys),), np.int64)
        self._lib.pbox_hash_find(
            self._h, keys.ctypes.data_as(ctypes.c_void_p), len(keys),
            out.ctypes.data_as(ctypes.c_void_p))
        return out

    def keys_by_row(self) -> np.ndarray:
        """Every stored key, in insertion (row) order."""
        out = np.empty((len(self),), np.uint64)
        self._lib.pbox_hash_keys(self._h, out.ctypes.data_as(ctypes.c_void_p))
        return out

    def find_rows1_i32(self, keys: np.ndarray,
                       n_threads: Optional[int] = None) -> np.ndarray:
        """key → insertion-row + 1; 0 for missing and for key 0 (the
        reserved zero-embedding row).  Threaded (read-only probes)."""
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty((len(keys),), np.int32)
        self._lib.pbox_hash_find_rows1_i32(
            self._h, keys.ctypes.data_as(ctypes.c_void_p), len(keys),
            out.ctypes.data_as(ctypes.c_void_p), int(n_threads))
        return out
