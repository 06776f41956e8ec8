"""ctypes wrapper over the AUC calculator's native finalisation
(auc_finalize.cc), built into the port's native library
(``native/build.py``).  Host code only.

Its user is ``metrics.auc.AucCalculator``: at a pass's end the
bucket-error walk and the fold to coarse buckets each run as one call
over the whole float64 tables, with the Python loops' results bit for
bit.  Each function returns None when the library is unavailable, and
the calculator runs its Python loop instead.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

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
        try:
            lib = ctypes.CDLL(path)
            lib.pbox_auc_bucket_error.restype = ctypes.c_int
            lib.pbox_auc_bucket_error.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double)]
            lib.pbox_auc_fold.restype = None
            lib.pbox_auc_fold.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _tables(pos: np.ndarray, neg: np.ndarray):
    pos = np.ascontiguousarray(pos, np.float64)
    neg = np.ascontiguousarray(neg, np.float64)
    if pos.shape != neg.shape or pos.ndim != 1:
        raise ValueError(f"pos {pos.shape} and neg {neg.shape} must be "
                         "one table length")
    return pos, neg


def bucket_error(pos: np.ndarray, neg: np.ndarray, max_span: float,
                 relative_error_bound: float) -> Optional[float]:
    """The bucket error of the tables, or None when the library is
    unavailable.  Raises ValueError where the Python loop's
    ``math.sqrt`` would (negative weights)."""
    lib = _load()
    if lib is None:
        return None
    pos, neg = _tables(pos, neg)
    out = ctypes.c_double()
    if lib.pbox_auc_bucket_error(pos.ctypes.data, neg.ctypes.data,
                                 len(pos), max_span, relative_error_bound,
                                 ctypes.byref(out)):
        raise ValueError("math domain error")
    return out.value


def fold(pos: np.ndarray, neg: np.ndarray, bins: int
         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The tables folded to ``bins`` coarse buckets, or None when the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pos, neg = _tables(pos, neg)
    out_pos = np.empty((bins,), np.float64)
    out_neg = np.empty((bins,), np.float64)
    lib.pbox_auc_fold(pos.ctypes.data, neg.ctypes.data, len(pos), bins,
                      out_pos.ctypes.data, out_neg.ctypes.data)
    return out_pos, out_neg
