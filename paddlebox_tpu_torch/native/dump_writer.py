"""ctypes wrapper over the native xbox-dump TSV writer (dump_writer.cc).

Copy of ``paddlebox_tpu/native/dump_writer.py`` with the import paths
rewritten; ``dump_writer.cc`` is a verbatim copy, built into the port's
native library (``native/build.py``).  Host code only.

≙ the reference's native dump IO (SaveBase/SaveDelta through
boxps::PaddleFileMgr, box_wrapper.cc:1286): io/checkpoint.save_xbox
formats per-shard row blocks through this writer (one buffered fwrite
per ~4MB) instead of a per-row Python loop; degrades gracefully to the
Python fallback when the native build is unavailable.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from paddlebox_tpu_torch.native import build

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not build.ensure_built():
            return None
        try:
            lib = ctypes.CDLL(build.lib_path())
            lib.pbox_dump_xbox.restype = ctypes.c_longlong
            lib.pbox_dump_xbox.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong]
            lib.pbox_load_xbox.restype = ctypes.c_longlong
            lib.pbox_load_xbox.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong]
        except (OSError, AttributeError):
            # a stale prebuilt .so without this symbol must degrade to
            # the Python fallback, not crash the one caller that has one
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def dump_rows(path: str, append: bool, keys: np.ndarray, show: np.ndarray,
              click: np.ndarray, embed_w: np.ndarray,
              mf: np.ndarray) -> Optional[int]:
    """Write one block of xbox rows; returns rows written or None when the
    native library is unavailable (caller falls back).  Raises OSError on
    an IO failure."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    # f64 columns: exact for f32 inputs AND the ctr_double accessor's
    # f64 stats (an f32 round-trip could flip the 6th %.6g digit)
    show = np.ascontiguousarray(show, np.float64)
    click = np.ascontiguousarray(click, np.float64)
    embed_w = np.ascontiguousarray(embed_w, np.float64)
    mf = np.ascontiguousarray(mf, np.float32)
    n, d = mf.shape
    assert len(keys) == len(show) == len(click) == len(embed_w) == n
    wrote = lib.pbox_dump_xbox(
        path.encode(), 1 if append else 0,
        keys.ctypes.data, show.ctypes.data, click.ctypes.data,
        embed_w.ctypes.data, mf.ctypes.data, n, d)
    if wrote < 0:
        raise OSError(f"native xbox dump failed writing {path!r}")
    return int(wrote)


def load_rows(path: str, d: int):
    """Parse a whole xbox dump natively → (keys, show, click, embed_w, mf)
    arrays, or None when the native library is unavailable.  Raises
    ValueError naming the malformed line index on bad input."""
    import os
    lib = _load()
    if lib is None:
        return None
    size = os.path.getsize(path)
    buf = bytearray(size + 1)     # one allocation, NUL-terminated in place
    with open(path, "rb") as f:
        got = f.readinto(memoryview(buf)[:size])
    if got != size:
        raise OSError(f"short read loading {path!r}")
    buf[size] = 0
    upper = buf.count(b"\n", 0, size) + (
        0 if size == 0 or buf[size - 1] == 0x0A else 1)
    upper = max(upper, 1)
    keys = np.empty((upper,), np.uint64)
    show = np.empty((upper,), np.float64)
    click = np.empty((upper,), np.float64)
    embed_w = np.empty((upper,), np.float64)
    mf = np.empty((upper, max(d, 1)), np.float32)
    cbuf = (ctypes.c_char * len(buf)).from_buffer(buf)
    ret = lib.pbox_load_xbox(cbuf, size, keys.ctypes.data,
                             show.ctypes.data, click.ctypes.data,
                             embed_w.ctypes.data, mf.ctypes.data,
                             upper, d)
    if ret < 0:
        raise ValueError(
            f"malformed xbox line {-int(ret)} in {path!r} "
            f"(expected key\\tshow\\tclick\\tembed_w\\t{d} mf values)")
    n = int(ret)
    return (keys[:n], show[:n], click[:n], embed_w[:n], mf[:n])
