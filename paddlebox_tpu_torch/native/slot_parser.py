"""ctypes wrapper over the native MultiSlot parser (slot_parser.cc).

Copy of ``paddlebox_tpu/native/slot_parser.py`` with the import paths
rewritten, the parser-plugin override of the parse entry included
(``data_feed.ParserPluginManager`` sets ``_lib`` / ``_entry`` to a
dlopen'd library's symbol).  Left out: ``NativeHashShard``, whose one
extra method, ``keys_by_row``, lives on ``hash_map.NativeKeyHash``.

The block it returns equals ``data_feed.SlotParser``'s bit for bit
(tests/test_torch_native.py).  Where the two differ is on bad input: a
slot with a count of 0 or below, or a record cut short, is a parse
error here (``ValueError`` with the parser's status), where the Python
parser accepts an empty slot.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.native import build
from paddlebox_tpu_torch.utils.monitor import stat_add

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
        lib.pbox_parse_block.restype = ctypes.c_void_p
        lib.pbox_parse_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        lib.pbox_slot_total.restype = ctypes.c_int64
        lib.pbox_slot_total.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        for name in ("pbox_fill_slot_u64", "pbox_fill_slot_f32"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                           ctypes.c_void_p, ctypes.c_void_p]
        for name in ("pbox_fill_logkeys", "pbox_fill_insids", "pbox_free"):
            getattr(lib, name).restype = None
        lib.pbox_fill_logkeys.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p]
        lib.pbox_insid_bytes.restype = ctypes.c_int64
        lib.pbox_insid_bytes.argtypes = [ctypes.c_void_p]
        lib.pbox_fill_insids.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p]
        lib.pbox_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeSlotParser:
    """Drop-in replacement for data_feed.SlotParser.parse_block."""

    def __init__(self, config: DataFeedConfig, parse_ins_id: bool = False,
                 parse_logkey: bool = False):
        self.config = config
        self.parse_ins_id = parse_ins_id
        self.parse_logkey = parse_logkey
        self._is_float = np.array(
            [1 if s.dtype == "float" else 0 for s in config.slots], np.uint8)

    # plugin .so overrides (ParserPluginManager sets these to a dlopen'd
    # site-specific parser exposing the same ABI)
    _lib = None
    _entry = "pbox_parse_block"

    def parse_block(self, lines) -> SlotRecordBlock:
        # the accessors (slot_total / fill_*) always come from the port's
        # own library: a plugin overrides only the parse entry and must
        # return a handle of the same block layout
        lib = _load()
        entry = lib.pbox_parse_block
        if self._lib is not None:
            entry = getattr(self._lib, self._entry)
            # ctypes' default restype (c_int) would truncate the handle
            entry.restype = ctypes.c_void_p
            entry.argtypes = lib.pbox_parse_block.argtypes
        buf = ("\n".join(lines) + "\n").encode()
        n_rec = ctypes.c_int64(0)
        status = ctypes.c_int32(0)
        handle = entry(
            buf, len(buf), len(self.config.slots),
            self._is_float.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(self.parse_ins_id), int(self.parse_logkey),
            ctypes.byref(n_rec), ctypes.byref(status))
        if not handle:
            raise ValueError(
                f"native parse failed (status={status.value}); check slot "
                f"config against the data (n_slots={len(self.config.slots)})")
        try:
            n = n_rec.value
            block = SlotRecordBlock(n=n)
            for si, slot in enumerate(self.config.slots):
                total = lib.pbox_slot_total(handle, si)
                offsets = np.empty(n + 1, np.int64)
                if slot.dtype == "float":
                    values = np.empty(total, np.float32)
                    lib.pbox_fill_slot_f32(handle, si,
                                           values.ctypes.data,
                                           offsets.ctypes.data)
                    block.float_slots[slot.name] = (values, offsets)
                else:
                    values = np.empty(total, np.uint64)
                    lib.pbox_fill_slot_u64(handle, si,
                                           values.ctypes.data,
                                           offsets.ctypes.data)
                    block.uint64_slots[slot.name] = (values, offsets)
            if self.parse_logkey:
                sids = np.empty(n, np.uint64)
                cm = np.empty(n, np.int32)
                rk = np.empty(n, np.int32)
                lib.pbox_fill_logkeys(handle, sids.ctypes.data,
                                      cm.ctypes.data, rk.ctypes.data)
                block.search_ids, block.cmatch, block.rank = sids, cm, rk
            if self.parse_ins_id or self.parse_logkey:
                nbytes = lib.pbox_insid_bytes(handle)
                chars = ctypes.create_string_buffer(max(nbytes, 1))
                offs = np.empty(n + 1, np.int64)
                lib.pbox_fill_insids(handle, chars, offs.ctypes.data)
                raw = chars.raw[:nbytes].decode()
                block.ins_ids = [raw[offs[i]:offs[i + 1]] for i in range(n)]
            stat_add("stat_total_feasign_num_in_mem", block.feasign_count)
            return block
        finally:
            lib.pbox_free(handle)
