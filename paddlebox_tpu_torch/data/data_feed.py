"""Slot-file readers & parsers.

≙ the DataFeed hierarchy (data_feed.h:977-2233).  Text format is the
reference's MultiSlot format (SlotRecordInMemoryDataFeed::ParseOneInstance,
data_feed.cc:2397-2500): per line, optionally ``1 <ins_id>`` and
``1 <logkey>`` prefixes, then for each configured slot in order
``<num> <v1> ... <vnum>``.  Files may be piped through a shell preprocessor
first (pipe_command ≙ fs_open_read with pipe, data_feed.cc:330).

Copy of ``paddlebox_tpu/data/data_feed.py``: ``make_parser`` returns the
native C++ parser (``native/slot_parser.py``) when the native library
builds and no string slot is configured, else the pure-Python
``SlotParser``; ``use_native=False`` forces the Python one.
``load_parser_plugin`` loads a site-specific parser by spec, as the JAX
package's does.  A scheme-prefixed path (``hdfs://...``) is read
through the filesystem registered for its scheme (``io/fs.py``).
"""

from __future__ import annotations

import gzip
import io
import subprocess
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.io import fs as pfs
from paddlebox_tpu_torch.utils.monitor import stat_add


def parse_logkey(log_key: str) -> Tuple[int, int, int]:
    """Decode search_id/cmatch/rank from a packed hex log key
    (≙ SlotRecordInMemoryDataFeed parser_log_key, data_feed.cc:2363-2372:
    rank = last 2 hex digits, cmatch = previous 2, search_id = rest)."""
    if len(log_key) < 4:
        return 0, 0, 0
    rank = int(log_key[-2:], 16)
    cmatch = int(log_key[-4:-2], 16)
    search_id = int(log_key[:-4], 16) if len(log_key) > 4 else 0
    return search_id, cmatch, rank


class SlotParser:
    """Parses MultiSlot text lines into SlotRecordBlocks (python fallback).

    input_table: ps.aux_tables.InputTable shared by every parser of a
    dataset — "string"-dtype slots resolve each token through it into a
    stable int index at parse time (≙ InputTableDataFeed,
    data_feed.h:2224), stored in block.aux_slots as INDICES (0 = miss
    row, the ReplicaCache convention) so they never enter all_keys()."""

    def __init__(self, config: DataFeedConfig,
                 parse_ins_id: bool = False, parse_logkey: bool = False,
                 input_table=None):
        self.config = config
        self.parse_ins_id = parse_ins_id
        self.parse_logkey = parse_logkey
        self.input_table = input_table
        if config.string_slots and input_table is None:
            raise ValueError(
                "feed config declares string slots "
                f"{[s.name for s in config.string_slots]} but no "
                "InputTable was provided to resolve them")

    def parse_block(self, lines: Sequence[str]) -> SlotRecordBlock:
        cfg = self.config
        n = len(lines)
        u_vals: dict = {s.name: [] for s in cfg.slots if s.dtype == "uint64"}
        u_lens: dict = {k: np.zeros((n,), np.int64) for k in u_vals}
        a_vals: dict = {s.name: [] for s in cfg.slots if s.dtype == "string"}
        a_lens: dict = {k: np.zeros((n,), np.int64) for k in a_vals}
        f_vals: dict = {s.name: [] for s in cfg.slots if s.dtype == "float"}
        f_lens: dict = {k: np.zeros((n,), np.int64) for k in f_vals}
        ins_ids: List[str] = [] if self.parse_ins_id or self.parse_logkey else None
        search_ids = np.zeros((n,), np.uint64) if self.parse_logkey else None
        cmatch = np.zeros((n,), np.int32) if self.parse_logkey else None
        rank = np.zeros((n,), np.int32) if self.parse_logkey else None

        for li, line in enumerate(lines):
            toks = line.split()
            pos = 0
            if self.parse_ins_id:
                assert toks[pos] == "1", "ins_id prefix must be '1 <id>'"
                ins_ids.append(toks[pos + 1])
                pos += 2
            if self.parse_logkey:
                assert toks[pos] == "1", "logkey prefix must be '1 <key>'"
                key = toks[pos + 1]
                sid, cm, rk = parse_logkey(key)
                if not self.parse_ins_id:
                    ins_ids.append(key)
                search_ids[li], cmatch[li], rank[li] = sid, cm, rk
                pos += 2
            for slot in cfg.slots:
                num = int(toks[pos]); pos += 1
                vals = toks[pos:pos + num]; pos += num
                if slot.dtype == "uint64":
                    u_vals[slot.name].append(
                        np.array([int(v) for v in vals], dtype=np.uint64))
                    u_lens[slot.name][li] = num
                elif slot.dtype == "string":
                    a_vals[slot.name].append(
                        self.input_table.get_or_insert_many(vals))
                    a_lens[slot.name][li] = num
                else:
                    f_vals[slot.name].append(
                        np.array(vals, dtype=np.float32))
                    f_lens[slot.name][li] = num

        block = SlotRecordBlock(n=n, ins_ids=ins_ids, search_ids=search_ids,
                                cmatch=cmatch, rank=rank)
        for k, parts in u_vals.items():
            off = np.zeros((n + 1,), np.int64)
            np.cumsum(u_lens[k], out=off[1:])
            block.uint64_slots[k] = (
                np.concatenate(parts) if parts else np.empty((0,), np.uint64),
                off)
        for k, parts in f_vals.items():
            off = np.zeros((n + 1,), np.int64)
            np.cumsum(f_lens[k], out=off[1:])
            block.float_slots[k] = (
                np.concatenate(parts) if parts else np.empty((0,), np.float32),
                off)
        for k, parts in a_vals.items():
            off = np.zeros((n + 1,), np.int64)
            np.cumsum(a_lens[k], out=off[1:])
            block.aux_slots[k] = (
                np.concatenate(parts) if parts else np.empty((0,), np.uint64),
                off)
        stat_add("stat_total_feasign_num_in_mem", block.feasign_count)
        return block


def open_file(path: str, pipe_command: str = "") -> io.TextIOBase:
    """≙ fs_open_read (framework/io/fs.cc): optional shell pipe, gz
    support, and scheme-dispatched remote filesystems (hdfs://... through
    the registered ShellFS — io/fs.py)."""
    scheme, _ = pfs.split_scheme(path)
    if scheme and scheme != "file":
        if pipe_command:
            raise ValueError(
                "pipe_command over a remote path is not supported — "
                "preprocess into the remote store or read locally")
        raw = io.BufferedReader(pfs.open_read(path))
        if path.endswith(".gz"):
            return io.TextIOWrapper(gzip.GzipFile(fileobj=raw))
        return io.TextIOWrapper(raw)
    if pipe_command:
        cmd = f"cat '{path}' | {pipe_command}" if path else pipe_command
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        return io.TextIOWrapper(proc.stdout)
    if path.endswith(".gz"):
        proc = subprocess.Popen(["zcat", path], stdout=subprocess.PIPE)
        return io.TextIOWrapper(proc.stdout)
    return open(path, "r")


class DataFeed:
    """File → SlotRecordBlock stream (≙ InMemoryDataFeed::LoadIntoMemory,
    data_feed.cc:560-587)."""

    def __init__(self, config: DataFeedConfig, parse_ins_id: bool = False,
                 parse_logkey: bool = False, chunk_lines: int = 4096,
                 use_native: bool = True, input_table=None):
        self.config = config
        self.chunk_lines = chunk_lines
        self._parser = make_parser(config, parse_ins_id, parse_logkey,
                                   use_native=use_native,
                                   input_table=input_table)

    def read_file(self, path: str) -> Iterator[SlotRecordBlock]:
        with open_file(path, self.config.pipe_command) as f:
            while True:
                lines = []
                for line in f:
                    line = line.strip()
                    if line:
                        lines.append(line)
                    if len(lines) >= self.chunk_lines:
                        break
                if not lines:
                    return
                yield self._parser.parse_block(lines)


def make_parser(config: DataFeedConfig, parse_ins_id: bool = False,
                parse_logkey_: bool = False, use_native: bool = True,
                input_table=None):
    """Return the native C++ parser when built, else the python fallback.
    String (InputTable) slots force the python parser — the table's
    string→index map lives in the python process."""
    if use_native and not config.string_slots:
        from paddlebox_tpu_torch.native import slot_parser as native_parser
        if native_parser.available():
            return native_parser.NativeSlotParser(
                config, parse_ins_id, parse_logkey_)
    return SlotParser(config, parse_ins_id, parse_logkey_,
                      input_table=input_table)


class ParserPluginManager:
    """Pluggable per-format parsers — ≙ CustomParser + DLManager
    (data_feed.h:446,682): production feeds load site-specific parser
    implementations by name at run time instead of baking every data
    format into the framework.

    Two plugin kinds, keyed by a spec string (cached like DLManager::load):
      * ``"pkg.module:factory"`` — an importable Python factory called as
        ``factory(config) -> parser`` whose ``parse_block(lines)`` returns
        a ``SlotRecordBlock`` of this package (the reference's
        ISlotParser surface, data_feed.h:1964);
      * ``"/path/libplugin.so:symbol"`` — a C shared library exposing the
        block-parser ABI of native/slot_parser.cc under ``symbol``
        (dlopen'd once, ≙ DLManager caching), driven through the port's
        ``NativeSlotParser`` and its own native library's accessors.
    """

    def __init__(self):
        self._cache = {}

    def load(self, spec: str, config: DataFeedConfig):
        if spec in self._cache:
            return self._cache[spec](config)
        target, _, name = spec.partition(":")
        if target.endswith(".so"):
            import ctypes

            from paddlebox_tpu_torch.native.slot_parser import \
                NativeSlotParser
            lib = ctypes.CDLL(target)  # dlopen once; symbols resolved below

            def factory(cfg, _lib=lib, _sym=name or "pbox_parse_block"):
                p = NativeSlotParser(cfg)
                p._lib = _lib
                p._entry = _sym
                return p
        else:
            import importlib

            fn = getattr(importlib.import_module(target),
                         name or "create_parser")

            def factory(cfg, _fn=fn):
                return _fn(cfg)

        self._cache[spec] = factory
        return factory(config)


_plugin_manager = ParserPluginManager()


def load_parser_plugin(spec: str, config: DataFeedConfig):
    """Module-level convenience over a process-wide manager (≙ the global
    DLManager instance reached through dlmanager(), data_feed.h:707)."""
    return _plugin_manager.load(spec, config)
