"""SSD tier below the DRAM host table.

Copy of ``paddlebox_tpu/ps/ssd_table.py`` with the import paths rewritten
(host code: numpy, files, sockets and threads; no device call).

≙ SSDSparseTable (ps/table/ssd_sparse_table.{h,cc}): cold features live on
disk (the reference embeds RocksDB, ssd_sparse_table.h:81), hot ones stay in
DRAM; a cache threshold decides promotion, Save/SaveCache/Shrink traverse
both tiers.

TPU-first simplification (no RocksDB in the image): an append-only
log-structured store per shard — fixed-width binary rows in a data file plus
an in-memory key→offset index (rebuilt from the file on open).  Point reads
are one pread; pass-batched reads are sorted-offset sequential scans.
Compaction rewrites live rows (≙ rocksdb compaction, triggered by Shrink).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.ps import feature_value as fv
from paddlebox_tpu_torch.ps import heat
from paddlebox_tpu_torch.utils import lockdep, workpool

_MAGIC = b"PBOXSSD1"


class SSDShard:
    """One shard's log file: rows of (key u64 | field payload f32[width])."""

    def __init__(self, path: str, mf_dim: int):
        self.path = path
        self.mf_dim = mf_dim
        # payload field order mirrors feature_value.HOST_FIELDS
        self.scalar_fields = [f for f, _, s in fv.HOST_FIELDS if s == ()]
        self.width = len(self.scalar_fields) + mf_dim
        self.row_bytes = 8 + 4 * self.width
        self.index: Dict[int, int] = {}   # key → byte offset of latest row
        self._lock = lockdep.lock("ps.ssd_table.SSDShard._lock")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            self._rebuild_index()
        else:
            with open(path, "wb") as f:
                f.write(_MAGIC)

    def _rebuild_index(self) -> None:
        with open(self.path, "rb") as f:
            assert f.read(8) == _MAGIC, "corrupt ssd shard file"
            raw = f.read()
        usable = len(raw) // self.row_bytes * self.row_bytes
        rec = np.frombuffer(raw[:usable], self._rec_dtype)
        rb = self.row_bytes
        for i, k in enumerate(rec["k"].tolist()):
            self.index[k] = 8 + i * rb   # later rows win (log order)

    @property
    def _rec_dtype(self) -> np.dtype:
        return np.dtype([("k", "<u8"), ("v", "<f4", (self.width,))])

    def write_rows(self, keys: np.ndarray, soa: Dict[str, np.ndarray]) -> None:
        """One pack + one write per block (≙ rocksdb WriteBatch): the whole
        batch serializes vectorized into a structured record array."""
        n = len(keys)
        if n == 0:
            return
        rec = np.empty((n,), self._rec_dtype)
        rec["k"] = np.asarray(keys, np.uint64)
        for j, f in enumerate(self.scalar_fields):
            rec["v"][:, j] = soa[f]
        rec["v"][:, len(self.scalar_fields):] = soa["mf"]
        # the log file IS the locked resource: append offset + index.
        # PB502: append-only WAL — a torn tail is invisible because the
        # in-memory index only advances after the write returns, and
        # tmp+rename cannot express an append
        # pboxlint: disable-next=PB104,PB502 -- atomic vs compact; WAL
        with self._lock, open(self.path, "ab") as fh:
            off0 = fh.tell()
            fh.write(rec.tobytes())
            rb = self.row_bytes
            idx = self.index
            for i, k in enumerate(np.asarray(keys, np.uint64).tolist()):
                idx[k] = off0 + i * rb

    def read_rows(self, keys: np.ndarray
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """→ (soa rows aligned to keys, found mask); missing rows zeroed.
        Offsets sort + coalesce into contiguous runs, so a pass's rows
        (written together) come back as a handful of sequential reads."""
        n = len(keys)
        soa = fv.empty_soa(n, self.mf_dim)
        found = np.zeros(n, bool)
        # one lock span for offsets + reads: a concurrent compact() swaps
        # the file and would invalidate a pre-snapshotted offset list
        with self._lock:
            offs = np.array([self.index.get(int(k), -1) for k in keys],
                            np.int64)
            hit = offs >= 0
            if not hit.any():
                return soa, found
            found[:] = hit
            hit_idx = np.nonzero(hit)[0]
            order = np.argsort(offs[hit_idx], kind="stable")
            hit_idx = hit_idx[order]
            sorted_offs = offs[hit_idx]
            rb = self.row_bytes
            # coalesce adjacent rows into runs: one pread per run
            breaks = np.nonzero(np.diff(sorted_offs) != rb)[0] + 1
            starts = np.concatenate([[0], breaks])
            ends = np.concatenate([breaks, [len(sorted_offs)]])
            vals = np.empty((len(sorted_offs), self.width), np.float32)
            # reads must hold the lock: a concurrent compact() swaps
            # pboxlint: disable-next=PB104 -- the file under the offsets
            with open(self.path, "rb") as fh:
                for s, e in zip(starts, ends):
                    fh.seek(sorted_offs[s])
                    raw = fh.read(int((e - s) * rb))
                    rec = np.frombuffer(raw, self._rec_dtype)
                    vals[s:e] = rec["v"]
        for j, f in enumerate(self.scalar_fields):
            soa[f][hit_idx] = vals[:, j]
        soa["mf"][hit_idx] = vals[:, len(self.scalar_fields):]
        return soa, found

    def delete(self, keys: np.ndarray) -> None:
        with self._lock:
            for k in keys:
                self.index.pop(int(k), None)

    def keys(self) -> np.ndarray:
        with self._lock:
            return np.fromiter(self.index.keys(), np.uint64,
                               len(self.index))

    def compact(self) -> None:
        """Rewrite only live rows (≙ rocksdb compaction / Shrink)."""
        with self._lock:
            live = list(self.index.items())
            tmp = self.path + ".compact"
            # compaction swaps the file; writers/readers are excluded
            # pboxlint: disable-next=PB104 -- for the whole rewrite
            with open(self.path, "rb") as src, open(tmp, "wb") as dst:
                dst.write(_MAGIC)
                new_index = {}
                for key, off in live:
                    src.seek(off)
                    row = src.read(self.row_bytes)
                    new_index[key] = dst.tell()
                    dst.write(row)
            os.replace(tmp, self.path)
            self.index = new_index

    def __len__(self):
        return len(self.index)


class SSDTieredTable:
    """DRAM + SSD two-tier wrapper around ShardedHostTable.

    spill(): demote cold rows (score below cache threshold ≙
    `_cache_tk_size` top-k policy, ssd_sparse_table.h:82) to the SSD shards;
    bulk_pull transparently faults them back in.
    """

    def __init__(self, host_table, directory: str):
        self.host = host_table
        self.dir = directory
        self.shards = [
            SSDShard(os.path.join(directory, f"shard-{i:04d}.log"),
                     host_table.mf_dim)
            for i in range(host_table.shard_num)]

    def _shard_ids(self, keys):
        return self.host._shard_ids(keys)

    def spill_topk(self, cache_rows: int) -> int:
        """Keep only the `cache_rows` highest-scoring rows in DRAM, demote
        the rest (≙ the `_cache_tk_size` top-k cache-threshold policy,
        ssd_sparse_table.h:82: the threshold is the k-th score, computed
        over the whole table, not a fixed constant)."""
        scores = []
        for s in self.host._shards:
            with s.lock:   # a concurrent upsert replaces soa field arrays
                scores.append(np.array(self.host._score(s.soa)))
        all_scores = np.concatenate(scores) if scores else np.empty((0,))
        if len(all_scores) <= cache_rows:
            return 0
        if cache_rows <= 0:
            return self.spill(np.inf)   # demote everything
        # threshold = (n - cache_rows)-th smallest → top cache_rows stay
        thr = np.partition(all_scores, len(all_scores) - cache_rows)[
            len(all_scores) - cache_rows]
        return self.spill(thr)

    def spill(self, score_threshold: float) -> int:
        """Demote host rows with score < threshold to SSD.  One task per
        shard on the shared pool (each pairs a host shard with its own
        SSD log — no cross-shard state)."""

        def spill_shard(si: int) -> int:
            shard = self.host._shards[si]
            with shard.lock:
                score = self.host._score(shard.soa)
                cold = score < score_threshold
                if not cold.any():
                    return 0
                keys = shard.keys[cold]
                soa = {f: arr[cold] for f, arr in shard.soa.items()}
                self.shards[si].write_rows(keys, soa)
                shard.filter_keep(~cold)
                return int(cold.sum())

        return sum(workpool.table_pool().map(
            spill_shard, range(self.host.shard_num)))

    def bulk_pull(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        """Host rows, faulting SSD-resident rows back into DRAM
        (≙ LoadSSD2Mem box_wrapper.h:640).  The batched fault-in fans one
        task per shard: every key a task touches lives in that shard, so
        promotion upserts the host shard DIRECTLY (never back through the
        pooled bulk_write — a pool task waiting on nested pool futures
        could starve)."""
        out = self.host.bulk_pull(keys)
        # determine which keys were absent from DRAM → try SSD
        sid = self._shard_ids(keys)

        def fault_in(si: int) -> None:
            sel = np.nonzero(sid == si)[0]
            if not len(sel):
                return
            _, in_dram = self.host._shards[si].lookup(keys[sel])
            miss = sel[~in_dram]
            if not len(miss):
                return
            soa, found = self.shards[si].read_rows(keys[miss])
            hit = miss[found]
            if len(hit):
                if heat.ACTIVE is not None:
                    # SSD→DRAM promotions = the live working-set frontier
                    heat.ACTIVE.observe("fault_in", keys[hit])
                for f in out:
                    out[f][hit] = soa[f][found]
                # promote back to DRAM and drop from SSD
                self.host._shards[si].upsert(
                    keys[hit], {f: out[f][hit] for f in out})
                self.shards[si].delete(keys[hit])

        workpool.table_pool().map(fault_in, range(self.host.shard_num))
        return out

    def total_size(self) -> int:
        return self.host.size() + sum(len(s) for s in self.shards)

    def compact(self) -> None:
        workpool.table_pool().map(lambda s: s.compact(), self.shards)
