"""Host DRAM tier of the tiered parameter server.

Port of ``paddlebox_tpu/ps/host_table.py`` (≙ MemorySparseTable,
ps/table/memory_sparse_table.{h,cc}): shard by ``key % shard_num``,
bulk pull/write, day decay and shrink by accessor policy, every per-shard
loop fanned across the shared worker pool (utils/workpool.py,
``FLAGS_ps_table_threads``).  Numpy only — no device code.

Each shard keeps its keys in one insertion-ordered uint64 array with
parallel SoA value arrays in capacity-doubling buffers.  The index is a
lazily rebuilt sorted view + ``np.searchsorted``, the JAX package's
fallback when its native hash library is absent: the port's native hash
(native/hash_shard.cc) pulled and wrote a pass no faster at the day
loop's size (chip_smoke's ``index:`` line), so only ``PassKeyMapper``
uses it.
Save/load writes the JAX package's per-shard file layout
(``part-%05d.shard.npz``: a ``keys`` array and one array per SoA field),
so a table saved by either package loads into the other.  ``bulk_pull``
and ``bulk_write`` feed the key-space heat sketches (ps/heat.py) when
heat is on.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import EmbeddingTableConfig
from paddlebox_tpu_torch.ps import feature_value as fv
from paddlebox_tpu_torch.ps import heat
from paddlebox_tpu_torch.utils import lockdep, workpool
from paddlebox_tpu_torch.utils.monitor import stat_observe

_GROW_MIN = 64      # first allocation floor (rows)


class _Shard:
    """One shard: insertion-ordered keys + SoA values in growable buffers.

    ``keys`` and ``soa`` are ALWAYS length-trimmed views over the backing
    capacity buffers — readers never see the uninitialized tail, and
    in-place mutation of a view (``soa["show"] *= decay``) writes through.
    Wholesale replacement goes through :meth:`replace` /
    :meth:`filter_keep`, never bare attribute assignment, so the
    ``len``/``cap`` split can't desync.
    """

    def __init__(self, mf_dim: int, expand_dim: int = 0, adam: bool = False,
                 optimizer: str = "", double_stats: bool = False):
        self.optimizer = optimizer
        self.mf_dim = mf_dim
        # RLock: lookup lazily builds the sorted view and is called both
        # bare (readers) and from under upsert
        self.lock = lockdep.rlock("ps.host_table._Shard.lock")
        self._sorted_view = None    # (sorted_keys, order)
        self.grow_count = 0
        self.append_calls = 0
        self._len = 0
        self._keys_buf = np.empty((0,), np.uint64)
        self._soa_buf = fv.empty_soa(0, mf_dim, expand_dim, adam, optimizer,
                                     double_stats)
        self._refresh_views()

    def _refresh_views(self) -> None:
        with self.lock:      # reentrant: the callers that swap hold it
            n = self._len
            self.keys = self._keys_buf[:n]
            self.soa = {f: buf[:n] for f, buf in self._soa_buf.items()}

    @property
    def size(self) -> int:
        return self._len

    @property
    def capacity(self) -> int:
        return len(self._keys_buf)

    def _grow(self, need: int) -> None:
        """Reallocate every buffer to at least ``need`` rows (doubling).
        Reentrant from upsert (which already holds the RLock)."""
        with self.lock:
            cap = max(len(self._keys_buf) * 2, need, _GROW_MIN)
            nk = np.empty((cap,), np.uint64)
            nk[:self._len] = self._keys_buf[:self._len]
            self._keys_buf = nk
            for f, buf in self._soa_buf.items():
                nb = np.empty((cap,) + buf.shape[1:], buf.dtype)
                nb[:self._len] = buf[:self._len]
                self._soa_buf[f] = nb
            self.grow_count += 1

    def replace(self, keys: np.ndarray, soa: Dict[str, np.ndarray]) -> None:
        """Swap in a wholesale new row set: the given arrays BECOME the
        buffers (capacity == length; the next append grows)."""
        with self.lock:
            self._keys_buf = np.ascontiguousarray(keys, np.uint64)
            self._len = len(self._keys_buf)
            self._soa_buf = {f: np.ascontiguousarray(v)
                             for f, v in soa.items()}
            self._refresh_views()
            self._sorted_view = None

    def filter_keep(self, keep: np.ndarray) -> None:
        """Drop rows where ``keep`` is False (shrink), compacting into
        fresh exact-size buffers."""
        with self.lock:
            self.replace(self.keys[keep],
                         {f: v[keep] for f, v in self.soa.items()})

    def lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """→ (rows, found_mask); rows are insertion positions, valid where
        found.  Thread-safe: lazily builds the sorted view under the shard
        lock (reentrant from upsert)."""
        with self.lock:
            if self._len == 0:
                return (np.zeros(len(keys), np.int64),
                        np.zeros(len(keys), bool))
            if self._sorted_view is None:
                order = np.argsort(self.keys, kind="stable")
                self._sorted_view = (self.keys[order], order)
            sk, order = self._sorted_view
            pos = np.searchsorted(sk, keys)
            pos_c = np.minimum(pos, len(sk) - 1)
            found = sk[pos_c] == keys
            return order[pos_c], found

    def upsert(self, keys: np.ndarray, soa: Dict[str, np.ndarray]) -> None:
        """Overwrite existing rows in place, append new ones — no re-sort
        of the buffers (keys must be unique within one call, which
        pass-level write-back guarantees)."""
        t_req = time.monotonic()
        with self.lock:
            t0 = time.monotonic()
            rows, found = self.lookup(keys)
            if found.any():
                idx = rows[found]
                for f, arr in self.soa.items():
                    arr[idx] = soa[f][found]
            if (~found).any():
                new_keys = keys[~found]
                need = self._len + len(new_keys)
                if need > len(self._keys_buf):
                    self._grow(need)
                lockdep.guards(self, "_len")
                self._keys_buf[self._len:need] = new_keys
                for f, buf in self._soa_buf.items():
                    buf[self._len:need] = soa[f][~found]
                self._len = need
                self.append_calls += 1
                self._refresh_views()
                self._sorted_view = None
        stat_observe("ps.host_table.write_lock_wait_s", t0 - t_req)
        stat_observe("ps.host_table.write_lock_hold_s",
                     time.monotonic() - t0)


class ShardedHostTable:
    """DRAM embedding table, pass-batched API.  Per-shard loops fan across
    the shared worker pool (workpool.table_pool()); results are
    bit-identical to the sequential walk at any pool size."""

    def __init__(self, config: EmbeddingTableConfig, seed: int = 0):
        self.config = config
        self.mf_dim = config.embedding_dim
        self.expand_dim = config.expand_dim
        self.adam = config.sgd.optimizer in ("adam", "shared_adam")
        self.optimizer = config.sgd.optimizer
        self.shard_num = config.shard_num
        self.double_stats = config.accessor.accessor_type == "ctr_double"
        self._shards = [_Shard(self.mf_dim, self.expand_dim, self.adam,
                               self.optimizer, self.double_stats)
                        for _ in range(self.shard_num)]
        # fresh-row init is KEY-DETERMINISTIC (fv.default_rows_keyed): a
        # pure function of (seed, key) — the same splitmix64 bits as the
        # JAX package's host table for the same seed
        self._seed = seed

    # -- introspection -------------------------------------------------------
    def size(self) -> int:
        return sum(s.size for s in self._shards)

    def grow_stats(self) -> Tuple[int, int]:
        """→ (total buffer reallocations, total append calls) across
        shards — the growth-amortization surface the tests assert on."""
        return (sum(s.grow_count for s in self._shards),
                sum(s.append_calls for s in self._shards))

    def _shard_ids(self, keys: np.ndarray) -> np.ndarray:
        return (keys % np.uint64(self.shard_num)).astype(np.int64)

    def _shard_sel(self, keys: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        """Non-empty (shard_id, key-index array) groups for one call."""
        sid = self._shard_ids(keys)
        out = []
        for s in range(self.shard_num):
            sel = np.nonzero(sid == s)[0]
            if len(sel):
                out.append((s, sel))
        return out

    # -- pass-batched pull/push ---------------------------------------------
    def bulk_pull(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        """Read rows for unique `keys` (read-only; unseen keys get fresh
        default rows — insertion happens at write-back).  One gather task
        per shard on the pool; tasks write DISJOINT row sets of ``out``."""
        if heat.ACTIVE is not None:
            heat.ACTIVE.observe("pull", keys)
        out = fv.default_rows_keyed(keys, self.mf_dim, self._seed,
                                    self.config.sgd.mf_initial_range,
                                    self.config.sgd.initial_range,
                                    self.expand_dim, self.adam,
                                    self.config.sgd.beta1_decay_rate,
                                    self.config.sgd.beta2_decay_rate,
                                    self.optimizer, self.double_stats)

        def pull_shard(group):
            s, sel = group
            shard = self._shards[s]
            t_req = time.monotonic()
            with shard.lock:
                t0 = time.monotonic()
                pos, found = shard.lookup(keys[sel])
                hit = sel[found]
                if len(hit):
                    src = pos[found]
                    for f, arr in shard.soa.items():
                        out[f][hit] = arr[src]
            stat_observe("ps.host_table.pull_lock_wait_s", t0 - t_req)
            stat_observe("ps.host_table.pull_lock_hold_s",
                         time.monotonic() - t0)

        workpool.table_pool().map(pull_shard, self._shard_sel(keys))
        return out

    def export_keys(self) -> np.ndarray:
        """Every resident key, one per-shard copy under that shard's lock
        (the serving tier freezes a loaded table from this + bulk_pull;
        order is shard-major — callers needing an order sort)."""
        def keys_shard(shard) -> np.ndarray:
            with shard.lock:
                return np.array(shard.keys, copy=True)

        parts = workpool.table_pool().map(keys_shard, self._shards)
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.zeros((0,), np.uint64)
        return np.concatenate(parts).astype(np.uint64, copy=False)

    def bulk_write(self, keys: np.ndarray, soa: Dict[str, np.ndarray]) -> None:
        if heat.ACTIVE is not None:
            heat.ACTIVE.observe("push", keys)

        def write_shard(group):
            s, sel = group
            self._shards[s].upsert(keys[sel], fv.select_rows(soa, sel))

        workpool.table_pool().map(write_shard, self._shard_sel(keys))

    # -- lifecycle policy (≙ CtrCommonAccessor, ctr_accessor.cc) ------------
    def _score(self, soa: Dict[str, np.ndarray]) -> np.ndarray:
        sgd = self.config.sgd
        return (sgd.nonclk_coeff * (soa["show"] - soa["click"])
                + sgd.clk_coeff * soa["click"])

    def end_day(self) -> None:
        """Day rollover: decay show/click, age unseen features
        (≙ CtrCommonAccessor::UpdateStatAfterSave / show_click_decay)."""
        decay = self.config.accessor.show_click_decay_rate

        def decay_shard(shard):
            with shard.lock:
                shard.soa["show"] *= decay
                shard.soa["click"] *= decay
                shard.soa["unseen_days"] += 1.0

        workpool.table_pool().map(decay_shard, self._shards)

    def shrink(self) -> int:
        """Evict dead features (≙ Table::Shrink via accessor thresholds:
        score < delete_threshold or unseen too long)."""
        acc = self.config.accessor

        def shrink_shard(shard) -> int:
            with shard.lock:
                score = self._score(shard.soa)
                keep = ~((score < acc.delete_threshold) |
                         (shard.soa["unseen_days"]
                          > acc.delete_after_unseen_days))
                removed = int((~keep).sum())
                if removed:
                    shard.filter_keep(keep)
                return removed

        return sum(workpool.table_pool().map(shrink_shard, self._shards))

    def filter_keys(self, keep_fn) -> int:
        """Drop rows whose key fails ``keep_fn(keys) -> bool mask`` —
        the reshard source-side moved-row drop (cutover commit) and the
        reshard-on-load owner filter.  Returns rows removed."""
        def filter_shard(shard) -> int:
            with shard.lock:
                keep = np.asarray(keep_fn(shard.keys), bool)
                removed = int((~keep).sum())
                if removed:
                    shard.filter_keep(keep)
                return removed

        return sum(workpool.table_pool().map(filter_shard, self._shards))

    def select_keys(self, mask_fn) -> np.ndarray:
        """Resident keys for which ``mask_fn(keys) -> bool mask`` holds —
        the reshard snapshot's moving-row enumeration (ps/service.py
        ``reshard_begin``).  Shard-major order like export_keys; callers
        needing determinism sort."""
        def sel_shard(shard) -> np.ndarray:
            with shard.lock:
                keys = np.asarray(shard.keys, np.uint64)
                if not len(keys):
                    return keys
                return keys[np.asarray(mask_fn(keys), bool)]

        parts = [p for p in workpool.table_pool().map(sel_shard,
                                                      self._shards)
                 if len(p)]
        if not parts:
            return np.zeros((0,), np.uint64)
        return np.concatenate(parts)

    # -- persistence (≙ SaveBase/SaveDelta box_wrapper.cc:1286; per-shard
    #    files with .shard suffix, memory_sparse_table.h:34) ----------------
    def save(self, path: str, mode: str = "base",
             keys: Optional[np.ndarray] = None) -> int:
        """Per-shard npz dumps under `path`, which may be any registered
        filesystem scheme — e.g. hdfs://... through ShellFS
        (≙ SaveBase/SaveDelta's AFS paths, box_wrapper.h:721-743).  Shard
        files write in parallel on the pool; each lands atomically
        (tmp name + rename when the filesystem supports it), and delta
        mode resets ``delta_score`` only AFTER its shard file is safely
        down — a mid-save filesystem failure can't lose deltas.

        mode="rows" saves exactly the rows of ``keys`` (missing keys are
        skipped) — the checkpoint-delta primitive (io/checkpoint.py
        generation chain): per-pass cost ∝ the pass's written key set,
        and the resulting dump applies over a base via
        ``load(path, mode="upsert")``."""
        from paddlebox_tpu_torch.io import fs as pfs
        filesystem = pfs.get_fs(path)
        filesystem.mkdir(path)
        acc = self.config.accessor
        if mode == "rows":
            if keys is None:
                raise ValueError("save(mode='rows') requires keys")
            keys = np.asarray(keys, np.uint64)
            row_sel = dict(self._shard_sel(keys))

        def save_shard(item) -> int:
            i, shard = item
            with shard.lock:
                if mode == "rows":
                    sel = row_sel.get(i)
                    pos, found = (shard.lookup(keys[sel])
                                  if sel is not None and len(sel)
                                  else (np.zeros(0, np.int64),
                                        np.zeros(0, bool)))
                    idx = pos[found]
                    data = {f: arr[idx] for f, arr in shard.soa.items()}
                    data["keys"] = (keys[sel][found] if sel is not None
                                    else np.zeros(0, np.uint64))
                else:
                    score = self._score(shard.soa)
                    if mode == "base":
                        keep = score >= acc.base_threshold
                    elif mode == "delta":
                        keep = np.abs(shard.soa["delta_score"]) \
                            >= acc.delta_threshold
                    else:  # "all" / checkpoint
                        keep = np.ones(shard.size, bool)
                    data = {f: arr[keep] for f, arr in shard.soa.items()}
                    data["keys"] = shard.keys[keep]
                part = f"{path.rstrip('/')}/part-{i:05d}.shard.npz"
                try:
                    tmp = part + ".tmp"
                    with filesystem.open_write(tmp) as tmp_fh:
                        np.savez(tmp_fh, **data)
                    filesystem.rename(tmp, part)
                except NotImplementedError:
                    # scheme without a rename verb: direct write (the
                    # pre-atomic behavior; delta reset still gated on the
                    # write completing without raising)
                    # pboxlint: disable-next=PB502 -- no rename verb here
                    with filesystem.open_write(part) as fh:
                        # pboxlint: disable-next=PB502 -- same fallback
                        np.savez(fh, **data)
                if mode == "delta":
                    # only now is the shard file known to have landed —
                    # zeroing before the write/rename could lose deltas
                    # to a mid-save failure
                    shard.soa["delta_score"][keep] = 0.0
                return len(data["keys"])

        return sum(workpool.table_pool().map(
            save_shard, list(enumerate(self._shards))))

    def load(self, path: str, mode: str = "replace") -> int:
        """Read per-shard npz dumps.  mode="replace" (default) swaps each
        shard's row set wholesale; mode="upsert" merges the dumped rows
        over the current contents — the delta-chain apply of the
        generation-chained checkpoint (io/checkpoint.py)."""
        from io import BytesIO

        from paddlebox_tpu_torch.io import fs as pfs
        filesystem = pfs.get_fs(path)

        def load_shard(item) -> int:
            i, shard = item
            f = f"{path.rstrip('/')}/part-{i:05d}.shard.npz"
            if not filesystem.exists(f):
                return 0
            fh = filesystem.open_read(f)
            # np.load needs seek; only pipe-backed streams buffer fully
            src = fh if fh.seekable() else BytesIO(fh.read())
            with np.load(src) as z:
                with shard.lock:
                    new_keys = z["keys"]
                    n = len(new_keys)
                    # checkpoints from a different optimizer config may
                    # lack some state fields (e.g. adam moments when the
                    # save ran under adagrad) — init those like fresh rows
                    # instead of KeyErroring: moments/g2sums start at 0,
                    # beta-power trackers at the decay rates (the adam
                    # creation init, ≙ optimizer.cuh.h:436-441)
                    sgd = self.config.sgd
                    fresh = {"_b1p": sgd.beta1_decay_rate,
                             "_b2p": sgd.beta2_decay_rate}

                    def init_missing(name, tmpl):
                        fill = next((v for suf, v in fresh.items()
                                     if name.endswith(suf)), 0.0)
                        return np.full((n,) + tmpl.shape[1:], fill,
                                       tmpl.dtype)

                    def from_ckpt(name, tmpl):
                        if name not in z.files:
                            return init_missing(name, tmpl)
                        arr = z[name]
                        # accessor migration (e.g. ctr -> ctr_double):
                        # the template dtype wins or appended rows would
                        # mix dtypes and f64 exactness silently degrades
                        return arr.astype(tmpl.dtype) \
                            if arr.dtype != tmpl.dtype else arr

                    soa = {name: from_ckpt(name, tmpl)
                           for name, tmpl in shard.soa.items()}
                    if mode == "upsert":
                        if n:
                            shard.upsert(new_keys, soa)
                    else:
                        shard.replace(new_keys, soa)
            fh.close()
            return n if mode == "upsert" else shard.size

        return sum(workpool.table_pool().map(
            load_shard, list(enumerate(self._shards))))
