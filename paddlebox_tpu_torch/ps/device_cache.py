"""Device-resident hot-row embedding cache — the HBM tier of the store.

Port of ``paddlebox_tpu/ps/device_cache.py`` (≙ the HeterPS HBM-cached
table: HeterComm keeps the pass working set plus a hot-row pool resident
in device memory; ps_gpu_wrapper only faults cold rows in from the DRAM
tier):

  HBM   DeviceRowCache (this file)      — hottest rows, survives passes
  DRAM  ShardedHostTable                — full table, pass write-back

The cache is **write-back at pass granularity** and never a second source
of truth across a checkpoint commit:

* ``pass_manager._build_host`` intersects the pass's unique keys with an
  immutable index *snapshot* (published at ``begin_feed_pass``) and pulls
  only MISSES from the table;
* at adoption (``begin_pass``, main thread) hits are re-resolved against
  the live index and gathered on the card into the working set
  (``store[f].index_select`` then ``ws[f].index_copy_``, the working
  set's dtypes, so every step lowering is unchanged);
* the ONLY row mutation is the ``end_pass`` fold-back
  (:meth:`update_after_pass`, after the table ``bulk_write`` succeeded)
  and :meth:`invalidate` at coherence points (``set_date``'s decay,
  ``shrink``, ``load``, checkpoint ``resume``, ``reset_feed_state``).

Thread model (PassPrefetcher overlap): pass N+1's feed/build runs on
worker threads while pass N trains and folds back on the main thread.
Only the INDEX (sorted keys → slots) crosses threads, and it is
copy-on-write numpy: mutations build new arrays and swap them under
``_lock``, so a snapshot taken at ``begin_feed_pass`` is torn-read-free
and the worker's lookup makes no CUDA call.  All VALUE access (mirror
reads, store gathers and writes) happens on the main thread at adoption
and fold-back; a hit whose row was evicted between snapshot and adoption
re-resolves as a miss and falls back to a table pull.

Bit-identity argument: a resident row's device values are exactly the
values ``build_working_set`` would produce from the host row last written
back (same f32/int32 casts; under ctr_double the f64 show/click are cast
host-side from the merged write-back values), and its mirrored show and
click equal the written row's — so a cache hit yields the same
working-set bits, the same f64 pulled-stats base and (over a delta-mode
remote table) the same write-back base as a pull of the row just
written.

The cluster half: with the PS fleet's ``ServerMap`` attached
(``attach_server_map``, lazily at the engine's first feed pass), an
engine of rank r in a world of w admits only keys with
``shard_of_keys(key) % w == r``; ``update_server_map`` drops exactly the
key range a reshard moved, and ``invalidate_shard`` the rows of one
restarted PS shard.  All of it is numpy on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.parallel.topology import Sharded
from paddlebox_tpu_torch.ps import embedding
from paddlebox_tpu_torch.ps import heat
from paddlebox_tpu_torch.utils import flight, lockdep
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_set


class CacheIndexSnapshot:
    """Frozen (version, sorted keys) view published at begin_feed_pass.

    The feed/build threads use it only to decide what NOT to pull; the
    authoritative key→slot resolution happens later on the main thread
    (:meth:`DeviceRowCache.resolve`)."""

    __slots__ = ("version", "keys")

    def __init__(self, version: int, keys: np.ndarray):
        self.version = version
        self.keys = keys            # sorted uint64, never mutated in place

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Membership mask of `keys` (sorted unique) in the snapshot."""
        if len(self.keys) == 0 or len(keys) == 0:
            return np.zeros(len(keys), bool)
        pos = np.searchsorted(self.keys, keys)
        pos_c = np.minimum(pos, len(self.keys) - 1)
        return self.keys[pos_c] == keys


class CachePlan:
    """What a feed-thread build decided against a snapshot: which pass
    positions it expects to fill from the cache (so it did NOT pull them)
    and which keys it actually pulled.  Consumed at adoption on the main
    thread, where the hit set is re-validated against the live index."""

    __slots__ = ("keys", "pos", "snap", "n_miss", "pulled_keys")

    def __init__(self, keys: np.ndarray, pos: np.ndarray,
                 snap: CacheIndexSnapshot, n_miss: int,
                 pulled_keys: Optional[np.ndarray]):
        self.keys = keys            # snapshot-hit keys (sorted)
        self.pos = pos              # their positions in the pass key array
        self.snap = snap
        self.n_miss = n_miss
        self.pulled_keys = pulled_keys   # table-pulled key set (None if none)


class DeviceRowCache:
    """Fixed-capacity device-resident row pages keyed by feasign.

    Rows live in two planes sharing one slot space:

    * ``_store``  — device tensors ``[capacity, ...]`` per working-set
      field (f32/int32, the exact dtypes ``build_working_set`` emits) on
      ``device`` (``cuda`` unless the caller passes ``device="cpu"``);
    * ``_mirror`` — host arrays per table field (the table's dtypes, f64
      show/click under ctr_double, plus ``unseen_days``): the write-back
      base of a hit over a delta-mode remote table and the f64 stats
      source.

    Admission/eviction ranks by the same day-scale score ``shrink`` uses
    (``nonclk_coeff*(show-click) + clk_coeff*click``) plus pass recency;
    rows touched by the current pass are never evicted by it.

    Step-path agnostic: the cache operates on whole working-set rows
    (gather at adoption, fold-back at end_pass), never on a step's
    intermediate layout, so the fast, mxu and ragged steps compose with
    it unchanged.  Over a working set split across devices (a
    ``Sharded`` set) the store stays on ``device`` (the topology's first
    device): a hit is copied into the blocks that hold its row and the
    fold-back reads each row from its block, and every row that crosses
    between devices counts in ``ps.cache.device_copy_rows``.  Under a dp
    axis across processes every rank keeps the whole store: the
    fold-back's ``gather_rows`` brings another process's rows over the
    group (every rank calls it with the same rows), and a hit is written
    into this process's blocks only.
    """

    def __init__(self, capacity: int, nonclk_coeff: float = 0.1,
                 clk_coeff: float = 1.0, device: DeviceLike = None):
        assert capacity > 0
        self.capacity = int(capacity)
        self.nonclk_coeff = float(nonclk_coeff)
        self.clk_coeff = float(clk_coeff)
        self.device = resolve_device(device)
        self._lock = lockdep.lock("ps.device_cache.DeviceRowCache._lock")
        self.version = 0
        # copy-on-write index: sorted resident keys + their slots
        self._keys = np.empty((0,), np.uint64)
        self._slots = np.empty((0,), np.int32)
        # per-slot metadata (value planes — main-thread only)
        self._slot_key = np.zeros((self.capacity,), np.uint64)  # 0 = free
        self._slot_score = np.zeros((self.capacity,), np.float64)
        self._slot_pass = np.full((self.capacity,), -1, np.int64)
        self._store: Optional[Dict[str, torch.Tensor]] = None
        self._mirror: Optional[Dict[str, np.ndarray]] = None
        self.row_bytes = 0          # device bytes per cached row
        # cluster topology (optional): the fleet's ServerMap plus this
        # engine's rank/world.  With a map attached, admission is keyed
        # by the SAME splitmix64 placement the PS cluster uses — each
        # engine caches a disjoint slice of the key space
        self._server_map = None
        self._device_rank = 0
        self._device_world = 1
        # epoch stamp of the owned mask: the membership epoch the current
        # admission placement was computed under.  A live reshard bumps it
        # via update_server_map(), which also drops exactly the moved range
        self._map_epoch = 0

    def attach_server_map(self, server_map, device_rank: int = 0,
                          device_world: int = 1) -> None:
        """Adopt the PS cluster's key placement for cache admission.

        ``shard_of_keys(key) % device_world == device_rank`` defines this
        engine's owned slice.  Already-resident rows outside the slice are
        left to age out via normal eviction (attach happens before the
        first admission in practice, so the set is empty).  Main thread
        only, between passes.
        """
        with self._lock:
            self._server_map = server_map
            self._device_rank = int(device_rank)
            self._device_world = max(1, int(device_world))
            self._map_epoch = int(getattr(server_map, "epoch", 0))

    @property
    def map_epoch(self) -> int:
        """Membership epoch the resident set's owned mask was stamped
        under (0 when no ServerMap is attached)."""
        return self._map_epoch

    def update_server_map(self, new_map, reason: str = "") -> None:
        """Adopt a post-reshard ServerMap, invalidating ONLY the moved
        key range: rows whose owning shard is the same under the old and
        new placement keep their device/host planes hot; rows whose
        owner changed are dropped (their authoritative copy just moved
        between PS processes).  The owned admission mask is re-stamped
        with the new map's epoch.  Numpy only (the client's map-change
        hook may call it on a verb's thread); between passes.
        """
        with self._lock:
            old_map = self._server_map
            if old_map is None or (
                    getattr(old_map, "n", 1) == getattr(new_map, "n", 1)
                    and getattr(old_map, "addrs", None)
                    == getattr(new_map, "addrs", None)):
                # first attach, or a no-op refresh (same membership):
                # nothing moved, just restamp
                self._server_map = new_map
                self._map_epoch = int(getattr(new_map, "epoch", 0))
                return
            keys = self._keys
            slots = self._slots
        if len(keys):
            moved = old_map.shard_of_keys(keys) != new_map.shard_of_keys(keys)
        else:
            moved = np.zeros((0,), bool)
        self._drop(keys, slots, moved, server_map=new_map)
        flight.record("cache_invalidate_moved", epoch=self._map_epoch,
                      reason=reason or "reshard", dropped=int(moved.sum()),
                      kept=int((~moved).sum()))

    def _drop(self, keys: np.ndarray, slots: np.ndarray, gone: np.ndarray,
              server_map=None) -> None:
        """Free the slots of the resident keys masked by ``gone`` and swap
        in the index without them (optionally with a new map).  The
        version bumps even when nothing is dropped: in-flight snapshots
        may predate the change and must resolve all-miss."""
        drop_slots = slots[gone]
        self._slot_key[drop_slots] = 0
        self._slot_score[drop_slots] = 0.0
        self._slot_pass[drop_slots] = -1
        keep = ~gone
        with self._lock:
            self.version += 1
            self._keys = keys[keep]
            self._slots = slots[keep]
            if server_map is not None:
                self._server_map = server_map
                self._map_epoch = int(getattr(server_map, "epoch", 0))
            left = len(self._keys)
        stat_set("ps.cache.resident_rows", float(left))
        stat_add("ps.cache.invalidations")

    # -- index (cross-thread surface) ---------------------------------------
    def snapshot(self) -> CacheIndexSnapshot:
        """Publish the current index for a feed pass (prefetcher-safe:
        the returned arrays are never mutated in place)."""
        with self._lock:
            return CacheIndexSnapshot(self.version, self._keys)

    def resolve(self, keys: np.ndarray, snap: CacheIndexSnapshot
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Authoritative hit resolution at adoption time (main thread):
        → (valid_mask, slots).  Keys evicted (or the whole cache
        invalidated) since the snapshot resolve as invalid and must be
        re-pulled from the table by the caller."""
        with self._lock:
            if snap.version != self.version or len(self._keys) == 0 \
                    or len(keys) == 0:
                return np.zeros(len(keys), bool), \
                    np.zeros(len(keys), np.int32)
            pos = np.searchsorted(self._keys, keys)
            pos_c = np.minimum(pos, len(self._keys) - 1)
            found = self._keys[pos_c] == keys
            return found, np.where(found, self._slots[pos_c], 0)

    @property
    def resident_rows(self) -> int:
        with self._lock:
            return len(self._keys)

    @property
    def store_bytes(self) -> int:
        """Device bytes the store holds (0 before the first fold-back)."""
        return self.row_bytes * self.capacity if self._store else 0

    # -- value planes (main-thread only) ------------------------------------
    def read_mirror(self, slots: np.ndarray,
                    fields: Optional[Tuple[str, ...]] = None
                    ) -> Dict[str, np.ndarray]:
        """Host-mirror rows for the given slots (delta-mode write-back
        base / f64 stats source).  Main thread only."""
        assert self._mirror is not None
        names = fields if fields is not None else tuple(self._mirror)
        return {f: self._mirror[f][slots]
                for f in names if f in self._mirror}

    def host_templates(self, n: int) -> Dict[str, np.ndarray]:
        """Zero host-row arrays with the table's field dtypes/shapes —
        used when a pass has no misses at all (no table pull to derive
        the SoA layout from).  Numpy only: runs on the build thread."""
        with self._lock:
            mirror = self._mirror
        assert mirror is not None
        return {f: np.zeros((n,) + v.shape[1:], v.dtype)
                for f, v in mirror.items()}

    def scatter_into(self, ws: Dict[str, torch.Tensor], rows: np.ndarray,
                     slots: np.ndarray) -> Dict[str, torch.Tensor]:
        """Cached-plane gather: copy resident rows into the pass working
        set on the device (no host staging, no table bytes for hits).
        Pure read of the store; writes ``ws`` in place and returns it.
        Over a working set split across devices each hit row goes to the
        blocks that hold its pass row, copied where a block lives on
        another device than the store (``ps.cache.device_copy_rows``)."""
        assert self._store is not None
        slots_d = torch.as_tensor(np.asarray(slots, np.int64),
                                  device=self.device)
        moved = embedding.scatter_device_rows(
            ws, np.asarray(rows, np.int64),
            {f: buf.index_select(0, slots_d)
             for f, buf in self._store.items()}, self.device)
        if moved:
            stat_add("ps.cache.device_copy_rows", float(moved))
        return ws

    def _ensure_planes(self, soa: Dict[str, np.ndarray],
                       ws: Dict[str, torch.Tensor]) -> None:
        if self._store is not None:
            return
        store = {}
        for f in soa:
            if f == "unseen_days" or f not in ws:
                continue
            w = ws[f]
            store[f] = torch.zeros((self.capacity,) + tuple(w.shape[1:]),
                                   dtype=w.dtype, device=self.device)
        mirror = {f: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                  for f, v in soa.items()}
        with self._lock:
            self._mirror = mirror
        # pboxlint: disable-next=PB102 -- value planes are main-thread-only; _lock guards only the COW index
        self._store = store
        self.row_bytes = int(sum(
            v.element_size() * int(np.prod(v.shape[1:], dtype=np.int64))
            for v in store.values()))

    def _score(self, soa: Dict[str, np.ndarray]) -> np.ndarray:
        show = np.asarray(soa["show"], np.float64)
        click = np.asarray(soa["click"], np.float64)
        return self.nonclk_coeff * (show - click) + self.clk_coeff * click

    # -- the single sanctioned mutation: end_pass fold-back ------------------
    def update_after_pass(self, keys: np.ndarray, soa: Dict[str, np.ndarray],
                          ws: Dict[str, torch.Tensor], pass_id: int,
                          host_casts: Optional[Dict[str, np.ndarray]] = None
                          ) -> None:
        """Fold the pass's written rows back into the cache and run
        admission/eviction.  MUST be called only from the engine's
        ``end_pass``, after the table ``bulk_write`` succeeded — on a
        write-back failure the cache stays untouched so the replayed
        end_pass folds back exactly once.

        ``keys`` are the pass's sorted unique keys (working-set rows
        1..n), ``soa`` the exact host rows just written, ``ws`` the
        trained working set.  ``host_casts`` overrides the device source
        per field (ctr_double: the f64-merged show/click cast to f32
        host-side, so hit rows replay the same f64→f32 cast a table pull
        would).
        """
        n = len(keys)
        if n == 0:
            return
        self._ensure_planes(soa, ws)
        scores = self._score(soa)

        # resident rows of this pass: value refresh + recency/score
        if len(self._keys):
            pos = np.searchsorted(self._keys, keys)
            pos_c = np.minimum(pos, len(self._keys) - 1)
            res_mask = self._keys[pos_c] == keys
            res_idx = np.flatnonzero(res_mask)
            res_slots = self._slots[pos_c[res_mask]]
        else:
            res_idx = np.empty((0,), np.int64)
            res_slots = np.empty((0,), np.int32)

        # admission candidates: this pass's non-resident keys, hottest
        # first (stable key tie-break keeps the policy deterministic)
        cand_mask = np.ones((n,), bool)
        cand_mask[res_idx] = False
        cand = np.flatnonzero(cand_mask)
        # the topology trio is co-mutated under _lock (attach_server_map /
        # update_server_map): snapshot it atomically
        with self._lock:
            smap = self._server_map
            rank, world = self._device_rank, self._device_world
        if smap is not None and world > 1:
            # sharded topology: only admit this engine's owned slice of
            # the key space (same ServerMap placement the wire uses)
            owned = (smap.shard_of_keys(keys[cand]) % world) == rank
            cand = cand[owned]
        order = np.lexsort((keys[cand], -scores[cand]))
        cand = cand[order]

        free = np.flatnonzero(self._slot_key == 0)
        take = cand[:len(free)]
        adm_idx: List[np.ndarray] = [take]
        adm_slots: List[np.ndarray] = [free[:len(take)]]
        rest = cand[len(free):]
        n_evict = 0
        if len(rest):
            # evict coldest residents NOT touched by this pass, but only
            # for strictly hotter candidates (ties keep the incumbent).
            # res_slots must be masked explicitly — their _slot_pass still
            # holds the PREVIOUS pass until the update block below
            evict_ok = (self._slot_key != 0) & (self._slot_pass < pass_id)
            evict_ok[res_slots] = False
            evictable = np.flatnonzero(evict_ok)
            if len(evictable):
                eorder = np.lexsort((self._slot_key[evictable],
                                     self._slot_pass[evictable],
                                     self._slot_score[evictable]))
                evictable = evictable[eorder]
                k = min(len(rest), len(evictable))
                wins = scores[rest[:k]] > self._slot_score[evictable[:k]]
                n_evict = int(np.argmin(wins)) if not wins.all() else k
                if n_evict:
                    ev = evictable[:n_evict]
                    ev_keys = self._slot_key[ev]
                    if heat.ACTIVE is not None:
                        # churn tracking: which keys fall out of HBM
                        heat.ACTIVE.observe("cache_evict", ev_keys)
                    # pboxlint: disable-next=PB102 -- value planes are main-thread-only; _lock guards only the COW index
                    self._slot_key[ev] = 0
                    adm_idx.append(rest[:n_evict])
                    adm_slots.append(ev)
        adm_i = np.concatenate(adm_idx)
        adm_s = np.concatenate(adm_slots)

        upd_idx = np.concatenate([res_idx, adm_i]).astype(np.int64)
        upd_slots = np.concatenate([res_slots, adm_s]).astype(np.int64)
        if len(upd_idx):
            for f, mirror in self._mirror.items():
                if f in soa:
                    mirror[upd_slots] = soa[f][upd_idx]
            rows_d = torch.as_tensor(upd_idx + 1, device=self.device)
            slots_d = torch.as_tensor(upd_slots, device=self.device)
            moved = 0
            for f, buf in self._store.items():
                if host_casts is not None and f in host_casts:
                    src = torch.as_tensor(
                        np.ascontiguousarray(host_casts[f][upd_idx]),
                        dtype=buf.dtype).to(self.device)
                elif isinstance(ws[f], Sharded):
                    # each row read from the block that holds it, where
                    # the block lives, and copied to the store's device
                    src, crossed = ws[f].gather_rows(upd_idx + 1,
                                                     self.device)
                    moved = max(moved, crossed)
                else:
                    src = ws[f].index_select(0, rows_d)
                # slots are unique: one write per slot, deterministic
                buf.index_copy_(0, slots_d, src)
            if moved:
                stat_add("ps.cache.device_copy_rows", float(moved))
            self._slot_key[upd_slots] = keys[upd_idx]
            # pboxlint: disable-next=PB102 -- value planes are main-thread-only; _lock guards only the COW index
            self._slot_score[upd_slots] = scores[upd_idx]
            # pboxlint: disable-next=PB102 -- value planes are main-thread-only; _lock guards only the COW index
            self._slot_pass[upd_slots] = pass_id

        # the new index: the old one without the evicted keys, the
        # admitted keys merged in (sorted by key, as a re-sort of every
        # resident slot would give, in linear time)
        idx_keys, idx_slots = self._keys, self._slots
        if n_evict:
            gone = np.searchsorted(idx_keys, ev_keys)
            idx_keys = np.delete(idx_keys, gone)
            idx_slots = np.delete(idx_slots, gone)
        if len(adm_i):
            slot_of = np.full((n,), -1, np.int64)
            slot_of[adm_i] = adm_s
            a_rows = np.flatnonzero(slot_of >= 0)    # admitted, key order
            at = np.searchsorted(idx_keys, keys[a_rows])
            idx_keys = np.insert(idx_keys, at, keys[a_rows])
            idx_slots = np.insert(idx_slots, at,
                                  slot_of[a_rows].astype(np.int32))
        # copy-on-write index swap (feed threads may hold the old arrays)
        with self._lock:
            self._keys = idx_keys
            self._slots = idx_slots
        stat_set("ps.cache.resident_rows", float(len(idx_keys)))
        if heat.ACTIVE is not None and len(adm_i):
            heat.ACTIVE.observe("cache_admit", keys[adm_i])
        if n_evict:
            stat_add("ps.cache.evictions", float(n_evict))
            flight.record("cache_evict", pass_id=pass_id, count=n_evict,
                          resident=len(idx_keys))

    # -- coherence points ----------------------------------------------------
    def invalidate(self, reason: str = "") -> None:
        """Version-bump + drop the whole index (set_date's decay, shrink,
        load, checkpoint resume, reset_feed_state).  In-flight snapshots
        resolve as all-miss afterwards; device/host planes stay
        allocated for reuse.  Numpy only: ``set_date`` may call it on the
        prefetch worker."""
        with self._lock:
            had = len(self._keys)
            self.version += 1
            self._keys = np.empty((0,), np.uint64)
            self._slots = np.empty((0,), np.int32)
        self._slot_key[:] = 0
        self._slot_score[:] = 0.0
        self._slot_pass[:] = -1
        stat_set("ps.cache.resident_rows", 0.0)
        stat_add("ps.cache.invalidations")
        flight.record("cache_invalidate", reason=reason or "unspecified",
                      dropped=had)

    def invalidate_shard(self, shard: int, reason: str = "") -> None:
        """Drop only one PS cluster shard's resident rows (single-shard
        supervisor restart behind a fan-out: the other N-1 shards never
        lost state, so their cached rows stay hot).  Falls back to a full
        invalidate when no ServerMap is attached.  Main thread only."""
        if self._server_map is None:
            self.invalidate(reason or f"shard-{shard}")
            return
        with self._lock:
            keys = self._keys
            slots = self._slots
        hit = self._server_map.shard_of_keys(keys) == int(shard)
        self._drop(keys, slots, hit)
        flight.record("cache_invalidate_shard", shard=int(shard),
                      reason=reason or "unspecified",
                      dropped=int(hit.sum()))
