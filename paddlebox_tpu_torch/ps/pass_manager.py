"""Pass lifecycle engine — the BoxWrapper/BoxHelper equivalent.

Port of ``paddlebox_tpu/ps/pass_manager.py`` (≙ BoxWrapper box_wrapper.h:377
+ BoxHelper box_wrapper.h:1043 + the PSGPUWrapper pass machinery,
ps_gpu_wrapper.cc:114-1007):

  set_date            ≙ BoxHelper::SetDate (box_wrapper.h:1048) — a date
                        change decays the table (end_day) and rolls the
                        quality monitors over
  begin_feed_pass     ≙ BeginFeedPass (box_wrapper.cc:129) — opens a key
                        collection agent for the loading pass
  add_keys            ≙ PSAgent::AddKey via MergeInsKeys (data_set.cc:2293)
  end_feed_pass       ≙ EndFeedPass (box_wrapper.cc:152) — dedups the pass
                        keys, pulls rows from the host table and builds the
                        device working set; ``async_build=True`` pulls on a
                        background thread for the NEXT pass while the
                        current one trains
  begin_pass/end_pass ≙ box_wrapper.cc:171,186 — begin_pass adopts an
                        async build (upload on the calling thread, then the
                        stale-row refresh); end_pass writes the working set
                        back to the host table
  save_base/save_delta≙ SaveBase/SaveDelta (box_wrapper.cc:1286)
  load                ≙ InitializeGPUAndLoadModel (box_wrapper.h:624)
  shrink              ≙ ShrinkTable (box_wrapper.h:638)

Device row cache (``FLAGS_ps_device_cache``, ps/device_cache.py): the
build pulls only the keys missing from the cache's index snapshot
(published at begin_feed_pass); adoption (``_adopt``) resolves the hits
against the live index, pulls any hit evicted since the snapshot, uploads
the miss rows and gathers the hit rows on the device; end_pass folds the
written rows back after the table write succeeded.  Cache on = cache off
bit for bit.  Key-space heat (``FLAGS_obs_heat``, ps/heat.py) is turned
on at construction and faded at a change of date.

Threads: the async build thread (and the pass prefetcher's worker,
data/prefetch.py) run host work only — key dedup, the cache snapshot and
its lookup, the table pull, the day's decay.  Every device copy (the
working-set upload, the cache gather and fold-back, the stale-row
refresh, the write-back's device-to-host copy) runs on the thread that
calls begin_pass/end_pass.  Each timer of ``timers`` is used by one
thread at a time: ``dedup_keys``/``build_pull``/``end_day`` by the feed
side, ``build_device``/``cache_gather``/``refresh_stale``/
``dump_to_cpu``/``cache_fold``/``train`` by the training side.

Not ported yet (ROADMAP): the cache's cluster half and remote-table (PS
service) adoption, and serving-frozen working sets.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import EmbeddingTableConfig
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.metrics import quality
from paddlebox_tpu_torch.ps import embedding, faults
from paddlebox_tpu_torch.ps import heat
from paddlebox_tpu_torch.ps.device_cache import CachePlan, DeviceRowCache
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.utils import flight, intervals, lockdep, trace
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_set, stat_snapshot
from paddlebox_tpu_torch.utils.timer import TimerRegistry

flags.define_flag(
    "obs_pass_report", False,
    "print a PrintSyncTimer-style per-pass wall-time table (pull/train/"
    "write seconds, wire bytes, inflight hwm, injected faults) at every "
    "end_pass (≙ PrintSyncTimer box_wrapper.h:795)")


class BoxPSEngine:
    """Host table + the pass's device working set ``ws`` (a dict of
    tensors on ``device``; ``cuda`` unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, config: Optional[EmbeddingTableConfig] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.config = config or EmbeddingTableConfig()
        self.device = resolve_device(device)
        heat.maybe_enable_from_flags()
        self.table = ShardedHostTable(self.config, seed=seed)
        self.timers = TimerRegistry()
        self.day_id: Optional[str] = None
        self.pass_id = 0
        self.phase = 1  # join/update flip (≙ FlipPhase box_wrapper.h:805)

        self._agent_lock = lockdep.lock(
            "ps.pass_manager.BoxPSEngine._agent_lock")
        self._agent_keys: List[np.ndarray] = []
        self._feeding = False

        self.mapper: Optional[embedding.PassKeyMapper] = None
        self.ws: Optional[Dict[str, torch.Tensor]] = None
        self.num_keys = 0
        self._pulled_stats = None

        # pass-pipelined preload (≙ PreLoadIntoMemory + pre-build thread,
        # box_wrapper.h:1141 / ps_gpu_wrapper.cc:907-955): the next pass's
        # host rows are pulled in the background while the current one
        # trains
        self._build_thread: Optional[threading.Thread] = None
        self._build_error: Optional[BaseException] = None
        self._next: Optional[tuple] = None  # (mapper, n, host_rows, plan)
        self._last_written: Optional[np.ndarray] = None
        self._feed_obs0 = None
        self._pass_obs0 = None
        self._pass_feed_report = None

        # HBM tier: device-resident hot-row cache (ps/device_cache.py)
        self.cache: Optional[DeviceRowCache] = None
        if flags.get_flags("ps_device_cache"):
            cap = int(flags.get_flags("ps_device_cache_rows"))
            if cap > 0:
                sgd = self.config.sgd
                self.cache = DeviceRowCache(
                    cap, nonclk_coeff=sgd.nonclk_coeff,
                    clk_coeff=sgd.clk_coeff, device=self.device)
        self._feed_cache_snap = None     # index snapshot for the open feed
        self._cache_fresh_keys = None    # adoption-fresh rows (skip refresh)

    # -- date / phase --------------------------------------------------------
    def set_date(self, date: str, *, table_decay: bool = True) -> None:
        """Advance the engine's day.  A change of date decays the table
        (``table.end_day``) unless ``table_decay=False``, and rolls the
        quality monitors' day series over."""
        if self.day_id is not None and date != self.day_id:
            flight.record("day_end", day=self.day_id, next_day=date)
            if table_decay:
                with self.timers("end_day"):
                    self.table.end_day()
            quality.end_day(self.day_id)
            # coherence point: end_day decayed show/click table-wide —
            # every cached row is stale now (the prefetcher's day-boundary
            # drain guarantees no feed snapshot is in flight here)
            if self.cache is not None:
                self.cache.invalidate("end_day")
            if heat.ACTIVE is not None:
                heat.ACTIVE.decay_day()
        self.day_id = date

    def flip_phase(self) -> None:
        self.phase = 1 - self.phase

    # -- feed pass -----------------------------------------------------------
    def begin_feed_pass(self) -> None:
        assert not self._feeding, "previous feed pass not closed"
        with self._agent_lock:
            self._agent_keys = []
        # per-pass observability baseline: the end_pass report prints
        # deltas against it.  Held pending until begin_pass promotes it —
        # under the prefetcher pass N+1's feed opens while pass N trains,
        # and must not clobber N's open window.
        self._feed_obs0 = {
            "stats0": {**stat_snapshot("ps."), **stat_snapshot("ckpt.")},
            "timers0": {n: (s, c) for n, s, c in self.timers.rows()},
            "m0": time.monotonic(),
        }
        flight.record("pass_feed_begin", pass_id=self.pass_id + 1,
                      day=self.day_id)
        # publish the cache index snapshot for THIS feed (prefetcher-safe:
        # the build thread intersects against this frozen view; hit
        # resolution re-checks the live index at adoption)
        self._feed_cache_snap = (self.cache.snapshot()
                                 if self.cache is not None else None)
        # pboxlint: disable-next=PB102 -- single-coordinator lifecycle flag
        self._feeding = True

    def add_keys(self, keys: np.ndarray) -> None:
        """Thread-safe feasign sink for dataset reader threads."""
        if len(keys):
            with self._agent_lock:
                self._agent_keys.append(np.asarray(keys, np.uint64))

    def _dedup_agent_keys(self) -> np.ndarray:
        with self.timers("dedup_keys"):
            with self._agent_lock:
                parts = self._agent_keys
                self._agent_keys = []
            allk = np.concatenate(parts) if parts else \
                np.empty((0,), np.uint64)
            uniq = np.unique(allk)
            return uniq[uniq != 0]  # key 0 = reserved zero row

    def _build_host(self, uniq: np.ndarray) -> tuple:
        """Host half of the build: the table pull — with the cache on,
        of the keys missing from the feed's snapshot only, plus the
        ``CachePlan`` that adoption resolves.  No device work, so it may
        run on the async build thread."""
        snap = self._feed_cache_snap
        with self.timers("build_pull"), \
                trace.span("ps.engine.build_pull", keys=len(uniq)):
            t0 = time.monotonic()
            plan = None
            if snap is not None and len(snap.keys) and len(uniq):
                # HBM tier: pull only cache MISSES from the table; the
                # snapshot-hit rows are filled from the device cache at
                # adoption (begin_pass, main thread)
                hit_mask = snap.lookup(uniq)
                miss = uniq[~hit_mask]
                if len(miss):
                    pulled = self.table.bulk_pull(miss)
                    miss_pos = np.flatnonzero(~hit_mask)
                    host_rows = {}
                    for f, v in pulled.items():
                        full = np.zeros((len(uniq),) + v.shape[1:], v.dtype)
                        full[miss_pos] = v
                        host_rows[f] = full
                else:
                    host_rows = self.cache.host_templates(len(uniq))
                plan = CachePlan(uniq[hit_mask], np.flatnonzero(hit_mask),
                                 snap, len(miss))
                pulled_n = len(miss)
            else:
                host_rows = self.table.bulk_pull(uniq)
                pulled_n = len(uniq)
                if self.cache is not None:
                    stat_add("ps.cache.misses", float(len(uniq)))
                    if heat.ACTIVE is not None:
                        heat.ACTIVE.observe_cache(0, len(uniq))
            t1 = time.monotonic()
            intervals.record("pull", t0, t1)
            stat_add("ps.engine.build_pull_s", t1 - t0)
            stat_add("ps.engine.build_pull_rows", float(pulled_n))
        return embedding.PassKeyMapper(uniq), len(uniq), host_rows, plan

    def _upload(self, host_rows) -> Dict[str, torch.Tensor]:
        # ctr_double accessor: the host keeps f64 show/click; the device
        # trains in f32, so end_pass writes back host + (device delta) in
        # f64 (≙ DownpourCtrDoubleAccessor, ctr_double_accessor.h)
        if host_rows["show"].dtype == np.float64:
            self._pulled_stats = {f: host_rows[f].copy()
                                  for f in ("show", "click")}
        else:
            self._pulled_stats = None
        with self.timers("build_device"):
            t0 = time.monotonic()
            ws = embedding.build_working_set(host_rows, self.device)
            intervals.record("upload", t0, time.monotonic())
            if self._pulled_stats is not None:
                ws["show_acc"] = torch.zeros_like(ws["show"])
                ws["click_acc"] = torch.zeros_like(ws["click"])
            return ws

    def _adopt(self, mapper, host_rows,
               plan: Optional[CachePlan]) -> Dict[str, torch.Tensor]:
        """Main-thread working-set assembly: resolve the feed's cache plan
        against the live index, pull any hit that was evicted since the
        snapshot, read the f64 pulled-stats base of the hits from the
        mirror, upload the miss rows and gather the hit rows on the
        device."""
        if plan is None or self.cache is None:
            if self.cache is not None:
                # a cold pass (empty snapshot): this pass's rate, set on
                # the thread that trains it
                stat_set("ps.cache.hit_rate", 0.0)
            return self._upload(host_rows)
        with self.timers("cache_gather"):
            valid, slots = self.cache.resolve(plan.keys, plan.snap)
            n_valid = int(valid.sum())
            inv_keys = plan.keys[~valid]
            if len(inv_keys):
                # evicted (or invalidated) between snapshot and adoption —
                # an ordinary miss, just discovered late
                fresh = self.table.bulk_pull(inv_keys)
                inv_pos = plan.pos[~valid]
                for f, v in fresh.items():
                    if f in host_rows:
                        host_rows[f][inv_pos] = v
                stat_add("ps.engine.build_pull_rows", float(len(inv_keys)))
                stat_add("ps.cache.gather_fallback_rows",
                         float(len(inv_keys)))
            hit_pos = plan.pos[valid]
            hit_slots = np.asarray(slots[valid], np.int64)
            if n_valid and host_rows["show"].dtype == np.float64:
                # ctr_double: the f64 stats base comes from the mirror
                for f, v in self.cache.read_mirror(
                        hit_slots, fields=("show", "click")).items():
                    host_rows[f][hit_pos] = v
            ws = self._upload(host_rows)
            if n_valid:
                ws = self.cache.scatter_into(
                    ws, mapper(plan.keys[valid]), hit_slots)
            # rows assembled from post-write-back state at adoption time —
            # the stale-row refresh must not re-pull them
            self._cache_fresh_keys = np.union1d(
                plan.keys[valid], inv_keys) if len(inv_keys) \
                else plan.keys[valid]
            n_miss = plan.n_miss + len(inv_keys)
            stat_add("ps.cache.hits", float(n_valid))
            stat_add("ps.cache.misses", float(n_miss))
            stat_set("ps.cache.hit_rate",
                     n_valid / max(n_valid + n_miss, 1))
            if heat.ACTIVE is not None:
                # hot-coverage: share of this pass's rows the device
                # cache served resident
                heat.ACTIVE.observe_cache(n_valid, n_miss)
            stat_add("ps.cache.bytes_saved",
                     float(n_valid * self.cache.row_bytes))
        return ws

    def end_feed_pass(self, async_build: bool = False) -> None:
        """Dedup pass keys, pull host rows, build the device working set.

        ``async_build=True`` pulls the host rows on a background thread
        for the NEXT pass while the current one still trains (≙
        EndFeedPass handing the agent to the feedpass thread pool,
        box_wrapper.cc:152 + start_build_thread ps_gpu_wrapper.cc:907);
        begin_pass adopts the result, uploads it on the calling thread and
        re-pulls the rows the in-flight pass writes at its end_pass (the
        reference accepts that staleness; this engine does not)."""
        assert self._feeding
        # pboxlint: disable-next=PB102 -- lifecycle flag, coordinator-only
        self._feeding = False
        uniq = self._dedup_agent_keys()
        flight.record("pass_feed_end", pass_id=self.pass_id + 1,
                      keys=len(uniq), asynchronous=async_build)
        if not async_build:
            assert self._build_thread is None and self._next is None, \
                "a preloaded pass is pending adoption (begin_pass) — " \
                "mixing it with a synchronous feed pass would discard data"
            self.mapper, self.num_keys, host_rows, plan = \
                self._build_host(uniq)
            self.ws = self._adopt(self.mapper, host_rows, plan)
            return
        assert self._build_thread is None, "previous async build not adopted"

        def run():
            try:
                self._next = self._build_host(uniq)
            except BaseException as e:  # re-raised in begin_pass, not lost
                self._build_error = e

        self._build_error = None
        # pboxlint: disable-next=PB102 -- coordinator-only thread handoff
        self._build_thread = threading.Thread(target=run, daemon=True,
                                              name="pbox-pass-build")
        self._build_thread.start()

    def wait_feed_pass_done(self) -> None:
        """≙ BoxHelper::WaitFeedPassDone (box_wrapper.h:1156).  Raises if
        the background build failed: a stale previous working set must
        never train in place of the failed pass."""
        if self._build_thread is not None:
            self._build_thread.join()
            self._build_thread = None
        err = self._build_error
        if err is not None:
            self._build_error = None
            raise RuntimeError(
                "async working-set build failed (end_feed_pass "
                "background thread)") from err

    def peek_next_mapper(self) -> Optional[embedding.PassKeyMapper]:
        """The key mapper the next begin_pass will adopt, as soon as the
        async host build finishes (this waits on it), without adopting the
        working set.  Key translation reads only the sorted key array,
        which the stale-row refresh never changes, so a pass packed
        against it before adoption is the pass packed after."""
        self.wait_feed_pass_done()
        if self._next is not None:
            return self._next[0]
        return self.mapper

    # -- train pass ----------------------------------------------------------
    def begin_pass(self) -> None:
        with trace.span("ps.engine.begin_pass", pass_id=self.pass_id + 1):
            if self._build_thread is not None or self._next is not None:
                self.wait_feed_pass_done()  # raises if async build failed
                assert self._next is not None
                self.mapper, self.num_keys, host_rows, plan = self._next
                self.ws = self._adopt(self.mapper, host_rows, plan)
                self._next = None
                self._refresh_stale_rows()
                self._cache_fresh_keys = None
            assert self.ws is not None, \
                "end_feed_pass must run before begin_pass"
            # promote the pending feed-time baseline to THIS pass's window
            if self._feed_obs0 is not None:
                self._pass_obs0 = self._feed_obs0
                self._feed_obs0 = None
            self.pass_id += 1
            flight.record("pass_begin", pass_id=self.pass_id,
                          keys=self.num_keys)

    def _refresh_stale_rows(self) -> None:
        """An async-built working set pulled host rows while the previous
        pass was still training; the rows that pass wrote at its end_pass
        are stale here.  Re-pull the intersection and overwrite those rows
        (unique rows, so the write is deterministic)."""
        if self._last_written is None or self.mapper is None \
                or self.num_keys == 0:
            return
        stale = np.intersect1d(self._last_written, self.mapper.sorted_keys,
                               assume_unique=True)
        fresh_keys = self._cache_fresh_keys
        if fresh_keys is not None and len(fresh_keys):
            # cache hits (and adoption-time fallback pulls) were assembled
            # AFTER the previous pass's write-back + fold-back — already
            # fresh, and re-pulling them would hand back the table bytes
            # the cache just saved
            stale = np.setdiff1d(stale, fresh_keys, assume_unique=True)
        if not len(stale):
            return
        with self.timers("refresh_stale"):
            stat_add("ps.engine.stale_refresh_rows", float(len(stale)))
            fresh = self.table.bulk_pull(stale)
            if self._pulled_stats is not None:
                pos = np.searchsorted(self.mapper.sorted_keys, stale)
                for f in ("show", "click"):
                    if f in fresh:
                        self._pulled_stats[f][pos] = fresh[f]
            if hasattr(self.table, "patch_snapshot"):
                # delta-mode remote tables: the refreshed values also
                # replace the write-back base for these rows
                self.table.patch_snapshot(self.mapper.sorted_keys, stale,
                                          fresh)
            rows = torch.as_tensor(self.mapper(stale).astype(np.int64),
                                   device=self.device)
            for f, t in self.ws.items():
                if f in fresh:
                    t[rows] = torch.as_tensor(fresh[f], dtype=t.dtype,
                                              device=self.device)

    def end_pass(self, need_save_delta: bool = False,
                 delta_path: str = "") -> None:
        """Write the trained working set back to the host table.

        If the write-back raises, ``ws``, ``mapper`` and the pulled stats
        stay intact, so calling ``end_pass`` again writes the same rows."""
        assert self.ws is not None and self.mapper is not None
        if faults.ACTIVE is not None:
            # seeded kill site: the trainer dies with a trained but
            # unwritten pass; auto-resume re-drives it from a checkpoint
            faults.on_lifecycle("end_pass")
        with self.timers("dump_to_cpu"), \
                trace.span("ps.engine.end_pass_write",
                           pass_id=self.pass_id, keys=self.num_keys):
            soa = embedding.dump_working_set(self.ws, self.num_keys)
            soa["unseen_days"] = np.zeros((self.num_keys,), np.float32)
            if self._pulled_stats is not None:
                # f64 base + the exact per-pass delta accumulators
                for f in ("show", "click"):
                    soa[f] = self._pulled_stats[f] + \
                        soa[f + "_acc"].astype(np.float64)
                    del soa[f + "_acc"]
            try:
                t0 = time.monotonic()
                self.table.bulk_write(self.mapper.sorted_keys, soa)
                t1 = time.monotonic()
                intervals.record("write", t0, t1)
                stat_add("ps.engine.end_pass_write_s", t1 - t0)
            except Exception:
                # keep _pulled_stats/ws/mapper: a re-driven end_pass must
                # rebuild the identical soa
                stat_add("ps.engine.end_pass_write_failure")
                raise
            self._pulled_stats = None
        if self.cache is not None:
            # fold-back: the ONLY cache row mutation — after the table
            # write succeeded, so a failed write-back replays end_pass
            # with the cache untouched (exactly-once)
            with self.timers("cache_fold"):
                casts = None
                if soa["show"].dtype == np.float64:
                    # hit rows must replay the same f64→f32 cast a table
                    # pull of the written row would
                    casts = {f: soa[f].astype(np.float32)
                             for f in ("show", "click")}
                self.cache.update_after_pass(
                    self.mapper.sorted_keys, soa, self.ws,
                    pass_id=self.pass_id, host_casts=casts)
        self.ws = None
        self._last_written = np.asarray(self.mapper.sorted_keys)
        # feed-gap attribution over this pass's window (begin_feed_pass →
        # write-back done), overlap-aware
        m0 = (self._pass_obs0 or {}).get("m0")
        if m0 is not None:
            rep = intervals.report(since=m0)
            self._pass_feed_report = rep
            stat_set("feed.device_busy_frac", rep["device_busy_frac"])
            stat_set("feed.feed_gap_ratio", rep["feed_gap_ratio"])
            # host feed seconds that ran under a step window
            for k in ("pull", "pack", "upload", "write"):
                # pboxlint: disable-next=PB204 -- closed kind set (intervals.KINDS)
                stat_set(f"feed.{k}_hidden_s", rep.get(f"{k}_hidden_s", 0.0))
        flight.record("pass_end", pass_id=self.pass_id, keys=self.num_keys)
        if flags.get_flags("obs_pass_report"):
            print(self.pass_report(), flush=True)
        if need_save_delta and delta_path:
            self.save_delta(delta_path)

    def reset_feed_state(self) -> None:
        """Drop every in-flight feed/pass artifact so a checkpoint restore
        starts from a clean pass boundary (io/checkpoint.py resume, and
        fleet.train_passes' auto-resume after a trainer death).  Joins a
        live async build first, then clears the working set, mapper, agent
        sink and the stale-row cursor (the restored table already holds
        the last durable pass)."""
        t = self._build_thread
        if t is not None:
            t.join(timeout=30)
        # crash-recovery teardown: the only writer thread joined above
        # pboxlint: disable-next=PB102 -- no concurrent build thread remains
        self._build_thread = None
        self._build_error = None
        self._next = None
        with self._agent_lock:
            self._agent_keys = []
        # pboxlint: disable-next=PB102 -- single-coordinator lifecycle flag
        self._feeding = False
        self._feed_obs0 = None
        self._pass_obs0 = None
        self.ws = None
        self.mapper = None
        self.num_keys = 0
        self._pulled_stats = None
        self._last_written = None
        self._feed_cache_snap = None
        self._cache_fresh_keys = None
        if self.cache is not None:
            # coherence point: a checkpoint restore / crash teardown may
            # roll the table back past rows the cache folded in — rebuild
            # cold (covers TrainCheckpoint.resume, PassPrefetcher.abort and
            # fleet.train_passes' auto-resume loop)
            self.cache.invalidate("reset")

    # -- persistence ---------------------------------------------------------
    def _save(self, path: str, mode: str) -> int:
        rows = self.table.save(path, mode=mode)
        flight.record("checkpoint_save", mode=mode, path=path, rows=rows)
        return rows

    def save_base(self, path: str) -> int:
        return self._save(path, "base")

    def save_delta(self, path: str) -> int:
        return self._save(path, "delta")

    def save_checkpoint(self, path: str) -> int:
        return self._save(path, "all")

    def load(self, path: str) -> int:
        rows = self.table.load(path)
        flight.record("checkpoint_load", path=path, rows=rows)
        if self.cache is not None:
            self.cache.invalidate("load")
        return rows

    def shrink(self) -> int:
        removed = self.table.shrink()
        if self.cache is not None:
            # shrink evicted dead table rows — cached copies of them must
            # not resurrect through a later hit
            self.cache.invalidate("shrink")
        return removed

    # -- convenience ---------------------------------------------------------
    def attach_dataset(self, dataset) -> None:
        """Register this engine as the dataset's feasign consumer
        (≙ PadBoxSlotDataset holding the BoxWrapper agent)."""
        dataset.register_key_consumer(self.add_keys)

    def print_sync_timers(self) -> str:
        return self.timers.report()

    def pass_report(self) -> str:
        """PrintSyncTimer-style per-pass wall-time table (≙ PrintSyncTimer
        box_wrapper.h:795): the phase seconds of this pass (deltas since
        its begin_feed_pass), the table pool's pressure, injected faults,
        checkpoint cost, the quality gauges and the feed-gap split.
        Printed at every end_pass under ``FLAGS_obs_pass_report``."""
        obs0 = self._pass_obs0 or {}
        stats0 = obs0.get("stats0") or {}
        timers0 = obs0.get("timers0") or {}
        cur = {**stat_snapshot("ps."), **stat_snapshot("ckpt.")}

        def delta(key: str) -> float:
            return cur.get(key, 0.0) - stats0.get(key, 0.0)

        lines = [f"---- PrintSyncTimer pass {self.pass_id} "
                 f"day {self.day_id or '-'} ----",
                 f"  {'phase':<20} {'seconds':>10} {'count':>7}"]
        for name, secs, count in self.timers.rows():
            s0, c0 = timers0.get(name, (0.0, 0))
            if count - c0 == 0 and secs - s0 < 1e-9:
                continue            # phase did not run this pass
            lines.append(f"  {name:<20} {secs - s0:>10.3f} "
                         f"{count - c0:>7d}")
        ch, cm = delta("ps.cache.hits"), delta("ps.cache.misses")
        if ch or cm:
            # HBM-tier effectiveness for THIS pass: rows the device cache
            # kept off the table pull, vs rows still pulled
            lines.append(
                f"  cache: hits={int(ch)} misses={int(cm)} "
                f"hit_rate={ch / max(ch + cm, 1.0):.2f} "
                f"resident={int(cur.get('ps.cache.resident_rows', 0))} "
                f"evictions={int(delta('ps.cache.evictions'))} "
                f"bytes_saved={int(delta('ps.cache.bytes_saved'))}")
        pool_tasks = delta("ps.pool.table.tasks")
        if pool_tasks:
            lines.append(
                f"  pool table: tasks={int(pool_tasks)} "
                f"busy={delta('ps.pool.table.busy_s'):.3f}s "
                f"threads={int(cur.get('ps.pool.table.threads', 1))} "
                f"queue_hwm={int(cur.get('ps.pool.table.queue_depth_hwm', 0))} "
                f"active_hwm={int(cur.get('ps.pool.table.active_hwm', 0))} "
                f"util_p95={cur.get('ps.pool.table.utilization.p95', 0.0):.2f}")
        faults_n = sum(delta(k) for k in cur if k.startswith("ps.fault."))
        if faults_n:
            lines.append(f"  injected_faults={int(faults_n)}")
        if delta("ckpt.save_s.count") > 0 or delta("ckpt.restore_s.count"):
            lines.append(
                f"  ckpt: saves={int(delta('ckpt.save_s.count'))} "
                f"save_s={delta('ckpt.save_s.sum'):.3f} "
                f"delta_rows={int(delta('ckpt.delta_rows'))} "
                f"restores={int(delta('ckpt.restore_s.count'))} "
                f"restore_s={delta('ckpt.restore_s.sum'):.3f} "
                f"generation={int(cur.get('ckpt.generation', -1))}")
        q = stat_snapshot("quality.")
        if q.get("quality.passes"):
            lines.append(
                f"  quality: auc={q.get('quality.auc', 0.0):.4f} "
                f"auc_window={q.get('quality.auc_window', 0.0):.4f} "
                f"auc_drop={q.get('quality.auc_drop', 0.0):.4f} "
                f"calib_drift={q.get('quality.calibration_drift', 0.0):.4f} "
                f"psi={q.get('quality.psi.prediction', 0.0):.4f}")
        rep = self._pass_feed_report
        if rep:
            lines.append(
                f"  feed gap: wall={rep['wall_s']:.3f}s "
                f"device_busy={rep['device_busy_s']:.3f}s "
                f"device_busy_frac={rep['device_busy_frac']:.2f} "
                f"feed_gap_ratio={rep['feed_gap_ratio']:.2f}")
            lines.append(
                f"  host busy: pull={rep['pull_busy_s']:.3f}s "
                f"pack={rep['pack_busy_s']:.3f}s "
                f"upload={rep['upload_busy_s']:.3f}s "
                f"write={rep['write_busy_s']:.3f}s "
                f"overlapped_with_device={rep['overlap_s']:.3f}s")
            hidden = {k: rep.get(f"{k}_hidden_s", 0.0)
                      for k in ("pull", "pack", "upload", "write")}
            if any(v > 1e-9 for v in hidden.values()):
                lines.append(
                    "  prefetch hidden: " + " ".join(
                        f"{k}={v:.3f}s" for k, v in hidden.items()))
        return "\n".join(lines)
