"""Pass lifecycle engine — the BoxWrapper/BoxHelper equivalent.

Port of ``paddlebox_tpu/ps/pass_manager.py`` (≙ BoxWrapper box_wrapper.h:377
+ BoxHelper box_wrapper.h:1043), synchronous lifecycle only:

  begin_feed_pass     ≙ BeginFeedPass (box_wrapper.cc:129) — opens a key
                        collection agent for the loading pass
  add_keys            ≙ PSAgent::AddKey via MergeInsKeys (data_set.cc:2293)
  end_feed_pass       ≙ EndFeedPass (box_wrapper.cc:152) — dedups the pass
                        keys, pulls rows from the host table and builds the
                        device working set (one pinned H2D per field)
  begin_pass/end_pass ≙ box_wrapper.cc:171,186 — end_pass writes the
                        working set back to the host table

Not ported yet (ROADMAP): set_date / day rollover, the device row cache,
async pass build and stale-row refresh, heat, flight events, fault
injection, quality rollover, save/load.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from paddlebox_tpu_torch.config import EmbeddingTableConfig
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.ps import embedding
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.utils import intervals, lockdep, trace
from paddlebox_tpu_torch.utils.monitor import stat_add
from paddlebox_tpu_torch.utils.timer import TimerRegistry


class BoxPSEngine:
    """Host table + the pass's device working set ``ws`` (a dict of
    tensors on ``device``; ``cuda`` unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, config: Optional[EmbeddingTableConfig] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.config = config or EmbeddingTableConfig()
        self.device = resolve_device(device)
        self.table = ShardedHostTable(self.config, seed=seed)
        self.timers = TimerRegistry()
        self.pass_id = 0

        self._agent_lock = lockdep.lock(
            "ps.pass_manager.BoxPSEngine._agent_lock")
        self._agent_keys: List[np.ndarray] = []
        self._feeding = False

        self.mapper: Optional[embedding.PassKeyMapper] = None
        self.ws: Optional[Dict[str, torch.Tensor]] = None
        self.num_keys = 0
        self._pulled_stats = None

    # -- feed pass -----------------------------------------------------------
    def begin_feed_pass(self) -> None:
        assert not self._feeding, "previous feed pass not closed"
        with self._agent_lock:
            self._agent_keys = []
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

    def _build_host(self, uniq: np.ndarray):
        with self.timers("build_pull"), \
                trace.span("ps.engine.build_pull", keys=len(uniq)):
            t0 = time.monotonic()
            host_rows = self.table.bulk_pull(uniq)
            t1 = time.monotonic()
            intervals.record("pull", t0, t1)
            stat_add("ps.engine.build_pull_s", t1 - t0)
            stat_add("ps.engine.build_pull_rows", float(len(uniq)))
        return embedding.PassKeyMapper(uniq), len(uniq), host_rows

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

    def end_feed_pass(self) -> None:
        """Dedup pass keys, pull host rows, build the device working set
        (synchronously; the async build is not ported)."""
        assert self._feeding
        # pboxlint: disable-next=PB102 -- lifecycle flag, coordinator-only
        self._feeding = False
        uniq = self._dedup_agent_keys()
        self.mapper, self.num_keys, host_rows = self._build_host(uniq)
        self.ws = self._upload(host_rows)

    # -- train pass ----------------------------------------------------------
    def begin_pass(self) -> None:
        with trace.span("ps.engine.begin_pass", pass_id=self.pass_id + 1):
            assert self.ws is not None, \
                "end_feed_pass must run before begin_pass"
            self.pass_id += 1

    def end_pass(self) -> None:
        """Write the trained working set back to the DRAM tier.  If the
        write-back raises, ``ws``, ``mapper`` and the pulled stats are
        left intact so a second ``end_pass`` rebuilds the same rows."""
        assert self.ws is not None and self.mapper is not None
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
            t0 = time.monotonic()
            self.table.bulk_write(self.mapper.sorted_keys, soa)
            t1 = time.monotonic()
            intervals.record("write", t0, t1)
            stat_add("ps.engine.end_pass_write_s", t1 - t0)
            self._pulled_stats = None
        self.ws = None

    def print_sync_timers(self) -> str:
        return self.timers.report()
