"""Shared named worker pools for per-shard host-table fan-out.

≙ MemorySparseTable's ``shards_task_pool_`` (ps/table/memory_sparse_table.cc:
every Pull/Push/Save/Shrink fans one task per shard across a dedicated
thread pool).  Our ``ShardedHostTable`` used to walk shards one at a time on
the caller's thread — after the pipelined wire path made the client
bandwidth-bound, that serial walk became the floor under
``build_pull``/``end_pass_write``.  The heavy per-shard work is numpy
slicing/assignment, which releases the GIL, so fanning shards across a small
thread pool is real host parallelism; the per-shard locks make it safe and
keys are unique per call, so results are bit-identical to the sequential
walk (append order within a shard stays single-threaded).

One process-wide pool (``kind="table"``) is shared by every table so
concurrent callers (the async preload pull + the main-thread write-back)
queue against ONE bounded worker set instead of multiplying threads.
``FLAGS_ps_table_threads`` sizes it; ``1`` restores the exact sequential
path (no executor at all).

Observability (the ``ps.pool.<kind>.*`` namespace, folded into /statz and
the per-pass report):

* ``queue_depth``/``queue_depth_hwm`` — tasks submitted-but-unfinished at
  submit time: a persistently deep queue means shard tasks outpace the pool.
* ``active_hwm``/``utilization`` — workers busy at task start (utilization
  is the busy fraction of the pool, histogram → p50/p95 in snapshots).
* ``busy_s``/``tasks``/``task_s`` — cumulative busy seconds, task count and
  the per-task latency distribution.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, TypeVar

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils import flight, lockdep
from paddlebox_tpu_torch.utils.monitor import (stat_add, stat_max, stat_observe,
                                         stat_set)

T = TypeVar("T")
R = TypeVar("R")

flags.define_flag(
    "ps_table_threads", min(8, os.cpu_count() or 1),
    "worker threads of the shared host-table shard pool: bulk_pull/"
    "bulk_write/end_day/shrink/save/load and the ssd fault-in fan one "
    "task per shard across it (numpy shard work releases the GIL).  "
    "1 = sequential on the caller's thread; results are bit-identical "
    "at any setting")

flags.define_flag(
    "pass_pack_threads", min(4, os.cpu_count() or 1),
    "worker threads of the whole-pass packer (data/pass_feed.pack_pass): "
    "per-slot plane builds and record-range partitions of the pad/"
    "translate work fan across it, each worker writing disjoint rows of "
    "the preallocated SoA planes (numpy pad/searchsorted releases the "
    "GIL).  1 = sequential on the caller's thread; results are "
    "bit-identical at any setting")


class WorkPool:
    """A named, metered ThreadPoolExecutor wrapper with an inline
    sequential path at ``threads=1`` (and for single-item maps).

    ``map`` is the only work surface: run ``fn`` over ``items``, return
    results in item order, re-raise the first failure.  Calls from a
    worker thread of THIS pool run inline — a shard task that fans out
    again (e.g. SSD fault-in promoting rows) can never deadlock the pool
    by waiting on futures no free worker can run.
    """

    def __init__(self, threads: int, kind: str = "table"):
        self.kind = kind
        self.threads = max(1, int(threads))
        self._prefix = f"pbox-{kind}"
        self._lock = lockdep.lock("utils.workpool.WorkPool._lock")
        self._queued = 0        # submitted, not yet picked up
        self._active = 0        # running right now
        self._sat_hwm = 0       # deepest saturated queue flight-recorded
        self._ex: Optional[ThreadPoolExecutor] = None
        if self.threads > 1:
            self._ex = ThreadPoolExecutor(
                max_workers=self.threads,
                thread_name_prefix=self._prefix)
        stat_set(f"ps.pool.{self.kind}.threads", float(self.threads))

    def _run_one(self, fn: Callable[[T], R], item: T) -> R:
        with self._lock:
            lockdep.guards(self, "_active")
            self._queued -= 1
            self._active += 1
            active = self._active
        stat_max(f"ps.pool.{self.kind}.active_hwm", float(active))
        stat_observe(f"ps.pool.{self.kind}.utilization",
                     active / float(self.threads))
        t0 = time.monotonic()
        try:
            return fn(item)
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                self._active -= 1
            stat_add(f"ps.pool.{self.kind}.tasks")
            stat_add(f"ps.pool.{self.kind}.busy_s", dt)
            stat_observe(f"ps.pool.{self.kind}.task_s", dt)

    def map(self, fn: Callable[[T], R], items: Sequence[T]) -> List[R]:
        items = list(items)
        n = len(items)
        ex = self._ex        # one read: a concurrent resize may None it
        if n == 0:
            return []
        # inline paths: no executor, nothing to overlap, or already ON a
        # pool worker (re-entrant fan-out must not wait on the pool)
        if (ex is None or n == 1
                or threading.current_thread().name.startswith(self._prefix)):
            return [fn(it) for it in items]
        with self._lock:
            self._queued += n
            depth = self._queued + self._active
            # flight-record saturation only on a NEW high-water mark so
            # a persistently deep queue emits O(log) events, not O(maps)
            saturated_hwm = depth > self.threads and depth > self._sat_hwm
            if saturated_hwm:
                self._sat_hwm = depth
        stat_observe(f"ps.pool.{self.kind}.queue_depth", float(depth))
        stat_max(f"ps.pool.{self.kind}.queue_depth_hwm", float(depth))
        if saturated_hwm:
            flight.record("pool_saturated", pool=self.kind, depth=depth,
                          threads=self.threads)
        futs = []
        try:
            for it in items:
                futs.append(ex.submit(self._run_one, fn, it))
        except RuntimeError:
            # executor raced a resize/shutdown (flag flip mid-flight):
            # finish what was submitted, run the REST inline — every item
            # executes exactly once (decay/append tasks are not
            # idempotent), none is dropped
            with self._lock:
                self._queued = max(0, self._queued - (n - len(futs)))
            head = [f.result() for f in futs]
            return head + [fn(it) for it in items[len(futs):]]
        return [f.result() for f in futs]

    def state(self) -> dict:
        """Queue/occupancy snapshot for the wedge doctor
        (utils/doctor.py): is a hang waiting ON the pool or IN it?"""
        with self._lock:
            return {"kind": self.kind, "threads": self.threads,
                    "queued": self._queued, "active": self._active,
                    "saturated_hwm": self._sat_hwm}

    def shutdown(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=False)
            self._ex = None


_POOL: Optional[WorkPool] = None
_POOL_LOCK = threading.Lock()

_PACK_POOL: Optional[WorkPool] = None
_PACK_POOL_LOCK = threading.Lock()


def table_pool() -> WorkPool:
    """The process-wide shard pool, sized by ``FLAGS_ps_table_threads``.
    Re-reads the flag on every call so tests (and live reconfiguration)
    can flip pool size between passes; a resize retires the old executor
    gracefully (in-flight maps finish or fall back inline)."""
    global _POOL
    want = max(1, int(flags.get_flags("ps_table_threads")))
    with _POOL_LOCK:
        if _POOL is None or _POOL.threads != want:
            old, _POOL = _POOL, WorkPool(want, kind="table")
            if old is not None:
                old.shutdown()
        return _POOL


def pack_pool() -> WorkPool:
    """The process-wide whole-pass pack pool, sized by
    ``FLAGS_pass_pack_threads`` — same re-read/resize contract as
    :func:`table_pool`, separate so a deep table fan-out can never starve
    the pass packer (and vice versa)."""
    global _PACK_POOL
    want = max(1, int(flags.get_flags("pass_pack_threads")))
    with _PACK_POOL_LOCK:
        if _PACK_POOL is None or _PACK_POOL.threads != want:
            old, _PACK_POOL = _PACK_POOL, WorkPool(want, kind="pack")
            if old is not None:
                old.shutdown()
        return _PACK_POOL


def pool_state() -> Optional[dict]:
    """State of the process pool WITHOUT creating it (doctor scrapes
    must not side-effect a pool into existence); None when no pool has
    been built yet."""
    with _POOL_LOCK:
        pool = _POOL
    return pool.state() if pool is not None else None
