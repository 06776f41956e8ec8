"""Fleet facade — the user-level API surface.

Port of ``paddlebox_tpu/fleet.py`` (≙ paddle.distributed.fleet
(fleet/base/fleet_base.py:144), the BoxPSDataset python class
(python/paddle/fluid/dataset.py:1231: set_date/begin_pass/end_pass/
load_into_memory/preload_into_memory/wait_preload_done/slots_shuffle) and
Executor.train_from_dataset (executor.py:2412)).

A reference user drives training as:
    fleet.init(strategy)
    dataset = fleet.DatasetFactory().create_dataset("BoxPSDataset", ...)
    dataset.set_filelist(...)
    dataset.set_date(d); dataset.load_into_memory(); dataset.begin_pass()
    fleet.train_from_dataset(trainer, dataset)
    dataset.end_pass(True)
or hands a day's per-pass filelists to :func:`train_passes`.  This module
offers the same verbs over the port's one-card engine and trainer.  Not
ported yet: the trainer fleet (``run_trainer_fleet``) and topologies.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import (DataFeedConfig, DistributedStrategy,
                                        EmbeddingTableConfig)
from paddlebox_tpu_torch.data.dataset import ShuffleTransport, SlotDataset
from paddlebox_tpu_torch.data.prefetch import PassPrefetcher
from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.metrics import quality
from paddlebox_tpu_torch.metrics.auc import MetricGroup
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer
from paddlebox_tpu_torch.utils.backoff import Backoff
from paddlebox_tpu_torch.utils.monitor import stat_add

_GLOBAL: Dict = {"fleet": None}


class Fleet:
    """Process-wide runtime handle (≙ fleet_base.Fleet singleton)."""

    def __init__(self, strategy: Optional[DistributedStrategy] = None):
        self.strategy = strategy or DistributedStrategy()
        self.engine: Optional[BoxPSEngine] = None
        # the named metric registry (≙ BoxWrapper's metric maps,
        # box_wrapper.h:769)
        self.metrics = MetricGroup()

    # ≙ fleet.init(is_collective/role_maker)
    def init_engine(self, table_config: Optional[EmbeddingTableConfig] = None,
                    seed: int = 0, device: DeviceLike = None) -> BoxPSEngine:
        self.engine = BoxPSEngine(table_config or self.strategy.table,
                                  seed=seed, device=device)
        return self.engine

    @property
    def worker_num(self) -> int:
        return 1

    def barrier_worker(self) -> None:
        pass  # one trainer


def init(strategy: Optional[DistributedStrategy] = None) -> Fleet:
    f = Fleet(strategy)
    _GLOBAL["fleet"] = f
    return f


def instance() -> Fleet:
    if _GLOBAL["fleet"] is None:
        init()
    return _GLOBAL["fleet"]


class BoxPSDataset:
    """≙ BoxPSDataset (dataset.py:1231) + the BoxHelper pass loop: one
    object owning the slot dataset AND driving the engine's feed-pass
    overlap, so user code reads like the reference's day/pass loop."""

    def __init__(self, feed_config: DataFeedConfig,
                 engine: Optional[BoxPSEngine] = None,
                 parse_ins_id: bool = False, parse_logkey: bool = False,
                 read_threads: int = 4,
                 transport: Optional[ShuffleTransport] = None):
        self.feed_config = feed_config
        self.engine = engine or instance().engine
        assert self.engine is not None, "fleet.init_engine() first"
        self.dataset = SlotDataset(feed_config, parse_ins_id, parse_logkey,
                                   read_threads, transport)
        self.engine.attach_dataset(self.dataset)

    # -- file/date plumbing (dataset.py:1252-1285) --------------------------
    def set_filelist(self, filelist: Sequence[str]) -> None:
        self.dataset.set_filelist(filelist)

    def set_date(self, date: str) -> None:
        self.engine.set_date(date)

    # -- pass lifecycle ------------------------------------------------------
    def load_into_memory(self) -> None:
        self.engine.begin_feed_pass()
        self.dataset.load_into_memory()

    def preload_into_memory(self) -> None:
        self.engine.begin_feed_pass()
        self.dataset.preload_into_memory()

    def wait_preload_done(self) -> None:
        self.dataset.wait_preload_done()
        # readers are done feeding keys: kick the background working-set
        # build so it overlaps any still-running training pass
        self.engine.end_feed_pass(async_build=True)

    def begin_pass(self) -> None:
        if self.engine._feeding:
            self.engine.end_feed_pass()
        self.engine.begin_pass()

    def end_pass(self, need_save_delta: bool = False,
                 delta_path: str = "") -> None:
        self.engine.end_pass(need_save_delta, delta_path)
        self.dataset.release_memory()

    # -- shuffles ------------------------------------------------------------
    def local_shuffle(self) -> None:
        self.dataset.local_shuffle()

    def global_shuffle(self, by_ins_id: bool = False) -> None:
        self.dataset.global_shuffle(by_ins_id)

    def slots_shuffle(self, slots: Sequence[str]) -> None:
        """≙ BoxPSDataset.slots_shuffle (dataset.py:1302 →
        SlotsShuffle box_wrapper.h:1186): permute the chosen slots' feasign
        spans across instances, keeping everything else fixed (feature
        importance ablation)."""
        rng = np.random.default_rng(0)
        for block in self.dataset.get_blocks():
            for name in slots:
                if name not in block.uint64_slots:
                    continue
                values, offsets = block.uint64_slots[name]
                lens = np.diff(offsets)
                order = rng.permutation(block.n)
                # records keep their own length; only spans with equal length
                # swap cleanly — group by length and permute within groups
                for length in np.unique(lens):
                    rows = np.nonzero(lens == length)[0]
                    if len(rows) < 2 or length == 0:
                        continue
                    perm = rows[rng.permutation(len(rows))]
                    spans = np.stack([
                        values[offsets[r]:offsets[r] + length]
                        for r in perm])
                    for i, r in enumerate(rows):
                        values[offsets[r]:offsets[r] + length] = spans[i]

    # -- stats ---------------------------------------------------------------
    def get_memory_data_size(self) -> int:
        return self.dataset.instance_num()

    def get_shuffle_data_size(self) -> int:
        return self.dataset.instance_num()


class DatasetFactory:
    """≙ fluid.DatasetFactory (dataset.py:31)."""

    def create_dataset(self, name: str = "BoxPSDataset", **kw) -> BoxPSDataset:
        if name in ("BoxPSDataset", "InMemoryDataset", "SlotRecordDataset"):
            return BoxPSDataset(**kw)
        raise ValueError(f"unknown dataset type {name}")


def train_from_dataset(trainer: SparseTrainer, dataset: BoxPSDataset,
                       ) -> Dict[str, float]:
    """≙ Executor.train_from_dataset (executor.py:2412 →
    BoxPSTrainer::Run)."""
    return trainer.train_pass(dataset.dataset)


def _resumable(e: BaseException) -> bool:
    """A crash the resume tier may roll back and re-drive: a lost
    connection or a simulated process death (faults.InjectedFault is a
    ConnectionError), raised directly or by the prefetch worker
    (PassPrefetcher.next_pass and the engine's async build wrap the
    failing thread's error in RuntimeError)."""
    while isinstance(e, RuntimeError) and e.__cause__ is not None:
        e = e.__cause__
    return isinstance(e, ConnectionError)


def train_passes(trainer: SparseTrainer, dataset: BoxPSDataset,
                 passes: Sequence[Sequence[str]], date: Optional[str] = None,
                 before_pass=None, prefetch: Optional[bool] = None,
                 checkpoint=None, resume=None) -> list:
    """Day loop over per-pass filelists — the reference's
    set_date/load_into_memory/begin_pass/train/end_pass sequence
    (dataset.py:1231 usage), pipelined when ``FLAGS_pass_prefetch`` is on:
    pass N+1's read + key dedup + table pull + pack run on the
    prefetcher's background threads (data/prefetch.py) while pass N
    trains.  Results are bit-identical either way
    (tests/test_torch_fleet.py).  The flag defaults to on, as in the JAX
    package, but on an H100 at chip_smoke.py's depth (4 batches a pass)
    the prefetched loop is the SLOWER one: the worker may open pass N+1's
    feed only once pass N is adopted, a pass trains in well under a
    second, so it hides little of a 2-6 s feed chain, and the adoption's
    stale-row refresh is extra main-thread work (PERF.md §5).  Pass
    ``prefetch=False`` for short passes.

    passes: one filelist per pass.  before_pass(dataset) runs after the
    load, inside the pass's feed window — e.g.
    ``lambda ds: ds.preprocess_instance()`` for pv-grouped training.
    prefetch: override the flag (None = read FLAGS_pass_prefetch).

    Crash recovery (the production re-drive-by-date contract): pass a
    ``TrainCheckpoint`` (or set ``FLAGS_ckpt_dir``) and an auto-resume
    budget (``resume=N`` / True / ``FLAGS_auto_resume``) and the loop
    (1) resumes from the last committed generation — completed passes of
    the same ``date`` are SKIPPED via the checkpointed pass cursor,
    (2) saves an incremental generation after every completed pass, and
    (3) survives a mid-run failure with a two-tier retry: a write-back
    ``ConnectionError`` re-drives ``end_pass`` in place (the pinned-rid
    replay — chunks that landed dedup server-side), while a simulated
    process death (faults.InjectedFault from a lifecycle kill site) or an
    exhausted in-place retry tears the prefetcher down, reloads the last
    generation (rolling back any partial pass) and re-drives the
    remaining passes.  Only a ``ConnectionError`` (InjectedFault is one),
    or the prefetcher's RuntimeError wrapping one, is resumed: any other
    exception is a fault of the program and propagates at once.
    Bit-identity vs a fault-free run is asserted by
    tests/test_torch_fleet.py.

    Device row cache (``FLAGS_ps_device_cache``): no interaction needed
    here — both recovery tiers already pass through its coherence points.
    The prefetcher teardown calls ``engine.reset_feed_state`` and the
    checkpoint rollback calls ``TrainCheckpoint.resume``, each of which
    invalidates the cache, so a re-driven pass always rebuilds it cold
    from the rolled-back table and stays bit-identical to a cache-off
    run (tests/test_torch_device_cache.py).

    Returns the per-pass train metrics; passes skipped by the resume
    cursor (completed by a PREVIOUS incarnation) yield ``None`` entries
    so indices still line up with ``passes``."""
    engine, ds = dataset.engine, dataset.dataset
    if prefetch is None:
        prefetch = bool(flags.get_flags("pass_prefetch"))
    if resume is None:
        budget = int(flags.get_flags("auto_resume"))
    elif resume is True:
        budget = int(flags.get_flags("auto_resume")) or 8
    else:
        budget = int(resume)
    if checkpoint is None:
        root = flags.get_flags("ckpt_dir")
        if root:
            checkpoint = TrainCheckpoint(root)

    # resume BEFORE set_date: the restored day cursor decides whether
    # set_date triggers an end_day rollover (resuming into a new day) or
    # is a same-day re-drive (skip completed passes)
    state = None
    if checkpoint is not None and budget > 0:
        state = checkpoint.resume(engine, trainer)
    start = 0
    if state is not None and date is not None \
            and state.get("day_id") == date:
        start = min(int(state.get("pass_index", 0) or 0), len(passes))
    if date is not None:
        dataset.set_date(date)
    if checkpoint is not None and budget > 0 and state is None:
        # durable floor before the first pass: a crash after pass 0's
        # write-back but before its generation commits must roll back TO
        # something, or the re-driven pass double-applies
        checkpoint.save(engine, trainer,
                        extra={"day_id": engine.day_id, "pass_index": start})

    metrics: list = [None] * start

    def end_with_replay(end_fn) -> None:
        # in-place tier: the server died (or dropped us) mid write-back
        # while THIS trainer survived — engine/adapter state is intact, so
        # re-driving end_pass resends byte-identical chunks under pinned
        # rids (already-landed chunks dedup server-side).  The backoff
        # window rides out a supervisor restart (launch.PSServerSupervisor)
        bo = Backoff(base=0.05, cap=2.0, deadline=30.0)
        attempt = 0
        while True:
            try:
                end_fn()
                return
            except faults.InjectedFault:
                raise       # simulated process death → outer resume tier
            except ConnectionError:
                attempt += 1
                stat_add("ps.fleet.end_pass_replay")
                if not bo.sleep(attempt):
                    raise

    def save_cursor(i: int) -> None:
        if checkpoint is not None:
            checkpoint.save_pass(engine, trainer,
                                 extra={"day_id": engine.day_id,
                                        "pass_index": i + 1})

    def run_serial(todo) -> None:
        for i in todo:
            dataset.set_filelist(passes[i])
            dataset.load_into_memory()
            if before_pass is not None:
                before_pass(ds)
            dataset.begin_pass()
            feed = trainer.build_pass_feed(ds)
            m = trainer.train_pass(feed)
            end_with_replay(dataset.end_pass)
            metrics.append(m)
            quality.observe_pass(m, pass_id=engine.pass_id,
                                  day=engine.day_id)
            save_cursor(i)

    def run_prefetch(todo) -> None:
        def load(filelist):
            # runs on the prefetch worker INSIDE the feed window the
            # prefetcher opened (begin_feed_pass is its job, not ours)
            ds.set_filelist(filelist)
            ds.load_into_memory()   # reader threads feed keys to engine
            if before_pass is not None:
                before_pass(ds)
            return ds

        pf = PassPrefetcher(engine, trainer)
        try:
            for i in todo:
                pf.submit(lambda fl=passes[i]: load(fl))
            for i in todo:
                feed = pf.next_pass()
                m = trainer.train_pass(feed)
                # NOT dataset.end_pass(): its release_memory would drop
                # the blocks the worker already loaded for the NEXT pass
                end_with_replay(pf.end_pass)
                metrics.append(m)
                quality.observe_pass(m, pass_id=engine.pass_id,
                                      day=engine.day_id)
                save_cursor(i)
        except BaseException:
            # failure path only: drop the pipeline AND the engine's
            # in-flight feed state so the resume tier re-drives against a
            # clean pass boundary (the happy path keeps feed state — the
            # caller may chain more days onto this engine)
            pf.abort()
            raise
        finally:
            pf.close()

    todo = list(range(start, len(passes)))
    while True:
        try:
            if prefetch:
                run_prefetch(todo)
            else:
                run_serial(todo)
            return metrics
        except (ConnectionError, RuntimeError) as e:
            if checkpoint is None or budget <= 0 or not _resumable(e):
                raise
            budget -= 1
            stat_add("ps.fleet.auto_resume")
            # roll the world back to the last committed generation: the
            # partial pass's table writes (if any) are discarded with the
            # reload, and the re-drive below replays it deterministically
            if not prefetch:
                if hasattr(engine, "reset_feed_state"):
                    engine.reset_feed_state()
            ds.release_memory()
            state = checkpoint.resume(engine, trainer)
            # the cursor only stands when the restored generation belongs
            # to THE DAY THIS CALL DRIVES — a crash before the new day's
            # first durable pass rolls the world back into the previous
            # day, whose completed cursor must not skip the new passes
            new_start = 0
            if state is not None and date is not None \
                    and state.get("day_id") == date:
                new_start = min(int(state.get("pass_index", 0) or 0),
                                len(passes))
            if date is not None and engine.day_id != date:
                # rolled back across the day boundary: re-drive set_date
                # (end_day decay) exactly as the first attempt did —
                # deterministic, since the table was rolled back with it
                dataset.set_date(date)
            del metrics[new_start:]
            metrics.extend([None] * (new_start - len(metrics)))
            todo = list(range(new_start, len(passes)))
