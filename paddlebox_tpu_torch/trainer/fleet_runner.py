"""Fault-tolerant multi-trainer data parallelism: the fleet runner.

Port of ``paddlebox_tpu/trainer/fleet_runner.py``.  ≙ the reference's
multi-trainer BoxPS deployment (N trainer processes × M PS shards,
fleet_desc-driven): every trainer reads a 1/N file split, globally
shuffles records by key, trains its share of the pass against the shared
PS tier, and the fleet converges to ONE model.  This module gives that
fleet the SAME robustness contract the PS fleet already has
(ps/cluster.py + launch.PSServerSupervisor): kill any trainer at any
point — mid-shuffle, mid-train, mid-write-back, mid-fold, mid-save —
and the supervisor-restarted rank rejoins and the run converges
**bit-identically** to the never-killed run.

Every slice engine and the trainer live on the runner's ``device``
(``cuda`` unless the caller passes ``"cpu"``).  Ranks may be threads of
one process on one card (``fleet.run_trainer_fleet``): each rank's
device work is then launched from its supervisor's thread, on the
card's default stream, and the kernels' launch counters sum over ranks.

Determinism anchor — virtual slices
-----------------------------------
Records never partition by rank.  They partition by a fixed count of
``V = FLAGS_fleet_virtual_shards`` *virtual slices*:
``slice_of(route_keys(block), V)`` (data/shuffle_transport.SHUFFLE_SALT,
decorrelated from the PS CLUSTER_SALT).  Rank ``r`` of an ``N``-wide
fleet owns slices ``{v : v % N == r}`` — fleet width only decides
*placement* of slices, never their *content* or *order*.  Every
fp-order-sensitive reduction then runs per-slice and folds in ascending
``v``:

* each owned slice trains from the SAME pass-start dense state
  (``dense0``) on its own fresh engine, producing a dense delta ``Δ_v``
  and a metrics vector;
* sparse write-backs happen in ``V`` barrier-separated *turns*, turn
  ``v`` writing exactly slice ``v``'s delta — the server folds
  overlapping rows in slice order, not arrival order;
* the dense fold is :meth:`FleetCollective.reduce_slots`: publish owned
  ``Δ_v`` to epoch-suffixed dense slots, fence, then EVERY rank pulls
  slots ``0..V-1`` and accumulates in that fixed order
  (``final = dense0 + ΣΔ_v``) — identical fp sequence at any ``N``.

So ``N=1`` and ``N=4`` execute the *same arithmetic in the same order*;
only the wall-clock placement differs.

Crash-anywhere exactly-once
---------------------------
Every cross-process side effect is driven through a rid deterministic in
(rank, epoch, slice) — ``namespaced_group("fleet", rank, ...)`` — so a
restarted rank replays *byte-identical* requests and the PS dedup
windows collapse the duplicates:

* slice write-backs pin group ``fleet.t<r>:e<epoch>.v<v>`` before
  ``end_pass`` (landed chunks dedup, unlanded apply once);
* fleet barriers/folds ride :class:`FleetCollective` (PB604: every wait
  deadline-bounded, expiry raises the typed ``PeerDead``);
* day rollover is the 2-phase ``end_day`` under the leader-failover
  group ``fleet.day:<d>.endday`` — exactly once per day no matter how
  many leaders drive it.

A restarted rank resumes from the ONE manifest (io/checkpoint.py): it
reads the fleet cursor, rolls its dense replica back to the pass
boundary, replays the cursor pass's pulls against a **shadow table**
(the checkpoint bytes — the live table may already hold other ranks'
pass-``e`` write-backs, which the original pulls never saw), and
re-drives the pass.  The shuffle transport resyncs the epoch's frames
from the survivors' retained send buffers.

Leadership is *advisory*: the elected leader (min live rank, file
heartbeats with a background beat thread) merely drives lifecycle
duties first; any rank stuck at a duty-fenced barrier pokes the duty
closure itself, and the closures are idempotent (lease markers +
cursor checks + dedup'd rids), so a dead leader delays a save by one
poke interval instead of wedging the fleet.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import DataFeedConfig, EmbeddingTableConfig
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.data_feed import DataFeed
from paddlebox_tpu_torch.data.pass_feed import route_keys
from paddlebox_tpu_torch.data.shuffle_transport import slice_of
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.metrics import quality
from paddlebox_tpu_torch.metrics.auc import AucCalculator
from paddlebox_tpu_torch.parallel.collective import (FleetCollective,
                                               namespaced_group)
from paddlebox_tpu_torch.ps import cluster as ps_cluster
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.ps.service import RemoteTableAdapter
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.backoff import Backoff
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe, stat_set

flags.define_flag(
    "trainers", 1,
    "trainer fleet width N: each pass's filelist splits 1/N per rank and "
    "re-partitions by record key over the shuffle transport")
flags.define_flag(
    "fleet_virtual_shards", 8,
    "virtual slice count V — the fleet's determinism anchor: records "
    "route to a fixed V slices independent of fleet width, rank r owns "
    "slices v % N == r, and every order-sensitive fold runs in ascending "
    "v.  MUST stay constant across runs being compared bit-for-bit")
flags.define_flag(
    "fleet_hb_ttl_s", 2.0,
    "trainer membership heartbeat TTL: a rank silent past this drops "
    "from the live set and leadership moves to the next live rank")

# AUC bucket resolution of the per-pass metrics fold (exact counts at
# this resolution — integer-valued f64s, so the cross-rank sum is exact)
_FOLD_BINS = 50
# metrics fold vector: [batches, loss_sum, pos[50], neg[50]]
_MVEC_LEN = 2 + 2 * _FOLD_BINS


# ---------------------------------------------------------------------------
# Membership / leader election
# ---------------------------------------------------------------------------

class _Membership:
    """File-heartbeat membership over the shared workdir (the fleet's
    cheap substitute for an external lock service): each rank renews
    ``members/hb-<r>`` from a BACKGROUND thread (a rank blocked in a
    20s-cadence barrier retry must not miss its 2s TTL), the live set is
    the ranks with a fresh beat, and the leader is the minimum live
    rank.  Election is advisory — correctness never depends on there
    being exactly one leader (duties are idempotent) — so split-brain
    during a TTL race costs a duplicate no-op, not divergence."""

    def __init__(self, workdir: str, rank: int, world: int,
                 ttl_s: Optional[float] = None):
        self.dir = os.path.join(workdir, "members")
        os.makedirs(self.dir, exist_ok=True)
        self.rank = int(rank)
        self.world = int(world)
        self.ttl_s = (float(flags.get_flags("fleet_hb_ttl_s"))
                      if ttl_s is None else float(ttl_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_leader: Optional[int] = None

    def _hb_path(self, r: int) -> str:
        return os.path.join(self.dir, f"hb-{r}")

    def heartbeat(self) -> None:
        tmp = self._hb_path(self.rank) + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{time.time():.6f}")
        os.replace(tmp, self._hb_path(self.rank))

    def live(self) -> set:
        now = time.time()
        out = {self.rank}
        for r in range(self.world):
            if r == self.rank:
                continue
            try:
                with open(self._hb_path(r)) as f:
                    t = float(f.read() or 0.0)
            except (OSError, ValueError):
                continue
            if now - t <= self.ttl_s:
                out.add(r)
        return out

    def leader(self) -> int:
        led = min(self.live())
        if led != self._last_leader:
            prev, self._last_leader = self._last_leader, led
            stat_set("trainer.fleet.leader", float(led))
            flight.record("leader_elect", leader=led, previous=prev,
                          observer=self.rank)
        return led

    def start(self) -> None:
        self.heartbeat()
        interval = max(0.05, self.ttl_s / 3.0)

        def beat():
            while not self._stop.wait(interval):
                try:
                    self.heartbeat()
                except OSError:
                    pass

        # pboxlint: disable-next=PB405 -- heartbeat pump for the runner's lifetime; stop() joins it
        self._thread = threading.Thread(target=beat, daemon=True,
                                        name=f"pbox-fleet-hb-{self.rank}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# Shadow table — the restarted rank's replay pull source
# ---------------------------------------------------------------------------

class _ShadowTable:
    """Engine-facing table for a crashed rank's pass REPLAY: pulls read
    the pass-boundary CHECKPOINT (what the original pulls saw) instead
    of the live PS (which may already hold other ranks' current-pass
    write-backs), while seeding the adapter's delta-snapshot with those
    same bytes so ``bulk_write`` recomputes byte-identical deltas —
    which then dedup/land exactly once under the pinned rid group.
    Keys absent from the checkpoint resolve to the shadow's
    key-deterministic fresh rows — the same rows the server materializes
    for a delta-push to a never-pulled key (ps/service.py
    push_sparse_delta), so even a pre-first-checkpoint key replays
    identically.  Everything except ``bulk_pull`` delegates to the
    adapter."""

    def __init__(self, adapter: RemoteTableAdapter,
                 shadow: ShardedHostTable):
        self._adapter = adapter
        self._shadow = shadow

    def bulk_pull(self, keys):
        rows = self._shadow.bulk_pull(np.asarray(keys, np.uint64))
        self._adapter.seed_snapshot(keys, rows)
        stat_add("trainer.fleet.shadow_pull_rows", float(len(keys)))
        return rows

    def __getattr__(self, name):
        return getattr(self._adapter, name)


def load_shadow_table(ckpt: TrainCheckpoint, config: EmbeddingTableConfig,
                      seed: int) -> ShardedHostTable:
    """Materialize the head generation's sparse state into a local
    ShardedHostTable, walking the base+delta chain AND — the cluster
    case — each generation's ``shard-<k:03d>/`` subdirs (cluster_save
    fans one logical dump over M shard subdirs; a flat
    ``load_table(shard=None)`` would read zero rows from an M>1 dump).
    Part index == key % shard_num on every PS shard (they share the
    table config), so all M dumps' ``part-i`` files upsert cleanly into
    local shard ``i``."""
    shadow = ShardedHostTable(config, seed=seed)
    head = ckpt._manifest()
    if head is None:
        return shadow
    chain = ckpt._state(head).get("chain", [head])
    for gen in chain:
        sparse = os.path.join(ckpt._gen_dir(gen), "sparse")
        width = ps_cluster.dump_width(sparse)
        if width <= 1:
            shadow.load(sparse, mode="upsert")
        else:
            for k in range(width):
                shadow.load(ps_cluster.shard_dir(sparse, k), mode="upsert")
    return shadow


# ---------------------------------------------------------------------------
# Checkpoint shim
# ---------------------------------------------------------------------------

class _CkptEngine:
    """The minimal engine surface ``TrainCheckpoint._save_generation``
    reads (table / day_id / pass_id / phase / server_map-via-table) —
    the fleet snapshots the shared adapter + the post-fold trainer, not
    any one slice engine."""

    def __init__(self, table, day_id: Optional[str], pass_id: int):
        self.table = table
        self.day_id = day_id
        self.pass_id = int(pass_id)
        self.phase = 1
        self._last_written = None


# ---------------------------------------------------------------------------
# Dense state <-> flat vector
# ---------------------------------------------------------------------------

def _adam_state_keys(opt: torch.optim.Optimizer, group: Dict) -> tuple:
    """Per-parameter state keys of the dense optimizer, in the flat
    vector's order.  Adam creates them lazily at its first step, so a
    fresh optimizer holds none: the layout comes from the optimizer's
    type, never from what it happens to hold."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError(
            f"the fleet's dense fold flattens Adam's state only, got "
            f"{type(opt).__name__}")
    keys = ("step", "exp_avg", "exp_avg_sq")
    return keys + (("max_exp_avg_sq",) if group.get("amsgrad") else ())


def _flatten_dense(trainer) -> np.ndarray:
    """(module parameters, dense optimizer state) -> one host f32 vector:
    ``named_parameters()`` in order, then per parameter group and
    parameter the optimizer's state (absent state reads as zeros, step
    0 — what Adam would create).  f32 keeps the fold arithmetic in the
    model's own precision (Δ accumulation in v order is then the exact
    sequence a single process would run)."""
    parts = [p.detach().cpu().numpy().astype(np.float32).ravel()
             for _, p in trainer.model.named_parameters()]
    opt = trainer.dense_opt
    for group in opt.param_groups:
        keys = _adam_state_keys(opt, group)
        for p in group["params"]:
            st = opt.state.get(p, {})
            for k in keys:
                v = st.get(k)
                if v is None:
                    parts.append(np.zeros(1 if k == "step" else p.numel(),
                                          np.float32))
                else:
                    parts.append(torch.as_tensor(v).detach().cpu().numpy()
                                 .astype(np.float32).ravel())
    if not parts:
        return np.zeros((0,), np.float32)
    return np.concatenate(parts)


def _unflatten_dense(trainer, flat: np.ndarray) -> None:
    """Write ``flat`` back in place: ``param.data.copy_`` keeps the
    optimizer bound to the same ``Parameter`` objects (as
    ``TrainCheckpoint.restore_dense`` does), and every state entry is
    written — existing tensors keep their dtype and device, absent ones
    are created where Adam would create them (``step`` a CPU scalar
    unless the group is capturable or fused)."""
    off = 0

    def take(n: int) -> np.ndarray:
        nonlocal off
        chunk = flat[off:off + n]
        off += n
        return chunk

    with torch.no_grad():
        for _, p in trainer.model.named_parameters():
            p.data.copy_(torch.from_numpy(
                take(p.numel()).reshape(tuple(p.shape))))
        opt = trainer.dense_opt
        for group in opt.param_groups:
            keys = _adam_state_keys(opt, group)
            on_device = bool(group.get("capturable") or group.get("fused"))
            for p in group["params"]:
                st = opt.state[p]
                for k in keys:
                    val = torch.from_numpy(
                        take(1 if k == "step" else p.numel()).copy())
                    cur = st.get(k)
                    if torch.is_tensor(cur):
                        cur.copy_(val.reshape(cur.shape))
                    elif k == "step":
                        st[k] = val.reshape(()).to(
                            dtype=torch.float64
                            if torch.get_default_dtype() == torch.float64
                            else torch.float32,
                            device=p.device if on_device else "cpu")
                    else:
                        st[k] = val.reshape(tuple(p.shape)).to(
                            dtype=p.dtype, device=p.device)
    if off != len(flat):
        raise ValueError(f"dense vector of {len(flat)} values, the trainer "
                         f"holds {off}")


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

class FleetRunner:
    """One trainer rank of the N-wide fleet (see module docstring).

    ``days`` for :meth:`run` is ``[(date, [filelist, ...]), ...]`` — per
    day, the ordered passes, each pass a GLOBAL filelist (every rank
    sees the same list; rank r reads indices ``r, r+N, ...``).
    ``device``: where the slice engines and the trainer work (``cuda``
    unless ``"cpu"`` is asked for; raises when CUDA is asked for and
    absent).
    """

    def __init__(self, rank: int, world: int, client, workdir: str,
                 table_config: EmbeddingTableConfig,
                 model_fn: Callable[[], object],
                 feed_config: DataFeedConfig, batch_size: int,
                 virtual_shards: Optional[int] = None,
                 table_seed: int = 0, trainer_seed: int = 0,
                 prefetch: bool = False, transport=None,
                 fault_plan: Optional[faults.FaultPlan] = None,
                 auc_table_size: int = 100_000,
                 parse_ins_id: bool = False, device: DeviceLike = None):
        self.rank = int(rank)
        self.device = resolve_device(device)
        self.world = int(world)
        self.client = client
        self.workdir = workdir
        self.table_config = table_config
        self.feed_config = feed_config
        self.batch_size = int(batch_size)
        self.table_seed = int(table_seed)
        self.prefetch = bool(prefetch)
        self.transport = transport
        self.fault_plan = fault_plan
        self.parse_ins_id = bool(parse_ins_id)
        self.V = int(flags.get_flags("fleet_virtual_shards")
                     if virtual_shards is None else virtual_shards)
        if self.V < self.world:
            raise ValueError(
                f"fleet_virtual_shards={self.V} < world={self.world}: "
                f"some ranks would own no slice — raise V (and keep it "
                f"constant across every run you compare)")
        if self.world > 1 and self.transport is None:
            raise ValueError("world > 1 requires a shuffle transport")

        os.makedirs(workdir, exist_ok=True)
        self._marker_dir = os.path.join(workdir, "saved")
        os.makedirs(self._marker_dir, exist_ok=True)

        # every owned slice's pull snapshot is held until its write-back
        # turn, so the adapter must keep one per owned slice (the JAX
        # runner keeps FLAGS_ps_snap_cap, 4: with more owned slices it
        # evicts one and that slice's write-back fails)
        owned = len(range(self.rank, self.V, self.world))
        self.adapter = RemoteTableAdapter(
            client, delta_mode=True,
            snap_cap=max(int(flags.get_flags("ps_snap_cap")), owned))
        self._table = self.adapter          # swapped to _ShadowTable on replay
        # the bootstrap engine only anchors the trainer's construction;
        # every trained slice gets its own fresh engine (rebound per
        # slice — the trainer keeps nothing of an engine between passes
        # but its table config, which every slice engine shares)
        boot = BoxPSEngine(table_config, seed=self.table_seed,
                           device=self.device)
        boot.table = self.adapter
        self.trainer = SparseTrainer(boot, model_fn(), feed_config,
                                     batch_size,
                                     auc_table_size=auc_table_size,
                                     seed=trainer_seed, device=self.device)
        self.coll = FleetCollective(client, self.rank, self.world)
        self.membership = _Membership(workdir, self.rank, self.world)
        self.ckpt = TrainCheckpoint(os.path.join(workdir, "ckpt"))
        self.history: List[Dict] = []
        stat_set("trainer.fleet.rank", float(self.rank))

    # -- faults --------------------------------------------------------------
    def _fault(self, point: str) -> None:
        plan = self.fault_plan
        if plan is None:
            return
        act = plan.fire("lifecycle", None, point)
        if act is None:
            return
        if act.kind == "delay":
            time.sleep(act.delay_s)
        elif act.kind in ("kill", "drop", "kill_server"):
            plan.killed.set()
            raise faults.InjectedFault(
                f"injected: trainer killed at fleet point ({point})")

    # -- leadership / duties -------------------------------------------------
    def _poke(self, duty: Optional[Callable[[], None]] = None
              ) -> Callable[[], None]:
        def poke():
            try:
                self.membership.heartbeat()
            except OSError:
                pass
            if duty is not None and self.membership.leader() == self.rank:
                duty()
        return poke

    def _claim(self, tag: str, lease_s: float = 30.0) -> bool:
        """Best-effort single-writer lease for a lifecycle duty: O_EXCL
        marker claims it; a claimer dead past ``lease_s`` (cursor still
        behind — the caller re-checks) gets stolen on the next poke."""
        path = os.path.join(self._marker_dir, tag)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, f"{time.time():.6f}".encode())
            os.close(fd)
            return True
        except FileExistsError:
            try:
                with open(path) as f:
                    t = float(f.read() or 0.0)
            except (OSError, ValueError):
                t = 0.0
            if time.time() - t > lease_s:
                try:
                    os.unlink(path)   # stale claim: next attempt retries
                except OSError:
                    pass
            return False

    def _cursor(self) -> Tuple[int, int, int]:
        st = self.ckpt.read_state()
        fl = (st or {}).get("fleet")
        if not fl:
            return (-1, -1, -1)
        return (int(fl["epoch"]), int(fl["day_index"]),
                int(fl["pass_index"]))

    def _save_ckpt(self, date: Optional[str], pass_id: int,
                   cursor: Tuple[int, int, int]) -> None:
        epoch, di, pi = cursor
        eng = _CkptEngine(self.adapter, day_id=date, pass_id=pass_id)
        self.ckpt.save(eng, self.trainer, extra={"fleet": {
            "epoch": epoch, "day_index": di, "pass_index": pi,
            "world": self.world, "virtual_shards": self.V,
            # all ranks advance in lockstep (barrier-fenced), so the
            # per-trainer cursor map is uniform — recorded per rank in
            # the ONE manifest for the N x M runbook's inspection tools
            "cursors": {str(r): epoch for r in range(self.world)},
            "history": self.history,
        }})
        flight.record("fleet_cursor", epoch=epoch, day_index=di,
                      pass_index=pi, rank=self.rank)

    def _duty_save(self, cursor: Tuple[int, int, int],
                   date: Optional[str], pass_id: int,
                   tag: str) -> Callable[[], None]:
        """Idempotent save duty: advance the manifest to ``cursor`` if
        nobody has yet.  Runs on the leader inline, and on any rank's
        barrier poke after a leader death (lease + cursor check keep it
        single-shot; a duplicate save would write identical bytes as a
        fresh generation — wasteful, never divergent)."""
        def duty():
            if self._cursor() >= cursor:
                return
            if not self._claim(tag):
                return
            self._save_ckpt(date, pass_id, cursor)
        return duty

    def _duty_floor(self) -> None:
        """Fresh-start floor generation: the initial base checkpoint
        every crash-recovery shadow replays against (epoch-0 deaths
        included).  Guarded by the manifest's absence rather than a
        marker — a marker writer dying pre-commit would otherwise leave
        a state nobody can recover from."""
        if self.ckpt._manifest() is not None:
            return
        if not self._claim("floor"):
            return
        if self.ckpt._manifest() is None:
            self._save_ckpt(None, 0, (0, 0, 0))

    # -- engines -------------------------------------------------------------
    def _make_engine(self, date: str) -> BoxPSEngine:
        eng = BoxPSEngine(self.table_config, seed=self.table_seed,
                          device=self.device)
        eng.table = self._table
        # fresh engine: day_id is None so this only adopts the date (no
        # decay, no quality rollover — the leader's end_day duty owns
        # both, exactly once fleet-wide)
        eng.set_date(date, table_decay=False)
        return eng

    def _end_pass_with_replay(self, engine: BoxPSEngine) -> None:
        """Drive the slice write-back to completion: a dropped
        connection re-runs ``end_pass`` in place — the adapter kept the
        snapshot and the PINNED group, so the retry resends
        byte-identical chunks under identical rids (landed ones dedup).
        Budgeted by the fleet deadline, not attempt-counted (PB501)."""
        bo = Backoff(base=0.1, cap=2.0, deadline=self.coll.deadline_s)
        attempt = 0
        while True:
            try:
                engine.end_pass()
                return
            except faults.InjectedFault:
                raise
            except ConnectionError:
                attempt += 1
                stat_add("trainer.fleet.end_pass_replays")
                if not bo.sleep(attempt):
                    raise

    # -- shuffle -------------------------------------------------------------
    def _shuffle_pass(self, filelist: Sequence[str], epoch: int
                      ) -> Dict[int, List[SlotRecordBlock]]:
        """Read this rank's 1/N of the filelist, route every record to
        its virtual slice, ship non-owned slices to their owners, and
        collect what the peers shipped here.  Reading is single-threaded
        in global file order so the per-destination send sequence — and
        with it the idempotent-resend seq numbering — is deterministic:
        a restarted rank re-sends the exact frames the survivors'
        watermarks already saw."""
        if self.transport is not None:
            self.transport.set_epoch(epoch)
        local: Dict[int, List[SlotRecordBlock]] = {}
        feed = DataFeed(self.feed_config, self.parse_ins_id)
        t0 = time.monotonic()
        for fi in range(self.rank, len(filelist), self.world):
            self._fault("fleet_shuffle")
            for j, block in enumerate(feed.read_file(filelist[fi])):
                sl = slice_of(route_keys(block), self.V)
                for v in np.unique(sl):
                    sub = block.select(np.nonzero(sl == v)[0])
                    sub.shuffle_tag = (int(v), fi, j)
                    dst = int(v) % self.world
                    if dst == self.rank:
                        local.setdefault(int(v), []).append(sub)
                    else:
                        self.transport.send(dst, sub)
        if self.transport is not None:
            self.transport.barrier()
            for blk in self.transport.drain():
                v = int(blk.shuffle_tag[0])
                local.setdefault(v, []).append(blk)
        stat_observe("trainer.fleet.shuffle_s", time.monotonic() - t0)
        for v in local:
            local[v].sort(key=lambda b: b.shuffle_tag)
        return local

    # -- metrics -------------------------------------------------------------
    @staticmethod
    def _metrics_vec(result: Optional[Dict]) -> np.ndarray:
        vec = np.zeros((_MVEC_LEN,), np.float64)
        if result is None:
            return vec
        batches = float(result.get("batches", 0))
        vec[0] = batches
        vec[1] = float(result.get("loss", 0.0)) * batches
        bk = result.get("auc_buckets") or {}
        pos = np.asarray(bk.get("pos", np.zeros(_FOLD_BINS)), np.float64)
        neg = np.asarray(bk.get("neg", np.zeros(_FOLD_BINS)), np.float64)
        vec[2:2 + _FOLD_BINS] = pos
        vec[2 + _FOLD_BINS:] = neg
        return vec

    @staticmethod
    def _fold_metrics(slots: List[np.ndarray]) -> Dict[str, float]:
        acc = np.zeros((_MVEC_LEN,), np.float64)
        for s in slots:                      # ascending v — fixed order
            acc += np.asarray(s, np.float64)
        batches = acc[0]
        calc = AucCalculator(table_size=_FOLD_BINS)
        calc._pos[:] = acc[2:2 + _FOLD_BINS]
        calc._neg[:] = acc[2 + _FOLD_BINS:]
        auc = calc.compute()["auc"]
        return {
            "batches": int(batches),
            "loss": float(acc[1] / batches) if batches else 0.0,
            "auc": float(auc),
        }

    # -- one pass ------------------------------------------------------------
    def _run_pass(self, di: int, date: str, pi: int,
                  filelist: Sequence[str], epoch: int,
                  shadow: bool) -> Dict:
        """The full pass protocol (see module docstring): shuffle →
        per-slice train → pull/write fence → V write-back turns → dense
        fold → metrics fold → cursor save → pass barrier."""
        r, N, V = self.rank, self.world, self.V
        if shadow and self.transport is not None:
            # fresh process mid-epoch: ask survivors to replay their
            # retained epoch frames (our previous incarnation's inbox
            # died with it) — set_epoch first so the replays land in the
            # right window
            self.transport.set_epoch(epoch)
            self.transport.resync()
        local = self._shuffle_pass(filelist, epoch)

        owned = [v for v in range(V) if v % N == r]
        flat0 = _flatten_dense(self.trainer)

        # feed + train each owned slice from the same dense0; prefetch
        # mode builds slice i+1's working set (its PULLS) while slice i
        # trains — safe before the tr fence because no write-back has
        # happened yet, so every pull still reads the pass-start table
        engines: Dict[int, BoxPSEngine] = {}
        deltas: Dict[int, np.ndarray] = {}
        results: Dict[int, Optional[Dict]] = {}

        def open_feed(v: int) -> Tuple[BoxPSEngine, SlotDataset]:
            eng = self._make_engine(date)
            eng.pass_id = epoch
            ds = SlotDataset(self.feed_config, self.parse_ins_id)
            ds._blocks = local.get(v, [])
            eng.begin_feed_pass()
            for b in ds._blocks:
                eng.add_keys(b.all_keys())
            eng.end_feed_pass(async_build=self.prefetch)
            return eng, ds

        nonempty = [v for v in owned if local.get(v)]
        pending: Dict[int, Tuple[BoxPSEngine, SlotDataset]] = {}
        if self.prefetch and nonempty:
            pending[nonempty[0]] = open_feed(nonempty[0])
        for i, v in enumerate(nonempty):
            if self.prefetch:
                eng, ds = pending.pop(v)
                if i + 1 < len(nonempty):
                    pending[nonempty[i + 1]] = open_feed(nonempty[i + 1])
            else:
                eng, ds = open_feed(v)
            eng.begin_pass()
            # restore the pass-start dense state so every slice's delta
            # is measured from the same base (slices sum, not chain)
            _unflatten_dense(self.trainer, flat0)
            self.trainer.engine = eng
            self.trainer.reset_metrics()
            res = self.trainer.train_pass(ds)
            flat1 = _flatten_dense(self.trainer)
            engines[v] = eng
            deltas[v] = flat1 - flat0
            results[v] = res
        for v in owned:
            if v not in deltas:
                deltas[v] = np.zeros_like(flat0)
                results[v] = None

        # fence: EVERY rank's pulls (feed builds) precede ANY write-back
        t_bar = time.monotonic()
        self.coll.barrier(f"tr.{epoch}", poke=self._poke())
        stat_observe("trainer.fleet.straggler_gap_s",
                     time.monotonic() - t_bar)

        # V write-back turns in ascending v: the server applies slice
        # deltas in slice order — overlapping rows fold associatively in
        # an N-independent sequence
        for v in range(V):
            if v % N == r and v in engines:
                self._fault("end_pass")
                group = namespaced_group("fleet", r, f"e{epoch}.v{v}")
                self.adapter.pin_group(engines[v].mapper.sorted_keys, group)
                self._end_pass_with_replay(engines[v])
            self.coll.barrier(f"wb.{epoch}.{v}", poke=self._poke())

        # dense fold — epoch-suffixed slot names: a twice-crashed rank
        # replaying pass e must never read pass e+1's values out of a
        # reused name.  (The server accumulates one V-vector set per
        # pass; documented retention cost, see ARCHITECTURE.md.)
        self._fault("fleet_allreduce")
        slot_vecs = self.coll.reduce_slots(
            f"fleet.d.{epoch}", {v: deltas[v] for v in owned}, V,
            tag=f"d.{epoch}", poke=self._poke())
        final = flat0.copy()
        for vec in slot_vecs:                       # ascending v
            final += np.asarray(vec, np.float32)
        _unflatten_dense(self.trainer, final)

        # metrics fold (same transport: exact counts, v order)
        mvecs = self.coll.reduce_slots(
            f"fleet.m.{epoch}", {v: self._metrics_vec(results[v])
                                 for v in owned}, V,
            tag=f"m.{epoch}", poke=self._poke())
        metrics = self._fold_metrics(mvecs)
        metrics.update({"day": date, "pass": pi, "epoch": epoch})
        self.history.append(metrics)

        # cursor save (leader first, any poked rank on leader death),
        # then the pass barrier — whose release proves the save landed
        cursor = (epoch + 1, di, pi + 1)
        duty = self._duty_save(cursor, date, epoch + 1,
                               tag=f"pass-e{epoch:06d}")
        if self.membership.leader() == self.rank:
            duty()
        self.coll.barrier(f"pass.{epoch}", timeout=5.0,
                          poke=self._poke(duty))
        return metrics

    # -- day end -------------------------------------------------------------
    def _day_end(self, di: int, date: str, epoch: int) -> None:
        """Two-phase day rollover, exactly once fleet-wide: the decay
        verb pins the leader-failover group (any rank may re-drive it;
        the dedup windows collapse duplicates), the cursor advances to
        (di+1, 0), and the day barrier fences the next day."""
        group = namespaced_group("fleet.day", None, f"d{di}.endday")
        save = self._duty_save((epoch, di + 1, 0), date, epoch,
                               tag=f"day-d{di:06d}")

        def duty():
            if self._cursor() >= (epoch, di + 1, 0):
                return
            self.client.end_day(table=None, group=group)
            quality.end_day(date)
            save()

        if self.membership.leader() == self.rank:
            duty()
        self.coll.barrier(f"day.{di}", timeout=5.0, poke=self._poke(duty))

    # -- run -----------------------------------------------------------------
    def run(self, days: Sequence[Tuple[str, Sequence[Sequence[str]]]]
            ) -> Dict:
        self.membership.start()
        try:
            return self._run(days)
        finally:
            self.membership.stop()
            if self.transport is not None:
                self.transport.close()

    def _run(self, days) -> Dict:
        st = self.ckpt.read_state()
        restarted = bool(st and st.get("fleet"))
        if not restarted:
            # fresh fleet: establish the floor generation before anyone
            # trains — the recovery anchor for epoch-0 deaths.  Inline on
            # the (believed) leader, NOT only via barrier pokes: a poke
            # fires only between retry attempts, so a first-try barrier
            # would otherwise release with no floor written at all.
            # Startup membership may elect several self-leaders for an
            # instant — the manifest-absence check + claim lease keep
            # the save single-shot regardless.
            if self.membership.leader() == self.rank:
                self._duty_floor()
            self.coll.barrier("floor", timeout=5.0,
                              poke=self._poke(self._duty_floor))
            st = self.ckpt.read_state()
        fl = (st or {}).get("fleet") or {"epoch": 0, "day_index": 0,
                                         "pass_index": 0, "history": []}
        epoch = int(fl["epoch"])
        di0 = int(fl["day_index"])
        pi0 = int(fl["pass_index"])
        self.history = list(fl.get("history", []))

        if restarted:
            flight.record("trainer_resume", rank=self.rank, epoch=epoch,
                          day_index=di0, pass_index=pi0)
            # dense rolls back to the cursor's pass boundary — the base
            # every surviving rank measured this pass's deltas from
            self.ckpt.restore_dense(self.trainer)
            # tail-barrier replay: our previous incarnation may have
            # died between the cursor save and its registration at the
            # trailing barrier(s) — survivors would wait forever.  The
            # rids are deterministic, so if we DID register, these are
            # cached acks (no double count); if not, we register now.
            self.coll.barrier("floor", timeout=5.0,
                              poke=self._poke(self._duty_floor))
            if epoch > 0:
                self.coll.barrier(f"pass.{epoch - 1}", timeout=5.0,
                                  poke=self._poke())
            if pi0 == 0 and di0 > 0:
                self.coll.barrier(f"day.{di0 - 1}", timeout=5.0,
                                  poke=self._poke())

        # the cursor pass (if mid-day) replays against the checkpoint
        # shadow: the live table may already hold other ranks' pass-e
        # write-backs, which the original pulls never saw
        shadow_first = restarted

        for di in range(di0, len(days)):
            date, passes = days[di]
            pi_start = pi0 if di == di0 else 0
            for pi in range(pi_start, len(passes)):
                if shadow_first:
                    shadow_first = False
                    shadow_tbl = load_shadow_table(
                        self.ckpt, self.table_config, self.table_seed)
                    self._table = _ShadowTable(self.adapter, shadow_tbl)
                    stat_add("trainer.fleet.shadow_replays")
                    try:
                        self._run_pass(di, date, pi, passes[pi], epoch,
                                       shadow=True)
                    finally:
                        self._table = self.adapter
                else:
                    self._run_pass(di, date, pi, passes[pi], epoch,
                                   shadow=False)
                epoch += 1
            # a rank restarted exactly at the day boundary (pass_index
            # == len) replays the day end; the dedup'd group + cursor
            # check make the replay exactly-once
            self._day_end(di, date, epoch)

        return {"history": self.history,
                "params": {n: p.detach().cpu().clone() for n, p
                           in self.trainer.model.named_parameters()},
                "opt_state": copy.deepcopy(
                    self.trainer.dense_opt.state_dict()["state"]),
                "epoch": epoch, "rank": self.rank}
