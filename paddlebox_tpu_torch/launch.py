"""Multi-process launcher + distributed runtime init, and the
supervisors of the trainer, parameter-server and serving tiers.

Port of ``paddlebox_tpu/launch.py`` (≙ `python -m
paddle.distributed.launch`, launch/main.py + controllers/): ``launch``
spawns one worker process per rank with the rendezvous env, restarts
failed ones and tears the job down on fatal errors; ``launch_elastic``
relaunches into a shrunk or regrown world; ``init_distributed`` is the
worker's rendezvous (a ``torch.distributed`` gloo group where the JAX
package calls ``jax.distributed.initialize``); ``ClusterScraper`` folds
every worker's ``/statz`` into the job-level ``/clusterz`` timeline;
``TrainerSupervisor`` restarts one fleet-trainer rank in place;
``PSServerSupervisor``, ``PSFleet`` and ``PSElasticWatcher`` run the
sharded PS tier; ``ServingReplicaSupervisor`` and ``serve_fleet`` the
serving tier.  Host code (processes, sockets, threads): importing this
module imports no torch; ``init_distributed`` imports
``torch.distributed`` when it runs.

Usage:
    python -m paddlebox_tpu_torch.launch --nproc_per_node 2 train.py --args...
Inside the worker, call ``init_distributed()`` first.

A one-host fleet, trained through::

    flt = PSFleet(4, config=table_config, seed=0)
    engine.table = RemoteTableAdapter(PSClient(flt.addrs), delta_mode=True)
    fleet.train_passes(trainer, dataset, passes, date=...)
    flt.stop()
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from paddlebox_tpu_torch.utils import flight


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """≙ fleet.init collective rendezvous (MPICluster box_wrapper.h:446):
    a ``torch.distributed`` gloo group over ``tcp://<coordinator>``.
    Reads the PBOX_* env set by the launcher when args are omitted
    (``PBOX_COORDINATOR``, ``PBOX_WORLD_SIZE``, ``PBOX_RANK``).  Returns
    this process's rank; :func:`process_group` is then the group a
    topology's cross-process dp axis takes.  No-op for single-process
    jobs.  Gloo, not NCCL: NCCL refuses two ranks on one card, and the
    fleet's ranks share a card.  The rendezvous and every later
    operation of the group give up after ``FLAGS_fleet_deadline_s``, so
    a peer that never joins, or is lost, fails the job instead of
    hanging it."""
    from paddlebox_tpu_torch.utils import doctor, obs_server
    # worker-side observability entry: FLAGS_obs_port (assigned base+rank
    # by the launcher) starts the /metrics exporter; FLAGS_obs_trace the
    # span tracer — both no-ops when unset.  The wedge doctor's SIGUSR1
    # handler makes every worker live-interrogable (kill -USR1 <pid>
    # writes a postmortem bundle under FLAGS_obs_postmortem_dir).
    obs_server.maybe_start_from_flags()
    doctor.install()
    num = num_processes if num_processes is not None else \
        int(os.environ.get("PBOX_WORLD_SIZE", "1"))
    if num <= 1:
        return 0
    rank = process_id if process_id is not None else \
        int(os.environ.get("PBOX_RANK", "0"))
    coord = coordinator or os.environ.get("PBOX_COORDINATOR",
                                          "127.0.0.1:12355")
    import datetime

    import torch.distributed as dist

    from paddlebox_tpu_torch import flags
    from paddlebox_tpu_torch.parallel import collective  # noqa: F401 (flag)
    deadline = float(flags.get_flags("fleet_deadline_s"))
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=num, rank=rank,
                            timeout=datetime.timedelta(seconds=deadline))
    return rank


def process_group():
    """The group :func:`init_distributed` formed (the default group), or
    None in a single-process job: what a cross-process topology is given
    (``HybridTopology(..., process_group=process_group())``)."""
    import torch.distributed as dist
    return dist.group.WORLD if dist.is_initialized() else None


class ClusterScraper:
    """Supervisor-side cluster aggregation: a periodic thread pulling
    every worker's ``/statz?raw=1``, folding the live scrapes through
    the bucket-wise ``obs_server.merge_snapshots`` into a JOB-LEVEL
    timeline (utils/timeline.TimelineRing), served at ``/clusterz`` —
    the horizontal half of the telemetry timeline.

    Tolerant of dead/restarting workers by construction: a failed
    scrape just drops that worker from the interval's fold (and marks
    it dead in the ``workers`` map) — the merged series carries on with
    whoever answers.  ``stop()`` joins the thread (PB405)."""

    def __init__(self, ports: List[int], interval_s: float = 5.0,
                 cap: int = 512, host: str = "127.0.0.1",
                 prefix: str = ""):
        from paddlebox_tpu_torch.utils import obs_server, timeline
        self._obs = obs_server
        self.ports = list(ports)
        self.interval_s = float(interval_s)
        self.host = host
        # narrow the per-interval pull to one dotted subtree (the
        # /statz?prefix= filter) — "" scrapes everything
        self.prefix = prefix
        self.ring = timeline.TimelineRing(cap)
        self._alive: Dict[int, bool] = {p: False for p in self.ports}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_ports(self, ports: List[int]) -> None:
        """Fold more workers into the scrape set — how the trainer
        fleet's /statz exporters join the same /clusterz timeline as the
        PS tier (launched later than the scraper, hence dynamic)."""
        with self._lock:
            for p in ports:
                if p not in self._alive:
                    self.ports.append(p)
                    self._alive[p] = False

    def scrape_once(self) -> int:
        """One scrape+merge round; returns how many workers answered
        (0 appends nothing — an all-dead interval is a gap, not a zero
        sample)."""
        path = "/statz?raw=1"
        if self.prefix:
            path += f"&prefix={self.prefix}"
        snaps = []
        with self._lock:
            ports = list(self.ports)   # snapshot: add_ports appends live
        for p in ports:
            snap = self._obs.scrape(p, path=path, host=self.host)
            with self._lock:
                self._alive[p] = snap is not None
            if snap:
                snaps.append(snap)
        if snaps:
            merged = self._obs.merge_snapshots(snaps)
            # pboxlint: disable-next=PB102 -- TimelineRing locks internally; single scrape-thread writer
            self.ring.append(merged)
        return len(snaps)

    def start(self) -> "ClusterScraper":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pbox-clusterscrape", daemon=True)
            self._thread.start()
        self._obs.set_clusterz_provider(self.render)
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — scraping must never die
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._obs.set_clusterz_provider(None)

    def render(self, name: Optional[str] = None,
               n: Optional[int] = None) -> Dict:
        """The /clusterz payload: index + per-worker liveness, or one
        merged metric's series via ``?name=``."""
        if name:
            out = self.ring.series(name, n=n)
            out["enabled"] = True
            return out
        with self._lock:
            workers = {str(p): alive for p, alive in self._alive.items()}
        latest = self.ring.samples(1)
        return {"enabled": True, "interval_s": self.interval_s,
                "len": len(self.ring), "workers": workers,
                "names": self.ring.names(),
                "latest": latest[0]["stats"] if latest else {}}


def launch(script: str, script_args: List[str], nproc: int,
           coordinator: str = "127.0.0.1:12355",
           max_restarts: int = 0, log_dir: str = "",
           obs_port: int = 0) -> int:
    """Spawn nproc workers; restart failed ones up to max_restarts
    (≙ launch controllers' replica watch).

    obs_port > 0 assigns each worker rank its own exporter port
    (``FLAGS_obs_port = obs_port + rank``); the launcher then scrapes
    every worker's /statz periodically and prints ONE merged job-wide
    snapshot at teardown (the supervisor-side half of the observability
    layer — obs_server.merge_snapshots)."""
    procs: List[Optional[subprocess.Popen]] = [None] * nproc
    restarts = [0] * nproc
    obs_last: Dict[int, Dict] = {}      # rank -> last good /statz
    obs_t = [0.0]

    def spawn(rank: int) -> subprocess.Popen:
        env = dict(os.environ)
        env.update({
            "PBOX_RANK": str(rank),
            "PBOX_WORLD_SIZE": str(nproc),
            "PBOX_COORDINATOR": coordinator,
        })
        if obs_port:
            # pboxlint: disable-next=PB203 -- env export to spawned workers
            env["FLAGS_obs_port"] = str(obs_port + rank)
        stdout = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            stdout = open(os.path.join(log_dir, f"worker-{rank}.log"), "ab")
        return subprocess.Popen([sys.executable, script] + script_args,
                                env=env, stdout=stdout,
                                stderr=subprocess.STDOUT if stdout else None)

    def obs_scrape(final: bool = False) -> None:
        """Best-effort periodic pull of every live worker's /statz; the
        merged view prints once at job teardown (day end)."""
        if not obs_port:
            return
        now = time.time()
        if not final and now - obs_t[0] < 5.0:
            return
        obs_t[0] = now
        from paddlebox_tpu_torch.utils import obs_server
        for r, p in enumerate(procs):
            if p is not None and p.poll() is None:
                # raw=1 ships each worker's histogram buckets so the
                # merged percentiles are recomputed bucket-wise instead
                # of max-of-percentiles (obs_server.merge_snapshots)
                snap = obs_server.scrape(obs_port + r,
                                         path="/statz?raw=1")
                if snap:
                    obs_last[r] = snap
        if final and obs_last:
            merged = obs_server.merge_snapshots(list(obs_last.values()))
            print("[obs] merged job snapshot "
                  f"({len(obs_last)} workers): "
                  + json.dumps(merged, sort_keys=True),
                  file=sys.stderr, flush=True)

    for r in range(nproc):
        procs[r] = spawn(r)

    scraper: Optional[ClusterScraper] = None
    if obs_port:
        # job-level merged timeline: the supervisor serves /clusterz on
        # the port just past the worker range (obs_port + nproc)
        from paddlebox_tpu_torch.utils import obs_server
        scraper = ClusterScraper(
            [obs_port + r for r in range(nproc)]).start()
        obs_server.start(port=obs_port + nproc)

    exit_code = 0
    try:
        while True:
            alive = 0
            for r, p in enumerate(procs):
                if p is None:
                    continue
                ret = p.poll()
                if ret is None:
                    alive += 1
                elif ret != 0 and restarts[r] < max_restarts:
                    restarts[r] += 1
                    flight.record("worker_restart", rank=r, code=ret,
                                  restarts=restarts[r])
                    procs[r] = spawn(r)
                    alive += 1
                elif ret != 0:
                    # fatal: kill the rest (≙ controller abort)
                    exit_code = ret
                    for q in procs:
                        if q is not None and q.poll() is None:
                            q.send_signal(signal.SIGTERM)
                    return exit_code
                else:
                    procs[r] = None
            if alive == 0:
                return exit_code
            obs_scrape()
            time.sleep(0.2)
    except KeyboardInterrupt:
        for q in procs:
            if q is not None and q.poll() is None:
                q.send_signal(signal.SIGTERM)
        return 130
    finally:
        obs_scrape(final=True)
        if scraper is not None:
            scraper.stop()


def launch_elastic(script: str, script_args: List[str], nproc: int,
                   elastic_dir: str,
                   coordinator_host: str = "127.0.0.1",
                   coordinator_base_port: int = 12400,
                   min_workers: int = 1,
                   max_relaunches: int = 3,
                   heartbeat_ttl: float = 6.0,
                   log_dir: str = "",
                   poll_s: float = 0.2,
                   obs_port: int = 0) -> int:
    """Elastic job orchestration: relaunch into a shrunk/regrown world.

    ≙ ElasticManager + launcher cooperating (fleet/elastic/manager.py:131
    watch loop, :217-233 restart path): workers heartbeat into a TTL'd
    FileStore (the etcd-prefix equivalent, elastic.FileStore); the
    launcher watches BOTH process liveness and heartbeats.  On a failure
    it re-rendezvouses: every surviving worker is stopped, lost ranks are
    dropped (scale-in), any pending grow request is honored up to the
    original nproc (scale-out), and a NEW generation spawns with
    renumbered ranks 0..new_world-1, a fresh coordinator port, and
    PBOX_ELASTIC_GEN bumped — workers recover via checkpoint auto-resume
    (io/checkpoint.py), exactly the reference's restart semantics.

    Loss classification (single-host stand-ins for node loss):
      * FIRST exit by SIGKILL      -> treated as a crash: the rank
                                      respawns.  On Linux an OOM-killed
                                      worker also exits -SIGKILL, and a
                                      transient OOM must not permanently
                                      shrink capacity.
      * REPEAT SIGKILL (same rank) -> the rank's "node" really is gone
                                      (or pathologically OOMs): scale-in
      * heartbeat expired, alive   -> partitioned: SIGTERM + scale-in
      * any other nonzero exit     -> crash: rank respawns in the new
                                      generation (same world size)
      * exit 0                     -> done; leaves the job quietly
    Scale-out: write the desired extra worker count into
    ``<elastic_dir>/grow`` — honored at the next (or a voluntary)
    re-rendezvous (≙ the reference watching new joiners under the np
    prefix).

    Returns 0 when every worker of the final generation exits 0; nonzero
    when the world would drop below min_workers or relaunch budget is
    exhausted.
    """
    from paddlebox_tpu_torch.elastic import FileStore

    os.makedirs(elastic_dir, exist_ok=True)
    store = FileStore(os.path.join(elastic_dir, "members"),
                      ttl=heartbeat_ttl)
    grow_path = os.path.join(elastic_dir, "grow")
    gen = 0
    world = nproc
    relaunches = 0

    def spawn(rank: int, world_size: int, generation: int):
        env = dict(os.environ)
        env.update({
            "PBOX_RANK": str(rank),
            "PBOX_WORLD_SIZE": str(world_size),
            "PBOX_COORDINATOR":
                f"{coordinator_host}:{coordinator_base_port + generation}",
            "PBOX_ELASTIC_DIR": elastic_dir,
            "PBOX_ELASTIC_GEN": str(generation),
        })
        if obs_port:
            # rank-based, so ports are stable across generations
            # pboxlint: disable-next=PB203 -- env export to spawned workers
            env["FLAGS_obs_port"] = str(obs_port + rank)
        stdout = None
        try:
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                stdout = open(os.path.join(
                    log_dir, f"worker-g{generation}-{rank}.log"), "ab")
            return subprocess.Popen(
                [sys.executable, script] + script_args,
                env=env, stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None)
        finally:
            if stdout is not None:
                stdout.close()          # child holds its own copy

    def read_grow(peek: bool = False) -> int:
        """Parse <elastic_dir>/grow.  Malformed or non-positive requests
        are always consumed (a bad request must not be re-parsed every
        poll); a valid positive one is consumed unless peek=True — the
        voluntary path peeks first so an at-the-cap request stays pending
        for a failure re-rendezvous that CAN honor it."""
        try:
            with open(grow_path) as f:
                raw = f.read().strip()
        except FileNotFoundError:
            return 0
        try:
            val = max(0, int(raw or 0))
        except ValueError:
            print(f"[elastic] ignoring malformed grow request {raw!r}",
                  file=sys.stderr)
            val = 0
        if val == 0 or not peek:
            os.remove(grow_path)
        return val

    def stop_all(procs):
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 10
        for p in procs.values():
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.kill()

    procs = {r: spawn(r, world, gen) for r in range(world)}
    scraper: Optional[ClusterScraper] = None
    if obs_port:
        # ports are rank-stable across generations, so one scraper set
        # covers every generation up to the original nproc; dead or
        # shrunk-away ranks simply stop answering
        from paddlebox_tpu_torch.utils import obs_server
        scraper = ClusterScraper(
            [obs_port + r for r in range(nproc)]).start()
        obs_server.start(port=obs_port + nproc)
    sigkills: Dict[int, int] = {}   # rank -> SIGKILL exits across ALL
    # generations (ranks are renumbered per generation; the single-host
    # stand-in treats rank r of every generation as the same "node")
    seen_hb: set = set()    # ranks that registered this generation — a
    # partition verdict needs a once-alive heartbeat (startup time — torch
    # import, data load — must never read as a lost node)
    hb_miss: Dict[int, int] = {}   # consecutive missing-heartbeat polls
    # required before the partition verdict: an exiting worker deletes its
    # key a few ms before its process ends — one missed poll is a race,
    # not a partition
    miss_quorum = max(3, int(heartbeat_ttl / 2 / poll_s))

    try:
        while True:
            time.sleep(poll_s)
            lost, crashed = [], []
            for r, p in list(procs.items()):
                ret = p.poll()
                if ret is None:
                    continue
                if ret == 0:
                    del procs[r]            # done — leaves quietly
                elif ret == -signal.SIGKILL:
                    # a lone SIGKILL is indistinguishable from a transient OOM
                    # kill — respawn like a crash; only a REPEAT verdict on
                    # the same rank reads as real node loss and scales in
                    sigkills[r] = sigkills.get(r, 0) + 1
                    (lost if sigkills[r] > 1 else crashed).append(r)
                else:
                    crashed.append(r)
            # sustained heartbeat loss of a live, once-registered process =
            # partitioned
            alive_hb = {int(k.split("-")[1]) for k in store.alive_keys()}
            for r, p in list(procs.items()):
                if p.poll() is None and r in seen_hb and r not in alive_hb:
                    hb_miss[r] = hb_miss.get(r, 0) + 1
                    if hb_miss[r] >= miss_quorum:
                        p.send_signal(signal.SIGTERM)
                        lost.append(r)
                else:
                    hb_miss.pop(r, None)
            seen_hb |= alive_hb

            if not procs and not lost and not crashed:
                return 0                    # final generation all done
            if lost or crashed:
                # failures spend relaunch budget
                if relaunches >= max_relaunches:
                    stop_all(procs)
                    return 75               # EX_TEMPFAIL: budget exhausted
                relaunches += 1
                grow = read_grow()
            else:
                # voluntary scale-out: free (no failure happened); a healthy
                # job must never die because a grow request arrived after the
                # failure budget was spent
                grow = read_grow(peek=True)
                if not grow:
                    continue
                # against the generation's world, not the live count: a
                # rank that finished first (exit 0) frees no capacity, and
                # reading its slot as room would tear down the ranks
                # still finishing and burn an at-cap request
                if min(world + grow, nproc) <= world:
                    continue                # at the nproc cap — leave pending
                read_grow()                 # honored now: consume it

            # -- re-rendezvous ------------------------------------------------
            # stop EVERYTHING first — including just-SIGTERMed partitioned
            # ranks, so they get the kill escalation + reap and can never keep
            # mutating shared state (the checkpoint) beside the new generation
            stop_all(procs)
            for r in lost + crashed:
                procs.pop(r, None)
            for k in store.alive_keys():    # clean the prefix for the new gen
                store.delete(k)
            survivors = len(procs) + len(crashed)
            new_world = min(survivors + grow, nproc)
            if new_world < min_workers:
                return 76                   # below quorum
            gen += 1
            if new_world > world:
                flight.record("elastic_grow", gen=gen, world=new_world,
                              grew=new_world - world)
            elif new_world < world:
                flight.record("elastic_scale_in", gen=gen, world=new_world,
                              lost=len(lost), crashed=len(crashed))
            flight.record("elastic_rerendezvous", gen=gen, world=new_world,
                          survivors=survivors, grow=grow)
            world = new_world
            procs = {r: spawn(r, world, gen) for r in range(world)}
            seen_hb = set()
            hb_miss = {}
    finally:
        if scraper is not None:
            scraper.stop()


class PSServerSupervisor:
    """Auto-resume's server half: own a PSServer, watch it, and restart
    it in place when it dies (a chaos ``kill()``, an unhandled crash) —
    the worker launcher's replica watch pulled inside one process, where
    the PS tier lives in tests and single-host jobs.

    Restart semantics keep exactly-once intact: the new instance binds
    the SAME port (clients retry through their backoff window and land on
    it), shares the SAME table object, and receives the dead instance's
    dedup window via ``PSServer(dedup_state=...)`` — so a client retrying
    a ``push_sparse_delta`` that applied just before the kill replays the
    cached response instead of double-applying.  With ``ckpt_root`` +
    ``reload_from_ckpt=True`` the supervisor instead reloads the last
    committed generation into the table before serving (cross-process
    semantics: rows + DEDUP.bin from ONE checkpoint, io/checkpoint.py).

    Bounded: ``max_restarts`` lifetime budget with exponential backoff
    between attempts; bind retries ride out the dead listener's socket
    lingering in TIME_WAIT.  ``stop()`` shuts the watch down and joins it
    (the managed-lifecycle thread shape, lint rule PB405)."""

    def __init__(self, table, host: str = "127.0.0.1", port: int = 0,
                 max_restarts: int = 8, backoff_base: float = 0.05,
                 backoff_cap: float = 1.0, ckpt_root: Optional[str] = None,
                 reload_from_ckpt: bool = False, poll_s: float = 0.02,
                 shard: Optional[int] = None, membership=None,
                 cluster_shard: Optional[int] = None):
        from paddlebox_tpu_torch.ps.service import PSServer
        self._make = PSServer
        self.table = table
        self.host = host
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self.ckpt_root = ckpt_root
        self.reload_from_ckpt = reload_from_ckpt
        # cluster rank: a sharded fleet member reloads ONLY its own
        # shard-<k:03d>/ checkpoint subdirs (rows + DEDUP.bin)
        self.shard = shard
        self._backoff = (backoff_base, backoff_cap)
        self._poll_s = poll_s
        self._stop = threading.Event()
        # ``membership`` (a ServerMap) turns on epoch fencing;
        # ``cluster_shard`` is the server's index in it (-1 = pending
        # member awaiting a reshard cutover).  Defaults to ``shard``.
        cs = cluster_shard if cluster_shard is not None else (shard or 0)
        self.server = PSServer(table, host=host, port=port,
                               membership=membership, shard=cs)
        self.port = self.server.addr[1]
        self._watch = threading.Thread(target=self._run,
                                       name="pbox-ps-supervisor",
                                       daemon=True)
        self._watch.start()

    @property
    def addr(self):
        return (self.host, self.port)

    def _restart(self) -> bool:
        from paddlebox_tpu_torch.utils.backoff import Backoff
        from paddlebox_tpu_torch.utils.monitor import stat_add, stat_set
        old = self.server
        self.restarts += 1
        flight.record("resume_begin", role="ps_server",
                      restart=self.restarts, port=self.port)
        dedup = old.dedup_state()
        if self.ckpt_root and self.reload_from_ckpt:
            # cross-process restart semantics: distrust the in-process
            # table and take rows AND dedup window from the same committed
            # generation — a window entry for a rid whose write the reload
            # rolled back would otherwise ack a retry without its data
            from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
            from paddlebox_tpu_torch.ps.service import _dedup_read
            ck = TrainCheckpoint(self.ckpt_root)
            head = ck.load_table(self.table, shard=self.shard)
            dedup = None
            if head is not None:
                sparse = os.path.join(ck._gen_dir(head), "sparse")
                if self.shard is not None:
                    sparse = os.path.join(sparse,
                                          f"shard-{self.shard:03d}")
                dedup = _dedup_read(sparse)
        bo = Backoff(base=self._backoff[0], cap=self._backoff[1],
                     deadline=30.0)
        attempt = 0
        while not self._stop.is_set():
            try:
                # the dying instance's membership may be AHEAD of what
                # this supervisor was constructed with (a reshard cutover
                # adopted a newer epoch) — carry the latest forward,
                # snapshotted atomically so a cutover racing the restart
                # cannot pair the new map with the old shard index
                membership, shard, _ = old._membership_view()
                self.server = self._make(self.table, host=self.host,
                                         port=self.port,
                                         dedup_state=dedup,
                                         membership=membership,
                                         shard=shard)
                break
            except OSError:
                # the dead listener's port may still be draining
                attempt += 1
                if not bo.sleep(attempt):
                    return False
        else:
            return False
        stat_add("ps.supervisor.restarts")
        stat_set("ps.supervisor.restart_gen", float(self.restarts))
        flight.record("resume_ok", role="ps_server",
                      restart=self.restarts, port=self.port)
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.server._dead:
                if self.restarts >= self.max_restarts:
                    flight.record("supervisor_give_up",
                                  restarts=self.restarts)
                    return
                if not self._restart():
                    return
            self._stop.wait(self._poll_s)

    def stop(self) -> None:
        """Stop watching and shut the current server down (drain)."""
        self._stop.set()
        self._watch.join(timeout=30.0)
        self.server.shutdown()


class PSFleet:
    """N supervised PSServers forming one sharded
    cluster — rank-stable ports (rank k binds ``port_base + k`` when a
    base is given), identically-seeded tables (fresh-row defaults are
    pure in (seed, key), so any client sees one consistent key space),
    and one :class:`PSServerSupervisor` per shard for restart-in-place
    with per-shard dedup/checkpoint handoff (``shard-<k:03d>/`` subdirs
    of the generation checkpoint, io/checkpoint.py).

    ``env_value()`` is the ``PBOX_PS_ADDRS`` export — "host:port,..."
    in rank order, which is also ServerMap order: every worker parsing
    it derives the SAME key→shard placement."""

    def __init__(self, n: int, config=None, seed: int = 0,
                 host: str = "127.0.0.1", port_base: int = 0,
                 mf_dim: int = 8, ckpt_root: Optional[str] = None,
                 reload_from_ckpt: bool = False, max_restarts: int = 8):
        from paddlebox_tpu_torch.config import EmbeddingTableConfig
        from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
        if n < 1:
            raise ValueError("PSFleet needs n >= 1 servers")
        cfg = config or EmbeddingTableConfig(embedding_dim=mf_dim)
        self._cfg = cfg
        self._seed = seed
        self._host = host
        self._port_base = port_base
        self._ckpt_root = ckpt_root
        self._max_restarts = max_restarts
        # pboxlint: disable-next=PB803 -- fleet-level epoch mirror, not a ServerMap
        self.epoch = 0
        self.n = n
        self.sups = [self._spawn(k, n, reload_from_ckpt)
                     for k in range(n)]
        # retired (shrunk-away) supervisors stay up for a grace period
        # answering typed redirects + chunk-fate probes, then reap
        self._retired: List = []        # (mono_deadline, supervisor)
        self._apply_membership()

    def _spawn(self, k: int, n: int, reload_from_ckpt: bool = False,
               pending: bool = False):
        from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
        return PSServerSupervisor(
            ShardedHostTable(self._cfg, seed=self._seed),
            host=self._host,
            port=(self._port_base + k) if self._port_base else 0,
            shard=(k if n > 1 else None),
            cluster_shard=(-1 if pending else k),
            ckpt_root=self._ckpt_root,
            reload_from_ckpt=reload_from_ckpt,
            max_restarts=self._max_restarts)

    def _apply_membership(self) -> None:
        """Stamp the fleet's current ServerMap onto every member — the
        addresses are only all known once every server has bound, so
        membership lands right after construction (and after every
        resize), before any worker client connects."""
        from paddlebox_tpu_torch.ps import cluster as ps_cluster
        m = ps_cluster.make_server_map(self.addrs, epoch=self.epoch)
        for k, s in enumerate(self.sups):
            s.server.membership = m
            s.server.shard = k
            s.shard = k if self.n > 1 else None

    @property
    def addrs(self):
        return [s.addr for s in self.sups]

    def env_value(self) -> str:
        from paddlebox_tpu_torch.ps import cluster as ps_cluster
        return ps_cluster.format_addrs(self.addrs)

    def resize(self, new_n: int, workdir: str, *, rounds: int = 2,
               settle_rows: int = 0, timeout: float = 120.0,
               retire_grace: float = 5.0) -> None:
        """Live-resize the fleet to ``new_n`` shards via the key-range
        handoff (ps/reshard.py): grow spawns pending members first
        (``shard=-1`` — they answer typed redirects until the cutover
        admits them); shrink retires the tail AFTER the cutover, keeping
        the retirees up for ``retire_grace`` seconds so late clients
        still draw redirects instead of connection errors.  Serving
        continues throughout; only the moving key range blocks, briefly,
        at the freeze."""
        from paddlebox_tpu_torch.ps import cluster as ps_cluster
        from paddlebox_tpu_torch.ps import reshard as ps_reshard
        from paddlebox_tpu_torch.ps.service import PSClient
        new_n = int(new_n)
        if new_n < 1:
            raise ValueError("PSFleet.resize needs new_n >= 1")
        if new_n == self.n:
            return
        grown = []
        if new_n > self.n:
            grown = [self._spawn(k, new_n, pending=True)
                     for k in range(self.n, new_n)]
            m = ps_cluster.make_server_map(self.addrs, epoch=self.epoch)
            for s in grown:
                s.server.membership = m
        new_addrs = self.addrs + [s.addr for s in grown] \
            if grown else self.addrs[:new_n]
        drv = PSClient(self.addrs, retries=None, deadline=timeout)
        try:
            drv._adopt_map(ps_cluster.make_server_map(
                self.addrs, epoch=self.epoch))
            new_map = ps_reshard.reshard(
                drv, new_addrs, workdir, rounds=rounds,
                settle_rows=settle_rows, timeout=timeout,
                manifest_root=self._ckpt_root)
        except BaseException:
            for s in grown:
                s.stop()
            raise
        finally:
            drv.close()
        now = time.monotonic()
        if new_n > self.n:
            self.sups = self.sups + grown
        else:
            self._retired += [(now + retire_grace, s)
                              for s in self.sups[new_n:]]
            self.sups = self.sups[:new_n]
        self.n = new_n
        # pboxlint: disable-next=PB803 -- fleet-level epoch mirror, not a ServerMap
        self.epoch = new_map.epoch
        for k, s in enumerate(self.sups):
            s.shard = k if new_n > 1 else None
        flight.record("ps_fleet_resize", n=new_n, epoch=self.epoch)

    def reap_retired(self, force: bool = False) -> None:
        """Stop retired supervisors whose grace elapsed (all, when
        ``force``)."""
        now = time.monotonic()
        keep = []
        for deadline, s in self._retired:
            if force or now >= deadline:
                s.stop()
            else:
                keep.append((deadline, s))
        self._retired = keep

    def stop(self) -> None:
        self.reap_retired(force=True)
        for s in self.sups:
            s.stop()


class TrainerSupervisor:
    """``--trainers N``'s per-rank half: own one fleet-trainer rank,
    watch it, and restart it when it dies — the trainer-tier mirror of
    :class:`PSServerSupervisor`.

    The factory builds a FULL fresh incarnation (runner + PSClient +
    shuffle transport) because crash recovery is process-shaped: the new
    runner reads the fleet cursor from the shared manifest, replays its
    namespaced rid groups against the checkpoint shadow, and re-joins
    the surviving ranks' barriers (trainer/fleet_runner.py protocol).
    Nothing of the dead incarnation is reused, so in-proc (test) and
    subprocess (deployment) restarts follow the same code path.

    Bounded by ``max_restarts`` with exponential backoff between
    attempts; ``join()`` surfaces the final result or re-raises the last
    error once the budget is spent.  ``stop()`` abandons the watch and
    joins the thread (PB405)."""

    def __init__(self, runner_factory, rank: int, days,
                 max_restarts: int = 3, backoff_base: float = 0.1,
                 backoff_cap: float = 2.0):
        self._factory = runner_factory
        self.rank = int(rank)
        self.days = days
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self.result = None
        self.error: Optional[BaseException] = None
        self._backoff = (float(backoff_base), float(backoff_cap))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"pbox-trainer-sup-{rank}",
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from paddlebox_tpu_torch.utils.backoff import Backoff
        from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe
        bo = Backoff(base=self._backoff[0], cap=self._backoff[1])
        t_crash: Optional[float] = None
        while not self._stop.is_set():
            try:
                runner = self._factory(self.rank)
            except BaseException as e:  # noqa: BLE001 — factory = restart
                self.error = e
                runner = None
            if runner is not None:
                if t_crash is not None:
                    # MTTR from observed death to the replacement
                    # incarnation (fresh client + transport, rebuilt by
                    # the factory) entering run() — what the bench's
                    # restart_mttr_s gate measures
                    stat_observe("trainer.fleet.restart_mttr_s",
                                 time.monotonic() - t_crash)
                    t_crash = None
                try:
                    self.result = runner.run(self.days)
                    self.error = None
                    return
                except BaseException as e:  # noqa: BLE001 — any death restarts
                    self.error = e
            if self.restarts >= self.max_restarts:
                flight.record("supervisor_give_up", role="trainer",
                              rank=self.rank, restarts=self.restarts)
                return
            self.restarts += 1
            if t_crash is None:
                t_crash = time.monotonic()
            flight.record("trainer_restart", rank=self.rank,
                          restart=self.restarts,
                          error=type(self.error).__name__)
            stat_add("trainer.supervisor.restarts")
            bo.sleep(self.restarts)

    def join(self, timeout: Optional[float] = None):
        """Wait for the supervised rank to finish; returns its result or
        re-raises its terminal error (restart budget spent)."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"trainer rank {self.rank} still running after "
                f"{timeout}s")
        if self.result is None and self.error is not None:
            raise self.error
        return self.result

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)


class PSElasticWatcher:
    """Honor live fleet-resize requests dropped into a directory.

    Drop a positive integer into ``<dir>/ps_grow`` (servers to add) or
    ``<dir>/ps_shrink`` (servers to remove; the fleet never shrinks
    below 1) and the watcher drives :meth:`PSFleet.resize` — snapshot,
    delta catch-up, freeze, epoch-bumped cutover — then re-exports
    ``PBOX_PS_ADDRS`` for future worker generations (live workers
    discover the new map through typed redirects + the health probe
    fall-through, no restart needed).  Requests are consumed
    best-effort: a malformed file is eaten and logged; a failed resize
    is rolled back by the driver (the fleet keeps serving the old
    epoch) and the request is dropped rather than retried forever."""

    def __init__(self, fleet: PSFleet, elastic_dir: str, workroot: str,
                 poll_s: float = 0.5, retire_grace: float = 5.0,
                 rounds: int = 2, timeout: float = 120.0):
        os.makedirs(elastic_dir, exist_ok=True)
        self.fleet = fleet
        self.dir = elastic_dir
        self.workroot = workroot
        self.retire_grace = retire_grace
        self.rounds = rounds
        self.timeout = timeout
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="pbox-ps-elastic",
                                        daemon=True)
        self._thread.start()

    def _consume(self, name: str) -> int:
        """Read-and-unlink ``<dir>/<name>``; 0 when absent/malformed
        (a bad request must not be re-parsed every poll)."""
        path = os.path.join(self.dir, name)
        try:
            with open(path) as f:
                raw = f.read().strip()
        except OSError:
            return 0
        try:
            os.unlink(path)
        except OSError:
            pass
        try:
            return max(0, int(raw))
        except ValueError:
            print(f"[ps-elastic] ignoring malformed {name}: {raw!r}",
                  file=sys.stderr)
            return 0

    def _resize(self, target: int) -> None:
        workdir = os.path.join(self.workroot,
                               f"reshard-e{self.fleet.epoch + 1}")
        try:
            self.fleet.resize(target, workdir, rounds=self.rounds,
                              timeout=self.timeout,
                              retire_grace=self.retire_grace)
        except Exception as e:
            print(f"[ps-elastic] resize to {target} failed "
                  f"(fleet keeps serving epoch {self.fleet.epoch}): {e}",
                  file=sys.stderr)
            return
        from paddlebox_tpu_torch.ps import cluster as ps_cluster
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ[ps_cluster.ADDRS_ENV] = self.fleet.env_value()
        print(f"[ps-elastic] fleet now n={self.fleet.n} "
              f"epoch={self.fleet.epoch}", file=sys.stderr)

    def _run(self) -> None:
        while not self._stop.is_set():
            grow = self._consume("ps_grow")
            if grow:
                self._resize(self.fleet.n + grow)
            shrink = self._consume("ps_shrink")
            if shrink:
                self._resize(max(1, self.fleet.n - shrink))
            self.fleet.reap_retired()
            self._stop.wait(self._poll_s)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)


class ServingReplicaSupervisor:
    """PSServerSupervisor's serving-tier sibling: own a ServingReplica,
    watch it, restart it in place when it dies.  Restart keeps the
    router's world intact: the new replica binds the SAME port, inherits
    the dead instance's dedup window, and re-resolves the CURRENT xbox
    swap manifest before serving — a replica that died on day N and
    restarts after the trainer published day N+1 comes back serving
    N+1, not a stale dump.  ``stop()`` joins the watch and drains the
    replica (PB405 lifecycle)."""

    def __init__(self, config=None, xbox_path: Optional[str] = None,
                 manifest_root: Optional[str] = None, tenants=None,
                 max_inflight: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_restarts: int = 8, backoff_base: float = 0.05,
                 backoff_cap: float = 1.0, poll_s: float = 0.02,
                 watch_s: float = 0.0, seed: int = 0,
                 shard: int = 0, n_shards: int = 1,
                 ckpt_root: Optional[str] = None, hot_keys=None):
        from paddlebox_tpu_torch.ps.serving import ServingReplica
        self._make = ServingReplica
        self.config = config
        self.xbox_path = xbox_path
        self.manifest_root = manifest_root
        self.tenants = tenants
        self.max_inflight = max_inflight
        self.host = host
        self.watch_s = watch_s
        self.seed = seed
        self.shard = int(shard)
        self.n_shards = max(1, int(n_shards))
        self.ckpt_root = ckpt_root
        self.hot_keys = hot_keys
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self._backoff = (backoff_base, backoff_cap)
        self._poll_s = poll_s
        self._stop = threading.Event()
        path, day, gen = self._resolve_dump()
        self.replica = ServingReplica(
            config=config, xbox_path=path, tenants=tenants,
            max_inflight=max_inflight, host=host, port=port,
            day=day, generation=gen, seed=seed,
            shard=self.shard, n_shards=self.n_shards,
            ckpt_root=ckpt_root, hot_keys=hot_keys)
        self.port = self.replica.addr[1]
        self._arm_watch()
        self._watch = threading.Thread(target=self._run,
                                       name="pbox-serving-supervisor",
                                       daemon=True)
        self._watch.start()

    @property
    def addr(self):
        return (self.host, self.port)

    def _resolve_dump(self):
        """(path, day, generation) of the dump to load NOW — the swap
        manifest when one is published, else the pinned --serve_xbox."""
        if self.manifest_root:
            from paddlebox_tpu_torch.io.checkpoint import read_xbox_manifest
            man = read_xbox_manifest(self.manifest_root)
            if man:
                return (man["path"], str(man.get("day", "")),
                        int(man["generation"]))
        return self.xbox_path, "", 1

    def _arm_watch(self) -> None:
        # ckpt delta-streaming trumps day-granularity manifest polling:
        # a replica fed from a TrainCheckpoint gets pass-level freshness
        if self.ckpt_root:
            self.replica.watch_ckpt(self.ckpt_root)
        elif self.manifest_root and self.watch_s > 0:
            self.replica.watch_manifest(self.manifest_root, self.watch_s)

    def _restart(self) -> bool:
        from paddlebox_tpu_torch.utils.backoff import Backoff
        from paddlebox_tpu_torch.utils.monitor import stat_add
        old = self.replica
        self.restarts += 1
        flight.record("resume_begin", role="serving_replica",
                      restart=self.restarts, port=self.port)
        dedup = old.dedup_state()
        path, day, gen = self._resolve_dump()
        bo = Backoff(base=self._backoff[0], cap=self._backoff[1],
                     deadline=30.0)
        attempt = 0
        while not self._stop.is_set():
            try:
                self.replica = self._make(
                    config=self.config, xbox_path=path,
                    tenants=self.tenants, max_inflight=self.max_inflight,
                    host=self.host, port=self.port, day=day,
                    generation=gen, seed=self.seed, dedup_state=dedup,
                    shard=self.shard, n_shards=self.n_shards,
                    ckpt_root=self.ckpt_root, hot_keys=self.hot_keys)
                break
            except OSError:
                attempt += 1
                if not bo.sleep(attempt):
                    return False
        else:
            return False
        self._arm_watch()
        stat_add("serving.supervisor.restarts")
        flight.record("resume_ok", role="serving_replica",
                      restart=self.restarts, port=self.port)
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.replica._dead:
                if self.restarts >= self.max_restarts:
                    flight.record("supervisor_give_up",
                                  role="serving_replica",
                                  restarts=self.restarts)
                    return
                if not self._restart():
                    return
            self._stop.wait(self._poll_s)

    def stop(self) -> None:
        self._stop.set()
        self._watch.join(timeout=30.0)
        self.replica.shutdown()


def serve_fleet(args) -> int:
    """--serve N: run N supervised serving replicas in this process and
    block until interrupted.  Prints the replica addresses (one per
    line, ``host:port``) so a router — ``ServingRouter([...])`` or an
    external LB — can be pointed at the fleet.

    With ``--serve_shards S`` the N replicas split into S ServerMap
    shard groups (replica i serves shard i % S) and the router runs in
    ``shard_groups`` mode: per-shard fan, p2c hot-key routing, group
    failover.  ``--serve_ckpt`` feeds the fleet pass-delta freshness
    from a TrainCheckpoint instead of day-granularity xbox manifests."""
    from paddlebox_tpu_torch.config import EmbeddingTableConfig
    from paddlebox_tpu_torch.ps.serving import ServingRouter
    tenants = [t.strip() for t in (args.serve_tenants or "default"
                                   ).split(",") if t.strip()]
    config = EmbeddingTableConfig(embedding_dim=args.serve_mf_dim)
    n_shards = max(1, int(getattr(args, "serve_shards", 1) or 1))
    if n_shards > args.serve:
        raise SystemExit(f"--serve_shards {n_shards} needs at least that "
                         f"many replicas (--serve {args.serve})")
    ckpt_root = getattr(args, "serve_ckpt", "") or None
    sups = [ServingReplicaSupervisor(
        config=config,
        xbox_path=args.serve_xbox or None,
        manifest_root=args.serve_manifest or None,
        tenants=tenants,
        max_inflight=args.serve_max_inflight,
        watch_s=args.serve_watch_s,
        seed=args.serve_seed,
        shard=i % n_shards, n_shards=n_shards,
        ckpt_root=ckpt_root,
        max_restarts=args.max_restarts or 8)
        for i in range(args.serve)]
    for s in sups:
        print(f"[serve] replica {s.addr[0]}:{s.addr[1]} "
              f"shard={s.shard}/{n_shards} "
              f"tenants={','.join(tenants)}", file=sys.stderr)
    if n_shards > 1:
        groups = [[s.addr for s in sups if s.shard == k]
                  for k in range(n_shards)]
        router = ServingRouter(shard_groups=groups, tenant=tenants[0])
        router.refresh_hot_keys()
    else:
        router = ServingRouter([s.addr for s in sups], tenant=tenants[0])
    try:
        while True:
            time.sleep(5.0)
            router.observe_generation()    # fleet-wide swap coherence
            gens = router.generations()
            if len(gens) > 1:
                print(f"[serve] hot-swap in flight: generations {gens}",
                      file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        router.close()
        for s in sups:
            s.stop()
    return 0


def main():
    ap = argparse.ArgumentParser(prog="paddlebox_tpu_torch.launch")
    ap.add_argument("--nproc_per_node", type=int, default=1)
    ap.add_argument("--coordinator", default="127.0.0.1:12355")
    ap.add_argument("--max_restarts", type=int, default=0)
    ap.add_argument("--log_dir", default="")
    ap.add_argument("--elastic_dir", default="",
                    help="enable elastic relaunch orchestration on this "
                         "shared dir (≙ the etcd prefix)")
    ap.add_argument("--min_workers", type=int, default=1)
    ap.add_argument("--max_relaunches", type=int, default=3)
    ap.add_argument("--chaos_backend", default="",
                    help="host:port of a live PSServer; the launcher "
                         "spawns a seeded ChaosProxy (ps/faults.py) in "
                         "front of it and exports PBOX_PS_ADDR so workers "
                         "train through injected connection chaos — the "
                         "multi-process face of the chaos soak suite")
    ap.add_argument("--chaos_seed", type=int, default=0)
    # PS wire-path knobs, exported to every worker as FLAGS_* env (the
    # flag registry reads FLAGS_<name> at import): pipelined pull/push
    # stream pool, in-flight window, and payload quantization
    ap.add_argument("--ps_streams", type=int, default=None,
                    help="workers' PSClient connection-pool size "
                         "(FLAGS_ps_streams; 1 = stop-and-wait)")
    ap.add_argument("--ps_window", type=int, default=None,
                    help="max chunk frames in flight per pipelined verb "
                         "(FLAGS_ps_window)")
    ap.add_argument("--ps_wire_dtype", default="",
                    choices=("", "f32", "f16", "i8"),
                    help="wire encoding of float32 PS row payloads "
                         "(FLAGS_ps_wire_dtype; server state stays fp32)")
    ap.add_argument("--ps_table_threads", type=int, default=None,
                    help="host-table shard worker pool size on every "
                         "worker (FLAGS_ps_table_threads; per-shard "
                         "pull/write/save/load fan across it, 1 = "
                         "sequential)")
    ap.add_argument("--pack_threads", type=int, default=None,
                    help="whole-pass packer pool size on every worker "
                         "(FLAGS_pass_pack_threads; per-slot/record-range "
                         "pad+translate fan across it, bit-identical at "
                         "any setting, 1 = sequential)")
    ap.add_argument("--pass_prefetch", type=int, default=None,
                    choices=(0, 1),
                    help="pipeline the pass feed on every worker "
                         "(FLAGS_pass_prefetch): pass N+1's load/pull/"
                         "pack run in the background while pass N trains")
    ap.add_argument("--ps_device_cache", type=int, default=None,
                    choices=(0, 1),
                    help="keep the hottest embedding rows resident in "
                         "device memory across passes on every worker "
                         "(FLAGS_ps_device_cache): build_pull fetches "
                         "only cache misses over the wire; bit-identical "
                         "to off")
    ap.add_argument("--ps_device_cache_rows", type=int, default=None,
                    help="row capacity of each worker's device-resident "
                         "hot-row cache (FLAGS_ps_device_cache_rows; "
                         "ps/device_cache.py)")
    ap.add_argument("--auto_resume", type=int, default=0,
                    help="crash-recovery budget (FLAGS_auto_resume): each "
                         "worker's fleet.train_passes rolls back to the "
                         "last committed checkpoint generation and "
                         "re-drives the partial pass up to this many "
                         "times; also floors --max_restarts so respawned "
                         "workers actually get to resume.  0 = off")
    ap.add_argument("--ckpt_dir", default="",
                    help="checkpoint root for every worker "
                         "(FLAGS_ckpt_dir): generation-chained saves "
                         "after each pass + auto-resume restore from "
                         "here (io/checkpoint.py)")
    ap.add_argument("--obs_port", type=int, default=0,
                    help="observability exporter base port: worker rank r "
                         "serves /metrics + /statz + /tracez + /flightz "
                         "+ /debugz on obs_port + r (FLAGS_obs_port); "
                         "the launcher scrapes all workers and prints one "
                         "merged snapshot at job end.  0 = off")
    ap.add_argument("--obs_flight_ring", type=int, default=None,
                    help="flight-recorder ring capacity on every worker "
                         "(FLAGS_obs_flight_ring; newest-N lifecycle "
                         "events served as /flightz and embedded in "
                         "postmortems).  0 disables")
    ap.add_argument("--obs_postmortem_dir", default="",
                    help="directory for wedge-doctor postmortem bundles "
                         "(FLAGS_obs_postmortem_dir; SIGUSR1 on any "
                         "worker writes one).  empty = <tmpdir>/"
                         "pbox-postmortems")
    ap.add_argument("--obs_timeline_interval_s", type=float, default=None,
                    help="telemetry-timeline sample cadence on every "
                         "worker (FLAGS_obs_timeline_interval_s; serves "
                         "/timelinez, feeds the SLO watchdog, embeds in "
                         "postmortems).  0 = off")
    ap.add_argument("--obs_timeline_ring", type=int, default=None,
                    help="timeline ring capacity per worker "
                         "(FLAGS_obs_timeline_ring; newest-N samples)")
    ap.add_argument("--obs_slo_watchdog", type=int, default=None,
                    help="evaluate the SLO rule set on every timeline "
                         "sample (FLAGS_obs_slo_watchdog; breaches emit "
                         "latched slo_breach flight events).  1 = on")
    ap.add_argument("--obs_heat", type=int, default=None,
                    help="key-space heat sketches on every worker "
                         "(FLAGS_obs_heat; ps/heat.py serves /heatz — "
                         "hot keys, shard skew, working-set size — and "
                         "the supervisor's /clusterz merges the fleet "
                         "view).  1 = on")
    ap.add_argument("--obs_heat_topk", type=int, default=None,
                    help="heavy-hitter capacity per heat site "
                         "(FLAGS_obs_heat_topk)")
    ap.add_argument("--obs_heat_width", type=int, default=None,
                    help="count-min sketch width per heat site "
                         "(FLAGS_obs_heat_width)")
    ap.add_argument("--obs_heat_depth", type=int, default=None,
                    help="count-min sketch depth per heat site "
                         "(FLAGS_obs_heat_depth)")
    ap.add_argument("--ps_servers", type=int, default=0,
                    help="start N supervised PSServer shards in the "
                         "launcher process (one PSServerSupervisor each, "
                         "rank-stable ports, restart-in-place with "
                         "per-shard dedup/checkpoint handoff) and export "
                         "PBOX_PS_ADDRS so every worker's PSClient fans "
                         "chunked verbs across the cluster.  0 = off")
    ap.add_argument("--ps_port_base", type=int, default=0,
                    help="shard k binds ps_port_base + k (0 = ephemeral "
                         "ports; rank order stays the ServerMap order "
                         "either way)")
    ap.add_argument("--ps_mf_dim", type=int, default=8,
                    help="PS fleet table embedding_dim — must match the "
                         "training script's table config")
    ap.add_argument("--ps_seed", type=int, default=0,
                    help="PS fleet fresh-row seed; all shards share it "
                         "(defaults are pure in (seed, key), so the "
                         "cluster key space is consistent)")
    ap.add_argument("--ps_elastic", default="",
                    help="watch DIR/ps_grow and DIR/ps_shrink for live "
                         "fleet-resize requests (integer = servers to "
                         "add/remove) and drive the key-range handoff "
                         "(ps/reshard.py) without stopping training; "
                         "PBOX_PS_ADDRS is re-exported after each "
                         "cutover.  '' = off")
    ap.add_argument("--ps_reshard_rounds", type=int, default=2,
                    help="delta catch-up rounds before the reshard "
                         "freeze (>= 1)")
    ap.add_argument("--ps_retire_grace", type=float, default=5.0,
                    help="seconds a shrunk-away PS server keeps "
                         "answering typed redirects before it stops")
    ap.add_argument("--serve", type=int, default=0,
                    help="run N supervised read-only serving replicas "
                         "(ps/serving.py) instead of training workers; "
                         "needs --serve_xbox, --serve_manifest or "
                         "--serve_ckpt")
    ap.add_argument("--serve_xbox", default="",
                    help="xbox dump to serve (pinned; no hot-swap unless "
                         "--serve_manifest is also given)")
    ap.add_argument("--serve_manifest", default="",
                    help="directory holding XBOX_MANIFEST.json; replicas "
                         "load the manifest's dump and hot-swap when the "
                         "trainer publishes the next day")
    ap.add_argument("--serve_tenants", default="default",
                    help="comma-separated tenant namespaces "
                         "(FLAGS_serve_tenants)")
    ap.add_argument("--serve_max_inflight", type=int, default=None,
                    help="per-tenant admission cap; excess pulls are shed "
                         "with a typed overload error "
                         "(FLAGS_serve_max_inflight)")
    ap.add_argument("--serve_watch_s", type=float, default=2.0,
                    help="manifest poll cadence for hot-swap (0 = never "
                         "poll; swaps only via the swap verb)")
    ap.add_argument("--serve_mf_dim", type=int, default=8,
                    help="table embedding_dim — must match the trainer "
                         "that wrote the dump")
    ap.add_argument("--serve_seed", type=int, default=0,
                    help="default-row seed — must match the trainer for "
                         "bit-identical miss rows")
    ap.add_argument("--serve_shards", type=int, default=1,
                    help="split the fleet into S ServerMap shard groups "
                         "(replica i serves shard i %% S); the router "
                         "fans per shard and merges in key order")
    ap.add_argument("--serve_ckpt", default="",
                    help="TrainCheckpoint root to stream: replicas load "
                         "the manifest head's base+delta chain and hot-"
                         "patch each new save_pass generation "
                         "(pass-granularity freshness vs day-granularity "
                         "--serve_manifest)")
    ap.add_argument("--serve_hot_keys", type=int, default=None,
                    help="top-K heat-sketch keys replicated into every "
                         "shard group for p2c routing (0 = off) "
                         "(FLAGS_serving_hot_keys)")
    ap.add_argument("script", nargs="?", default="")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    if not args.serve and not args.script:
        ap.error("script is required unless --serve is given")
    # EXPORTS for the worker processes — set_flags() cannot cross the
    # process boundary, the child's flag registry reads FLAGS_* at import
    if args.ps_streams is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_ps_streams"] = str(args.ps_streams)
    if args.ps_window is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_ps_window"] = str(args.ps_window)
    if args.ps_wire_dtype:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_ps_wire_dtype"] = args.ps_wire_dtype
    if args.ps_table_threads is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_ps_table_threads"] = str(args.ps_table_threads)
    if args.pack_threads is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_pass_pack_threads"] = str(args.pack_threads)
    if args.pass_prefetch is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_pass_prefetch"] = str(args.pass_prefetch)
    if args.ps_device_cache is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_ps_device_cache"] = str(args.ps_device_cache)
    if args.ps_device_cache_rows is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_ps_device_cache_rows"] = str(
            args.ps_device_cache_rows)
    if args.obs_flight_ring is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_flight_ring"] = str(args.obs_flight_ring)
    if args.obs_postmortem_dir:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_postmortem_dir"] = args.obs_postmortem_dir
    if args.obs_timeline_interval_s is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_timeline_interval_s"] = str(
            args.obs_timeline_interval_s)
    if args.obs_timeline_ring is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_timeline_ring"] = str(args.obs_timeline_ring)
    if args.obs_slo_watchdog is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_slo_watchdog"] = str(args.obs_slo_watchdog)
    if args.obs_heat is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_heat"] = str(args.obs_heat)
    if args.obs_heat_topk is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_heat_topk"] = str(args.obs_heat_topk)
    if args.obs_heat_width is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_heat_width"] = str(args.obs_heat_width)
    if args.obs_heat_depth is not None:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_obs_heat_depth"] = str(args.obs_heat_depth)
    if args.auto_resume:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_auto_resume"] = str(args.auto_resume)
        # a worker that dies outside train_passes (import crash, OOM)
        # only resumes if the launcher respawns it: floor the respawn
        # budget so --auto_resume alone yields a self-healing job
        args.max_restarts = max(args.max_restarts, args.auto_resume)
    if args.ckpt_dir:
        # pboxlint: disable-next=PB203 -- env export to spawned workers
        os.environ["FLAGS_ckpt_dir"] = args.ckpt_dir
    if args.serve:
        if args.serve_tenants:
            # pboxlint: disable-next=PB203 -- env export to spawned workers
            os.environ["FLAGS_serve_tenants"] = args.serve_tenants
        if args.serve_max_inflight is not None:
            # pboxlint: disable-next=PB203 -- env export to spawned workers
            os.environ["FLAGS_serve_max_inflight"] = str(
                args.serve_max_inflight)
        if args.serve_hot_keys is not None:
            # pboxlint: disable-next=PB203 -- env export to spawned workers
            os.environ["FLAGS_serving_hot_keys"] = str(args.serve_hot_keys)
        if not (args.serve_xbox or args.serve_manifest or args.serve_ckpt):
            ap.error("--serve needs --serve_xbox, --serve_manifest or "
                     "--serve_ckpt")
        sys.exit(serve_fleet(args))
    ps_fleet = None
    if args.ps_servers:
        from paddlebox_tpu_torch.ps import cluster as _ps_cluster
        ps_fleet = PSFleet(
            args.ps_servers, mf_dim=args.ps_mf_dim, seed=args.ps_seed,
            port_base=args.ps_port_base,
            ckpt_root=args.ckpt_dir or None,
            reload_from_ckpt=bool(args.ckpt_dir),
            max_restarts=max(args.max_restarts, 8))
        os.environ[_ps_cluster.ADDRS_ENV] = ps_fleet.env_value()
        for k, (h, p) in enumerate(ps_fleet.addrs):
            print(f"[ps] shard {k} {h}:{p}", file=sys.stderr)
    ps_watcher = None
    if args.ps_elastic:
        if ps_fleet is None:
            ap.error("--ps_elastic needs --ps_servers")
        ps_watcher = PSElasticWatcher(
            ps_fleet, args.ps_elastic,
            workroot=os.path.join(args.ps_elastic, "reshard"),
            retire_grace=args.ps_retire_grace,
            rounds=max(1, args.ps_reshard_rounds))
    proxy = None
    if args.chaos_backend:
        from paddlebox_tpu_torch.ps.faults import ChaosProxy, FaultPlan
        bhost, _, bport = args.chaos_backend.rpartition(":")
        proxy = ChaosProxy((bhost or "127.0.0.1", int(bport)),
                           FaultPlan.default_chaos(args.chaos_seed))
        os.environ["PBOX_PS_ADDR"] = f"{proxy.addr[0]}:{proxy.addr[1]}"
        print(f"[chaos] proxy {proxy.addr} -> {args.chaos_backend} "
              f"(seed {args.chaos_seed})", file=sys.stderr)
    try:
        if args.elastic_dir:
            host, _, port = args.coordinator.rpartition(":")
            rc = launch_elastic(
                args.script, args.script_args, args.nproc_per_node,
                args.elastic_dir,
                coordinator_host=host or "127.0.0.1",
                coordinator_base_port=int(port) if port else 12400,
                min_workers=args.min_workers,
                max_relaunches=args.max_relaunches, log_dir=args.log_dir,
                obs_port=args.obs_port)
        else:
            rc = launch(args.script, args.script_args,
                        args.nproc_per_node, args.coordinator,
                        args.max_restarts, args.log_dir,
                        obs_port=args.obs_port)
    finally:
        if proxy is not None:
            proxy.shutdown()
        if ps_watcher is not None:
            ps_watcher.stop()
        if ps_fleet is not None:
            ps_fleet.stop()
    sys.exit(rc)


if __name__ == "__main__":
    main()
