"""Launcher halves for the parameter-server and serving tiers:
supervised PS servers, the sharded PS fleet and its elastic watcher, and
supervised serving replicas.

Port of the PS and serving halves of ``paddlebox_tpu/launch.py``:
``PSServerSupervisor`` (restart-in-place with dedup / checkpoint
handoff), ``PSFleet`` (N supervised shards forming one cluster, live
``resize`` through ps/reshard.py), ``PSElasticWatcher`` (file-driven
grow / shrink), ``ServingReplicaSupervisor`` (restart-in-place of a
``ServingReplica`` that re-resolves the xbox swap manifest) and
``serve_fleet`` (N supervised replicas, optionally in shard groups,
behind one ``ServingRouter``).  Host code only (numpy, sockets,
threads): no device call on any thread here.  The classes are copies
with the import paths rewritten.

Not ported yet (ROADMAP Queue 1): the worker launcher (``launch``,
``launch_elastic``, ``init_distributed``, ``main``, which parses the
``--serve*`` arguments ``serve_fleet`` reads), the trainer fleet's
``TrainerSupervisor`` and the cluster scraper (items 8 and 10).

A one-host fleet, trained through::

    flt = PSFleet(4, config=table_config, seed=0)
    engine.table = RemoteTableAdapter(PSClient(flt.addrs), delta_mode=True)
    fleet.train_passes(trainer, dataset, passes, date=...)
    flt.stop()
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import List, Optional

from paddlebox_tpu_torch.utils import flight


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
