"""Sharded PS cluster topology — key-space partitioning and 2-phase lifecycle.

Copy of ``paddlebox_tpu/ps/cluster.py`` with the import paths rewritten
(host code: numpy, files, sockets and threads; no device call).

≙ the reference's multi-server deployment (PAPER.md L5b: `brpc_ps_client`
routing `key % shard_num` across `brpc_ps_server` processes,
`boxps::MPICluster`): a :class:`ServerMap` assigns every feasign to exactly
one of N parameter servers by a deterministic splitmix64 hash, so placement
is stable across runs, restarts, and client instances — the property that
makes N=1 and N=4 training bit-identical (each key's row lives on exactly
one shard, fresh-row defaults are pure in (seed, key), and per-key RMW
order within a shard is unchanged by the partition).

The hash salt is DISTINCT from the host-table's internal shard salt so the
two partitions decorrelate: a server's local `ShardedHostTable` spreads its
subset of the key space evenly across its own lock shards regardless of
which cluster shard it is.

Cluster-wide lifecycle (`end_day`, and any future decaying verb) is
2-phase over the per-server dedup windows: ``lifecycle_prepare`` on every
shard under a pinned rid-group, then ``lifecycle_commit`` only after all N
prepared.  Every phase rid is deterministic (``<group>.p<k>`` /
``<group>.c<k>``), so a caller-level retry after a partial failure replays
through the dedup windows — shards that already prepared/committed return
their cached ack, shards that didn't execute once.  Exactly-once decay
survives any single-shard crash + supervisor restart because the dedup
window itself is part of the restart handoff (service.dedup_state /
DEDUP.bin).  The commit frame carries the full verb (not just the txn id):
a restarted server that lost its staged-txn dict can still execute the
commit directly.

Checkpoint fan-out: `cluster_save`/`cluster_load` write/read per-shard
``shard-<k:03d>/`` subdirectories under the caller's path.  Because all N
subdirs live inside one generation tmpdir, the tmp+rename commit and
the single cluster MANIFEST atomically advance ALL shards together —
crash recovery rolls every shard back to the same generation.

Elastic membership (ps/reshard.py) adds a monotonic **epoch** to the map:
every fenced sparse verb carries its client's epoch, a server whose
membership disagrees answers a typed ``wrong_epoch`` / ``not_owner`` /
``migrating`` rejection (never silently applying to a range it no longer
owns), and the client refreshes its map from the fleet's ``health``
surface (shard 0 preferred, falling through dead entries) and re-drives
only the affected chunks through the dedup window.  Membership changes
MUST route through the reshard API — pboxlint PB803 flags hand-built
``ServerMap`` construction or ``addrs``/``epoch`` mutation anywhere else
(:func:`make_server_map` is the sanctioned constructor for client code).

``cluster_load`` reshards on load: when the on-disk dump width differs
from the fleet width (an N=4 dump restoring into an N=2 fleet), every
fleet shard walks ALL source subdirs server-side and keeps only the keys
that hash to itself — the offline fallback when a live handoff isn't
wanted.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.ps import wire
from paddlebox_tpu_torch.ps.feature_value import _keyed_hash
from paddlebox_tpu_torch.utils import lockdep
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe

# Cluster-placement salt — deliberately distinct from any host-table
# internal salt so cluster-shard and lock-shard partitions decorrelate.
CLUSTER_SALT = 0x9E2A5C7B3D41F68D

# env var exporting the PS fleet's addresses to spawned workers
# (cluster analogue of the single-server PBOX_PS_ADDR)
ADDRS_ENV = "PBOX_PS_ADDRS"

# lifecycle verbs legal inside a 2-phase cluster transaction
# (reshard_cutover = the membership flip: commit adopts the staged/carried
#  new map, drops moved rows on the sources, and unfreezes the moving range)
LIFECYCLE_VERBS = ("end_day", "reshard_cutover")


def shard_dir(path: str, shard: int) -> str:
    """Per-shard subdirectory of a cluster checkpoint/dump path."""
    return os.path.join(path, f"shard-{shard:03d}")


def format_addrs(addrs: Sequence[Tuple[str, int]]) -> str:
    return ",".join(f"{h}:{p}" for h, p in addrs)


def parse_addrs(spec: str) -> List[Tuple[str, int]]:
    """Parse "host:port,host:port,..." (the ADDRS_ENV format)."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host, int(port)))
    return out


def addrs_from_env() -> Optional[List[Tuple[str, int]]]:
    spec = os.environ.get(ADDRS_ENV, "")
    return parse_addrs(spec) if spec else None


class ServerMap:
    """Deterministic key-hash → shard assignment over N server addresses.

    splitmix64 on (key ^ CLUSTER_SALT) mod N: seed-stable, uniform, and
    independent of insertion order — the same key always routes to the
    same shard for every client of the same fleet size.
    """

    __slots__ = ("addrs", "n", "epoch")

    def __init__(self, addrs: Sequence[Tuple[str, int]], epoch: int = 0):
        if not addrs:
            raise ValueError("ServerMap needs at least one server address")
        self.addrs: List[Tuple[str, int]] = [tuple(a) for a in addrs]
        self.n = len(self.addrs)
        # monotonic membership epoch: bumped by exactly one on every
        # committed reshard; fenced sparse verbs carry it so a server
        # whose membership disagrees can answer a typed redirect instead
        # of silently applying to a range it doesn't own
        self.epoch = int(epoch)

    def describe(self) -> Dict:
        """Wire-shaped membership descriptor (health / redirect hint).
        Addresses ride as the compact ``format_addrs`` string — the wire
        codec carries scalars and flat dicts, not nested lists."""
        return {"epoch": self.epoch, "addrs": format_addrs(self.addrs)}

    def shard_of_keys(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized shard id per key (int64; all zeros when n == 1)."""
        keys = np.asarray(keys, np.uint64)
        if self.n == 1:
            return np.zeros(keys.shape, np.int64)
        return (_keyed_hash(keys, CLUSTER_SALT) % np.uint64(self.n)) \
            .astype(np.int64)

    def shard_of_key(self, key: int) -> int:
        return int(self.shard_of_keys(np.asarray([key], np.uint64))[0])

    def partition(self, keys: np.ndarray) -> List[np.ndarray]:
        """Positions of each shard's keys in the original array.

        Returns ``pos`` with ``len(pos) == n``; ``pos[s]`` preserves the
        caller's relative order, which keeps per-shard chunk payloads —
        and therefore pinned-rid replay bytes — deterministic.
        """
        shards = self.shard_of_keys(keys)
        return [np.flatnonzero(shards == s) for s in range(self.n)]


def owned_mask(keys: np.ndarray, shard: int, n: int) -> np.ndarray:
    """Boolean mask of ``keys`` owned by ``shard`` in an ``n``-wide fleet
    — the pure placement predicate (no address list needed), used by the
    server-side reshard-on-load owner filter."""
    keys = np.asarray(keys, np.uint64)
    if n <= 1:
        return np.ones(keys.shape, bool)
    return (_keyed_hash(keys, CLUSTER_SALT) % np.uint64(n)).astype(
        np.int64) == int(shard)


def make_server_map(addrs: Sequence[Tuple[str, int]],
                    epoch: int = 0) -> ServerMap:
    """Sanctioned ServerMap constructor for client/server code.

    pboxlint PB803 flags direct ``ServerMap(...)`` construction outside
    ps/cluster.py + ps/reshard.py so every membership change routes
    through the reshard API; code that merely needs a map over a known
    address list (PSClient ctor, server membership adoption) builds it
    here.
    """
    return ServerMap(addrs, epoch=epoch)


def map_from_desc(desc: Dict) -> ServerMap:
    """Rebuild a ServerMap from a membership descriptor
    (:meth:`ServerMap.describe` — health responses, redirect hints).
    Accepts the wire string form and the in-process pair-list form."""
    a = desc["addrs"]
    addrs = parse_addrs(a) if isinstance(a, str) \
        else [(h, int(p)) for h, p in a]
    return ServerMap(addrs, epoch=int(desc.get("epoch", 0)))


class _InflightBudget:
    """Shared in-flight chunk cap across the per-shard pipeline runs.

    One sharded verb drives N concurrent :class:`_PipelineRun` s; this
    budget keeps the TOTAL frames in flight at the single-server window,
    so fan-out multiplies wire concurrency without multiplying client
    memory.  Lock order: a run's _cv is always taken BEFORE this lock
    (take() probes under its cv); release() never holds both — it drops
    the budget lock, then notifies each registered run cv with nothing
    held, so no cycle can form between same-named run cvs.
    """

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self._used = 0
        self._lock = lockdep.lock("ps.cluster._InflightBudget._lock")
        self._run_cvs: List = []

    def register(self, cv) -> None:
        with self._lock:
            self._run_cvs.append(cv)

    def try_acquire(self) -> bool:
        with self._lock:
            if self._used < self.cap:
                self._used += 1
                return True
            return False

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._used = max(0, self._used - n)
            cvs = list(self._run_cvs)
        for cv in cvs:
            with cv:
                cv.notify_all()


def two_phase_lifecycle(client, verb: str, table: Optional[str] = None,
                        timeout: float = 60.0,
                        extra: Optional[Dict] = None,
                        group: Optional[str] = None):
    """Run a decaying lifecycle verb cluster-wide, exactly once per shard.

    n == 1 degrades to the plain single-server dedup'd send (byte- and
    rid-identical to the pre-cluster client).  n > 1 runs prepare on
    every shard, then commit only after ALL prepared; the rid group is
    pinned on the client until the commit completes, so a caller-level
    retry after any partial failure re-drives the SAME rids and the
    per-shard dedup windows collapse duplicates.

    ``extra`` is merged into every phase frame — the reshard cutover uses
    it to carry the new membership descriptor, so even a server that
    crashed and lost its staged migration state can execute the commit
    from the frame alone (the same self-containment the commit verb
    already has).

    ``group`` pins a CALLER-deterministic rid group instead of the
    client-private pin in ``_txn_groups``: a verb that must stay
    exactly-once across a caller PROCESS death (the trainer fleet's
    end_day, re-driven by whichever rank wins the leader lease) derives
    the group from durable coordinates (day id), so every driver —
    original leader, failover leader, the restarted original — replays
    the same rids through the dedup windows.  The n == 1 degenerate path
    pins ``<group>.c0`` for the same reason (the plain send otherwise
    mints a fresh rid per attempt).
    """
    if verb not in LIFECYCLE_VERBS:
        raise ValueError(f"not a cluster lifecycle verb: {verb!r}")
    extra = extra or {}
    n = getattr(client, "n_shards", 1)
    # every phase frame carries the client's membership epoch: a fleet
    # that resharded since this client last refreshed answers a typed
    # wrong_epoch instead of decaying only the shards the stale map
    # names (the client's verb layer refreshes and re-drives — the
    # pinned rid group makes the replay exactly-once per shard)
    stamp = getattr(client, "_stamp_ep", None) or (lambda r: r)
    if n <= 1:
        req = {"cmd": verb, "table": table, **extra}
        if group is not None:
            req[wire.RID_FIELD] = f"{group}.c0"
        return client._call(stamp(req), dedup=True, timeout=timeout)
    t0 = time.perf_counter()
    txn_key = (verb, table or "")
    pinned = group
    if group is None:
        group = client._txn_groups.get(txn_key)
        if group is None:
            group = client.new_rid_group()
            client._txn_groups[txn_key] = group
    prepared: List[int] = []
    try:
        for shard in range(n):
            client._call(stamp({"cmd": "lifecycle_prepare", "verb": verb,
                                "table": table, "txn": group, **extra,
                                wire.RID_FIELD: f"{group}.p{shard}"}),
                         shard=shard, timeout=timeout)
            prepared.append(shard)
    except Exception:
        # Best-effort abort of staged shards; the group stays pinned, so
        # a caller retry replays the same prepare rids (dedup'd) and can
        # still commit — abort only clears server-side staging bookkeeping.
        for shard in prepared:
            try:
                client._call(stamp({"cmd": "lifecycle_abort", "verb": verb,
                                    "table": table, "txn": group, **extra,
                                    wire.RID_FIELD: f"{group}.a{shard}"}),
                             shard=shard, timeout=5.0)
            except Exception:
                pass
        stat_add("ps.cluster.lifecycle_abort")
        raise
    out = None
    for shard in range(n):
        out = client._call(stamp({"cmd": "lifecycle_commit", "verb": verb,
                                  "table": table, "txn": group, **extra,
                                  wire.RID_FIELD: f"{group}.c{shard}"}),
                           shard=shard, timeout=timeout)
    if pinned is None:
        client._txn_groups.pop(txn_key, None)
    stat_add("ps.cluster.lifecycle_commit")
    stat_observe("ps.cluster.lifecycle_s", time.perf_counter() - t0)
    return out


def _fan_out(client, build_req, timeout: float) -> List[Dict]:
    """Send one request per shard concurrently; list of responses by shard.

    Control-plane fan-out (save/load/size/health — one frame per shard,
    no chunk streams), so plain threads over `_call` are enough; the row
    verbs use the budgeted per-shard pipeline instead.
    """
    n = client.n_shards
    out: List[Optional[Dict]] = [None] * n
    errs: List[Optional[BaseException]] = [None] * n

    def drive(shard: int) -> None:
        try:
            out[shard] = client._call(build_req(shard), shard=shard,
                                      timeout=timeout)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs[shard] = e

    threads = [threading.Thread(target=drive, args=(s,), daemon=True)
               for s in range(1, n)]
    for t in threads:
        t.start()
    drive(0)
    for t in threads:
        t.join()
    for shard, e in enumerate(errs):
        if e is not None:
            raise e
    return out  # type: ignore[return-value]


def cluster_save(client, path: str, mode: str = "all",
                 keys: Optional[np.ndarray] = None,
                 table: Optional[str] = None) -> int:
    """Fan `save` out per shard into ``shard-<k:03d>/`` subdirs.

    EVERY shard saves every generation — even one with zero delta keys —
    because the dump is also where that shard's DEDUP.bin lands; a
    restarting supervisor needs a current dedup window from its own
    subdir regardless of how the delta keys hashed.
    """
    n = getattr(client, "n_shards", 1)
    stamp = getattr(client, "_stamp_ep", None) or (lambda r: r)
    if n <= 1:
        req: Dict = stamp({"cmd": "save", "path": path, "mode": mode,
                           "table": table})
        if keys is not None:
            req["keys"] = np.asarray(keys, np.uint64)
        return int(client._call(req, timeout=120)["saved"])
    pos = None
    if keys is not None:
        keys = np.asarray(keys, np.uint64)
        pos = client.server_map.partition(keys)

    def build(shard: int) -> Dict:
        req = stamp({"cmd": "save", "path": shard_dir(path, shard),
                     "mode": mode, "table": table})
        if pos is not None:
            req["keys"] = keys[pos[shard]]
        return req

    out = _fan_out(client, build, timeout=120)
    return sum(int(r["saved"]) for r in out)


def dump_width(path: str) -> int:
    """Number of contiguous ``shard-<k:03d>/`` subdirs under a cluster
    dump path (0 = flat single-server dump)."""
    k = 0
    while os.path.isdir(shard_dir(path, k)):
        k += 1
    return k


def cluster_load(client, path: str, mode: str = "all",
                 table: Optional[str] = None) -> int:
    """Fan `load` out per shard from ``shard-<k:03d>/`` subdirs.

    **Reshard-on-load:** when the dump width on disk differs from the
    fleet width (an N=4 dump restoring into an N=2 fleet, or a flat
    single-server dump into any fleet), every fleet shard is asked to
    walk ALL source subdirs itself with an ``owner`` filter — it keeps
    only the keys that hash to it under the CURRENT map, so each row
    lands on exactly one shard and the restored key space is identical
    to a natively-sharded save.  The offline fallback to the live
    handoff in ps/reshard.py.
    """
    n = getattr(client, "n_shards", 1)
    stamp = getattr(client, "_stamp_ep", None) or (lambda r: r)
    src = dump_width(path)
    if n <= 1:
        if src in (0, 1):
            p = path if src == 0 else shard_dir(path, 0)
            return int(client._call(stamp({"cmd": "load", "path": p,
                                           "mode": mode, "table": table}),
                                    timeout=120)["loaded"])
        r = client._call(stamp({"cmd": "load", "path": path, "mode": mode,
                                "table": table,
                                "owner": np.asarray([0, 1], np.int64),
                                "src_shards": src}), timeout=120)
        stat_add("ps.cluster.reshard_on_load")
        return int(r["loaded"])
    if src == n:
        out = _fan_out(
            client,
            lambda shard: stamp({"cmd": "load",
                                 "path": shard_dir(path, shard),
                                 "mode": mode, "table": table}),
            timeout=120)
        return sum(int(r["loaded"]) for r in out)
    out = _fan_out(
        client,
        lambda shard: stamp({"cmd": "load", "path": path, "mode": mode,
                             "table": table,
                             "owner": np.asarray([shard, n], np.int64),
                             "src_shards": src}),
        timeout=120)
    stat_add("ps.cluster.reshard_on_load")
    return sum(int(r["loaded"]) for r in out)
