"""RPC parameter-server service — the CPU PS tier over the network.

Copy of ``paddlebox_tpu/ps/service.py`` with the import paths rewritten;
host code only (numpy, sockets, threads), so no server, client, pump or
pool thread ever makes a CUDA call.  One departure: a server's
``{"ok": False}`` error reply is raised as :class:`ServerErrorReply` (a
``RuntimeError``, so every caller that catches ``RuntimeError`` keeps
working; ``fleet.train_passes`` resumes it).

≙ PSCORE's brpc server/client (ps/service/brpc_ps_server.{h,cc},
brpc_ps_client.{h,cc}): push/pull sparse & dense against tables sharded by
``key % shard_num``, plus save/load/shrink/barrier control verbs.  The
TPU rebuild keeps the same wire verbs over length-prefixed TCP frames in
the typed binary codec (ps/wire.py — dtype/shape headers + raw buffers,
like sendrecv.proto's VariableMessage; NO pickle touches network bytes).
Several named tables ride one service (≙ brpc's table_id-routed cmds /
the_one_ps multi-table deployment); trainers on other hosts pull pass
working sets from, and flush them to, this service instead of their local
DRAM (the multi-host BuildPull path, ps_gpu_wrapper.cc:337-419).

Retry discipline (upgraded from the reference's retry-then-fail,
ps_gpu_wrapper.cc:388-419): EVERY verb is safely retryable.  Idempotent
verbs simply resend; non-idempotent verbs (``push_sparse_delta``,
``push_dense``, ``barrier``, ``allreduce``, ``end_day``) carry a
client-generated request id (``rid`` = client token + monotonic seq,
wire.RID_FIELD) that the server dedups through a bounded per-client
window in :class:`PSServer` — a resend of an applied-but-unacknowledged
mutation returns the cached response instead of applying twice
(exactly-once under ambiguous failure).  The client backs off
exponentially with jitter under an overall deadline budget
(utils/backoff.Backoff).  Fault injection hooks (ps/faults.py) ride the
``connect``/``send``/``recv``/``dispatch`` sites when armed; production
pays one ``is None`` check per site.

Wire-path pipelining (≙ BoxPS hiding PS latency behind the pass
lifecycle — the multi-stream BuildPull / EndPass dump of
ps_gpu_wrapper.cc:337-419,983): a :class:`PSClient` owns a pool of
``FLAGS_ps_streams`` connections and drives multi-chunk row verbs as a
sliding window of up to ``FLAGS_ps_window`` frames in flight across the
pool (:class:`_PipelineRun`).  Responses match their requests by the rid
echo, so chunks complete out of order across streams; a failed stream's
in-flight chunks requeue and resend — through the dedup window — on any
surviving (or reconnected) stream, which is what makes pipelining
compose with the exactly-once protocol and with pinned-rid pass-level
replay.  No client-wide lock ever covers network I/O: ``_lock`` guards
rid allocation and the learned row-width estimate only (lint rule PB104
enforces this package-wide); each pooled stream is exclusively checked
out by one verb/pump for the duration of its frame I/O.

Optional payload quantization (EQuARX-style reduced-precision wire
traffic): ``FLAGS_ps_wire_dtype`` ∈ {f32, f16, i8} encodes the float32
row fields of pull_sparse responses and push_sparse/push_sparse_delta
requests at reduced precision with per-chunk-per-field scales
(wire.quantize_rows, tag 7).  Decode dequantizes transparently, so the
server's table state stays fp32 and a delta-mode RemoteTableAdapter's
pull snapshot is automatically the DEQUANTIZED values — write-back
deltas stay consistent (a zero training delta writes back exact zeros).
``rows_abs`` metadata (slot, mf_size, beta powers) and f64 counters are
never quantized.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import socketserver
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.ps import cluster as ps_cluster
from paddlebox_tpu_torch.ps import faults, heat, wire
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.utils import flight, lockdep, trace
from paddlebox_tpu_torch.utils.backoff import Backoff
from paddlebox_tpu_torch.utils.monitor import (stat_add, stat_max, stat_observe,
                                         stat_snapshot)

DEFAULT_TABLE = "embedding"

flags.define_flag(
    "ps_dedup_window", 1024,
    "per-client-token cap of the PS server's rid->response dedup window; "
    "exactly-once holds for resends within the newest <window> requests "
    "of a client (must exceed the chunk count of one logical delta push)")
flags.define_flag(
    "ps_streams", 4,
    "PSClient connection-pool size: multi-chunk row verbs pipeline their "
    "chunks across this many concurrent wire streams; 1 restores "
    "stop-and-wait")
flags.define_flag(
    "ps_window", 8,
    "max chunk frames in flight across a PSClient's stream pool during a "
    "pipelined multi-chunk verb (clamped to >= ps_streams)")
flags.define_flag(
    "ps_wire_dtype", "f32",
    "wire encoding of float32 row fields in pull_sparse/push_sparse/"
    "push_sparse_delta frames: f32 (exact), f16, or i8 (per-chunk-per-"
    "field scales; ~2x/4x fewer wire bytes).  Server table state stays "
    "fp32 — payloads dequantize at decode")
flags.define_flag(
    "obs_slow_verb_ms", 0.0,
    "server-side slow-verb threshold in milliseconds: a dispatch slower "
    "than this logs a warning and bumps ps.server.slow_verb (0 = off).  "
    "Latency histograms (ps.server.<verb>.latency_s.*) record "
    "regardless")
flags.define_flag(
    "ps_snap_cap", 4,
    "RemoteTableAdapter cap on concurrent delta-mode pull snapshots; "
    "raise it when pipelined next-pass preload overlaps several pulls, "
    "or an evicted snapshot fails its later write-back")


def _send(sock, msg: Dict, role: str = "client") -> None:
    payload = wire.encode(msg)
    if role == "client" and "cmd" in msg:
        stat_add(f"ps.wire.{msg['cmd']}.tx_bytes", float(len(payload)))
    if len(payload) > wire.MAX_FRAME:
        # non-retryable by construction (RuntimeError, not ConnectionError):
        # the peer would reject it anyway — fail once with the real reason
        raise RuntimeError(
            f"frame of {len(payload)} bytes exceeds wire cap "
            f"{wire.MAX_FRAME} — split the request (fewer keys per call)")
    frame = struct.pack("<Q", len(payload)) + payload
    if faults.ACTIVE is not None:
        faults.on_send(sock, frame, role)
    sock.sendall(frame)


def _recv(sock, role: str = "client") -> Dict:
    if faults.ACTIVE is not None:
        faults.on_recv(role)
    head = b""
    while len(head) < 8:
        chunk = sock.recv(8 - len(head))
        if not chunk:
            raise ConnectionError("peer closed")
        head += chunk
    (length,) = struct.unpack("<Q", head)
    if length > wire.MAX_FRAME:
        raise ConnectionError(f"oversized frame ({length} bytes)")
    buf = bytearray()
    while len(buf) < length:
        chunk = sock.recv(min(1 << 20, length - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return wire.decode(bytes(buf))


class _DedupWindow:
    """Bounded per-client rid → cached-response window (the server half of
    the exactly-once protocol).

    A rid is ``<token>:<tail>``; entries group by token.  ``begin`` either
    admits a new rid (returns None — caller executes the verb and must
    ``commit`` or ``drop``), returns the cached response of a completed
    duplicate, or blocks while the original is still executing (a blocking
    verb like barrier whose first connection died keeps its handler thread
    registered — the resend must WAIT for that execution, never start a
    second one).

    Bounded-memory contract: at most ``cap`` completed entries per token
    and ``token_cap`` tokens (LRU); in-flight entries are never evicted.
    A resend older than the newest ``cap`` rids of its client re-executes
    — callers keep ``cap`` above the chunk count of one logical verb.
    """

    def __init__(self, cap: int = 1024, token_cap: int = 1024,
                 wait_timeout: float = 120.0):
        self.cap = cap
        self.token_cap = token_cap
        self.wait_timeout = wait_timeout
        self._cv = lockdep.condition("ps.service._DedupWindow._cv")
        # token -> OrderedDict[rid -> [done, resp]]
        self._by_token: "OrderedDict[str, OrderedDict]" = OrderedDict()

    @staticmethod
    def _token(rid: str) -> str:
        return rid.rsplit(":", 1)[0]

    def begin(self, rid: str) -> Optional[Dict]:
        tok = self._token(rid)
        deadline = time.monotonic() + self.wait_timeout
        with self._cv:
            while True:
                entries = self._by_token.get(tok)
                if entries is not None:
                    self._by_token.move_to_end(tok)
                entry = None if entries is None else entries.get(rid)
                if entry is None:
                    if entries is None:
                        entries = self._by_token[tok] = OrderedDict()
                        while len(self._by_token) > self.token_cap:
                            self._by_token.popitem(last=False)
                            stat_add("ps.server.dedup_token_evict")
                    entries[rid] = [False, None]    # in-flight
                    return None
                if entry[0]:                        # done → replay
                    stat_add("ps.server.dedup_hit")
                    flight.record("dedup_hit", rid=rid)
                    return entry[1]
                # original still executing on another handler thread
                stat_add("ps.server.dedup_wait")
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return {"ok": False,
                            "error": f"duplicate of rid {rid} still "
                                     f"executing after {self.wait_timeout}s"}
                self._cv.wait(rem)

    def commit(self, rid: str, resp: Dict) -> None:
        tok = self._token(rid)
        with self._cv:
            entries = self._by_token.get(tok)
            if entries is not None and rid in entries:
                entries[rid][:] = [True, resp]
                # eviction is by COMPLETION order: the entry just
                # committed must outlive older completions, or a tiny cap
                # could evict the response a blocked duplicate is waiting
                # for before it wakes
                entries.move_to_end(rid)
                done = [r for r, e in entries.items() if e[0]]
                evicted = done[:max(0, len(done) - self.cap)]
                for r in evicted:
                    del entries[r]
                    stat_add("ps.server.dedup_evict")
                if evicted:
                    flight.record("dedup_evict", n=len(evicted))
            self._cv.notify_all()

    def drop(self, rid: str) -> None:
        """The verb raised (nothing committed, or it rolled back — e.g. a
        barrier timeout): forget the rid so a resend re-executes."""
        tok = self._token(rid)
        with self._cv:
            entries = self._by_token.get(tok)
            if entries is not None:
                entries.pop(rid, None)
            self._cv.notify_all()

    def export(self) -> List[Tuple[str, bytes]]:
        """Durable snapshot of the window: every DONE entry as
        (rid, wire-encoded response), in token/completion order.  In-flight
        entries are deliberately skipped — their verbs never committed, so
        a resend after restore re-executing them is exactly the correct
        at-most-once-became-zero-times outcome.  Captured alongside the
        table state it describes (the checkpoint's save verb / an
        in-process ``PSServer.dedup_state`` handoff) so a client retrying
        across a server death replays instead of double-applying."""
        out: List[Tuple[str, bytes]] = []
        with self._cv:
            for entries in self._by_token.values():
                for rid, entry in entries.items():
                    if entry[0]:
                        out.append((rid, wire.encode(entry[1])))
        return out

    def restore(self, state: List[Tuple[str, bytes]]) -> int:
        """Full-replace the window from an ``export`` snapshot (restore
        order follows the checkpoint chain, so the HEAD generation's
        snapshot — restored last — wins).  Entries come back marked done;
        eviction bookkeeping restarts fresh.  The frames are decoded
        before the window's lock is taken."""
        decoded = [(rid, wire.decode(raw)) for rid, raw in state]
        with self._cv:
            self._by_token.clear()
            for rid, msg in decoded:
                tok = self._token(rid)
                entries = self._by_token.get(tok)
                if entries is None:
                    entries = self._by_token[tok] = OrderedDict()
                entries[rid] = [True, msg]
            self._cv.notify_all()
            return sum(len(e) for e in self._by_token.values())


# verbs whose rid is an ECHO ONLY (response matching on pipelined
# streams), never a dedup-window entry: they are idempotent, and caching
# e.g. a bulk pull response would blow the window's bounded memory
_RID_ECHO_ONLY = frozenset({"pull_sparse", "pull_dense", "size",
                            "list_tables", "health", "save", "load",
                            "forward", "dump_xbox"})

# sparse data verbs that carry the client's membership epoch ("ep") and
# are epoch/ownership-fenced on a membership-aware server (ps/reshard.py)
_FENCED_VERBS = frozenset({"pull_sparse", "push_sparse",
                           "push_sparse_delta", "forward"})

# cluster control-plane verbs fenced on the epoch alone (they address
# whole shards, so there is no per-key ownership to check): a client
# fanning these out over a STALE map would fork the fleet — end_day
# decays only the shards the old map names, save commits a
# partial-width dump, load restores into a partition nobody routes by.
# Exempt: the reshard driver's own traffic — lifecycle frames whose
# verb is "reshard_cutover" (the cutover crosses the epoch by design
# and its commit is epoch-guarded idempotent) and ingest loads marked
# with RESHARD_FIELD (they target pending members that are not yet in
# any map).
_FENCED_CONTROL_VERBS = frozenset({"end_day", "save", "load", "shrink",
                                   "lifecycle_prepare",
                                   "lifecycle_commit",
                                   "lifecycle_abort"})

# epoch field riding fenced requests (kept short like wire.RID_FIELD)
EPOCH_FIELD = "ep"

# marks a frame as the reshard driver's own data path (ps/reshard.py
# ingest) — skipped by the control-plane fence
RESHARD_FIELD = "rsd"


class FenceError(Exception):
    """Server-side typed epoch/ownership rejection.

    Raised from the fence check that runs AFTER the dedup-window echo
    (an applied duplicate still replays its cached ack) and BEFORE any
    table mutation — so a ``not_owner``/``wrong_epoch`` response PROVES
    the request was not applied, and ``_dispatch_dedup`` dropping the rid
    on the way out means a later re-drive under the new map re-executes
    cleanly.  ``dispatch_one`` renders it as a typed response
    (``{"ok": False, "<kind>": True, "epoch": E, "membership": desc}``)
    the client resolves by refreshing its map and re-driving only the
    affected chunks — never a user-visible error."""

    def __init__(self, kind: str, membership) -> None:
        super().__init__(kind)
        self.kind = kind            # "wrong_epoch" | "not_owner" | "migrating"
        self.membership = membership

    def resp(self) -> Dict:
        out = {"ok": False, self.kind: True,
               "error": f"fence: {self.kind}"}
        if self.membership is not None:
            out["epoch"] = self.membership.epoch
            out["membership"] = self.membership.describe()
        return out


class ServerErrorReply(RuntimeError):
    """A server's error reply (``{"ok": False, "error": ...}``) raised on
    the client: the request reached a live server, which refused or
    failed it.  A ``RuntimeError``, as in the JAX package; its own type
    lets ``fleet.train_passes`` tell it from a trainer's own fault."""


class _FenceRedirect(ServerErrorReply):
    """Client-side image of a typed fence response (or an aggregate of
    them across a pipelined fan-out).  ``hint`` is the freshest membership
    descriptor the servers offered; ``partial`` maps shard -> the
    per-chunk response list of that shard's pipeline run (``None`` =
    chunk never resolved, ``ok: False`` + typed field = provably not
    applied) so a non-idempotent verb can re-drive exactly the unapplied
    chunks."""

    def __init__(self, kind: str, hint: Optional[Dict] = None,
                 partial: Optional[Dict[int, List[Optional[Dict]]]] = None):
        super().__init__(f"fence redirect: {kind}")
        self.kind = kind
        self.hint = hint
        self.partial = partial


def _fence_kind(resp: Dict) -> Optional[str]:
    """The typed fence marker of a failed response, if any."""
    for kind in ("wrong_epoch", "not_owner", "migrating"):
        if resp.get(kind):
            return kind
    return None

# dedup-window snapshot rides in the checkpointed sparse dir, next to the
# shard files it must stay consistent with
DEDUP_FILE = "DEDUP.bin"


def _dedup_dump(path: str, state: List[Tuple[str, bytes]]) -> None:
    """Write a dedup-window snapshot as length-prefixed records
    ([rid_len][rid utf8][resp_len][wire-encoded resp]...) via tmp+rename —
    a crash mid-write leaves the previous file (or none) intact."""
    final = os.path.join(path, DEDUP_FILE)
    tmp = final + ".tmp"
    with open(tmp, "wb") as fh:
        for rid, raw in state:
            rb = rid.encode("utf-8")
            fh.write(struct.pack("<Q", len(rb)))
            fh.write(rb)
            fh.write(struct.pack("<Q", len(raw)))
            fh.write(raw)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)


def _dedup_read(path: str) -> Optional[List[Tuple[str, bytes]]]:
    fname = os.path.join(path, DEDUP_FILE)
    if not os.path.exists(fname):
        return None
    out: List[Tuple[str, bytes]] = []
    with open(fname, "rb") as fh:
        buf = fh.read()
    off = 0
    while off < len(buf):
        (rl,) = struct.unpack_from("<Q", buf, off)
        off += 8
        rid = buf[off:off + rl].decode("utf-8")
        off += rl
        (bl,) = struct.unpack_from("<Q", buf, off)
        off += 8
        out.append((rid, buf[off:off + bl]))
        off += bl
    return out


class _ThreadingTCPServer(socketserver.ThreadingTCPServer):
    # chaos restarts rebind the same port while old sockets drain TIME_WAIT
    allow_reuse_address = True
    daemon_threads = True


class PSServer:
    """Hosts named ShardedHostTables + a dense blob store behind TCP verbs:
    pull_sparse/push_sparse/pull_dense/push_dense/save/load/shrink/
    end_day/size/barrier/allreduce/list_tables/health (the BrpcPsService
    cmd surface with table-name routing ≙ table_id).  Requests carrying a
    rid are routed through the dedup window (exactly-once); ``shutdown``
    drains gracefully (stop accepting, finish in-flight verbs) and
    ``kill`` is the chaos harness's abrupt mid-verb death."""

    def __init__(self, table: Union[ShardedHostTable,
                                    Dict[str, ShardedHostTable]],
                 host: str = "127.0.0.1", port: int = 0,
                 dedup_state: Optional[List[Tuple[str, bytes]]] = None,
                 membership: Optional[Dict] = None, shard: int = 0):
        if isinstance(table, dict):
            self.tables: Dict[str, ShardedHostTable] = dict(table)
        else:
            self.tables = {DEFAULT_TABLE: table}
        heat.maybe_enable_from_flags()
        # elastic membership identity: the fleet map this server believes
        # in (None = legacy single-server, never fences) and its own index
        # in it (-1 = not a member — a retiring source after cutover, or a
        # joining destination before it).  Fenced sparse verbs are checked
        # against these; ps/reshard.py changes them via reshard_cutover.
        self.membership: Optional[ps_cluster.ServerMap] = None  # pboxlint: guarded-by=ps.service.PSServer._reshard_lock
        if membership is not None:
            self.membership = (membership
                               if isinstance(membership, ps_cluster.ServerMap)
                               else ps_cluster.map_from_desc(membership))
        self.shard = int(shard)
        # in-progress migration staging (reshard_begin .. cutover):
        # {"map": new ServerMap, "self_new": index-in-new-map (-1 leaving),
        #  "dirty": {table: set(moved keys written since snapshot)},
        #  "frozen": bool} — guarded by _reshard_lock
        self._reshard_lock = lockdep.lock("ps.service.PSServer._reshard_lock")
        self._reshard: Optional[Dict] = None
        self.dense: Dict[str, np.ndarray] = {}
        self._dense_lock = lockdep.lock("ps.service.PSServer._dense_lock")
        # per-table: delta merges need read-modify-write atomicity only
        # against the SAME table; unrelated tables stay concurrent
        self._delta_locks = {
            name: lockdep.lock("ps.service.PSServer._delta_locks")
            for name in self.tables}
        self._barrier_count = 0
        self._barrier_gen = 0
        self._barrier_cv = lockdep.condition("ps.service.PSServer._barrier_cv")
        # keyed cross-worker array allreduce (metric aggregation —
        # ≙ fleet.metrics gloo all_reduce of stat_pos/stat_neg,
        # fleet/metrics/metric.py:144)
        self._reduce_cv = lockdep.condition("ps.service.PSServer._reduce_cv")
        self._reduces: Dict[str, Dict] = {}
        # 2-phase cluster lifecycle staging (ps/cluster.py): txn id ->
        # {verb, table}.  Observability/abort bookkeeping only — the
        # commit frame is self-contained (carries the verb), so a
        # supervisor restart that loses this dict cannot lose a commit.
        self._staged_lock = lockdep.lock("ps.service.PSServer._staged_lock")
        self._staged: Dict[str, Dict] = {}
        self._dedup = _DedupWindow(cap=flags.get_flags("ps_dedup_window"))
        if dedup_state:
            # restart-durable exactly-once: a supervisor restarting a dead
            # server hands the old instance's window over (the table object
            # survived in-process, so state + window stay consistent)
            n = self._dedup.restore(dedup_state)
            stat_add("ps.server.dedup_restore_entries", n)
            flight.record("dedup_restore", entries=n, source="handoff")
        # lifecycle: _life_lock guards the dead flag (shutdown/kill may
        # race from a fault hook thread); _inflight_cv counts verbs being
        # executed so a graceful drain can wait them out
        self._life_lock = lockdep.lock("ps.service.PSServer._life_lock")
        # role tag surfaced by the health verb: "train" for the mutable
        # PS tier; the read-only serving tier (ps/serving.py) overrides
        # to "serving" so scrapers/routers can tell replicas apart
        self.mode = "train"
        self._dead = False
        self._draining = False
        self._inflight = 0
        self._inflight_cv = lockdep.condition("ps.service.PSServer._inflight_cv")
        self._conns_lock = lockdep.lock("ps.service.PSServer._conns_lock")
        self._conns: set = set()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                with outer._conns_lock:
                    outer._conns.add(self.request)

            def finish(self):
                with outer._conns_lock:
                    outer._conns.discard(self.request)

            def handle(self):
                # per-connection decode/apply pipeline: this thread recvs
                # AND DECODES frame i+1 while the dispatcher thread applies
                # frame i to the table and sends its response — a pipelined
                # multi-chunk verb overlaps chunk decode with the previous
                # chunk's table apply.  Responses stay strictly in request
                # order (one dispatcher, FIFO queue), which the client's
                # per-stream receiver requires.  The bounded queue (one
                # decoded frame of lookahead) keeps memory flat.
                q: "queue.Queue" = queue.Queue(maxsize=2)
                state = {"open": True}

                def abort_conn():
                    # wake this handler out of a blocked _recv so handle()
                    # returns and socketserver closes the connection (the
                    # client sees the same drop as the old inline path)
                    try:
                        self.request.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

                def dispatch_one(req) -> bool:
                    """Apply + respond to one decoded request; False ends
                    the connection (same exits as the old inline loop)."""
                    with outer._inflight_cv:
                        outer._inflight += 1
                    try:
                        try:
                            resp = outer._dispatch(req)
                        except faults.InjectedFault:
                            # injected mid-verb death: no response — the
                            # client's retry resolves through the dedup
                            # window (or a clean re-execute)
                            return False
                        except FenceError as e:
                            # typed epoch/ownership rejection (raised
                            # before any mutation; the rid was dropped):
                            # the client refreshes its map off the carried
                            # descriptor and re-drives the chunk
                            resp = e.resp()
                            if wire.RID_FIELD in req:
                                resp[wire.RID_FIELD] = req[wire.RID_FIELD]
                        except Exception as e:  # noqa: BLE001
                            resp = {"ok": False, "error": repr(e)}
                            if wire.RID_FIELD in req:
                                # echo even on failure: a pipelined client
                                # matches the error to the right chunk
                                resp[wire.RID_FIELD] = req[wire.RID_FIELD]
                        try:
                            _send(self.request, resp, role="server")
                        except RuntimeError as e:
                            # oversized RESPONSE: dying silently here would
                            # show the client a bare ConnectionError and it
                            # would re-pull the same oversized chunk — reply
                            # with the real reason instead (non-retryable)
                            err = {"ok": False,
                                   "error": f"response exceeds wire cap — "
                                            f"{e} (pull fewer keys per "
                                            f"call)"}
                            if wire.RID_FIELD in req:
                                err[wire.RID_FIELD] = req[wire.RID_FIELD]
                            try:
                                _send(self.request, err, role="server")
                            except (RuntimeError, ConnectionError, OSError):
                                return False
                        except (ConnectionError, OSError):
                            return False
                    finally:
                        with outer._inflight_cv:
                            outer._inflight -= 1
                            outer._inflight_cv.notify_all()
                    return not outer._draining  # drain: finish-current, out

                def dispatcher():
                    while True:
                        try:
                            req = q.get(timeout=0.25)
                        except queue.Empty:
                            if not state["open"]:
                                return
                            continue
                        if not dispatch_one(req):
                            abort_conn()
                            return

                t = threading.Thread(target=dispatcher, daemon=True)
                t.start()
                try:
                    while True:
                        try:
                            req = _recv(self.request, role="server")
                        except (ConnectionError, OSError, wire.DecodeError):
                            # malformed frame → stream sync is gone; drop
                            # the connection (client reconnects + retries)
                            return
                        while t.is_alive():
                            try:
                                q.put(req, timeout=0.25)
                                break
                            except queue.Full:
                                continue
                        if not t.is_alive():
                            return      # dispatcher ended the connection
                finally:
                    state["open"] = False
                    t.join()

        self._srv = _ThreadingTCPServer((host, port), Handler,
                                        bind_and_activate=True)
        self.addr: Tuple[str, int] = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def table(self) -> ShardedHostTable:
        """Back-compat single-table accessor (the default table)."""
        return self.tables[DEFAULT_TABLE]

    def _table(self, req: Dict) -> ShardedHostTable:
        name = req.get("table") or DEFAULT_TABLE
        t = self.tables.get(name)
        if t is None:
            raise KeyError(f"unknown table {name!r} "
                           f"(have {sorted(self.tables)})")
        return t

    # -- elastic membership fence -------------------------------------------
    def _membership_view(self):
        """Atomic (membership, shard, reshard) snapshot.  The trio is
        co-mutated under ``_reshard_lock`` in ``_adopt_membership``;
        reading the three words bare can observe the new map with the
        old shard index mid-cutover — every multi-word reader goes
        through this instead (PB902)."""
        with self._reshard_lock:
            return self.membership, self.shard, self._reshard

    def _fence(self, req: Dict) -> None:
        """Epoch + ownership check for a fenced sparse verb.  Runs AFTER
        the dedup echo (an applied duplicate replays its cached ack first)
        and BEFORE any mutation, so every rejection proves non-application
        and the dropped rid lets a re-drive under the new map execute
        cleanly.  Ordering: epoch first (a stale client must refresh
        before ownership means anything), then ownership, then the
        migration freeze (writes into a frozen moving range)."""
        m, shard, rs = self._membership_view()
        ep = req.get(EPOCH_FIELD)
        if ep is None:
            # unfenced legacy frame: serve while no reshard ever happened,
            # reject loudly (typed, with the map) once one has — silently
            # applying to a range this server may no longer own would
            # corrupt the moved rows
            if m.epoch <= 0:
                return
            stat_add("ps.server.fence_wrong_epoch")
            raise FenceError("wrong_epoch", m)
        if int(ep) != m.epoch:
            # EITHER direction: a stale client refreshes off the carried
            # descriptor; a client AHEAD of this server backs off bounded
            # (the cutover commit fan-out is still reaching us)
            stat_add("ps.server.fence_wrong_epoch")
            raise FenceError("wrong_epoch", m)
        if shard < 0:
            # epoch matched but this server left the fleet (owned_mask
            # degenerates to all-True at n == 1, so check explicitly)
            stat_add("ps.server.fence_not_owner")
            raise FenceError("not_owner", m)
        keys = req.get("keys")
        if keys is not None and m.n > 1:
            keys = np.asarray(keys, np.uint64)
            if len(keys) and not ps_cluster.owned_mask(
                    keys, shard, m.n).all():
                stat_add("ps.server.fence_not_owner")
                raise FenceError("not_owner", m)
        if rs is not None and rs["frozen"] \
                and req["cmd"] in ("push_sparse", "push_sparse_delta"):
            # cutover freeze: only WRITES touching the moving range block
            # (pulls still serve — the frozen values are consistent);
            # non-moving keys of this shard keep full write rate
            if keys is None:
                keys = np.asarray(req.get("keys", ()), np.uint64)
            if len(keys) and bool(
                    (rs["map"].shard_of_keys(keys)
                     != rs["self_new"]).any()):
                stat_add("ps.server.fence_migrating")
                raise FenceError("migrating", m)

    def _track_dirty(self, req: Dict) -> None:
        """Record moved-range keys a write touched during the un-frozen
        migration window — the delta catch-up set (reshard_delta ships
        exactly these rows)."""
        rs = self._reshard
        if rs is None or rs["frozen"]:
            return
        keys = np.asarray(req["keys"], np.uint64)
        if not len(keys):
            return
        moving = rs["map"].shard_of_keys(keys) != rs["self_new"]
        if moving.any():
            tname = req.get("table") or DEFAULT_TABLE
            with self._reshard_lock:
                if self._reshard is rs:
                    rs["dirty"].setdefault(tname, set()).update(
                        int(k) for k in keys[moving])

    def _moving_keys(self, tname: str, rs: Dict) -> np.ndarray:
        """Keys of ``tname`` resident on this server that the staged new
        map assigns elsewhere — the migration snapshot's row set."""
        t = self.tables[tname]
        return t.select_keys(
            lambda k: rs["map"].shard_of_keys(k) != rs["self_new"])

    def _dump_by_dst(self, tname: str, mk: np.ndarray, rs: Dict,
                     path: str) -> int:
        """Dump ``mk`` rows of ``tname`` split per DESTINATION shard into
        ``<path>/dst-<d:03d>/table-<tname>`` — each destination ingests
        only its own slice, so no server ever holds (or later re-ships)
        rows it will not own.  Missing keys are skipped by save(mode=
        "rows"), making retries after evictions harmless."""
        dst = rs["map"].shard_of_keys(mk)
        t = self.tables[tname]       # server-local dump, not a fleet send
        moved = 0
        for d in np.unique(dst):
            moved += t.save(
                os.path.join(path, f"dst-{int(d):03d}",
                             f"table-{tname}"),
                "rows", keys=np.sort(mk[dst == d]))
        return moved

    def _drop_unowned(self) -> int:
        """Drop every resident row this server does not own under its
        CURRENT membership — the cleanup that makes abandoned-migration
        ingest (rows upserted into a destination before an abort)
        invisible to later snapshots and to the union fleet state."""
        m, shard, _rs = self._membership_view()
        if m is None:
            return 0
        removed = 0
        for t in self.tables.values():
            if shard < 0:
                removed += t.filter_keys(
                    lambda k: np.zeros(len(k), bool))
            elif m.n > 1:
                removed += t.filter_keys(
                    lambda k: ps_cluster.owned_mask(k, shard, m.n))
        return removed

    def _adopt_membership(self, desc: Dict, assign: Optional[Dict]) -> bool:
        """Cutover commit: flip to the new map (idempotent — a duplicate
        or late commit with a non-advancing epoch is a no-op), drop the
        rows this server no longer owns, and unfreeze.  ``assign`` maps
        "host:port" -> new shard index; absent/-1 = leaving the fleet
        (the server keeps answering typed redirects until stopped)."""
        new_map = ps_cluster.map_from_desc(desc)
        me = f"{self.addr[0]}:{self.addr[1]}"
        new_idx = int((assign or {}).get(me, -1))
        with self._reshard_lock:
            cur = self.membership
            if cur is not None and new_map.epoch <= cur.epoch:
                return False
            self.membership = new_map
            self.shard = new_idx
            self._reshard = None
        removed = 0
        for t in self.tables.values():
            if new_idx >= 0:
                removed += t.filter_keys(
                    lambda k: ps_cluster.owned_mask(k, new_idx, new_map.n))
            else:
                # leaving: every row was shipped — drop them all so a
                # late unfenced read cannot see stale values
                removed += t.filter_keys(
                    lambda k: np.zeros(len(k), bool))
        stat_add("ps.server.reshard_rows_dropped", float(removed))
        flight.record("reshard_cutover", epoch=new_map.epoch,
                      shard=new_idx, dropped=removed)
        return True

    def _dispatch(self, req: Dict) -> Dict:
        """Fault hook + exactly-once wrapper around the verb switch.
        Observes every verb's server-side dispatch latency (dedup replays
        included — they are dispatches, just fast ones) and flags
        dispatches past ``FLAGS_obs_slow_verb_ms``."""
        if faults.ACTIVE is not None:
            faults.on_dispatch(req.get("cmd"), self)
        cmd = req.get("cmd")
        t0 = time.monotonic()
        try:
            return self._dispatch_dedup(req)
        finally:
            dt = time.monotonic() - t0
            stat_observe(f"ps.server.{cmd}.latency_s", dt)
            slow_ms = float(flags.get_flags("obs_slow_verb_ms"))
            if slow_ms > 0 and dt * 1000.0 >= slow_ms:
                stat_add("ps.server.slow_verb")
                logging.getLogger(__name__).warning(
                    "slow verb: %s took %.1fms (threshold %gms, rid=%s)",
                    cmd, dt * 1000.0, slow_ms, req.get(wire.RID_FIELD))

    def _dispatch_dedup(self, req: Dict) -> Dict:
        rid = req.get(wire.RID_FIELD)
        if rid is None:
            return self._exec(req)
        if req.get("cmd") in _RID_ECHO_ONLY:
            resp = self._exec(req)
            resp[wire.RID_FIELD] = rid
            return resp
        cached = self._dedup.begin(rid)
        if cached is not None:
            return cached
        try:
            resp = self._exec(req)
        except BaseException:
            # nothing applied, or the verb rolled itself back (barrier/
            # allreduce timeout paths) — a resend must re-execute
            self._dedup.drop(rid)
            raise
        resp[wire.RID_FIELD] = rid      # echo: client rejects stale frames
        self._dedup.commit(rid, resp)
        return resp

    def _exec(self, req: Dict) -> Dict:
        """Span wrapper around the verb switch: a server dispatch span
        opens only when the verb actually EXECUTES (a dedup-window
        replay returns before reaching here — chaos retries never
        duplicate server spans) and parents to the originating client
        span via the wire trace context."""
        if self.membership is not None:
            cmd = req.get("cmd")
            if cmd in _FENCED_VERBS \
                    or (cmd in _FENCED_CONTROL_VERBS
                        and req.get("verb") != "reshard_cutover"
                        and not req.get(RESHARD_FIELD)):
                self._fence(req)
        tr = trace.ACTIVE
        if tr is None:
            return self._exec_verb(req)
        cmd = req.get("cmd")
        with tr.span(f"ps.server.{cmd}",
                     parent=req.get(wire.TRACE_FIELD),
                     rid=req.get(wire.RID_FIELD)):
            return self._exec_verb(req)

    def _exec_verb(self, req: Dict) -> Dict:
        cmd = req["cmd"]
        if cmd == "pull_sparse":
            t = self._table(req)
            if req.get("create"):
                # persist fresh-row defaults on first pull so every worker
                # of a multi-trainer job sees identical base values
                # (delta write-back sums against a common base)
                # The per-table delta lock exists to serialize whole verbs
                # (read-modify-write atomicity for concurrent trainers), so
                # the pool fan-out inside bulk ops is intentionally part of
                # the guarded region — the "blocking" is the work itself.
                with self._delta_locks[req.get("table") or DEFAULT_TABLE]:
                    rows = t.bulk_pull(req["keys"])   # pboxlint: disable=PB602 -- verb-serialization by design
                    t.bulk_write(req["keys"], rows)   # pboxlint: disable=PB602 -- verb-serialization by design
                if self._reshard is not None:
                    # fresh-row defaults persisted mid-migration are
                    # moved-range state too — catch-up must ship them
                    self._track_dirty(req)
            else:
                rows = t.bulk_pull(req["keys"])
            wd = req.get("wire_dtype")
            if wd and wd != "f32":
                # reduced-precision RESPONSE payload; the table keeps the
                # exact fp32 rows written above — only the wire narrows
                rows = wire.quantize_rows(rows, wd, verb="pull_sparse")
            return {"ok": True, "rows": rows}
        if cmd == "push_sparse":
            self._table(req).bulk_write(req["keys"], req["rows"])
            if self._reshard is not None:
                self._track_dirty(req)
            return {"ok": True}
        if cmd == "push_sparse_delta":
            # geo/Hogwild-style merge for concurrent trainers: read-modify-
            # write under a lock so two workers' pass deltas SUM instead of
            # last-wins (≙ multi-node grad aggregation,
            # heter_comm_inl.h:2027 gather_one_node_grad + local merge).
            # Non-summable fields (slot, mf_size, beta powers) arrive as
            # absolute values and overwrite.
            t = self._table(req)
            # Delta-lock + pool fan-out: same deliberate verb-serialization
            # as the pull_sparse create path above.
            with self._delta_locks[req.get("table") or DEFAULT_TABLE]:
                cur = t.bulk_pull(req["keys"])   # pboxlint: disable=PB602 -- verb-serialization by design
                for f, d in req["rows"].items():
                    if f in cur:
                        cur[f] = cur[f] + d
                for f, v in (req.get("rows_abs") or {}).items():
                    if f in cur:
                        cur[f] = v
                if "unseen_days" in cur:
                    cur["unseen_days"] = np.zeros_like(cur["unseen_days"])
                t.bulk_write(req["keys"], cur)   # pboxlint: disable=PB602 -- verb-serialization by design
            if self._reshard is not None:
                self._track_dirty(req)
            return {"ok": True}
        if cmd == "pull_dense":
            with self._dense_lock:
                return {"ok": True, "value": self.dense.get(req["name"])}
        if cmd == "push_dense":
            with self._dense_lock:
                if req.get("add"):
                    cur = self.dense.get(req["name"])
                    self.dense[req["name"]] = (req["value"] if cur is None
                                               else cur + req["value"])
                else:
                    self.dense[req["name"]] = req["value"]
            return {"ok": True}
        if cmd == "save":
            keys = req.get("keys")
            if keys is not None:
                n = self._table(req).save(req["path"],
                                          req.get("mode", "all"), keys=keys)
            else:
                n = self._table(req).save(req["path"],
                                          req.get("mode", "all"))
            # the dedup window is PART of the table's durable state: a
            # checkpoint that restored rows without the rids that wrote
            # them would double-apply a client's post-restart retry
            _dedup_dump(req["path"], self._dedup.export())
            return {"ok": True, "saved": n}
        if cmd == "load":
            owner = req.get("owner")
            if owner is not None:
                # reshard-on-load (ps/cluster.cluster_load): the dump
                # width differs from the fleet width — walk EVERY source
                # subdir, then keep only the keys this shard owns under
                # the current map.  Clear-first preserves replace
                # semantics across the multi-dir upsert.  DEDUP.bin is
                # deliberately NOT restored: rid windows describe a
                # same-width server's history and don't map across
                # widths (clients are fresh after an offline reshard).
                t = self._table(req)
                shard_idx, n_width = int(owner[0]), int(owner[1])
                src = int(req.get("src_shards", 0))
                if req.get("mode", "replace") == "replace":
                    t.filter_keys(lambda k: np.zeros(len(k), bool))
                dirs = ([req["path"]] if src == 0 else
                        [ps_cluster.shard_dir(req["path"], k)
                         for k in range(src)])
                n = 0
                for d in dirs:
                    n += t.load(d, "upsert")
                n -= t.filter_keys(
                    lambda k: ps_cluster.owned_mask(k, shard_idx, n_width))
                stat_add("ps.server.reshard_on_load")
                return {"ok": True, "loaded": n}
            n = self._table(req).load(req["path"],
                                      req.get("mode", "replace"))
            state = _dedup_read(req["path"])
            if state is not None:
                restored = self._dedup.restore(state)
                stat_add("ps.server.dedup_restore_entries", restored)
                flight.record("dedup_restore", entries=restored,
                              source="checkpoint")
            return {"ok": True, "loaded": n}
        if cmd == "shrink":
            return {"ok": True, "removed": self._table(req).shrink()}
        if cmd == "end_day":
            self._table(req).end_day()
            return {"ok": True}
        if cmd == "lifecycle_prepare":
            # phase 1 of the cluster-wide 2-phase lifecycle
            # (ps/cluster.two_phase_lifecycle): validate + stage, execute
            # NOTHING.  The rid entering the dedup window here is what
            # makes a caller retry after partial failure exactly-once.
            verb = req.get("verb")
            if verb not in ps_cluster.LIFECYCLE_VERBS:
                raise ValueError(f"unknown lifecycle verb: {verb!r}")
            if verb == "reshard_cutover":
                # validate the self-contained commit CAN execute: the
                # frame must carry the new membership.  A mid-migration
                # restart that lost _reshard staging still prepares —
                # the commit executes from the frame alone.
                if not req.get("membership"):
                    raise ValueError("reshard_cutover prepare without a "
                                     "membership descriptor")
            else:
                self._table(req)  # raises on unknown table before staging
            with self._staged_lock:
                lockdep.guards(self, "_staged")
                self._staged[req["txn"]] = {"verb": verb,
                                            "table": req.get("table")}
            stat_add("ps.server.lifecycle_prepare")
            return {"ok": True, "staged": True}
        if cmd == "lifecycle_commit":
            # phase 2: self-contained — executes from the frame's own
            # verb/table, so a post-restart server with an empty _staged
            # dict still applies it (the dedup window, which DID survive
            # via handoff/DEDUP.bin, collapses duplicate commits)
            verb = req.get("verb")
            with self._staged_lock:
                self._staged.pop(req.get("txn") or "", None)
            if verb == "end_day":
                self._table(req).end_day()
            elif verb == "reshard_cutover":
                # adopt the frame's membership (idempotent on a duplicate
                # commit — the epoch guard makes it a no-op), drop moved
                # rows, unfreeze.  Self-contained like end_day's commit.
                if faults.ACTIVE is not None:
                    faults.on_lifecycle("reshard_cutover")
                self._adopt_membership(req["membership"],
                                       req.get("assign"))
            else:
                raise ValueError(f"unknown lifecycle verb: {verb!r}")
            stat_add("ps.server.lifecycle_commit")
            return {"ok": True}
        if cmd == "lifecycle_abort":
            with self._staged_lock:
                self._staged.pop(req.get("txn") or "", None)
            if req.get("verb") == "reshard_cutover":
                # abandon the migration: discard staging + dirty set,
                # unfreeze, and drop any rows ingested as a destination —
                # the old membership keeps serving exactly its own key
                # range (rollback is the MANIFEST's old epoch; owned
                # table state never changed)
                with self._reshard_lock:
                    self._reshard = None
                dropped = self._drop_unowned()
                flight.record("reshard_abort", shard=self.shard,
                              dropped=dropped)
            stat_add("ps.server.lifecycle_abort")
            return {"ok": True}
        if cmd == "reshard_begin":
            # migration phase 1 (ps/reshard.py): stage the proposed map,
            # start tracking writes into the moving range, and dump the
            # moving rows of EVERY table as the migration snapshot (the
            # same tmp+rename'd per-shard dump files checkpoints use).
            # Dedup'd + idempotent-by-re-snapshot: a retry (dropped rid,
            # or a restarted driver with a fresh rid) re-stages and
            # re-dumps CURRENT state, so nothing written between
            # attempts can be lost.
            new_map = ps_cluster.map_from_desc(req["membership"])
            self_new = int(req.get("self_new", -1))
            # self-clean first: an abandoned earlier migration may have
            # left ingested rows this server doesn't own — shipping those
            # stale copies would race the true owner's fresh dump
            self._drop_unowned()
            with self._reshard_lock:
                self._reshard = {"map": new_map, "self_new": self_new,
                                 "dirty": {}, "frozen": False}
            rs = self._reshard
            moved = 0
            for name in sorted(self.tables):
                mk = self._moving_keys(name, rs)
                if not len(mk):
                    continue
                moved += self._dump_by_dst(name, mk, rs, req["path"])
            if faults.ACTIVE is not None:
                faults.on_lifecycle("reshard_snapshot")
            stat_add("ps.server.reshard_snapshot_rows", float(moved))
            flight.record("reshard_begin", shard=self.shard,
                          epoch=new_map.epoch, rows=moved)
            return {"ok": True, "moved": moved}
        if cmd == "reshard_delta":
            # migration phase 2: ship the dirty (moved-range rows written
            # since the snapshot) set.  CUMULATIVE — the dirty set is not
            # cleared until cutover, so a kill between the dump and the
            # ack can never lose a row (the retry re-ships it; the
            # destination's keyed upsert is idempotent).  ``freeze=True``
            # is the final round: moving-range WRITES start answering
            # ``migrating``, in-flight verbs drain, then the closing
            # delta is collected — nothing can dirty the range after it.
            rs = self._reshard
            if rs is None:
                raise RuntimeError("reshard_delta without reshard_begin")
            if bool(req.get("freeze")):
                with self._reshard_lock:
                    rs["frozen"] = True
                with self._inflight_cv:
                    deadline = time.monotonic() + 5.0
                    while self._inflight > 1:
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            break
                        self._inflight_cv.wait(rem)
            with self._reshard_lock:
                dirty = {name: np.sort(np.fromiter(ks, np.uint64,
                                                   count=len(ks)))
                         for name, ks in rs["dirty"].items() if ks}
            moved = 0
            for name, mk in sorted(dirty.items()):
                moved += self._dump_by_dst(name, mk, rs, req["path"])
            if faults.ACTIVE is not None:
                faults.on_lifecycle("reshard_catchup")
            stat_add("ps.server.reshard_delta_rows", float(moved))
            return {"ok": True, "moved": moved,
                    "frozen": bool(rs["frozen"])}
        if cmd == "dump_xbox":
            # server-side xbox dump of THIS shard's rows (cluster fan-out
            # writes per-shard part files the client concatenates); lazy
            # import avoids a ps -> io import at module load
            from paddlebox_tpu_torch.io.checkpoint import dump_table_xbox
            n = dump_table_xbox(
                self._table(req), req["path"],
                base=bool(req.get("base", True)),
                base_threshold=float(req.get("base_threshold", 0.0)),
                delta_threshold=float(req.get("delta_threshold", 0.0)),
                quant_bits=int(req.get("quant_bits", 0)))
            return {"ok": True, "dumped": n}
        if cmd == "size":
            return {"ok": True, "size": self._table(req).size()}
        if cmd == "list_tables":
            return {"ok": True,
                    "tables": {n: t.size() for n, t in self.tables.items()}}
        if cmd == "health":
            # heartbeat: cheap liveness + drain visibility for clients and
            # the launcher's replica watch.  The stats sub-dict makes a
            # remote liveness check double as a metrics pull (verb-latency
            # percentiles included) even with FLAGS_obs_port off
            with self._inflight_cv:
                inflight = self._inflight
            out = {"ok": True, "mode": self.mode,
                   "draining": self._draining,
                   "inflight": inflight,
                   "tables": ",".join(sorted(self.tables)),
                   "stats": {k: float(v)
                             for k, v in stat_snapshot("ps.").items()}}
            hs = heat.summary()
            if hs is not None:
                # skew pull rides the liveness probe (≙ the stats
                # sub-dict) even with the obs exporter off
                out["heat"] = hs
            m, shard, rs = self._membership_view()
            if m is not None:
                # membership authority surface: clients refresh their
                # ServerMap from ANY live member's health (shard 0
                # preferred, falling through dead entries)
                out["membership"] = m.describe()
                out["shard"] = shard
                out["migrating"] = rs is not None
            return out
        if cmd == "barrier":
            world = req["world"]
            with self._barrier_cv:
                gen = self._barrier_gen
                self._barrier_count += 1
                if self._barrier_count >= world:
                    self._barrier_count = 0
                    self._barrier_gen += 1
                    self._barrier_cv.notify_all()
                else:
                    try:
                        while self._barrier_gen == gen:
                            if not self._barrier_cv.wait(timeout=60):
                                raise TimeoutError("ps barrier timeout")
                    except TimeoutError:
                        # roll back this waiter's arrival or every later
                        # barrier releases one participant short
                        if self._barrier_gen == gen:
                            self._barrier_count -= 1
                        raise
            return {"ok": True}
        if cmd == "allreduce":
            # keyed sum-allreduce of named arrays across `world` callers:
            # the exact distributed-metrics primitive (global AUC = AUC of
            # the SUMMED pos/neg bucket tables, ≙ fleet.metrics.auc,
            # fleet/metrics/metric.py:144).  Each key is one collective;
            # last reader cleans up, so keys are reusable across passes.
            key, world = req["key"], int(req["world"])
            with self._reduce_cv:
                st = self._reduces.setdefault(
                    key, {"sum": None, "count": 0, "readers": 0,
                          "done": False})
                if st["done"]:
                    raise RuntimeError(
                        f"allreduce key {key!r} still draining readers — "
                        "use a fresh key per collective (e.g. suffix the "
                        "pass id)")
                if st["sum"] is None:
                    st["sum"] = dict(req["arrs"])
                    st["world"] = world
                else:
                    if st["world"] != world:
                        raise ValueError(
                            f"allreduce key {key!r}: participants disagree "
                            f"on world size ({st['world']} vs {world}) — a "
                            "smaller world would complete the collective "
                            "early with a partial sum")
                    if set(st["sum"]) != set(req["arrs"]):
                        raise ValueError(
                            f"allreduce key {key!r}: participants disagree "
                            f"on array names ({sorted(st['sum'])} vs "
                            f"{sorted(req['arrs'])})")
                    st["sum"] = {k: st["sum"][k] + v
                                 for k, v in req["arrs"].items()}
                st["count"] += 1
                if st["count"] >= world:
                    st["done"] = True
                    self._reduce_cv.notify_all()
                else:
                    while not st["done"]:
                        if not self._reduce_cv.wait(timeout=60):
                            if st["done"]:
                                break     # completed as the clock expired
                            # roll back the WHOLE contribution (count AND
                            # the summed arrays) so a retry on the same
                            # key cannot double-count this worker
                            st["count"] -= 1
                            if st["count"] == 0:
                                # last waiter out: drop the entry entirely
                                # so a resized-world retry on the same key
                                # does not trip the world-agreement check
                                del self._reduces[key]
                            else:
                                st["sum"] = {k: st["sum"][k] - v
                                             for k, v in req["arrs"].items()}
                            raise TimeoutError("ps allreduce timeout")
                result = st["sum"]
                st["readers"] += 1
                if st["readers"] >= world:
                    del self._reduces[key]
            return {"ok": True, "arrs": result}
        return {"ok": False, "error": f"unknown cmd {cmd}"}

    # -- lifecycle -----------------------------------------------------------
    def _mark_dead(self) -> bool:
        with self._life_lock:
            if self._dead:
                return False
            self._dead = True
            return True

    def shutdown(self, drain_timeout: float = 5.0) -> None:
        """Graceful drain: stop accepting, let in-flight verbs finish
        (bounded by ``drain_timeout``), then close every connection."""
        if not self._mark_dead():
            return
        self._draining = True
        self._srv.shutdown()            # stop accepting new connections
        with self._inflight_cv:
            deadline = time.monotonic() + drain_timeout
            while self._inflight > 0:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                self._inflight_cv.wait(rem)
        self._srv.server_close()
        self._close_conns()

    def kill(self) -> None:
        """Abrupt death (the chaos harness's mid-verb server loss): no
        drain — the listener and every live connection drop on the floor.
        Table state survives in-process; a restart on the same port
        resumes service.  Exactly-once survives the kill two ways: an
        in-process restart hands ``dedup_state()`` to the new instance
        (launch.PSServerSupervisor), and a cross-process restart reloads
        the window from the checkpoint's DEDUP.bin alongside the rows it
        describes.  Injected mid-verb kills additionally fire BEFORE the
        verb applies (crash-before-commit)."""
        if not self._mark_dead():
            return
        self._srv.shutdown()
        self._srv.server_close()
        self._close_conns()

    def dedup_state(self) -> List[Tuple[str, bytes]]:
        """Snapshot the dedup window for an in-process restart handoff:
        ``PSServer(table, port=old_port, dedup_state=old.dedup_state())``.
        Safe to call on a dead server (the window outlives the sockets)."""
        return self._dedup.export()

    def _close_conns(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class _Stream:
    """One pooled PS connection.  A stream is EXCLUSIVELY checked out by a
    single verb (or pipeline pump) for the duration of its frame I/O, so
    no lock is ever held across network calls (lint rule PB104).  Each
    stream is pinned to one cluster shard: it only ever dials (and its
    chunks only ever requeue onto) that shard's address — a key's data
    lives on exactly one server, so cross-shard failover of a chunk
    would be meaningless."""

    __slots__ = ("idx", "shard", "sock", "gen", "closing")

    def __init__(self, idx: int, shard: int = 0, gen: int = 0):
        self.idx = idx
        self.shard = shard
        self.sock: Optional[socket.socket] = None
        # the client was closed while a verb held the stream: its socket
        # closes when the verb checks it back in
        self.closing = False
        # pool generation: a membership refresh swaps the whole pool; a
        # stream from a previous generation checking back in is closed
        # and discarded instead of polluting the new pool
        self.gen = gen


class _PipelineRun:
    """Shared state of one pipelined multi-chunk verb: the chunk queue,
    the sliding window, ordered results, and the abort latch.  Stream
    pumps call in from their own threads; every mutation happens under
    the run's condition lock.  A sharded verb runs one _PipelineRun per
    shard under a shared cluster ``budget`` (ps/cluster._InflightBudget)
    capping TOTAL frames in flight across the fan-out; take() probes the
    budget under this run's cv (lock order run._cv -> budget._lock) and
    complete()/requeue() release it with no locks held."""

    def __init__(self, reqs: List[Dict], window: int,
                 retries: Optional[int] = None, budget=None):
        self._cv = lockdep.condition("ps.service._PipelineRun._cv")
        self.budget = budget
        self.n = len(reqs)
        self._queue = deque(enumerate(reqs))
        self.results: List[Optional[Dict]] = [None] * self.n
        self.window = max(1, window)
        self.retries = retries     # per-CHUNK failure budget (None = ∞)
        self._attempts = [0] * self.n
        self.inflight = 0          # chunks claimed but not yet completed
        self.done_count = 0
        self.aborted = False
        self.gave_up = False       # some chunk exhausted its retry budget
        self.error: Optional[BaseException] = None      # non-retryable
        self.net_error: Optional[BaseException] = None  # last wire failure

    def _stopped(self) -> bool:
        return self.aborted or self.gave_up

    def take(self) -> Optional[Tuple[int, Dict]]:
        """Claim the next chunk + a window slot (None when drained or
        stopped).  Time blocked on a full window is the pipeline-stall
        metric: the wire is ahead of the window."""
        job = None
        stalled = 0.0
        with self._cv:
            while not self._stopped() and self._queue:
                if self.inflight < self.window and \
                        (self.budget is None or self.budget.try_acquire()):
                    job = self._queue.popleft()
                    self.inflight += 1
                    stat_max("ps.client.inflight_hwm", float(self.inflight))
                    break
                t0 = time.monotonic()
                self._cv.wait(1.0)
                stalled += time.monotonic() - t0
        if stalled:
            stat_add("ps.client.pipeline_stall_s", stalled)
            # per-chunk wait distribution: a fat p99 here means the wire
            # is persistently ahead of the window (raise FLAGS_ps_window)
            stat_observe("ps.client.pipeline_wait_s", stalled)
        return job

    def complete(self, idx: int, resp: Dict) -> None:
        with self._cv:
            self.results[idx] = resp
            self.inflight -= 1
            self.done_count += 1
            self._cv.notify_all()
        if self.budget is not None:
            self.budget.release()

    def requeue(self, jobs: List[Tuple[int, Dict]]) -> None:
        """A stream died with these chunks unresolved — hand them back for
        any surviving or reconnected stream (the rid ride-along makes the
        resend exactly-once server-side).  Each requeue spends the
        chunk's retry budget, preserving the sequential path's per-chunk
        ``retries`` semantics; an exhausted chunk stops the run."""
        with self._cv:
            for idx, req in reversed(jobs):
                self._queue.appendleft((idx, req))
                self.inflight -= 1
                self._attempts[idx] += 1
                if self.retries is not None \
                        and self._attempts[idx] >= self.retries:
                    self.gave_up = True
            self._cv.notify_all()
        if self.budget is not None:
            self.budget.release(len(jobs))
        if self.gave_up:
            stat_add("ps.client.give_up")
            flight.record("verb_give_up", site="chunk_requeue")

    def abort(self, err: BaseException) -> None:
        """A non-retryable failure (server-side verb error, oversized
        frame): latch the first error and stop handing out chunks."""
        with self._cv:
            if self.error is None:
                self.error = err
            self.aborted = True
            self._cv.notify_all()

    def note_net_error(self, err: BaseException) -> None:
        with self._cv:
            self.net_error = err

    def finished(self) -> bool:
        with self._cv:
            return self.done_count >= self.n

    def has_work(self) -> bool:
        with self._cv:
            return bool(self._queue) and not self._stopped()


class PSClient:
    """≙ BrpcPsClient: a pool of sticky connections, bulk verbs, retries
    with exponential backoff + jitter under a deadline budget; non-
    idempotent verbs ride the rid/dedup exactly-once protocol so EVERY
    verb retries safely (the reference's 3-retry-then-fail,
    ps_gpu_wrapper.cc:388-419, upgraded).  Multi-chunk row verbs pipeline
    their chunks across the pool (module docstring, "Wire-path
    pipelining").  ``retries=None`` means attempt-unbounded
    (deadline-bounded only); ``streams``/``window``/``wire_dtype`` default
    from FLAGS_ps_streams / FLAGS_ps_window / FLAGS_ps_wire_dtype."""

    def __init__(self, addr, retries: Optional[int] = 3,
                 retry_sleep: float = 0.1,
                 max_frame: int = wire.MAX_FRAME,
                 deadline: float = 60.0, backoff_cap: float = 2.0,
                 streams: Optional[int] = None,
                 window: Optional[int] = None,
                 wire_dtype: Optional[str] = None):
        # ``addr`` is one (host, port) — the classic single server — or a
        # list of them: an N-way sharded PS cluster.  The ServerMap owns
        # the deterministic key-hash -> shard placement; every row verb
        # partitions its keys by it and fans per-shard chunk streams out
        # concurrently (ps/cluster.py).  n == 1 is byte- and rid-
        # identical to the pre-cluster client.
        if addr and isinstance(addr[0], (tuple, list)):
            addrs = [tuple(a) for a in addr]
        else:
            addrs = [tuple(addr)]
        self.server_map = ps_cluster.make_server_map(addrs)
        self.n_shards = self.server_map.n
        heat.maybe_enable_from_flags()
        self.addr = self.server_map.addrs[0]   # back-compat (shard 0)
        # elastic-membership plumbing: callbacks fired after a map
        # refresh adopts a newer epoch (the DeviceRowCache invalidates
        # its moved range here), and the pool generation counter
        self._map_listeners: List = []
        self._pool_gen = 0
        # pinned 2-phase lifecycle rid-groups keyed by (verb, table):
        # a caller retry of a partially-failed cluster lifecycle replays
        # the SAME prepare/commit rids (ps/cluster.two_phase_lifecycle)
        self._txn_groups: Dict[Tuple[str, str], str] = {}
        # delta-push rid groups in flight -> (epoch, addrs) at first
        # send; a pinned-group replay that lands after a membership
        # change resolves its chunk fates against THIS fleet (see
        # _resolve_group) instead of re-chunking under the new one
        self._group_fleets: "OrderedDict[str, Tuple[int, List]]" = \
            OrderedDict()
        self.retries = retries
        self.retry_sleep = retry_sleep      # backoff base
        self.backoff_cap = backoff_cap
        self.deadline = deadline            # per-call retry budget (s)
        # soft frame budget for transparent chunking of the row verbs
        # (≙ brpc_ps_client splitting a bulk request over shard requests):
        # callers never split by hand; a whole-pass pull through
        # RemoteTableAdapter chunks here instead of tripping _send's cap
        self.max_frame = max_frame
        self.streams = max(1, int(flags.get_flags("ps_streams")
                                  if streams is None else streams))
        self.window = max(self.streams,
                          int(flags.get_flags("ps_window")
                              if window is None else window))
        self.wire_dtype = str(flags.get_flags("ps_wire_dtype")
                              if wire_dtype is None else wire_dtype)
        if self.wire_dtype not in wire.WIRE_DTYPES:
            raise ValueError(f"ps_wire_dtype must be one of "
                             f"{wire.WIRE_DTYPES}, got {self.wire_dtype!r}")
        # learned row width PER TABLE (bytes), learned once per pull call
        # from its first response — a narrow table's estimate must never
        # size a wide table's first chunk past the wire cap.  _lock guards
        # THIS dict and rid allocation only — never network I/O (PB104)
        self._row_bytes_est: Dict[str, int] = {}
        self._lock = lockdep.lock("ps.service.PSClient._lock")
        # connection pool: ``streams`` connections PER SHARD, checked out
        # exclusively via one _pool_cv; a stream is pinned to its shard
        self._pool = [_Stream(i, shard=s, gen=self._pool_gen)
                      for s in range(self.n_shards)
                      for i in range(self.streams)]
        self._free: List[List[_Stream]] = [
            [st for st in self._pool if st.shard == s]
            for s in range(self.n_shards)]
        self._pool_cv = lockdep.condition("ps.service.PSClient._pool_cv")
        # rid = token ":" seq — unique per client instance, monotonic
        self._token = f"c{os.getpid():x}-{os.urandom(4).hex()}"
        self._seq = 0

    def _next_rid(self) -> str:
        with self._lock:
            self._seq += 1
            return f"{self._token}:{self._seq}"

    def new_rid_group(self) -> str:
        """A stable id for a multi-chunk logical mutation: chunk i is sent
        as rid ``<group>.<i>``, so a CALLER-level resend of the whole
        logical verb (pass-level recovery) reuses the same rids and
        already-applied chunks dedup server-side."""
        return self._next_rid()

    def _per_chunk(self, bytes_per_row: int) -> int:
        """Keys per frame so each stays well under max_frame (4x headroom
        for codec overhead + field alignment) — the single chunk-budget
        policy for every row verb."""
        return max(1, int(self.max_frame // 4 // max(bytes_per_row, 1)))

    @staticmethod
    def _chunk_spans(n_keys: int, per: int):
        out = []
        done = 0
        while done < n_keys:
            c = min(per, n_keys - done)
            out.append((done, c))
            done += c
        return out or [(0, 0)]

    def _chunk_counts(self, n_keys: int, bytes_per_row: int):
        return self._chunk_spans(n_keys, self._per_chunk(bytes_per_row))

    @staticmethod
    def _rows_bytes(rows: Dict[str, np.ndarray]) -> int:
        """Wire bytes per row of a rows dict (key + per-field payload)."""
        tot = 8    # key
        for v in rows.values():
            a = np.asarray(v)
            tot += a.dtype.itemsize * (int(np.prod(a.shape[1:])) or 1)
        return tot

    def _quant_rows(self, rows: Dict[str, np.ndarray],
                    verb: str) -> Dict:
        """Encode a push payload for the wire under FLAGS_ps_wire_dtype
        (counted passthrough for f32)."""
        return wire.quantize_rows(rows, self.wire_dtype, verb=verb)

    # -- stream pool ---------------------------------------------------------
    def _checkout(self, shard: int = 0) -> _Stream:
        with self._pool_cv:
            while True:
                if shard >= len(self._free):
                    # the map shrank under this verb's feet — surface as
                    # a fence redirect: the verb re-partitions + re-drives
                    raise _FenceRedirect("wrong_epoch")
                if self._free[shard]:
                    return self._free[shard].pop()
                self._pool_cv.wait()

    def _checkout_upto(self, n: int, shard: int = 0) -> List[_Stream]:
        """Up to ``n`` free streams of one shard — at least one (blocks
        for the first); a concurrent verb holding part of the pool never
        deadlocks a pipelined call, it just narrows it."""
        with self._pool_cv:
            while True:
                if shard >= len(self._free):
                    raise _FenceRedirect("wrong_epoch")
                if self._free[shard]:
                    break
                self._pool_cv.wait()
            take = min(n, len(self._free[shard]))
            out = [self._free[shard].pop() for _ in range(take)]
            return out

    def _checkin(self, *streams: _Stream) -> None:
        with self._pool_cv:
            for st in streams:
                if st.closing:
                    st.closing = False
                    self._close_stream(st)
                if st.gen != self._pool_gen:
                    # stream from a pre-refresh pool: retire it
                    self._close_stream(st)
                    continue
                self._free[st.shard].append(st)
            self._pool_cv.notify_all()

    def _connect(self, stream: _Stream, timeout: float,
                 bo: Backoff) -> None:
        """Dial one pooled stream to ITS shard's address; the connect
        timeout honors the per-call timeout and never outlives the
        remaining retry budget."""
        if faults.ACTIVE is not None:
            faults.on_connect("client")
        rem = bo.remaining()
        cto = timeout if rem is None else max(min(timeout, rem), 0.001)
        addrs = self.server_map.addrs
        if stream.shard >= len(addrs):
            # a concurrent map refresh shrank the fleet — the normal
            # requeue/retry path resolves the chunks on the new map
            raise ConnectionError("stale stream shard after map refresh")
        stream.sock = socket.create_connection(
            addrs[stream.shard], timeout=cto)

    @staticmethod
    def _close_stream(stream: _Stream) -> None:
        if stream.sock is not None:
            try:
                stream.sock.close()
            except OSError:
                pass
            stream.sock = None

    def close(self) -> None:
        """Close every pooled connection.  A stream an in-flight verb
        holds keeps its socket until the verb checks it back in: the
        serving router closes a client it replaced while calls on it may
        still run, and a socket taken from under a call would fail it
        with no retry."""
        with self._pool_cv:
            idle = {id(st) for free in self._free for st in free}
            for st in self._pool:
                if id(st) in idle:
                    self._close_stream(st)
                else:
                    st.closing = True

    # -- elastic membership (epoch-fenced routing) --------------------------
    def on_map_change(self, cb) -> None:
        """Register ``cb(new_map)`` to fire after a refresh adopts a
        newer membership epoch — the DeviceRowCache drops exactly its
        moved range here (device_cache.update_server_map)."""
        self._map_listeners.append(cb)

    def _adopt_map(self, new_map: ps_cluster.ServerMap) -> bool:
        """Swap to a newer membership map: rebuild the stream pool (old
        streams retire as they check back in — the generation stamp keeps
        them out of the new pool) and notify listeners.  No-op unless the
        epoch actually advances."""
        with self._pool_cv:
            cur = self.server_map
            if new_map.epoch <= cur.epoch:
                return False
            self.server_map = new_map
            self.n_shards = new_map.n
            self.addr = new_map.addrs[0]
            self._pool_gen += 1
            # only FREE streams retire here; checked-out ones close
            # themselves on check-in via the generation stamp
            old_free = [st for lst in self._free for st in lst]
            self._pool = [_Stream(i, shard=s, gen=self._pool_gen)
                          for s in range(self.n_shards)
                          for i in range(self.streams)]
            self._free = [[st for st in self._pool if st.shard == s]
                          for s in range(self.n_shards)]
            for st in old_free:
                self._close_stream(st)
            self._pool_cv.notify_all()
        stat_add("ps.client.map_refresh")
        flight.record("map_refresh", epoch=new_map.epoch, n=new_map.n)
        for cb in list(self._map_listeners):
            cb(new_map)
        return True

    def _probe_membership(self, addr: Tuple[str, int],
                          timeout: float) -> Optional[Dict]:
        """One-shot health probe of a single address for its membership
        descriptor — a raw connection, never the (possibly mid-swap)
        pool."""
        with socket.create_connection(tuple(addr),
                                      timeout=timeout) as sock:
            sock.settimeout(timeout)
            _send(sock, {"cmd": "health"}, role="client")
            resp = _recv(sock, role="client")
        if resp.get("ok"):
            return resp.get("membership")
        return None

    def refresh_server_map(self, hint: Optional[Dict] = None,
                           timeout: float = 5.0) -> bool:
        """Re-learn the fleet membership and adopt the highest epoch
        seen.  Candidates: the redirect ``hint`` a fenced server carried
        (trusted directly — it is the authoritative map of a member),
        then the health surface of every address we know — current map
        first, hint addresses after — FALLING THROUGH dead entries
        instead of pinning to shard 0, so a dead authority can never
        orphan the fleet.  Returns True when a newer map was adopted."""
        best: Optional[ps_cluster.ServerMap] = None
        if hint:
            best = ps_cluster.map_from_desc(hint)
        seen = set()
        cands: List[Tuple[str, int]] = []
        for a in list(self.server_map.addrs) + (
                list(best.addrs) if best is not None else []):
            a = (a[0], int(a[1]))
            if a not in seen:
                seen.add(a)
                cands.append(a)
        for addr in cands:
            try:
                desc = self._probe_membership(addr, timeout)
            except (ConnectionError, OSError):
                stat_add("ps.client.map_probe_miss")
                continue
            if desc:
                m = ps_cluster.map_from_desc(desc)
                if best is None or m.epoch > best.epoch:
                    best = m
                break   # first LIVE answer wins (plus any newer hint)
        if best is None:
            return False
        return self._adopt_map(best)

    def _fence_recover(self, e: "_FenceRedirect", bo: Backoff,
                       attempt: int) -> None:
        """Shared verb-level recovery from a typed fence rejection:
        refresh the map off the hint; when nothing newer exists (the
        server is mid-commit behind us, or the range is frozen for the
        cutover) back off bounded — a stall here is the migration's
        blocking window, never an error."""
        stat_add("ps.client.fence_redirect")
        flight.record("fence_redirect", fence=e.kind,
                      epoch=self.server_map.epoch, attempt=attempt)
        changed = False
        try:
            changed = self.refresh_server_map(hint=e.hint)
        except (ConnectionError, OSError):
            pass
        if not changed and not bo.sleep(attempt):
            raise ConnectionError(
                f"fence redirect unresolved after {attempt} attempt(s): "
                f"{e.kind} at epoch {self.server_map.epoch}") from e

    def _call(self, req: Dict, retry: bool = True,
              timeout: float = 60, deadline: Optional[float] = None,
              dedup: bool = False, shard: int = 0) -> Dict:
        """One verb round-trip with retries on a checked-out stream.

        ``dedup=True`` stamps a fresh rid (or the caller presets
        wire.RID_FIELD itself for chunk groups): the server's dedup window
        makes the resend of an applied-but-unacknowledged mutation return
        the cached response — exactly-once, so even barrier/allreduce/
        delta verbs retry safely.  Backoff is exponential with jitter
        under ``deadline`` (default: the client's budget).

        Observability: one client span per verb (skipped when the caller
        pre-stamped a trace context — pipelined chunk requests carry
        their logical verb's span) and a client-side latency histogram
        per successful round trip, retries included."""
        if dedup and wire.RID_FIELD not in req:
            req = dict(req)
            req[wire.RID_FIELD] = self._next_rid()
        cmd = req.get("cmd")
        tr = trace.ACTIVE
        span = None
        if tr is not None and wire.TRACE_FIELD not in req:
            span = tr.start_span(f"ps.client.{cmd}",
                                 rid=req.get(wire.RID_FIELD))
            req = dict(req)
            req[wire.TRACE_FIELD] = span.context()
        t_call = time.monotonic()
        try:
            return self._call_attempts(req, retry, timeout, deadline,
                                       t_call, shard)
        finally:
            if span is not None:
                tr.finish(span)

    def _call_attempts(self, req: Dict, retry: bool, timeout: float,
                       deadline: Optional[float], t_call: float,
                       shard: int = 0) -> Dict:
        rid = req.get(wire.RID_FIELD)
        bo = Backoff(base=self.retry_sleep, cap=self.backoff_cap,
                     deadline=self.deadline if deadline is None
                     else deadline)
        attempt = 0
        while True:
            stream = self._checkout(shard)
            try:
                try:
                    if stream.sock is None:
                        self._connect(stream, timeout, bo)
                    stream.sock.settimeout(timeout)
                    _send(stream.sock, req, role="client")
                    resp = _recv(stream.sock, role="client")
                    if rid is not None \
                            and resp.get(wire.RID_FIELD, rid) != rid:
                        # a frame from a previous (timed-out) request
                        # surfaced on a reused stream — resync: reconnect
                        raise ConnectionError(
                            "stale response (rid mismatch)")
                except (ConnectionError, OSError):
                    self._close_stream(stream)
                    raise
            except (ConnectionError, OSError) as e:
                self._checkin(stream)
                attempt += 1
                stat_add("ps.client.retry")
                flight.record("verb_retry", cmd=req.get("cmd"),
                              attempt=attempt, error=type(e).__name__)
                exhausted = (self.retries is not None
                             and attempt >= self.retries)
                if not retry or exhausted or not bo.sleep(attempt):
                    stat_add("ps.client.give_up")
                    flight.record("verb_give_up", cmd=req.get("cmd"),
                                  attempt=attempt)
                    raise ConnectionError(
                        f"ps call {req.get('cmd')!r} failed after "
                        f"{attempt} attempt(s): {e}") from e
                continue
            except BaseException:
                self._checkin(stream)
                raise
            self._checkin(stream)
            if not resp.get("ok"):
                kind = _fence_kind(resp)
                if kind is not None:
                    # typed epoch/ownership rejection: provably NOT
                    # applied (the fence precedes any mutation and the
                    # rid was dropped) — the verb layer refreshes the
                    # map and re-drives
                    raise _FenceRedirect(kind,
                                         hint=resp.get("membership"))
                raise ServerErrorReply(resp.get("error", "ps error"))
            cmd = req.get("cmd")
            stat_observe(f"ps.client.{cmd}.latency_s",
                         time.monotonic() - t_call)
            return resp

    # -- pipelined chunk engine ---------------------------------------------
    def _pipeline(self, reqs: List[Dict], timeout: float = 60,
                  shard: int = 0) -> List[Dict]:
        """Drive chunk requests through one shard's stream pool with up
        to ``self.window`` frames in flight; returns responses in request
        order.  Every request must carry wire.RID_FIELD (the echo is the
        response-matching key).  Single-chunk calls and single-stream
        clients fall back to stop-and-wait ``_call``."""
        if not reqs:
            return []
        if len(reqs) == 1 or self.streams == 1:
            out: List[Dict] = []
            for r in reqs:
                try:
                    out.append(self._call(r, timeout=timeout,
                                          shard=shard))
                except _FenceRedirect as e:
                    # fenced chunk = provably unapplied; later chunks
                    # were never sent — mark both typed so the verb
                    # layer re-drives them without probing
                    partial: List[Optional[Dict]] = list(out)
                    partial += [{"ok": False, e.kind: True}
                                for _ in range(len(reqs) - len(out))]
                    raise _FenceRedirect(e.kind, hint=e.hint,
                                         partial={shard: partial}) \
                        from None
            return out
        streams = self._checkout_upto(min(self.streams, len(reqs)), shard)
        run = _PipelineRun(reqs, self.window, retries=self.retries)
        depth = max(1, -(-self.window // len(streams)))  # ceil division
        pumps = [threading.Thread(target=self._pump_stream,
                                  args=(s, run, timeout, depth),
                                  daemon=True)
                 for s in streams[1:]]
        for t in pumps:
            t.start()
        try:
            self._pump_stream(streams[0], run, timeout, depth)
        finally:
            for t in pumps:
                t.join()
            self._checkin(*streams)
        if run.error is not None:
            if isinstance(run.error, _FenceRedirect):
                raise _FenceRedirect(run.error.kind,
                                     hint=run.error.hint,
                                     partial={shard: list(run.results)})
            raise run.error
        if not run.finished():
            raise ConnectionError(
                f"pipelined {reqs[0].get('cmd')!r} incomplete "
                f"({run.done_count}/{run.n} chunks): {run.net_error}")
        return run.results    # type: ignore[return-value]

    def _pipeline_sharded(self, reqs_by_shard: Dict[int, List[Dict]],
                          timeout: float = 60) -> Dict[int, List[Dict]]:
        """Drive per-shard chunk request lists concurrently — one
        _PipelineRun per shard over that shard's stream pool, all under a
        SHARED inflight budget, so the fan-out multiplies wire
        concurrency (N sockets actively moving frames) without
        multiplying client memory (total frames in flight stays at the
        single-server window).  Returns {shard: responses-in-order}.

        Chunks never migrate between shards: a key's row lives on
        exactly one server, so a failed stream requeues its chunks for
        the SAME shard's surviving/reconnected streams only."""
        live = {s: r for s, r in reqs_by_shard.items() if r}
        if not live:
            return {}
        stat_observe("ps.cluster.fan_out_width", float(len(live)))
        if len(live) == 1:
            ((s, reqs),) = live.items()
            return {s: self._pipeline(reqs, timeout=timeout, shard=s)}
        budget = ps_cluster._InflightBudget(max(self.window, len(live)))
        runs: Dict[int, _PipelineRun] = {}
        held: List[_Stream] = []
        jobs: List[Tuple[_Stream, _PipelineRun, int]] = []
        finish: Dict[int, float] = {}
        for s in sorted(live):
            reqs = live[s]
            streams = self._checkout_upto(min(self.streams, len(reqs)), s)
            held.extend(streams)
            run = _PipelineRun(reqs, self.window, retries=self.retries,
                               budget=budget)
            budget.register(run._cv)
            runs[s] = run
            depth = max(1, -(-self.window // len(streams)))
            for st in streams:
                jobs.append((st, run, depth))

        def pump(st: _Stream, run: _PipelineRun, depth: int) -> None:
            try:
                self._pump_stream(st, run, timeout, depth)
            finally:
                # per-shard completion timestamp (last pump out wins):
                # the spread across shards is the slowest-shard stall
                finish[st.shard] = time.monotonic()

        pumps = [threading.Thread(target=pump, args=j, daemon=True)
                 for j in jobs[1:]]
        for t in pumps:
            t.start()
        try:
            pump(*jobs[0])
        finally:
            for t in pumps:
                t.join()
            self._checkin(*held)
        fence: Optional[_FenceRedirect] = None
        for s, run in runs.items():
            if isinstance(run.error, _FenceRedirect):
                e = run.error
                if fence is None or (
                        (e.hint or {}).get("epoch", -1)
                        > (fence.hint or {}).get("epoch", -1)):
                    fence = e
        if fence is not None:
            # aggregate: carry EVERY shard's per-chunk results so the
            # verb layer can re-drive exactly the unapplied chunks of
            # the whole fan-out (unfenced shards' unfinished chunks ride
            # along as unresolved)
            raise _FenceRedirect(fence.kind, hint=fence.hint,
                                 partial={s: list(runs[s].results)
                                          for s in runs})
        for s, run in runs.items():
            if run.error is not None:
                raise run.error
        for s, run in runs.items():
            if not run.finished():
                raise ConnectionError(
                    f"pipelined {live[s][0].get('cmd')!r} incomplete on "
                    f"shard {s} ({run.done_count}/{run.n} chunks): "
                    f"{run.net_error}")
        if len(finish) > 1:
            stat_observe("ps.cluster.slowest_shard_stall_s",
                         max(finish.values()) - min(finish.values()))
        return {s: runs[s].results    # type: ignore[misc]
                for s in live}

    def _pump_stream(self, stream: _Stream, run: _PipelineRun,
                     timeout: float, depth: int) -> None:
        """Drive one pooled connection for a pipelined verb.

        This thread SENDS; a paired receiver thread drains responses, so
        up to ``depth`` frames ride the socket concurrently and a full
        TCP buffer can never deadlock send against recv (the classic
        pipelining hazard).  Encode of the next chunk overlaps the
        send/recv of the previous ones by construction.  On a wire
        failure the stream's unresolved chunks requeue for any stream and
        this pump reconnects under the shared backoff/deadline policy;
        progress (any response landed) resets the budget."""
        bo = Backoff(base=self.retry_sleep, cap=self.backoff_cap,
                     deadline=self.deadline)
        attempt = 0
        while not run._stopped() and not run.finished():
            try:
                if stream.sock is None:
                    self._connect(stream, timeout, bo)
                stream.sock.settimeout(timeout)
            except (ConnectionError, OSError) as e:
                attempt += 1
                stat_add("ps.client.retry")
                flight.record("verb_retry", site="pump_connect",
                              attempt=attempt, error=type(e).__name__)
                run.note_net_error(e)
                exhausted = (self.retries is not None
                             and attempt >= self.retries)
                if exhausted or not bo.sleep(attempt):
                    stat_add("ps.client.give_up")
                    flight.record("verb_give_up", site="pump_connect",
                                  attempt=attempt)
                    return          # this stream gives up; others continue
                continue

            pending: "deque[Tuple[int, Dict]]" = deque()
            cv = lockdep.condition("ps.service.PSClient._pump_stream.cv")
            state = {"err": None, "done": False, "progress": False}

            def receiver(sock=stream.sock, pending=pending, cv=cv,
                         state=state):
                try:
                    while True:
                        with cv:
                            while not pending and not state["done"] \
                                    and state["err"] is None:
                                cv.wait()
                            if state["err"] is not None:
                                return
                            if not pending and state["done"]:
                                return
                            idx, req, t_sent = pending[0]
                        resp = _recv(sock, role="client")
                        rid = req[wire.RID_FIELD]
                        if resp.get(wire.RID_FIELD, rid) != rid:
                            raise ConnectionError(
                                "stale response (rid mismatch)")
                        # pipelined chunks never pass through _call — the
                        # per-rpc client latency lands here instead
                        stat_observe(f"ps.client.{req['cmd']}.latency_s",
                                     time.monotonic() - t_sent)
                        with cv:
                            pending.popleft()
                            state["progress"] = True
                            cv.notify_all()
                        if not resp.get("ok"):
                            run.complete(idx, resp)
                            kind = _fence_kind(resp)
                            if kind is not None:
                                # typed fence: stop the run; the verb
                                # layer inspects per-chunk results and
                                # re-drives only the unapplied ones
                                run.abort(_FenceRedirect(
                                    kind, hint=resp.get("membership")))
                            else:
                                run.abort(ServerErrorReply(
                                    resp.get("error", "ps error")))
                        else:
                            run.complete(idx, resp)
                except (ConnectionError, OSError) as e:
                    with cv:
                        if state["err"] is None:
                            state["err"] = e
                        cv.notify_all()

            rx = threading.Thread(target=receiver, daemon=True)
            rx.start()
            send_err: Optional[BaseException] = None
            try:
                while True:
                    with cv:
                        while len(pending) >= depth \
                                and state["err"] is None:
                            cv.wait()
                        if state["err"] is not None:
                            break
                    job = run.take()
                    if job is None:
                        break
                    idx, req = job
                    with cv:
                        pending.append((idx, req, time.monotonic()))
                        cv.notify_all()
                    try:
                        # encode happens inside _send — on this thread,
                        # while the receiver (and other streams) move
                        # earlier chunks
                        _send(stream.sock, req, role="client")
                    except (ConnectionError, OSError) as e:
                        send_err = e
                        break
                    except BaseException as e:
                        # non-retryable (oversized frame, raised before
                        # any byte moved): un-pend the chunk so the
                        # receiver never waits on it, poison the run
                        with cv:
                            if pending and pending[-1][0] == idx:
                                pending.pop()
                        run.abort(e)
                        break
            finally:
                with cv:
                    state["done"] = True
                    if send_err is not None and state["err"] is None:
                        state["err"] = send_err
                    cv.notify_all()
                if state["err"] is not None:
                    # unblock a receiver parked in recv on a broken pipe
                    self._close_stream(stream)
                rx.join()

            err = state["err"]
            if err is None and not run.aborted:
                # clean episode end: everything this stream sent is
                # acknowledged.  If the queue is empty the remaining
                # chunks belong to other streams — this pump is done (a
                # stream that later fails requeues and retries its own)
                if state["progress"]:
                    attempt = 0
                    bo.reset()
                if not run.has_work():
                    return
                continue
            # episode failed: requeue every unresolved chunk — each spends
            # its own per-chunk retry budget (run.requeue) and resends
            # exactly-once via its rid on any surviving or reconnected
            # stream — then reconnect under the deadline budget
            self._close_stream(stream)
            with cv:
                leftover = [(i, r) for i, r, _ in pending]
                pending.clear()
            if leftover:
                run.requeue(leftover)
            if run._stopped() or err is None:
                return
            stat_add("ps.client.stream_reconnect")
            flight.record("stream_reconnect", error=type(err).__name__,
                          requeued=len(leftover))
            run.note_net_error(err)
            if state["progress"]:
                attempt = 0
                bo.reset()
            attempt += 1
            stat_add("ps.client.retry")
            if not bo.sleep(attempt):
                stat_add("ps.client.give_up")
                flight.record("verb_give_up", site="pump_reconnect",
                              attempt=attempt)
                return

    # -- verbs (table=None → the default table) -----------------------------
    @staticmethod
    def _stamp_trace(req: Dict) -> Dict:
        """Attach the calling span's wire context (no-op when the tracer
        is off or no span is open): pipelined chunks parent their server
        spans to the enclosing logical-verb span instead of opening one
        client span per chunk."""
        ctx = trace.wire_context()
        if ctx is not None:
            req[wire.TRACE_FIELD] = ctx
        return req

    def _stamp_ep(self, req: Dict) -> Dict:
        """Ride the membership epoch on a fenced sparse verb.  Skipped
        for a plain epoch-0 single server (frames stay byte-compatible
        with the pre-elastic wire); once the fleet is sharded or any
        reshard has happened, every fenced frame carries it."""
        smap = self.server_map
        if smap.n > 1 or smap.epoch > 0:
            req[EPOCH_FIELD] = smap.epoch
        return req

    def _pull_req(self, sub_keys: np.ndarray, table: Optional[str],
                  create: bool) -> Dict:
        req = {"cmd": "pull_sparse", "keys": sub_keys, "table": table,
               "create": create, wire.RID_FIELD: self._next_rid()}
        if self.wire_dtype != "f32":
            req["wire_dtype"] = self.wire_dtype
        return self._stamp_trace(self._stamp_ep(req))

    def pull_sparse(self, keys: np.ndarray, table: Optional[str] = None,
                    create: bool = False) -> Dict[str, np.ndarray]:
        """Chunked bulk pull.  The FIRST chunk (a small probe when the
        table's row width is unlearned) teaches the call's row width —
        learned ONCE per call, then the chunk width is FROZEN for the
        remainder and the tail chunks pipeline across the stream pool:
        one estimate read + one write per call instead of per chunk, and
        deterministic chunking for a given first response."""
        keys = np.asarray(keys)
        with trace.span("ps.client.pull_sparse.bulk", keys=len(keys)):
            bo = Backoff(base=self.retry_sleep, cap=self.backoff_cap,
                         deadline=self.deadline)
            attempt = 0
            while True:
                try:
                    if self.n_shards > 1 and len(keys):
                        return self._pull_sparse_sharded(keys, table,
                                                         create)
                    return self._pull_sparse_chunked(keys, table, create)
                except _FenceRedirect as e:
                    # pulls are idempotent — refresh the map and re-pull
                    # whole (re-partitioned under the new epoch); never
                    # a user-visible error
                    attempt += 1
                    self._fence_recover(e, bo, attempt)

    def _pull_sparse_chunked(self, keys: np.ndarray, table: Optional[str],
                             create: bool) -> Dict[str, np.ndarray]:
        tname = table or DEFAULT_TABLE
        with self._lock:
            learned = self._row_bytes_est.get(tname)
        per = self._per_chunk(learned if learned is not None else 512)
        if learned is None:
            # unlearned TABLE (this one — another table's learned width
            # says nothing about this schema): a wide schema could
            # overshoot the hard wire cap on a huge first chunk — probe
            # small, then the learned width governs
            per = min(per, 65536)
        c = min(per, len(keys))
        rows = self._call(self._pull_req(keys[:c], table, create))["rows"]
        parts = [rows]
        lo = c
        if c:
            learned = max(self._rows_bytes(rows), 8)
            with self._lock:
                self._row_bytes_est[tname] = learned
        if lo < len(keys):
            per = self._per_chunk(learned)      # frozen for the remainder
            reqs = [self._pull_req(keys[lo + o:lo + o + cc], table, create)
                    for o, cc in self._chunk_spans(len(keys) - lo, per)]
            parts += [r["rows"] for r in self._pipeline(reqs)]
        if len(parts) == 1:
            return parts[0]
        return {f: np.concatenate([p[f] for p in parts])
                for f in parts[0]}

    def _pull_sparse_sharded(self, keys: np.ndarray, table: Optional[str],
                             create: bool) -> Dict[str, np.ndarray]:
        """Cluster fan-out pull: partition keys by the ServerMap, drive
        every shard's chunk stream concurrently (_pipeline_sharded), and
        reassemble rows into the caller's key order by position.  Width
        learning keeps the single probe-then-freeze discipline — the
        probe goes to the shard holding the most keys; the learned width
        then governs every shard's chunking (one schema per table)."""
        smap = self.server_map
        pos = smap.partition(keys)
        tname = table or DEFAULT_TABLE
        with self._lock:
            learned = self._row_bytes_est.get(tname)
        chunks: List[Tuple[np.ndarray, Dict[str, np.ndarray]]] = []
        if learned is None:
            probe_shard = int(np.argmax([len(p) for p in pos]))
            per = min(self._per_chunk(512), 65536)
            p = pos[probe_shard]
            c = min(per, len(p))
            sub = p[:c]
            rows = self._call(self._pull_req(keys[sub], table, create),
                              shard=probe_shard)["rows"]
            chunks.append((sub, rows))
            pos[probe_shard] = p[c:]
            learned = max(self._rows_bytes(rows), 8)
            with self._lock:
                self._row_bytes_est[tname] = learned
        per = self._per_chunk(learned)          # frozen for the fan-out
        reqs_by_shard: Dict[int, List[Dict]] = {}
        spans_by_shard: Dict[int, List[np.ndarray]] = {}
        for shard in range(smap.n):
            p = pos[shard]
            if not len(p):
                continue
            stat_add(f"ps.cluster.s{shard}.pull_keys", float(len(p)))
            stat_add(f"ps.cluster.s{shard}.est_bytes",
                     float(len(p) * per))
            if heat.ACTIVE is not None:
                heat.ACTIVE.observe_shard(shard, len(p))
            reqs = []
            spans = []
            for lo, c in self._chunk_spans(len(p), per):
                sub = p[lo:lo + c]
                reqs.append(self._pull_req(keys[sub], table, create))
                spans.append(sub)
            reqs_by_shard[shard] = reqs
            spans_by_shard[shard] = spans
        results = self._pipeline_sharded(reqs_by_shard)
        for shard, rlist in results.items():
            for sub, resp in zip(spans_by_shard[shard], rlist):
                chunks.append((sub, resp["rows"]))
        template = chunks[0][1]
        out = {f: np.empty((len(keys),) + np.asarray(v).shape[1:],
                           np.asarray(v).dtype)
               for f, v in template.items()}
        for sub, rows in chunks:
            for f in out:
                out[f][sub] = rows[f]
        return out

    def push_sparse(self, keys: np.ndarray, rows: Dict[str, np.ndarray],
                    table: Optional[str] = None):
        keys = np.asarray(keys)
        with trace.span("ps.client.push_sparse.bulk", keys=len(keys)):
            bo = Backoff(base=self.retry_sleep, cap=self.backoff_cap,
                         deadline=self.deadline)
            attempt = 0
            while True:
                try:
                    return self._push_sparse_once(keys, rows, table)
                except _FenceRedirect as e:
                    # absolute-row pushes are idempotent (re-applying
                    # the same values is a no-op), so whole-verb re-drive
                    # under the refreshed map is exact
                    attempt += 1
                    self._fence_recover(e, bo, attempt)

    def _push_sparse_once(self, keys: np.ndarray,
                          rows: Dict[str, np.ndarray],
                          table: Optional[str]):
        # single-reference snapshot: server_map/n_shards are co-mutated
        # under _pool_cv in _adopt_map — partitioning with one and
        # counting with the other mid-adopt would mis-route keys (PB902)
        sm = self.server_map
        if sm.n > 1 and len(keys):
            per_row = self._rows_bytes(rows)
            reqs_by_shard: Dict[int, List[Dict]] = {}
            for shard, p in enumerate(sm.partition(keys)):
                if not len(p):
                    continue
                stat_add(f"ps.cluster.s{shard}.push_keys",
                         float(len(p)))
                stat_add(f"ps.cluster.s{shard}.est_bytes",
                         float(len(p) * per_row))
                if heat.ACTIVE is not None:
                    heat.ACTIVE.observe_shard(shard, len(p))
                sub_rows = {f: np.asarray(v)[p]
                            for f, v in rows.items()}
                reqs = []
                for lo, c in self._chunk_counts(len(p), per_row):
                    chunk = {f: v[lo:lo + c]
                             for f, v in sub_rows.items()}
                    reqs.append(self._stamp_trace(self._stamp_ep(
                        {"cmd": "push_sparse",
                         "keys": keys[p[lo:lo + c]],
                         "rows": self._quant_rows(chunk,
                                                  "push_sparse"),
                         "table": table,
                         wire.RID_FIELD: self._next_rid()})))
                reqs_by_shard[shard] = reqs
            self._pipeline_sharded(reqs_by_shard)
            return
        per_row = self._rows_bytes(rows)
        reqs = []
        for lo, c in self._chunk_counts(len(keys), per_row):
            chunk = {f: np.asarray(v)[lo:lo + c]
                     for f, v in rows.items()}
            reqs.append(self._stamp_trace(self._stamp_ep(
                {"cmd": "push_sparse", "keys": keys[lo:lo + c],
                 "rows": self._quant_rows(chunk, "push_sparse"),
                 "table": table,
                 wire.RID_FIELD: self._next_rid()})))
        self._pipeline(reqs)

    def push_sparse_delta(self, keys: np.ndarray,
                          rows: Dict[str, np.ndarray],
                          rows_abs: Optional[Dict[str, np.ndarray]] = None,
                          table: Optional[str] = None,
                          rid_group: Optional[str] = None):
        """Chunked like push_sparse, pipelined across the pool.  Each
        chunk carries rid ``<group>.<i>`` so resends — in-call retries on
        any stream AND a caller-level replay of the whole logical push
        with the same ``rid_group`` (pass-level recovery after a
        mid-sequence failure) — apply exactly once; already-applied
        chunks return the cached ack.  Chunking is a pure function of the
        rows' raw widths, so a replay re-produces byte-identical chunk
        boundaries under identical rids."""
        keys = np.asarray(keys)
        rows_abs = rows_abs or {}
        group = rid_group or self.new_rid_group()
        with trace.span("ps.client.push_sparse_delta.bulk",
                        keys=len(keys), group=group):
            bo = Backoff(base=self.retry_sleep, cap=self.backoff_cap,
                         deadline=self.deadline)
            attempt = 0
            with self._lock:
                rec = self._group_fleets.get(group)
            if rec is not None and rec[0] != self.server_map.epoch:
                # pinned-group replay ACROSS a membership change: the
                # new partition would re-chunk under different rids, so
                # first resolve every ORIGINAL chunk's fate (same rids
                # against the recorded fleet — cached ack = applied,
                # typed fence = provably not), then re-drive only the
                # unapplied rows under the current map
                pos = self._resolve_group(keys, rows, rows_abs, table,
                                          group, rec)
                with self._lock:
                    self._group_fleets.pop(group, None)
                if not len(pos):
                    return
                keys, rows, rows_abs = self._slice_rows(
                    keys, rows, rows_abs, pos)
                group = self.new_rid_group()
            while True:
                smap = self.server_map
                with self._lock:
                    if group not in self._group_fleets:
                        self._group_fleets[group] = (smap.epoch,
                                                     list(smap.addrs))
                        while len(self._group_fleets) > 64:
                            self._group_fleets.popitem(last=False)
                reqs_by_shard, spans_by_shard = self._delta_reqs(
                    keys, rows, rows_abs, table, group, smap)
                try:
                    if smap.n == 1:
                        self._pipeline(reqs_by_shard[0])
                    else:
                        self._pipeline_sharded(reqs_by_shard)
                    with self._lock:
                        self._group_fleets.pop(group, None)
                    return
                except _FenceRedirect as e:
                    # non-idempotent verb: disambiguate every chunk
                    # before anything is re-sent under new rids
                    attempt += 1
                    pos = self._unapplied_positions(
                        reqs_by_shard, spans_by_shard, e, smap.addrs)
                    self._fence_recover(e, bo, attempt)
                    with self._lock:
                        self._group_fleets.pop(group, None)
                    if not len(pos):
                        return
                    keys, rows, rows_abs = self._slice_rows(
                        keys, rows, rows_abs, pos)
                    group = self.new_rid_group()

    @staticmethod
    def _slice_rows(keys, rows, rows_abs, pos):
        return (keys[pos],
                {f: np.asarray(v)[pos] for f, v in rows.items()},
                {f: np.asarray(v)[pos] for f, v in rows_abs.items()})

    def _delta_reqs(self, keys, rows, rows_abs, table, group,
                    smap: ps_cluster.ServerMap):
        """Partition + chunk one logical delta push under ``smap`` —
        a pure function of (keys, row widths, group, smap.n), so a
        pinned-group replay rebuilds byte-identical frames under
        identical rids.  n == 1 keeps the flat ``<group>.<i>`` rid form;
        sharded rids are ``<group>.<shard>.<i>``.  Returns
        (reqs_by_shard, spans_by_shard) with spans = each chunk's key
        positions in the caller's array."""
        per_row = self._rows_bytes(rows) + self._rows_bytes(rows_abs)
        reqs_by_shard: Dict[int, List[Dict]] = {}
        spans_by_shard: Dict[int, List[np.ndarray]] = {}
        if smap.n == 1:
            reqs: List[Dict] = []
            spans: List[np.ndarray] = []
            for i, (lo, c) in enumerate(
                    self._chunk_counts(len(keys), per_row)):
                delta = {f: np.asarray(v)[lo:lo + c]
                         for f, v in rows.items()}
                reqs.append(self._stamp_trace(self._stamp_ep(
                    {"cmd": "push_sparse_delta",
                     "keys": keys[lo:lo + c],
                     "rows": self._quant_rows(delta,
                                              "push_sparse_delta"),
                     # absolute metadata (slot, mf_size, beta powers)
                     # must survive the wire EXACT — never quantized
                     "rows_abs": {f: np.asarray(v)[lo:lo + c]
                                  for f, v in rows_abs.items()},
                     "table": table,
                     wire.RID_FIELD: f"{group}.{i}"})))
                spans.append(np.arange(lo, lo + c))
            reqs_by_shard[0] = reqs
            spans_by_shard[0] = spans
            return reqs_by_shard, spans_by_shard
        for shard, p in enumerate(smap.partition(keys)):
            if not len(p):
                continue
            stat_add(f"ps.cluster.s{shard}.push_keys", float(len(p)))
            stat_add(f"ps.cluster.s{shard}.est_bytes",
                     float(len(p) * per_row))
            if heat.ACTIVE is not None:
                heat.ACTIVE.observe_shard(shard, len(p))
            sub_rows = {f: np.asarray(v)[p] for f, v in rows.items()}
            sub_abs = {f: np.asarray(v)[p] for f, v in rows_abs.items()}
            shard_reqs = []
            spans = []
            for i, (lo, c) in enumerate(
                    self._chunk_counts(len(p), per_row)):
                delta = {f: v[lo:lo + c] for f, v in sub_rows.items()}
                shard_reqs.append(self._stamp_trace(self._stamp_ep(
                    {"cmd": "push_sparse_delta",
                     "keys": keys[p[lo:lo + c]],
                     "rows": self._quant_rows(delta,
                                              "push_sparse_delta"),
                     "rows_abs": {f: v[lo:lo + c]
                                  for f, v in sub_abs.items()},
                     "table": table,
                     wire.RID_FIELD: f"{group}.{shard}.{i}"})))
                spans.append(p[lo:lo + c])
            reqs_by_shard[shard] = shard_reqs
            spans_by_shard[shard] = spans
        return reqs_by_shard, spans_by_shard

    def _probe_chunk(self, addr: Tuple[str, int], req: Dict,
                     timeout: float = 30.0) -> bool:
        """Resolve one chunk's fate by re-sending it — SAME rid — to the
        server that originally received it (a raw one-shot connection:
        the pool may already index the new map).  A cached dedup ack (or
        a fresh execution on a server that still owns the range) proves
        applied-exactly-once; a typed fence proves never-applied.
        Raises when the server stays unreachable past the retry budget —
        the ambiguity then falls to caller-level pinned-group replay."""
        bo = Backoff(base=self.retry_sleep, cap=self.backoff_cap,
                     deadline=self.deadline)
        attempt = 0
        rid = req.get(wire.RID_FIELD)
        while True:
            try:
                with socket.create_connection(tuple(addr),
                                              timeout=timeout) as sock:
                    sock.settimeout(timeout)
                    _send(sock, req, role="client")
                    resp = _recv(sock, role="client")
                if rid is not None \
                        and resp.get(wire.RID_FIELD, rid) != rid:
                    raise ConnectionError("stale response (rid mismatch)")
            except (ConnectionError, OSError) as err:
                attempt += 1
                stat_add("ps.client.retry")
                exhausted = (self.retries is not None
                             and attempt >= self.retries)
                if exhausted or not bo.sleep(attempt):
                    raise ConnectionError(
                        f"chunk-fate probe to {addr} failed after "
                        f"{attempt} attempt(s): {err}") from err
                continue
            stat_add("ps.client.fence_probe")
            if resp.get("ok"):
                return True
            if _fence_kind(resp) is not None:
                return False
            raise ServerErrorReply(resp.get("error", "ps error"))

    def _unapplied_positions(self, reqs_by_shard, spans_by_shard,
                             e: "_FenceRedirect",
                             addrs: List[Tuple[str, int]]) -> np.ndarray:
        """Positions (into the verb's key array) of every chunk proven
        NOT applied.  ok chunks are done; typed-fence chunks were
        rejected before any mutation; unresolved chunks are probed
        same-rid against their original server."""
        unapplied: List[np.ndarray] = []
        partial = e.partial or {}
        for shard, reqs in reqs_by_shard.items():
            resps = partial.get(shard)
            for i, (req, span) in enumerate(
                    zip(reqs, spans_by_shard[shard])):
                resp = None if resps is None or i >= len(resps) \
                    else resps[i]
                if resp is not None and resp.get("ok"):
                    continue
                if resp is not None and _fence_kind(resp) is not None:
                    unapplied.append(span)
                    continue
                if shard < len(addrs) \
                        and self._probe_chunk(addrs[shard], req):
                    continue
                unapplied.append(span)
        if not unapplied:
            return np.zeros((0,), np.int64)
        return np.sort(np.concatenate(unapplied))

    def _resolve_group(self, keys, rows, rows_abs, table, group,
                       rec) -> np.ndarray:
        """A pinned-group replay arrived AFTER the map changed: rebuild
        the group's original frames (chunking and partition are pure
        functions, so the bytes and rids match what the failed attempt
        sent) and probe every chunk against the recorded fleet.  Returns
        the positions still unapplied — the caller re-drives exactly
        those under the current map with a fresh group."""
        epoch, addrs = rec
        old_map = ps_cluster.make_server_map(addrs, epoch=epoch)
        reqs_by_shard, spans_by_shard = self._delta_reqs(
            keys, rows, rows_abs, table, group, old_map)
        unapplied: List[np.ndarray] = []
        for shard, reqs in reqs_by_shard.items():
            for req, span in zip(reqs, spans_by_shard[shard]):
                if not self._probe_chunk(addrs[shard], req):
                    unapplied.append(span)
        stat_add("ps.client.group_replay_resolve")
        if not unapplied:
            return np.zeros((0,), np.int64)
        return np.sort(np.concatenate(unapplied))

    def pull_dense(self, name: str) -> Optional[np.ndarray]:
        return self._call({"cmd": "pull_dense", "name": name})["value"]

    def push_dense(self, name: str, value: np.ndarray, add: bool = False):
        self._call({"cmd": "push_dense", "name": name,
                    "value": np.asarray(value), "add": add}, dedup=True)

    def _control_fenced(self, fn):
        """Run a cluster control-plane verb (end_day/save/load/shrink)
        under the fence-recover loop: on a typed epoch rejection the
        call PROVABLY did not reach that shard's mutation (and the
        2-phase helper's pinned rids make any partially-applied shards
        replay cached acks), so refresh-the-map-and-re-drive is exact.
        Without this, a client holding a pre-reshard map would fan a
        lifecycle verb over only the shards the OLD map names — end_day
        decaying half a fleet is a silent table fork."""
        bo = Backoff(base=self.retry_sleep, cap=self.backoff_cap,
                     deadline=self.deadline)
        attempt = 0
        while True:
            try:
                return fn()
            except _FenceRedirect as e:
                attempt += 1
                self._fence_recover(e, bo, attempt)

    def save(self, path: str, mode: str = "all",
             table: Optional[str] = None, keys=None) -> int:
        """Durable dump — at n > 1 fans out into per-shard
        ``shard-<k:03d>/`` subdirs of ``path`` (ps/cluster.cluster_save);
        EVERY shard writes its DEDUP.bin there, so all N restart handoffs
        stay current.  n == 1 keeps the flat single-server layout."""
        return self._control_fenced(
            lambda: ps_cluster.cluster_save(self, path, mode=mode,
                                            keys=keys, table=table))

    def load(self, path: str, table: Optional[str] = None,
             mode: str = "replace") -> int:
        return self._control_fenced(
            lambda: ps_cluster.cluster_load(self, path, mode=mode,
                                            table=table))

    def shrink(self, table: Optional[str] = None) -> int:
        def run():
            if self.n_shards > 1:
                return sum(
                    int(self._call(self._stamp_ep(
                        {"cmd": "shrink", "table": table}),
                        shard=s)["removed"])
                    for s in range(self.n_shards))
            return self._call(self._stamp_ep(
                {"cmd": "shrink", "table": table}))["removed"]
        return self._control_fenced(run)

    def end_day(self, table: Optional[str] = None,
                group: Optional[str] = None) -> None:
        # non-idempotent (counter decay) → exactly-once via rid; cluster-
        # wide it is 2-phase over every shard's dedup window — ALL shards
        # decay or none (ps/cluster.two_phase_lifecycle; lint rule PB801
        # keeps every lifecycle send on this path).  ``group`` pins a
        # caller-deterministic rid group: the trainer fleet's leader
        # failover re-drives end_day under the SAME group from whichever
        # rank holds the lease, and the dedup windows collapse the
        # duplicates — decay happens exactly once per day regardless of
        # how many leaders attempted it.
        self._control_fenced(
            lambda: ps_cluster.two_phase_lifecycle(self, "end_day",
                                                   table=table,
                                                   group=group))

    def size(self, table: Optional[str] = None) -> int:
        if self.n_shards > 1:
            return sum(
                int(self._call({"cmd": "size", "table": table},
                               shard=s)["size"])
                for s in range(self.n_shards))
        return self._call({"cmd": "size", "table": table})["size"]

    def list_tables(self) -> Dict[str, int]:
        if self.n_shards > 1:
            out: Dict[str, int] = {}
            for s in range(self.n_shards):
                for name, n in self._call({"cmd": "list_tables"},
                                          shard=s)["tables"].items():
                    out[name] = out.get(name, 0) + int(n)
            return out
        return self._call({"cmd": "list_tables"})["tables"]

    def forward(self, keys: np.ndarray, lod: np.ndarray,
                table: Optional[str] = None) -> np.ndarray:
        """Serving-tier ragged inference pool (ps/serving.py): per-sample
        sum over [embed_w | mf] of each sample's keys, ``lod`` = n+1
        offsets into ``keys``.  Single-frame (serving batches are small
        by construction; the admission cap bounds them server-side).
        Read-only, so a fence redirect is a simple refresh-and-redo."""
        bo = Backoff(base=self.retry_sleep, cap=self.backoff_cap,
                     deadline=self.deadline)
        attempt = 0
        while True:
            try:
                resp = self._call(self._stamp_ep(
                    {"cmd": "forward",
                     "keys": np.asarray(keys, np.uint64),
                     "lod": np.asarray(lod, np.int64),
                     "table": table}))
                return resp["pooled"]
            except _FenceRedirect as e:
                attempt += 1
                self._fence_recover(e, bo, attempt)

    def invalidate_row_width(self, table: Optional[str] = None) -> None:
        """Drop learned row-width estimates (one table, or all when
        ``table`` is None).  Coherence point for anything that replaces
        table CONTENTS out from under this client — load_xbox, a serving
        hot-swap — where a stale estimate from the old rows would
        mis-chunk the first pull against the new schema."""
        with self._lock:
            if table is None:
                self._row_bytes_est.clear()
            else:
                self._row_bytes_est.pop(table, None)

    def health(self, timeout: float = 5.0) -> Dict:
        """Heartbeat: liveness + drain state, cheap enough to poll.  The
        report carries this client's wire-pool shape alongside the
        server's state: pool size, connected streams, window.  At n > 1
        the report AGGREGATES across shards — mode collapses when all
        agree ("mixed" otherwise), draining is any-shard, inflight and
        stats sum — and the raw per-shard reports ride in ``shards``."""
        if self.n_shards > 1:
            per = [self._call({"cmd": "health"}, timeout=timeout,
                              deadline=timeout, shard=s)
                   for s in range(self.n_shards)]
            modes = {r.get("mode") for r in per}
            stats: Dict[str, float] = {}
            for r in per:
                for k, v in (r.get("stats") or {}).items():
                    stats[k] = stats.get(k, 0.0) + float(v)
            resp = {"ok": True,
                    "mode": modes.pop() if len(modes) == 1 else "mixed",
                    "draining": any(r.get("draining") for r in per),
                    "inflight": sum(int(r.get("inflight", 0))
                                    for r in per),
                    "tables": per[0].get("tables", ""),
                    "stats": stats,
                    "n_shards": self.n_shards,
                    "shards": per}
            heats = [r.get("heat") for r in per if r.get("heat")]
            if heats:
                # cluster heat: shard key spaces are disjoint, so
                # distinct counts ADD; concentration reads as the
                # hottest member; imbalance is measured across the
                # members' observed pull totals
                totals = [float(h.get("total_keys", 0.0)) for h in heats]
                mean = sum(totals) / max(len(totals), 1)
                resp["heat"] = {
                    "topk_share": max(h.get("topk_share", 0.0)
                                      for h in heats),
                    "working_set_rows": round(
                        sum(h.get("working_set_rows", 0.0)
                            for h in heats), 1),
                    "shard_imbalance": round(max(totals) / mean, 4)
                    if mean > 0 else 0.0,
                }
        else:
            resp = self._call({"cmd": "health"}, timeout=timeout,
                              deadline=timeout)
        with self._pool_cv:
            resp["pool_streams"] = len(self._pool)
            resp["pool_connected"] = sum(
                1 for s in self._pool if s.sock is not None)
        resp["pool_window"] = self.window
        resp["wire_dtype"] = self.wire_dtype
        return resp

    def barrier(self, world: int, timeout: float = 120,
                rid: Optional[str] = None) -> None:
        # retryable via rid: a resend after a dropped connection WAITS on
        # the original registration server-side instead of double-
        # registering.  Client timeout stays LONGER than the server's wait
        # window, so the server side always resolves (release or
        # rollback) first.  ``rid`` pins a caller-deterministic request id
        # (the trainer fleet's replay-safe barriers: a restarted rank
        # re-driving its pass replays the SAME rid, so a barrier it
        # already joined answers from the dedup window instead of
        # double-registering).
        req: Dict = {"cmd": "barrier", "world": world}
        if rid is not None:
            req[wire.RID_FIELD] = rid
        self._call(req, timeout=timeout, deadline=2 * timeout, dedup=True)

    def allreduce(self, arrs: Dict[str, np.ndarray], world: int, key: str,
                  timeout: float = 120,
                  rid: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Sum the named arrays across `world` workers (every caller gets
        the same result).  Exactly-once like barrier (rid-dedup'd resend;
        ``rid`` pins a caller-deterministic id for restart replay).
        Use a fresh key per collective (e.g. f"auc-{pass_id}")."""
        req: Dict = {"cmd": "allreduce", "key": key, "world": world,
                     "arrs": dict(arrs)}
        if rid is not None:
            req[wire.RID_FIELD] = rid
        out = self._call(req, timeout=timeout,
                         deadline=2 * timeout, dedup=True)
        return out["arrs"]


class RemoteTableAdapter:
    """Duck-types ShardedHostTable's pass-batched surface over a PSClient so
    BoxPSEngine can run against a remote PS
    (engine.table = RemoteTableAdapter(client[, table])).

    delta_mode=True is the multi-trainer contract: bulk_pull snapshots the
    pulled rows (and asks the server to persist fresh-row defaults so every
    worker shares one base), bulk_write sends (new - snapshot) and the
    server SUMS concurrent workers' deltas — pass-granular Hogwild, the
    pass-lifecycle analogue of multi-node sparse grad aggregation
    (heter_comm_inl.h:2027/2131).

    Pass-level recovery: a failed write-back restores the pull snapshot
    AND pins the chunk rid-group, so re-driving end_pass resends byte-
    identical chunks under the same rids — chunks that DID land before the
    failure dedup server-side instead of double-applying.

    Quantized wire mode (FLAGS_ps_wire_dtype != f32): pull_sparse hands
    back the DEQUANTIZED values (wire.decode dequantizes), and the
    snapshot copies exactly those — so the write-back delta is
    (trained - dequantized base), i.e. precisely the training delta, and
    a zero-delta write-back leaves the server's fp32 state untouched."""

    def __init__(self, client: PSClient, table: Optional[str] = None,
                 delta_mode: bool = False,
                 snap_cap: Optional[int] = None):
        self.client = client
        self.table = table
        self.delta_mode = delta_mode
        # snapshots keyed by key-set digest: the engine pulls from several
        # sites (pass build, async preload of the NEXT pass, stale-row
        # refresh) and a single slot would be clobbered before write-back.
        # The cap is FLAGS_ps_snap_cap (pipelined next-pass preload raises
        # concurrent-snapshot pressure; an eviction here fails the
        # evictee's later write-back)
        self._snaps: Dict[bytes, Dict[str, np.ndarray]] = {}
        self._snap_groups: Dict[bytes, str] = {}
        self._snap_cap = max(1, int(flags.get_flags("ps_snap_cap")
                                    if snap_cap is None else snap_cap))
        # last successful delta write-back's MATERIALIZED rows (base+delta
        # as the server computed them) — consumed by the engine's device-
        # cache fold-back; None outside delta_mode
        self._write_effect: Optional[Dict[str, np.ndarray]] = None

    @property
    def server_map(self) -> ps_cluster.ServerMap:
        """The client's key-hash -> shard placement; consumers (device
        cache sharding, checkpoint metadata) read the topology here."""
        return self.client.server_map

    def pop_write_effect(self) -> Optional[Dict[str, np.ndarray]]:
        """The server-side value of the rows the last ``bulk_write``
        landed (delta mode: base + delta in the server's arithmetic, not
        the written soa — they can differ in the last ulp).  Cleared on
        read; the device cache folds these bits so hits replay wire pulls
        exactly."""
        eff, self._write_effect = self._write_effect, None
        return eff

    def invalidate_row_width(self) -> None:
        """Forward the coherence-point invalidation to the wire client
        (load_xbox calls this through engine.table when the engine runs
        against a remote PS)."""
        self.client.invalidate_row_width(self.table)

    def bulk_pull(self, keys):
        rows = self.client.pull_sparse(keys, table=self.table,
                                       create=self.delta_mode)
        if self.delta_mode:
            digest = np.asarray(keys, np.uint64).tobytes()
            if len(self._snaps) >= self._snap_cap:
                old = next(iter(self._snaps))       # oldest out
                self._snaps.pop(old)
                self._snap_groups.pop(old, None)
                # loud at the CAUSE: the silent eviction used to surface
                # later as a confusing no-matching-snapshot RuntimeError
                # at write-back time, far from here
                logging.getLogger(__name__).warning(
                    "RemoteTableAdapter: pull-snapshot cap (%d) hit — "
                    "evicting the oldest snapshot (%d keys); a later "
                    "write-back of that key set will fail. More "
                    "concurrent pulls in flight than _snap_cap?",
                    self._snap_cap, len(old) // 8)
                stat_add("ps.adapter.snap_evict")
            self._snaps[digest] = {f: np.array(v, copy=True)
                                   for f, v in rows.items()}
        return rows

    # fields where "sum of two workers' changes" is wrong — sent absolute
    NON_ACCUMULABLE = ("slot", "mf_size")
    NON_ACCUMULABLE_SUFFIX = ("_b1p", "_b2p")

    def _is_abs(self, f: str) -> bool:
        return (f in self.NON_ACCUMULABLE
                or f.endswith(self.NON_ACCUMULABLE_SUFFIX))

    def patch_snapshot(self, full_keys, sub_keys, rows) -> None:
        """The engine refreshed a SUBSET of an earlier pull (stale-row
        refresh after an async preload): fold the fresh values into the
        full pull's snapshot, or the next delta re-applies whatever peers
        (and this worker's previous pass) already pushed for those rows.
        Also drops the subset pull's own snapshot (it will never be
        written back)."""
        if not self.delta_mode:
            return
        full = np.asarray(full_keys, np.uint64)
        sub = np.asarray(sub_keys, np.uint64)
        self._snaps.pop(sub.tobytes(), None)
        snap = self._snaps.get(full.tobytes())
        if snap is None:
            return
        pos = np.searchsorted(full, sub)   # full pass keys are sorted
        for f, v in rows.items():
            if f in snap:
                snap[f][pos] = v

    def seed_snapshot(self, full_keys, rows, consumed=()) -> None:
        """A device-cache-assisted build pulled only cache MISSES over the
        wire; the engine assembled the full pass rows itself (hits from
        its host mirror — exactly the values this worker last wrote
        back).  Install them as the write-back base for the FULL key set
        so the later ``bulk_write(full_keys, ...)`` computes correct
        deltas, and drop the partial pulls' own snapshots (``consumed``,
        never written back directly) before they pressure the cap."""
        if not self.delta_mode:
            return
        for sub in consumed:
            sub_digest = np.asarray(sub, np.uint64).tobytes()
            self._snaps.pop(sub_digest, None)
            self._snap_groups.pop(sub_digest, None)
        digest = np.asarray(full_keys, np.uint64).tobytes()
        self._snaps[digest] = {f: np.array(v, copy=True)
                               for f, v in rows.items()}

    def pin_group(self, keys, group: str) -> None:
        """Pre-pin the rid group the NEXT ``bulk_write(keys, ...)`` will
        send its chunks under (instead of a fresh ``new_rid_group()``).
        The trainer fleet pins a group deterministic in (rank, day, pass,
        slice) right before each slice's write-back, so a crashed rank's
        replayed end_pass re-drives byte-identical chunks under identical
        rids — landed chunks dedup server-side, unlanded ones apply
        exactly once."""
        if not self.delta_mode:
            return
        self._snap_groups[np.asarray(keys, np.uint64).tobytes()] = group

    def bulk_write(self, keys, soa):
        if not self.delta_mode:
            return self.client.push_sparse(keys, soa, table=self.table)
        digest = np.asarray(keys, np.uint64).tobytes()
        snap = self._snaps.pop(digest, None)
        if snap is None:
            raise RuntimeError(
                "delta_mode write-back without a matching pull snapshot — "
                "the written key set must equal a previously pulled one")
        delta = {f: v - snap[f] for f, v in soa.items()
                 if f in snap and f != "unseen_days"
                 and not self._is_abs(f)}
        rows_abs = {f: np.asarray(v) for f, v in soa.items()
                    if self._is_abs(f)}
        group = self._snap_groups.pop(digest, None) or \
            self.client.new_rid_group()
        try:
            self.client.push_sparse_delta(keys, delta, rows_abs=rows_abs,
                                          table=self.table, rid_group=group)
        except Exception:
            # pass-level recovery: restore the snapshot and PIN the rid
            # group — a re-driven end_pass resends identical chunks under
            # identical rids, so chunks that landed dedup instead of
            # double-applying
            self._snaps[digest] = snap
            self._snap_groups[digest] = group
            stat_add("ps.adapter.writeback_retry_armed")
            raise
        # what the SERVER now holds for these rows: base + delta in the
        # server's own arithmetic (cur[f] + d elementwise), absolutes
        # overwritten, unseen_days zeroed.  base+delta can differ from the
        # written soa in the last ulp, so a device cache folding rows back
        # (pass_manager.end_pass) must mirror THESE bits, not soa's —
        # otherwise a later cache hit diverges from the wire pull it
        # replaces
        effect = {}
        for f, v in soa.items():
            if f in delta:
                effect[f] = snap[f] + delta[f]
            elif f == "unseen_days":
                effect[f] = np.zeros_like(np.asarray(v))
            else:
                effect[f] = np.asarray(v)
        self._write_effect = effect

    def end_day(self):
        self.client.end_day(table=self.table)

    def shrink(self):
        return self.client.shrink(table=self.table)

    def save(self, path, mode="all", keys=None):
        return self.client.save(path, mode, table=self.table, keys=keys)

    def load(self, path, mode="replace"):
        return self.client.load(path, table=self.table, mode=mode)

    def size(self):
        return self.client.size(table=self.table)
