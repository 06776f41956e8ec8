"""Deterministic fault injection for the PS tier — the chaos harness.

The exactly-once retry protocol (ps/service.py: request ids + the server
dedup window + backoff-under-deadline) is only trustworthy if failures
are *reproducible under test*.  This module provides that reproducibility
two ways, both driven by one seedable :class:`FaultPlan`:

  * **in-process hooks** at five named sites — ``connect`` (client about
    to dial), ``send`` / ``recv`` (either peer's frame I/O), ``dispatch``
    (server about to run a verb), and ``lifecycle`` (trainer-side
    SIGKILL-schedule points: ``ckpt_sparse`` mid-checkpoint-write,
    ``ckpt_commit`` between generation assembly and the MANIFEST pointer
    swap, ``end_pass`` before the pass write-back, and the live-reshard
    windows ``reshard_snapshot`` / ``reshard_catchup`` /
    ``reshard_cutover`` — io/checkpoint.py, ps/pass_manager.py and
    ps/reshard.py fire them).  The hooks can drop the connection,
    delay it, truncate a frame mid-write, kill the server abruptly
    mid-verb, or simulate a process SIGKILL at a lifecycle point (the
    kill-anywhere chaos soak's seeded schedule).  Production pays zero
    cost:
    the service path checks one module global (``faults.ACTIVE``) that
    stays ``None`` unless :func:`install` ran, and ``install`` refuses
    unless the registered flag ``FLAGS_ps_fault_injection`` is set.

  * a **chaos TCP proxy** (:class:`ChaosProxy`) that sits between a real
    ``PSClient`` and ``PSServer`` (possibly in other processes) and
    applies the same plan frame-by-frame on the wire — ``connect`` on a
    new client connection, ``send`` for client→server frames, ``recv``
    for server→client frames.

A plan is a list of rules.  Each rule names a site, optionally a role
(``client``/``server``/``proxy``), and triggers either at explicit hit
indices (``at=(3, 9)`` — the 4th and 10th invocation of that site+role
counter) or probabilistically from the plan's seeded RNG.  Given the
same call sequence, a plan fires identically — the chaos soak test
(tests/test_chaos_soak.py) leans on this to replay a schedule.

Injected faults raise :class:`InjectedFault` (a ``ConnectionError``
subclass) so they flow through exactly the retry paths a real network
failure would.  Every fire bumps ``ps.fault.<site>.<kind>`` in
utils/monitor.StatRegistry.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils import flight, lockdep
from paddlebox_tpu_torch.utils.monitor import stat_add

flags.define_flag(
    "ps_fault_injection", False,
    "allow faults.install() to arm in-process PS fault hooks (chaos "
    "testing only — production keeps this off and pays zero cost)")


class InjectedFault(ConnectionError):
    """An injected network/server fault (subclasses ConnectionError so it
    takes the same retry path a real failure would)."""


@dataclasses.dataclass(frozen=True)
class FaultAction:
    # "drop" | "delay" | "truncate" | "kill_server" | "kill" (lifecycle
    # site: simulate an abrupt process death at a named point)
    kind: str
    delay_s: float = 0.0


@dataclasses.dataclass
class _Rule:
    site: str
    role: Optional[str]
    action: FaultAction
    at: Tuple[int, ...] = ()
    prob: float = 0.0
    limit: Optional[int] = None   # max fires (None = unbounded)
    cmd: Optional[str] = None     # dispatch site only: match one verb
    seen: int = 0                 # matching invocations so far (at= index)
    fired: int = 0

    def matches(self, site: str, role: Optional[str],
                cmd: Optional[str]) -> bool:
        return (self.site == site
                and (self.role is None or self.role == role)
                and (self.cmd is None or self.cmd == cmd))


class FaultPlan:
    """Seedable, deterministic schedule of fault injections.

    Build with the fluent helpers (each returns ``self``)::

        plan = (FaultPlan(seed=7)
                .drop("send", role="client", at=(2, 5))
                .delay("recv", 0.01, prob=0.2)
                .truncate("send", at=(9,))
                .kill_server(at=(40,)))

    ``at`` indices are 0-based positions in the RULE's own sequence of
    matching invocations (``at=(2, 5)`` → its 3rd and 6th match);
    ``cmd=`` narrows a dispatch-site rule to one verb.  Thread-safe.
    """

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._rules: List[_Rule] = []
        self._hits: Dict[Tuple[str, Optional[str]], int] = {}
        self._lock = lockdep.lock("ps.faults.FaultPlan._lock")
        self.killed = threading.Event()   # set when a kill_server fires

    # -- rule makers ---------------------------------------------------------
    def add_rule(self, site: str, action: FaultAction,
                 role: Optional[str] = None, at: Tuple[int, ...] = (),
                 prob: float = 0.0, limit: Optional[int] = None,
                 cmd: Optional[str] = None) -> "FaultPlan":
        if site not in ("connect", "send", "recv", "dispatch", "lifecycle"):
            raise ValueError(f"unknown fault site {site!r}")
        with self._lock:
            self._rules.append(_Rule(site, role, action, tuple(at),
                                     float(prob), limit, cmd))
        return self

    def drop(self, site: str, role: Optional[str] = None,
             at: Tuple[int, ...] = (), prob: float = 0.0,
             limit: Optional[int] = None,
             cmd: Optional[str] = None) -> "FaultPlan":
        return self.add_rule(site, FaultAction("drop"), role, at, prob,
                             limit, cmd)

    def delay(self, site: str, seconds: float, role: Optional[str] = None,
              at: Tuple[int, ...] = (), prob: float = 0.0,
              limit: Optional[int] = None,
              cmd: Optional[str] = None) -> "FaultPlan":
        return self.add_rule(site, FaultAction("delay", seconds), role, at,
                             prob, limit, cmd)

    def truncate(self, site: str = "send", role: Optional[str] = None,
                 at: Tuple[int, ...] = (), prob: float = 0.0,
                 limit: Optional[int] = None,
                 cmd: Optional[str] = None) -> "FaultPlan":
        return self.add_rule(site, FaultAction("truncate"), role, at, prob,
                             limit, cmd)

    def kill_server(self, at: Tuple[int, ...] = (), prob: float = 0.0,
                    cmd: Optional[str] = None,
                    limit: Optional[int] = 1) -> "FaultPlan":
        """Abrupt server death mid-verb (dispatch site).  ``limit``
        defaults to 1 for the single-restart soaks; the kill-anywhere
        soak raises it and pairs each fire with a supervisor restart
        (launch.PSServerSupervisor)."""
        return self.add_rule("dispatch", FaultAction("kill_server"),
                             "server", at, prob, limit=limit, cmd=cmd)

    def kill_at(self, point: str, at: Tuple[int, ...] = (),
                prob: float = 0.0,
                limit: Optional[int] = None) -> "FaultPlan":
        """Seeded SIGKILL schedule at a named lifecycle point
        (``ckpt_sparse`` / ``ckpt_commit`` / ``end_pass``, or the
        migration windows ``reshard_snapshot`` — moving rows dumped but
        no cutover staged, ``reshard_catchup`` — deltas shipped and the
        moving range frozen, ``reshard_cutover`` — between the 2-phase
        prepare and commit): the producer site raises InjectedFault
        there, simulating an abrupt trainer death whose kill
        points replay from this one plan/seed."""
        return self.add_rule("lifecycle", FaultAction("kill"), None, at,
                             prob, limit=limit, cmd=point)

    @classmethod
    def default_chaos(cls, seed: int = 0) -> "FaultPlan":
        """A modest background-noise plan for soak runs / the launcher's
        ``--chaos_backend`` proxy: occasional connection drops and small
        delays, never a kill."""
        return (cls(seed)
                .drop("connect", prob=0.02)
                .drop("send", prob=0.01)
                .drop("recv", prob=0.01)
                .truncate("send", prob=0.005)
                .delay("send", 0.005, prob=0.05))

    # -- firing --------------------------------------------------------------
    def fire(self, site: str, role: Optional[str] = None,
             cmd: Optional[str] = None) -> Optional[FaultAction]:
        """Count one invocation of the site and return the action of the
        first matching rule (or None).  Deterministic given the same call
        sequence: one RNG draw per probabilistic rule per match."""
        with self._lock:
            self._hits[(site, role)] = self._hits.get((site, role), 0) + 1
            hit: Optional[FaultAction] = None
            for rule in self._rules:
                if not rule.matches(site, role, cmd):
                    continue
                idx = rule.seen
                rule.seen += 1
                scheduled = idx in rule.at
                if rule.prob > 0.0:
                    # always draw, so later decisions stay aligned even
                    # when an earlier rule already matched
                    scheduled = (self._rng.random() < rule.prob) or scheduled
                if scheduled and hit is None and (
                        rule.limit is None or rule.fired < rule.limit):
                    rule.fired += 1
                    hit = rule.action
        if hit is not None:
            stat_add(f"ps.fault.{site}.{hit.kind}")
            flight.record("fault_injected", site=site, action=hit.kind,
                          role=role, cmd=cmd)
        return hit

    def hits(self, site: str, role: Optional[str] = None) -> int:
        with self._lock:
            return self._hits.get((site, role), 0)


# ---------------------------------------------------------------------------
# In-process hook surface (called from ps/service.py when ACTIVE is set).
# ---------------------------------------------------------------------------

ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Arm the in-process hooks.  Refuses unless FLAGS_ps_fault_injection
    is set — production never reaches the injection branches."""
    global ACTIVE
    if not flags.get_flags("ps_fault_injection"):
        raise RuntimeError(
            "fault injection is disabled — set_flags({'ps_fault_injection':"
            " True}) (or FLAGS_ps_fault_injection=1) before install()")
    ACTIVE = plan
    return plan


def uninstall() -> None:
    global ACTIVE
    ACTIVE = None


def on_connect(role: str) -> None:
    plan = ACTIVE
    if plan is None:
        return
    act = plan.fire("connect", role)
    if act is None:
        return
    if act.kind == "delay":
        time.sleep(act.delay_s)
    elif act.kind == "drop":
        raise InjectedFault(f"injected: connect refused ({role})")


def on_send(sock: socket.socket, frame: bytes, role: str) -> None:
    """May send a truncated prefix of ``frame`` and sever, or raise before
    any byte moves; returns normally when no fault fires (the caller then
    sends the full frame)."""
    plan = ACTIVE
    if plan is None:
        return
    act = plan.fire("send", role)
    if act is None:
        return
    if act.kind == "delay":
        time.sleep(act.delay_s)
    elif act.kind == "drop":
        raise InjectedFault(f"injected: connection dropped before send "
                            f"({role})")
    elif act.kind == "truncate":
        try:
            sock.sendall(frame[:max(1, len(frame) // 2)])
            sock.shutdown(socket.SHUT_WR)   # peer sees a truncated frame
        except OSError:
            pass
        raise InjectedFault(f"injected: frame truncated mid-send ({role})")


def on_recv(role: str) -> None:
    plan = ACTIVE
    if plan is None:
        return
    act = plan.fire("recv", role)
    if act is None:
        return
    if act.kind == "delay":
        time.sleep(act.delay_s)
    elif act.kind == "drop":
        raise InjectedFault(f"injected: connection dropped before recv "
                            f"({role})")


def on_dispatch(cmd: Optional[str], server) -> None:
    plan = ACTIVE
    if plan is None:
        return
    act = plan.fire("dispatch", "server", cmd)
    if act is None:
        return
    if act.kind == "delay":
        time.sleep(act.delay_s)
    elif act.kind == "drop":
        # verb never runs; connection dies without a response — the
        # client's retry (same rid) re-executes cleanly
        raise InjectedFault(f"injected: dispatch dropped ({cmd})")
    elif act.kind == "kill_server":
        # abrupt mid-verb server death, BEFORE the verb applies (crash-
        # before-commit): the kill runs off-thread so this handler can
        # unwind while the listener + every live connection is torn down
        threading.Thread(target=server.kill, daemon=True).start()
        plan.killed.set()
        raise InjectedFault(f"injected: server killed mid-verb ({cmd})")


def on_lifecycle(point: str) -> None:
    """Trainer-side SIGKILL-schedule site: io/checkpoint.py fires it at
    ``ckpt_sparse`` (shard files down, generation not assembled) and
    ``ckpt_commit`` (generation assembled, MANIFEST not yet swapped);
    ps/pass_manager.py fires ``end_pass`` before the pass write-back;
    ps/reshard.py fires ``reshard_snapshot`` / ``reshard_catchup`` /
    ``reshard_cutover`` at the three migration crash windows.
    A matching ``kill`` rule raises InjectedFault — the abrupt-death
    simulation the auto-resume path (fleet.train_passes) must survive."""
    plan = ACTIVE
    if plan is None:
        return
    act = plan.fire("lifecycle", None, point)
    if act is None:
        return
    if act.kind == "delay":
        time.sleep(act.delay_s)
    elif act.kind in ("kill", "drop", "kill_server"):
        plan.killed.set()
        raise InjectedFault(f"injected: killed at lifecycle point "
                            f"({point})")


# ---------------------------------------------------------------------------
# Chaos TCP proxy — the out-of-process face of the same plan.
# ---------------------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _close_quietly(sock: Optional[socket.socket]) -> None:
    if sock is None:
        return
    # shutdown BEFORE close: close() alone defers the FIN while a sibling
    # pump thread is still blocked in recv() on the same fd (Linux fput
    # semantics) — the peer would hang to its timeout instead of seeing a
    # clean sever
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class ChaosProxy:
    """Frame-aware TCP proxy between a PSClient and a PSServer applying a
    FaultPlan on the wire: ``connect`` fires per accepted client
    connection, ``send`` per client→server frame, ``recv`` per
    server→client frame (all with role="proxy").  drop severs both
    directions, truncate forwards half a frame then severs, delay sleeps
    before forwarding.  The backend address can be repointed live
    (:meth:`set_backend`) after a server restart on a new port."""

    def __init__(self, backend: Tuple[str, int], plan: FaultPlan,
                 host: str = "127.0.0.1", port: int = 0):
        self._plan = plan
        self._stop = threading.Event()
        self._lock = lockdep.lock("ps.faults.ChaosProxy._lock")
        self._backend: Tuple[str, int] = tuple(backend)
        self._conns: set = set()
        self._listener = socket.create_server((host, port))
        self.addr: Tuple[str, int] = self._listener.getsockname()
        # pboxlint: disable-next=PB405 -- chaos-proxy listener pump; close() stops it via listener shutdown
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def set_backend(self, backend: Tuple[str, int]) -> None:
        with self._lock:
            self._backend = tuple(backend)

    def backend(self) -> Tuple[str, int]:
        with self._lock:
            return self._backend

    def shutdown(self) -> None:
        self._stop.set()
        _close_quietly(self._listener)
        with self._lock:
            conns = list(self._conns)
        for s in conns:
            _close_quietly(s)

    # -- internals -----------------------------------------------------------
    def _track(self, sock: socket.socket, add: bool) -> None:
        with self._lock:
            if add:
                self._conns.add(sock)
            else:
                self._conns.discard(sock)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            # pboxlint: disable-next=PB405 -- per-connection fault injector; dies with its socket pair
            threading.Thread(target=self._serve_conn, args=(client,),
                             daemon=True).start()

    def _serve_conn(self, client: socket.socket) -> None:
        upstream: Optional[socket.socket] = None
        try:
            act = self._plan.fire("connect", "proxy")
            if act is not None:
                if act.kind == "delay":
                    time.sleep(act.delay_s)
                else:                       # drop/truncate both sever here
                    return
            upstream = socket.create_connection(self.backend(), timeout=10)
        except OSError:
            _close_quietly(client)
            _close_quietly(upstream)
            return
        finally:
            if upstream is None:
                _close_quietly(client)
        self._track(client, True)
        self._track(upstream, True)
        pair = (client, upstream)

        def pump(src: socket.socket, dst: socket.socket, site: str) -> None:
            try:
                while not self._stop.is_set():
                    head = _read_exact(src, 8)
                    (length,) = struct.unpack("<Q", head)
                    payload = _read_exact(src, length)
                    act = self._plan.fire(site, "proxy")
                    if act is not None:
                        if act.kind == "delay":
                            time.sleep(act.delay_s)
                        elif act.kind == "drop":
                            raise ConnectionError("injected proxy drop")
                        elif act.kind == "truncate":
                            frame = head + payload
                            dst.sendall(frame[:max(1, len(frame) // 2)])
                            raise ConnectionError("injected proxy truncate")
                    dst.sendall(head + payload)
            except (ConnectionError, OSError):
                pass
            finally:
                # sever BOTH directions so the client sees a clean failure
                for s in pair:
                    self._track(s, False)
                    _close_quietly(s)

        # pboxlint: disable-next=PB405 -- byte pump dies when either socket closes
        threading.Thread(target=pump, args=(client, upstream, "send"),
                         daemon=True).start()
        # pboxlint: disable-next=PB405 -- byte pump dies when either socket closes
        threading.Thread(target=pump, args=(upstream, client, "recv"),
                         daemon=True).start()
