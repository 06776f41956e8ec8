"""TCP transport for the inter-node global shuffle.

Copy of ``paddlebox_tpu/data/shuffle_transport.py`` (host code: numpy,
sockets, threads; no torch) with the import paths rewritten.  Its frames
are the JAX package's byte for byte (the same ``ps/wire.py`` codec), so
a block crosses packages either way.

≙ boxps::PaddleShuffler (closed-source MPI transport driven from
data_set.cc:1910-1929 send_message_callback / ReceiveSuffleData
:2548): length-prefixed record-block messages between ranks, with DONE
markers standing in for the MPI barrier + wait_done.  Runs over plain
sockets (loopback or DCN) so the dataset shuffle works across launcher
processes without MPI.

Fault model (the trainer-fleet contract): any peer may die and be
restarted by a supervisor at any point of a shuffle.  Three mechanisms
make that survivable without losing or double-counting records:

* **Deadlines everywhere** — dials, sends and the DONE barrier all run
  under ``FLAGS_shuffle_deadline_s`` with exponential backoff; a peer
  dead past the budget raises the typed :class:`ShufflePeerDead`
  (a ``ConnectionError``) instead of hanging the pass forever.
* **Idempotent resend** — every block frame carries a (shuffle epoch,
  per-destination seq) id; the sender buffers the current epoch's
  frames and, after a reconnect, replays the whole window.  The
  receiver keeps a per-source watermark and drops already-seen seqs, so
  a replay delivers each block exactly once (TCP orders each stream and
  the replay is an in-order prefix-complete resend, which makes the
  max-seq watermark sound even across an old socket's late frames).
* **Resync** — a restarted rank (fresh process, same address) calls
  :meth:`set_epoch` with the pass's epoch and then :meth:`resync`; each
  peer replays its buffered frames + DONE for that epoch from the
  send-side buffer.  Buffers are retained until the NEXT epoch begins
  (``set_epoch``/barrier GC keeps the previous epoch), which is exactly
  as long as a crashed peer can still need them: nobody starts epoch
  e+1 before every rank finished e.

Epochs are explicit for the fleet runner (one per global pass,
monotonic); legacy callers that never call ``set_epoch`` stay on
epoch 0 — seq counters then keep growing across shuffles (the watermark
stays sound) and the barrier GCs the frame buffer each round.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.data.dataset import ShuffleTransport
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.ps import wire
from paddlebox_tpu_torch.ps.feature_value import _keyed_hash
from paddlebox_tpu_torch.utils import lockdep
from paddlebox_tpu_torch.utils.backoff import Backoff
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe

flags.define_flag(
    "shuffle_deadline_s", 60.0,
    "total budget for any one shuffle-transport wait (dial+resend loop, "
    "DONE barrier); a peer unreachable past this raises ShufflePeerDead "
    "instead of hanging the pass")

_MSG_BLOCK = 0
_MSG_DONE = 1
_MSG_RESYNC = 2

# frame header: kind, src rank, shuffle epoch, block seq, payload length
_HDR = struct.Struct("<BIQQQ")

# Record→slice routing salt for the fleet's shuffle-by-key — deliberately
# distinct from ps/cluster.CLUSTER_SALT so the trainer partition of the
# key space decorrelates from the PS-shard partition (a slice's keys
# spread over all M shards and vice versa).
SHUFFLE_SALT = 0x5BD1E995C3E4D96F


def slice_of(keys: np.ndarray, n_slices: int) -> np.ndarray:
    """Deterministic record route: splitmix64(key ^ SHUFFLE_SALT) mod V.
    Same key → same virtual slice for every rank, every fleet size."""
    return (_keyed_hash(np.asarray(keys, np.uint64), SHUFFLE_SALT)
            % np.uint64(max(1, n_slices))).astype(np.int64)


class ShufflePeerDead(ConnectionError):
    """A shuffle peer stayed unreachable past FLAGS_shuffle_deadline_s."""


def block_to_wire(block: SlotRecordBlock) -> bytes:
    """SlotRecordBlock → typed wire frame (ps/wire.py codec — dtype/shape
    headers + raw buffers, never pickle on network bytes)."""
    msg: Dict[str, object] = {"n": block.n}
    msg["u"] = {}
    msg["uo"] = {}
    for name, (vals, offs) in block.uint64_slots.items():
        msg["u"][name] = np.asarray(vals)
        msg["uo"][name] = np.asarray(offs)
    msg["f"] = {}
    msg["fo"] = {}
    for name, (vals, offs) in block.float_slots.items():
        msg["f"][name] = np.asarray(vals)
        msg["fo"][name] = np.asarray(offs)
    if block.aux_slots:
        msg["a"] = {}
        msg["ao"] = {}
        for name, (vals, offs) in block.aux_slots.items():
            msg["a"][name] = np.asarray(vals)
            msg["ao"][name] = np.asarray(offs)
    if block.ins_ids is not None:
        if any("\x00" in i for i in block.ins_ids):
            raise ValueError("ins_ids may not contain NUL bytes")
        # explicit count disambiguates [] vs [""] (and trailing empties)
        msg["ins_ids"] = "\x00".join(block.ins_ids)
        msg["ins_ids_n"] = len(block.ins_ids)
    for f in ("search_ids", "cmatch", "rank"):
        v = getattr(block, f)
        if v is not None:
            msg[f] = np.asarray(v)
    # fleet provenance tag (slice, file idx, block seq): lets the
    # receiver re-establish one global deterministic order over blocks
    # that arrived from many senders in arbitrary interleavings
    tag = getattr(block, "shuffle_tag", None)
    if tag is not None:
        msg["tag"] = np.asarray(tag, np.uint64)
    return wire.encode(msg)


def block_from_wire(payload: bytes) -> SlotRecordBlock:
    try:
        msg = wire.decode(payload)
        blk = SlotRecordBlock(n=int(msg["n"]))
        for name, vals in msg.get("u", {}).items():
            blk.uint64_slots[name] = (vals, msg["uo"][name])
        for name, vals in msg.get("f", {}).items():
            blk.float_slots[name] = (vals, msg["fo"][name])
        for name, vals in msg.get("a", {}).items():
            blk.aux_slots[name] = (vals, msg["ao"][name])
        if "ins_ids" in msg:
            n_ids = int(msg["ins_ids_n"])
            ids = msg["ins_ids"].split("\x00") if n_ids else []
            if len(ids) != n_ids:
                raise ValueError("ins_ids count mismatch")
            blk.ins_ids = ids
        for f in ("search_ids", "cmatch", "rank"):
            if f in msg:
                setattr(blk, f, msg[f])
        if "tag" in msg:
            blk.shuffle_tag = tuple(int(x) for x in msg["tag"])
        return blk
    except wire.DecodeError:
        raise
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        # decodable frame, wrong structure — same remedy as a bad frame
        raise wire.DecodeError(f"malformed block frame: {e!r}") from e


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class TcpShuffleTransport(ShuffleTransport):
    def __init__(self, rank: int, addrs: Sequence[Tuple[str, int]]):
        self._rank = rank
        self._addrs = list(addrs)
        self._world = len(addrs)
        self._epoch = 0
        self._rx_error = None
        self._closed = False
        # receive side (all under _done_cv's lock): per-epoch pending
        # blocks + DONE sets, per-source (epoch, max-seq) watermark
        self._pending: Dict[int, List[SlotRecordBlock]] = {}
        self._done_from: Dict[int, set] = {}
        self._peer_seen: Dict[int, List[int]] = {}
        self._resync_epochs: set = set()
        self._done_lock = lockdep.lock("data.shuffle_transport.TcpShuffleTransport._done_lock")
        self._done_cv = threading.Condition(self._done_lock)
        # _conn_lock guards the registries only (PB104: never frame I/O);
        # per-destination send locks serialize frames on ONE peer's socket
        # without stalling senders to OTHER peers behind a global lock.
        # The send-side resend state (_sent/_done_sent/_seq, keyed by
        # (dst, epoch)) is mutated only under the matching dst send lock.
        self._conns: Dict[int, socket.socket] = {}
        self._accepted: List[socket.socket] = []
        self._conn_lock = lockdep.lock("data.shuffle_transport.TcpShuffleTransport._conn_lock")
        self._send_locks: Dict[int, threading.Lock] = {}
        self._sent: Dict[Tuple[int, int], List[Tuple[int, bytes]]] = {}
        self._done_sent: Dict[Tuple[int, int], bool] = {}
        self._seq: Dict[Tuple[int, int], int] = {}
        self._explicit_epoch = False

        host, port = self._addrs[rank]
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # bind under backoff: a supervisor-restarted rank re-binds its
        # OWN address while the dead incarnation's sockets drain (or, in
        # thread-mode tests, while a peer's transient dial squats the
        # port) — transient EADDRINUSE is part of the restart contract
        bo = Backoff(base=0.05, cap=1.0, deadline=self._deadline_s())
        attempt = 0
        while True:
            try:
                self._listener.bind((host, port))
                break
            except OSError:
                attempt += 1
                if not bo.sleep(attempt):
                    raise
        self._listener.listen(self._world)
        # pboxlint: disable-next=PB405 -- listener pump lives for the transport; close() unblocks it via listener shutdown
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # ------------------------------------------------------------------
    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world

    @property
    def epoch(self) -> int:
        return self._epoch

    def _deadline_s(self) -> float:
        return float(flags.get_flags("shuffle_deadline_s"))

    # -- epochs --------------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        """Enter a shuffle epoch (the fleet runner: one per global pass,
        monotonic).  GCs send buffers and receive state of epochs < the
        new one — the PREVIOUS epoch's buffer must survive until here so
        a peer restarted mid-epoch can still resync off it."""
        epoch = int(epoch)
        if epoch < self._epoch:
            raise ValueError(
                f"shuffle epoch must be monotonic: {epoch} < {self._epoch}")
        self._explicit_epoch = True
        for dst in range(self._world):
            if dst == self._rank:
                continue
            with self._send_lock(dst):
                for k in [k for k in self._sent if k[0] == dst
                          and k[1] < epoch]:
                    # pboxlint: disable-next=PB102 -- keys are (dst, ...)-partitioned; the per-dst send lock held above guards them
                    self._sent.pop(k, None)
                    # pboxlint: disable-next=PB102 -- per-dst send lock held (partitioned state)
                    self._done_sent.pop(k, None)
                    # pboxlint: disable-next=PB102 -- per-dst send lock held (partitioned state)
                    self._seq.pop(k, None)
        with self._done_cv:
            self._epoch = epoch
            for e in [e for e in self._pending if e < epoch]:
                del self._pending[e]
            for e in [e for e in self._done_from if e < epoch]:
                del self._done_from[e]
            self._resync_epochs = {e for e in self._resync_epochs
                                   if e >= epoch}

    def resync(self) -> None:
        """Ask every peer to replay its buffered frames for the current
        epoch — the restarted rank's first call after ``set_epoch``.
        Peers that already finished sending (and whose original frames
        died with this rank's previous process) re-deliver from their
        epoch buffer; peers still mid-send just continue normally."""
        with self._done_cv:
            self._resync_epochs.add(self._epoch)
        for dst in range(self._world):
            if dst == self._rank:
                continue
            with self._send_lock(dst):
                self._tx_frame(dst, _MSG_RESYNC, self._epoch, 0, b"")

    # -- connections ---------------------------------------------------------
    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._conn_lock:
                if self._closed:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._accepted.append(conn)
            # pboxlint: disable-next=PB405 -- per-peer receiver, bounded by world size; dies with its socket
            threading.Thread(target=self._recv_loop, args=(conn,),
                             daemon=True).start()

    def _recv_loop(self, conn: socket.socket):
        try:
            while True:
                head = _recv_exact(conn, _HDR.size)
                kind, src, epoch, seq, length = _HDR.unpack(head)
                if length > wire.MAX_FRAME:
                    raise ConnectionError(
                        f"oversized shuffle frame ({length} bytes)")
                payload = _recv_exact(conn, length) if length else b""
                stat_add("trainer.fleet.shuffle_rx_bytes",
                         float(_HDR.size + length))
                if kind == _MSG_BLOCK:
                    with self._done_cv:
                        seen = self._peer_seen.setdefault(src, [-1, -1])
                        if epoch > seen[0]:
                            seen[0], seen[1] = epoch, -1
                        if epoch < seen[0] or seq <= seen[1]:
                            stat_add("trainer.fleet.shuffle_rx_dup")
                            continue        # replayed frame already seen
                        seen[1] = seq
                    blk = block_from_wire(payload)
                    with self._done_cv:
                        self._pending.setdefault(epoch, []).append(blk)
                elif kind == _MSG_DONE:
                    with self._done_cv:
                        self._done_from.setdefault(epoch, set()).add(src)
                        self._done_cv.notify_all()
                elif kind == _MSG_RESYNC:
                    self._replay_for(src, epoch)
        except (ConnectionError, OSError):
            return
        except wire.DecodeError as e:
            # a corrupt frame means lost records — poison the barrier so
            # the pass FAILS loudly instead of hanging or training short
            with self._done_cv:
                lockdep.guards(self, "_rx_error")
                self._rx_error = e
                self._done_cv.notify_all()
            return

    def _conn_to(self, dst: int) -> socket.socket:
        """One dial attempt (registry-cached).  Callers needing liveness
        guarantees go through the _tx_frame reconnect loop instead."""
        with self._conn_lock:
            if self._closed:
                raise ConnectionError("transport closed")
            sock = self._conns.get(dst)
        if sock is not None:
            return sock
        # dial OUTSIDE the lock; on a connect race the loser's socket
        # closes and everyone converges on the registered one
        s = socket.create_connection(self._addrs[dst],
                                     timeout=self._deadline_s())
        with self._conn_lock:
            cur = self._conns.setdefault(dst, s)
        if cur is not s:
            try:
                s.close()
            except OSError:
                pass
        return cur

    def _drop_conn(self, dst: int) -> None:
        with self._conn_lock:
            sock = self._conns.pop(dst, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _send_lock(self, dst: int) -> threading.Lock:
        with self._conn_lock:
            lk = self._send_locks.get(dst)
            if lk is None:
                lk = self._send_locks[dst] = lockdep.lock(
                    "data.shuffle_transport.TcpShuffleTransport._send_locks")
            return lk

    # -- send side -----------------------------------------------------------
    def _sendall(self, dst: int, frame: bytes) -> None:
        sock = self._conn_to(dst)
        t0 = time.monotonic()
        sock.sendall(frame)
        stat_observe("trainer.fleet.shuffle_s", time.monotonic() - t0)
        stat_add("trainer.fleet.shuffle_tx_bytes", float(len(frame)))

    def _tx_frame(self, dst: int, kind: int, epoch: int, seq: int,
                  payload: bytes) -> None:
        """Deliver one frame, reconnect-and-replay on failure.  Caller
        holds the dst send lock.  A BLOCK/DONE frame must already be in
        the epoch buffer (the replay is what re-delivers it)."""
        frame = _HDR.pack(kind, self._rank, epoch, seq,
                          len(payload)) + payload
        try:
            self._sendall(dst, frame)
            return
        except (ConnectionError, OSError):
            self._drop_conn(dst)
        bo = Backoff(base=0.05, cap=1.0, deadline=self._deadline_s())
        attempt = 0
        while True:
            attempt += 1
            stat_add("trainer.fleet.shuffle_reconnects")
            try:
                # idempotent window replay: resend every buffered frame
                # of this epoch in order (receiver watermark drops what
                # already landed), then DONE if it was already signalled
                for s, pl in self._sent.get((dst, epoch), []):
                    self._sendall(dst, _HDR.pack(_MSG_BLOCK, self._rank,
                                                 epoch, s, len(pl)) + pl)
                if self._done_sent.get((dst, epoch)):
                    self._sendall(dst, _HDR.pack(_MSG_DONE, self._rank,
                                                 epoch, 0, 0))
                if kind == _MSG_RESYNC:
                    self._sendall(dst, frame)
                return
            except (ConnectionError, OSError) as e:
                self._drop_conn(dst)
                if not bo.sleep(attempt):
                    raise ShufflePeerDead(
                        f"shuffle peer {dst} unreachable past "
                        f"{self._deadline_s():.0f}s deadline") from e

    def _replay_for(self, dst: int, epoch: int) -> None:
        """RESYNC handler: re-deliver the requested epoch's buffered
        frames to a restarted peer (runs on the recv thread; outbound
        socket, so no interference with this conn)."""
        with self._send_lock(dst):
            frames = list(self._sent.get((dst, epoch), []))
            done = bool(self._done_sent.get((dst, epoch)))
            if not frames and not done:
                return
            # a RESYNC means the requester restarted, so any cached
            # outbound conn predates its current incarnation — drop it
            # and redial its (fresh) listener instead of writing frames
            # into a half-dead socket's buffer
            self._drop_conn(dst)
            bo = Backoff(base=0.05, cap=1.0, deadline=5.0)
            attempt = 0
            while True:
                try:
                    for s, pl in frames:
                        self._sendall(dst, _HDR.pack(
                            _MSG_BLOCK, self._rank, epoch, s, len(pl)) + pl)
                    if done:
                        self._sendall(dst, _HDR.pack(
                            _MSG_DONE, self._rank, epoch, 0, 0))
                    break
                except (ConnectionError, OSError):
                    self._drop_conn(dst)
                    attempt += 1
                    if not bo.sleep(attempt):
                        # give up without poisoning anything: the peer's
                        # barrier re-sends RESYNC while DONEs are missing
                        return
        stat_add("trainer.fleet.shuffle_resync_replays")

    # ------------------------------------------------------------------
    def send(self, dst: int, block: SlotRecordBlock) -> None:
        payload = block_to_wire(block)
        with self._send_lock(dst):
            epoch = self._epoch
            seq = self._seq.get((dst, epoch), 0)
            # pboxlint: disable-next=PB102 -- keys are (dst, ...)-partitioned; the per-dst send lock held above guards them
            self._seq[(dst, epoch)] = seq + 1
            # pboxlint: disable-next=PB102 -- per-dst send lock held (partitioned state)
            self._sent.setdefault((dst, epoch), []).append((seq, payload))
            self._tx_frame(dst, _MSG_BLOCK, epoch, seq, payload)

    def barrier(self) -> None:
        """Signal DONE to every peer, then wait for every peer's DONE
        (≙ PaddleShuffler wait_done) — bounded by
        FLAGS_shuffle_deadline_s, raising ShufflePeerDead past it."""
        t0 = time.monotonic()
        deadline = t0 + self._deadline_s()
        epoch = self._epoch
        for dst in range(self._world):
            if dst == self._rank:
                continue
            with self._send_lock(dst):
                self._done_sent[(dst, epoch)] = True
                self._tx_frame(dst, _MSG_DONE, epoch, 0, b"")
        last_nudge = t0
        while True:
            with self._done_cv:
                if self._rx_error is not None:
                    raise RuntimeError(
                        "shuffle receive failed — records lost"
                    ) from self._rx_error
                missing = sorted(
                    set(range(self._world)) - {self._rank}
                    - self._done_from.get(epoch, set()))
                resynced = epoch in self._resync_epochs
            if not missing:
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise ShufflePeerDead(
                    f"shuffle barrier timed out after "
                    f"{self._deadline_s():.0f}s (no DONE from ranks "
                    f"{missing})")
            if resynced and time.monotonic() - last_nudge >= 2.0:
                # we are a restarted rank: a peer may have replayed its
                # window into our DEAD predecessor (or the replay itself
                # raced our rebind) — keep asking until the DONE lands
                last_nudge = time.monotonic()
                for dst in missing:
                    with self._send_lock(dst):
                        try:
                            self._tx_frame(dst, _MSG_RESYNC, epoch, 0, b"")
                        except (ConnectionError, OSError):
                            pass    # peer mid-restart; next nudge retries
            with self._done_cv:
                if (self._rx_error is None
                        and len(self._done_from.get(epoch, ()))
                        < self._world - 1):
                    self._done_cv.wait(timeout=min(left, 1.0))
        stat_observe("trainer.fleet.barrier_wait_s",
                     time.monotonic() - t0)
        if not self._explicit_epoch:
            # legacy (epoch-less) callers: nobody will resync off this
            # round once the barrier released everyone — GC the window
            # (seq counters keep growing so the watermark stays sound)
            with self._done_cv:
                self._done_from.pop(epoch, None)
            for dst in range(self._world):
                if dst == self._rank:
                    continue
                with self._send_lock(dst):
                    # pboxlint: disable-next=PB102 -- keys are (dst, ...)-partitioned; the per-dst send lock held above guards them
                    self._sent.pop((dst, epoch), None)
                    # pboxlint: disable-next=PB102 -- per-dst send lock held (partitioned state)
                    self._done_sent.pop((dst, epoch), None)

    def drain(self) -> List[SlotRecordBlock]:
        with self._done_cv:
            if self._rx_error is not None:
                raise RuntimeError("shuffle receive failed — records lost"
                                   ) from self._rx_error
            return self._pending.pop(self._epoch, [])

    def close(self) -> None:
        with self._conn_lock:
            self._closed = True
        with self._conn_lock:
            conns = list(self._conns.values()) + self._accepted
            self._conns.clear()
            self._accepted = []
        # shutdown() BEFORE close(), listener included: close() alone
        # cannot release a socket another thread is blocked in
        # accept()/recv() on (the in-flight syscall pins the kernel
        # socket, so the listen port stays occupied and a
        # supervisor-restarted SAME-PROCESS rank could never rebind it).
        # shutdown(SHUT_RDWR) wakes those syscalls, then close() frees.
        for s in [self._listener] + conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
