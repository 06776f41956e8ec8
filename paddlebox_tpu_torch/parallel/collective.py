"""Collectives: the named-axis device half and the trainer fleet's
host half.

Port of ``paddlebox_tpu/parallel/collective.py``.

The named-axis half (≙ distributed/collective/ProcessGroup.h:53-190
AllReduce/AllGather/AllToAll/ReduceScatter/Send/Recv) works on a
topology's shards from one controller: each function takes the list of
per-shard tensors (indexed by flat shard number, see
``parallel/topology.py``) and an axis name, or a tuple of them, and
returns the per-shard results.  Where the JAX package calls ``lax.psum``
inside ``shard_map``, the port calls ``all_reduce(xs, topo, axis)``
over the list.  Every reduction adds the group's tensors one after the
other in shard order — no atomics, the same bits on every run.  Every
member's result is a tensor of its own on the member's device: no two
members share one, so an in-place write through one never reaches
another.  Between devices a value moves by ``topology.move`` (a peer
copy between cards; a blocking copy into host memory).  Where a group
spans processes (a topology whose dp axis is a ``torch.distributed``
group), each member's share crosses through host memory, and each rank
is sent only the parts its members need (:func:`route`: one
``torch.distributed.all_to_all_single`` of self-describing byte
buffers).  Every reduction is folded on the receiving member's device in
shard order, so every rank gets the bits one process holding the whole
group would.  The reference's P2P walk paths (heter_comm.h:303) map to
:func:`ppermute`; its MoE global_scatter/global_gather to
:func:`all_to_all`.  torch is imported inside these functions only, so
the host half stays torch-free.

The host half (:class:`FleetCollective` — ≙ GlooWrapper/boxps::
MPICluster): barriers and dense-state reduction between trainer ranks
(threads or processes), riding the PS tier's rid-dedup'd barrier/dense
verbs so every operation is replay-safe across a trainer crash +
supervisor restart.  PB604 discipline applies here the same as to locks:
every wait carries a deadline, and expiry raises the typed
:class:`PeerDead` instead of hanging the fleet.  Host code only (numpy
over a PSClient; no torch).
"""

from __future__ import annotations

import time
from typing import (TYPE_CHECKING, Callable, Dict, List,
                    Optional, Sequence, Tuple, Union)

import numpy as np

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe

if TYPE_CHECKING:     # torch-free at import (see the module note)
    import torch
    from paddlebox_tpu_torch.parallel.topology import HybridTopology

flags.define_flag(
    "fleet_deadline_s", 180.0,
    "total budget for any one trainer-fleet collective wait (barrier / "
    "dense fold); a peer absent past this raises PeerDead — sized to "
    "ride out one supervisor restart (backoff + resume replay)")


class PeerDead(ConnectionError):
    """A fleet peer stayed absent from a collective past the deadline."""


def namespaced_group(base: str, rank: Optional[int], tail: str) -> str:
    """Sanctioned rid-group constructor for fleet/trainer code (pboxlint
    PB806): ``<base>.t<rank>:<tail>``.  The text before the colon is the
    server dedup window's token, so all of one trainer's chunk rids share
    one window — and distinct ranks NEVER share one, which is what makes
    per-trainer replay exactly-once (rank r's re-driven chunks can only
    dedup against rank r's own landed chunks).

    ``rank=None`` is the leader-lifecycle namespace (``<base>:<tail>``):
    verbs that must be exactly-once across a leader FAILOVER (end_day)
    pin one group independent of which rank drives them.
    """
    tok = base if rank is None else f"{base}.t{rank}"
    return f"{tok}:{tail}"


class FleetCollective:
    """Replay-safe barriers + deterministic dense reduction for the
    trainer fleet, over a PSClient.

    Every barrier rid is deterministic in (rank, tag) — a restarted
    trainer re-driving its pass replays the SAME rids, so barriers it
    already joined answer from the dedup window and barriers the fleet
    is still waiting on get its registration exactly once.  Calls retry
    under FLAGS_fleet_deadline_s (riding out a peer's supervisor
    restart), with an optional ``poke`` callback between attempts — the
    runner's leader-duty hook, so a rank waiting on a dead leader can
    take over its lifecycle work instead of deadlocking.
    """

    def __init__(self, client, rank: int, world: int,
                 namespace: str = "fleet",
                 deadline_s: Optional[float] = None):
        self.client = client
        self.rank = int(rank)
        self.world = int(world)
        self.namespace = namespace
        self.deadline_s = (float(flags.get_flags("fleet_deadline_s"))
                           if deadline_s is None else float(deadline_s))

    def _rid(self, kind: str, tag: str) -> str:
        return namespaced_group(self.namespace, self.rank,
                                f"{kind}.{tag}")

    def _retry(self, tag: str, fn: Callable[[], None],
               poke: Optional[Callable[[], None]]) -> None:
        deadline = time.monotonic() + self.deadline_s
        while True:
            try:
                fn()
                return
            except ConnectionError:
                pass
            except RuntimeError as e:
                # the PS barrier window rolled back (a peer absent for
                # its 60s wait) — same remedy as a dropped connection:
                # re-drive the SAME rid until the fleet deadline
                if "timeout" not in str(e) and "timed out" not in str(e):
                    raise
            if time.monotonic() >= deadline:
                raise PeerDead(
                    f"fleet collective {tag!r} incomplete after "
                    f"{self.deadline_s:.0f}s — a peer is gone past the "
                    f"restart budget")
            stat_add("trainer.fleet.collective_retries")
            if poke is not None:
                poke()

    def barrier(self, tag: str, timeout: float = 20.0,
                poke: Optional[Callable[[], None]] = None) -> None:
        """Fleet-wide barrier named by ``tag`` (deterministic rid —
        replayable).  All ranks must pass the same sequence of barriers
        (the PS barrier is generation-matched by arrival order)."""
        t0 = time.monotonic()
        self._retry(tag, lambda: self.client.barrier(
            self.world, timeout=timeout, rid=self._rid("bar", tag)), poke)
        stat_observe("trainer.fleet.barrier_wait_s",
                     time.monotonic() - t0)

    def allreduce(self, arrs: Dict[str, np.ndarray], tag: str,
                  timeout: float = 20.0,
                  poke: Optional[Callable[[], None]] = None
                  ) -> Dict[str, np.ndarray]:
        """Cross-rank sum via the PS allreduce verb, deadline-bounded and
        replay-safe (deterministic rid).  NOTE: the server folds
        contributions in ARRIVAL order — use only where fp association
        order doesn't matter (counters, diagnostics).  Bit-critical
        folds go through :meth:`reduce_slots`."""
        t0 = time.monotonic()
        out: List[Dict[str, np.ndarray]] = []
        self._retry(tag, lambda: out.append(self.client.allreduce(
            arrs, self.world, key=tag, timeout=timeout,
            rid=self._rid("ar", tag))), poke)
        stat_observe("trainer.fleet.allreduce_wait_s",
                     time.monotonic() - t0)
        return out[-1]

    def reduce_slots(self, prefix: str, mine: Dict[int, np.ndarray],
                     n_slots: int, tag: str,
                     poke: Optional[Callable[[], None]] = None
                     ) -> List[np.ndarray]:
        """Deterministic fleet reduction: each rank publishes its owned
        slots (absolute dense writes — idempotent under restart replay),
        a barrier fences publication, then EVERY rank reads all slots in
        slot order.  The caller folds in that fixed order, so the fp
        operation sequence is identical at any fleet size — the property
        the PS allreduce verb (arrival-order summation) cannot give.
        This is the fleet's dense-grad sync path."""
        t0 = time.monotonic()
        for v in sorted(mine):
            vec = np.asarray(mine[v])
            self._retry(f"{tag}.push.{v}",
                        lambda vec=vec, v=v: self.client.push_dense(
                            f"{prefix}.{v}", vec), poke)
        self.barrier(f"{tag}.fence", poke=poke)
        out: List[np.ndarray] = []
        for v in range(n_slots):
            got: List[np.ndarray] = []
            self._retry(f"{tag}.pull.{v}",
                        lambda v=v: got.append(self.client.pull_dense(
                            f"{prefix}.{v}")), poke)
            out.append(got[-1])
        stat_observe("trainer.fleet.allreduce_wait_s",
                     time.monotonic() - t0)
        return out


# ---------------------------------------------------------------------------
# named-axis collectives over a topology's shards
# ---------------------------------------------------------------------------

Axis = Union[str, Tuple[str, ...]]
Shards = List["torch.Tensor"]


def _groups(xs: Sequence, topo: "HybridTopology", axis: Axis
            ) -> List[List[int]]:
    """The groups of ``axis`` that hold a local shard."""
    if len(xs) != topo.world_size:
        raise ValueError(f"{len(xs)} per-shard values for a topology of "
                         f"{topo.world_size} shards")
    return [g for g in topo.axis_groups(axis)
            if any(topo.is_local(k) for k in g)]


def _rank_of(topo: "HybridTopology", shard: int) -> int:
    """The process (group rank) that holds ``shard``: its dp
    coordinate, when the dp axis spans processes."""
    return topo.axis_index(shard, "dp") if topo.spans_processes else 0


def _group(topo: "HybridTopology"):
    """The group the topology's shards cross over: None on one
    process, where nothing crosses."""
    return topo.process_group if topo.spans_processes else None


_DTYPES = ("float32", "bfloat16", "float16", "float64", "int64", "int32",
           "int16", "int8", "uint8", "bool")


def _pack(parts: Sequence[Optional["torch.Tensor"]]) -> "torch.Tensor":
    """``parts`` (tensors on any device, or None) as one host byte
    buffer: an int64 header (the count, then each part's dtype code, or
    -1 for None, its ndim and its shape), then each part's bytes, every
    piece padded to 8 bytes."""
    import torch
    head = [len(parts)]
    for x in parts:
        head += ([-1] if x is None else
                 [_DTYPES.index(str(x.dtype).split(".")[-1]), x.dim(),
                  *x.shape])
    sizes = [0 if x is None else x.numel() * x.element_size()
             for x in parts]
    off = 8 * len(head)
    buf = torch.zeros((off + sum(-(-n // 8) * 8 for n in sizes),),
                      dtype=torch.uint8)
    buf[:off].view(torch.int64).copy_(torch.tensor(head, dtype=torch.int64))
    for x, n in zip(parts, sizes):
        if x is not None:
            # one copy into host memory, straight into the buffer
            buf[off:off + n].view(x.dtype).copy_(x.detach().reshape(-1))
        off += -(-n // 8) * 8
    return buf


def _unpack(buf: "torch.Tensor") -> List[Optional["torch.Tensor"]]:
    """The parts :func:`_pack` put into ``buf``, as views of it."""
    import torch
    head = buf.view(torch.int64)
    i, parts, shapes = 1, [], []
    for _ in range(int(head[0])):
        code = int(head[i])
        if code < 0:
            shapes.append(None)
            i += 1
            continue
        ndim = int(head[i + 1])
        shapes.append((getattr(torch, _DTYPES[code]),
                       [int(d) for d in head[i + 2:i + 2 + ndim]]))
        i += 2 + ndim
    off = 8 * i
    for sh in shapes:
        if sh is None:
            parts.append(None)
            continue
        dtype, shape = sh
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        parts.append(buf[off:off + n].view(dtype).reshape(shape))
        off += -(-n // 8) * 8
    return parts


def route(group, items, value: Callable, kind: str) -> Dict:
    """The parts of an operation that cross processes, by key.
    ``items`` lists (key, source rank, destination rank) of every part,
    in the same order on every rank of ``group``; with ``group`` None
    (one process) nothing crosses and it is not read.  ``value(key)`` is
    the part (a tensor on any device, or None) where this rank is its
    source.  Each part whose ranks differ goes from its source to its
    destination alone, in one collective: two
    ``torch.distributed.all_to_all_single`` rounds of host byte buffers,
    the byte counts and then the buffers, each describing its parts
    (:func:`_pack`); none when no part crosses, which every rank sees
    alike.  Returns {key: host tensor, or None} of the parts this rank
    receives.  Nothing is summed here: the callers fold in a fixed order,
    so every rank computes the bits of one process holding the whole
    group (a ring all-reduce would add in an order that depends on the
    rank).  Counts ``parallel.xproc.<kind>.tx_bytes`` (the bytes this
    rank sends) and ``parallel.xproc.exchange_s``."""
    if group is None:
        return {}
    cross = [(key, s, d) for key, s, d in items if s != d]
    if not cross:
        return {}
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    me = dist.get_rank(group)
    send: List[list] = [[] for _ in range(dist.get_world_size(group))]
    for key, s, d in cross:
        if s == me:
            send[d].append(value(key))
    segs = [_pack(p) if p else torch.zeros((0,), dtype=torch.uint8)
            for p in send]
    send_n = torch.tensor([x.numel() for x in segs], dtype=torch.int64)
    recv_n = torch.empty_like(send_n)
    dist.all_to_all_single(recv_n, send_n, group=group)
    recv = torch.empty((int(recv_n.sum()),), dtype=torch.uint8)
    dist.all_to_all_single(recv, torch.cat(segs), recv_n.tolist(),
                           send_n.tolist(), group=group)
    got, off = {}, 0
    for r, n in enumerate(recv_n.tolist()):
        if n:
            got[r] = iter(_unpack(recv[off:off + n]))
        off += n
    out = {key: next(got[s]) for key, s, d in cross if d == me}
    stat_add(f"parallel.xproc.{kind}.tx_bytes", float(send_n.sum()))
    stat_add("parallel.xproc.exchange_s", time.perf_counter() - t0)
    return out


def fold_ranks(parts: Sequence[Sequence["torch.Tensor"]], device, group,
               kind: str) -> List["torch.Tensor"]:
    """Field i of every member's list ``parts[j]`` (this process's
    members in order; a None member, or field, sits out; a field no
    member has is None), summed on ``device`` in the order of the members
    of rank 0, then rank 1, ...: the device order of one process holding
    them all.  ``group`` None: this process's members only.  Across
    processes every rank has as many members and fields, each sent to
    every other rank (:func:`route`)."""
    live = [p for p in parts if p is not None]
    n = len(live[0])
    if group is not None:
        import torch.distributed as dist
        flat = [x for p in live for x in p]
        if any(x is None for x in flat):
            raise ValueError(f"fold_ranks({kind!r}): a member without a "
                             "value cannot cross processes")
        me, ranks = dist.get_rank(group), range(dist.get_world_size(group))
        got = route(group, (((r, i), r, d) for r in ranks
                            for i in range(len(flat)) for d in ranks),
                    lambda key: flat[key[1]], kind)
        every = [flat if r == me else [got[(r, i)] for i in range(len(flat))]
                 for r in ranks]
        live = [f[i:i + n] for f in every for i in range(0, len(f), n)]
    out = []
    for i in range(n):
        xs = [p[i] for p in live if p[i] is not None]
        out.append(_fold(xs, "sum", device) if xs else None)
    return out


def _members_elsewhere(xs: Sequence, topo: "HybridTopology", axis: Axis,
                       kind: str) -> Dict:
    """The members of ``axis``'s groups that other processes hold, by
    shard, as host tensors: each sent once to each other process that
    holds a member of its group (:func:`route`)."""
    def items():
        for g in topo.axis_groups(axis):
            ranks = sorted({_rank_of(topo, k) for k in g})
            for k in g:
                for r in ranks:
                    yield k, _rank_of(topo, k), r
    return route(_group(topo), items(), lambda k: xs[k], kind)


def _blocks_elsewhere(xs: Sequence, topo: "HybridTopology", axis: Axis,
                      dim: int, kind: str) -> Callable:
    """``parts(g, i)``: block i of ``dim`` (split over the group) of
    every member of ``axis`` group ``g``, in group order, for its member
    i, which this process holds.  Another process's member's block is
    received, sent to member i's process alone (:func:`route`); each
    member is chunked once."""
    n = topo.axis_size(axis)
    chunks: Dict[int, tuple] = {}

    def chunk(j, i):
        if j not in chunks:
            chunks[j] = xs[j].chunk(n, dim=dim)
        return chunks[j][i]
    got = route(_group(topo), (
        ((j, i, k), _rank_of(topo, j), _rank_of(topo, k))
        for g in topo.axis_groups(axis) for i, k in enumerate(g)
        for j in g), lambda key: chunk(key[0], key[1]), kind)
    return lambda g, i: [got[(j, i, g[i])] if (j, i, g[i]) in got
                         else chunk(j, i) for j in g]


def _on(x: "torch.Tensor", device, copy: bool = False) -> "torch.Tensor":
    from paddlebox_tpu_torch.parallel.topology import on_device
    return on_device(x, device, copy)


def _one_device(topo: "HybridTopology", group: Sequence[int]) -> bool:
    from paddlebox_tpu_torch.parallel.topology import device_key
    return len({device_key(topo.devices[k]) for k in group}) == 1


def _fold(parts: Sequence["torch.Tensor"], op: str, device
          ) -> "torch.Tensor":
    """The parts combined one after the other, in order, on ``device``
    (a new tensor)."""
    acc = _on(parts[0], device, copy=True)
    for x in parts[1:]:
        x = _on(x, device)
        if op == "max":
            acc = acc.maximum(x)
        elif op == "min":
            acc = acc.minimum(x)
        else:
            acc = acc + x
    return acc


def all_reduce(xs: Shards, topo: "HybridTopology", axis: Axis,
               op: str = "sum") -> Shards:
    """≙ lax.psum / pmax / pmin / pmean over ``axis``: the group's fold
    in shard order on its first local member's device, copied to the
    other local members.  A group that spans processes folds the other
    processes' members too, received through host memory
    (:func:`route`), so every rank computes the same bits as one process
    holding the whole group."""
    if op not in ("sum", "max", "min", "mean"):
        raise ValueError(f"unsupported all_reduce op: {op}")
    out = [None] * len(xs)
    groups = _groups(xs, topo, axis)
    other = _members_elsewhere(xs, topo, axis, f"all_reduce_{op}")
    for g in groups:
        local = [k for k in g if topo.is_local(k)]
        acc = _fold([other.get(k, xs[k]) for k in g], op,
                    topo.devices[local[0]])
        if op == "mean":
            acc = acc / len(g)
        out[local[0]] = acc
        for k in local[1:]:
            out[k] = _on(acc, topo.devices[k], copy=True)
    return out


def all_gather(xs: Shards, topo: "HybridTopology", axis: Axis, *,
               concat_dim: int = 0, tiled: bool = True) -> Shards:
    """≙ lax.all_gather: the group's tensors in axis order, concatenated
    along ``concat_dim`` (tiled) or stacked on a new dim there, built on
    each local member's device (the other processes' members received
    through host memory, as in :func:`all_reduce`)."""
    import torch
    from paddlebox_tpu_torch.parallel.topology import (device_key,
                                                       physical_device)
    out = [None] * len(xs)
    groups = _groups(xs, topo, axis)
    other = _members_elsewhere(xs, topo, axis, "all_gather")
    for g in groups:
        made = {}
        for k in g:
            if not topo.is_local(k):
                continue
            dev = topo.devices[k]
            key = device_key(physical_device(dev))
            if key in made:
                out[k] = made[key].clone()
                continue
            parts = [_on(other.get(j, xs[j]), dev) for j in g]
            made[key] = out[k] = (torch.cat(parts, dim=concat_dim) if tiled
                                  else torch.stack(parts, dim=concat_dim))
    return out


def all_to_all(xs: Shards, topo: "HybridTopology", axis: Axis, *,
               split_dim: int = 0, concat_dim: int = 0,
               tiled: bool = True) -> Shards:
    """≙ lax.all_to_all (tiled): member i receives chunk i of every
    member's ``split_dim``, concatenated along ``concat_dim`` in axis
    order (another process's chunks sent to it alone, :func:`route`)."""
    import torch
    if not tiled:
        raise ValueError("all_to_all: only the tiled form is ported")
    out = [None] * len(xs)
    groups = _groups(xs, topo, axis)
    parts = _blocks_elsewhere(xs, topo, axis, split_dim, "all_to_all")
    for g in groups:
        for i, k in enumerate(g):
            if topo.is_local(k):
                out[k] = torch.cat([_on(p, topo.devices[k])
                                    for p in parts(g, i)], dim=concat_dim)
    return out


def reduce_scatter(xs: Shards, topo: "HybridTopology", axis: Axis, *,
                   scatter_dim: int = 0) -> Shards:
    """≙ lax.psum_scatter (tiled): the group's sum, in shard order, and
    member i keeps block i of ``scatter_dim``.  On one device that is a
    view of one sum (the members' blocks do not overlap); across devices
    member i folds block i of every member on its own device, another
    process's blocks sent to it alone (:func:`route`)."""
    out = [None] * len(xs)
    groups = _groups(xs, topo, axis)
    for g in groups:
        size = xs[next(k for k in g if topo.is_local(k))].shape[scatter_dim]
        if size % len(g):
            raise ValueError(
                f"reduce_scatter: dim {scatter_dim} of size "
                f"{size} does not split over {len(g)} shards")
    parts = _blocks_elsewhere(xs, topo, axis, scatter_dim, "reduce_scatter")
    for g in groups:
        if all(topo.is_local(k) for k in g) and _one_device(topo, g):
            total = _fold([xs[k] for k in g], "sum", topo.devices[g[0]])
            for i, part in enumerate(total.chunk(len(g), dim=scatter_dim)):
                out[g[i]] = part
            continue
        for i, k in enumerate(g):
            if topo.is_local(k):
                out[k] = _fold(parts(g, i), "sum", topo.devices[k])
    return out


def gather_onto(xs: Shards, srcs: Sequence, dsts: Sequence,
                dim: int = 0) -> Shards:
    """≙ an all-gather between explicit placements: ``xs[i]`` lives on
    ``srcs[i]``, and each of ``dsts`` receives the ``xs`` concatenated
    in order along ``dim`` on its device (the parts it does not hold
    copied there).  Destinations on one device share the result."""
    import torch
    from paddlebox_tpu_torch.parallel.topology import device_key, transfer
    made, out = {}, []
    for dst in dsts:
        key = device_key(dst)
        if key not in made:
            made[key] = torch.cat([transfer(x, s, dst)
                                   for x, s in zip(xs, srcs)], dim=dim)
        out.append(made[key])
    return out


def gather_onto_shards(xs: Shards, srcs: Sequence[int],
                       dsts: Sequence[int], topo: "HybridTopology",
                       dim: int = 0) -> Shards:
    """:func:`gather_onto` between shards of ``topo``: ``xs[i]`` is
    shard ``srcs[i]``'s part (None where another process holds it), and
    each destination shard this process holds receives every part
    concatenated in order along ``dim``; another process's destination
    gets None.  Each part crosses once to each process that has a
    destination and lacks it (:func:`route`); every rank passes the same
    ``srcs`` and ``dsts``."""
    ranks = sorted({_rank_of(topo, k) for k in dsts})
    got = route(_group(topo), ((i, _rank_of(topo, k), r)
                               for i, k in enumerate(srcs) for r in ranks),
                lambda i: xs[i], "gather_onto")
    here = [k for k in dsts if topo.is_local(k)]
    whole = iter(gather_onto(
        [got.get(i, x) for i, x in enumerate(xs)],
        [got[i].device if i in got else topo.devices[k]
         for i, k in enumerate(srcs)],
        [topo.devices[k] for k in here], dim))
    return [next(whole) if topo.is_local(k) else None for k in dsts]


def reduce_scatter_onto_shards(xs: Shards, srcs: Sequence[Sequence[int]],
                               dsts: Sequence[int], topo: "HybridTopology",
                               dim: Optional[int] = 0) -> Shards:
    """≙ psum_scatter between shards of ``topo``: ``xs[i]`` splits into
    ``len(dsts)`` equal blocks along ``dim``, and destination j receives
    block j of every ``xs[i]`` summed in the order of i, on its own
    device (a fixed order, no atomics).  ``srcs[i]`` names the shards
    that hold ``xs[i]``, replicas of one value, one a process at most;
    ``xs[i]`` is this process's replica (None where it holds none).
    Destination j reads block j of ``xs[i]`` from the replica on its own
    process where there is one, else from the first, which sends it to
    j's process alone (:func:`route`).  ``dim`` None: no split, every
    destination sums the whole ``xs`` (one each process, as a step's
    pulled parts are summed on every rank).  Another process's
    destination gets None; every rank passes the same ``srcs`` and
    ``dsts``."""
    from paddlebox_tpu_torch.parallel.topology import transfer
    n = 1 if dim is None else len(dsts)
    size = next(x for x in xs if x is not None).shape[dim or 0]
    if size % n:
        raise ValueError(f"reduce_scatter_onto: dim {dim} of size {size} "
                         f"does not split over {n} destinations")
    drank = [_rank_of(topo, k) for k in dsts]

    def src(i, j):                  # the replica destination j reads
        return next((k for k in srcs[i] if _rank_of(topo, k) == drank[j]),
                    srcs[i][0])
    chunks = [None if x is None else
              [x] * len(dsts) if dim is None else x.chunk(n, dim=dim)
              for x in xs]
    got = route(_group(topo), (((i, j), _rank_of(topo, src(i, j)), drank[j])
                               for i in range(len(xs))
                               for j in range(len(dsts))),
                lambda key: chunks[key[0]][key[1]], "reduce_scatter_onto")
    out = []
    for j, k in enumerate(dsts):
        if not topo.is_local(k):
            out.append(None)
            continue
        dst, acc = topo.devices[k], None
        for i in range(len(xs)):
            part = (_on(got[(i, j)], dst) if (i, j) in got
                    else transfer(chunks[i][j], topo.devices[src(i, j)], dst))
            acc = part.clone() if acc is None else acc + part
        out.append(acc)
    return out


def ppermute(xs: Shards, topo: "HybridTopology", axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> Shards:
    """≙ lax.ppermute: (src, dst) pairs of axis positions; a member that
    no pair sends to receives zeros.  A member may hold None (a pipeline
    stage with no microbatch at a tick): None is moved like a value.
    What a member receives is a copy on its own device (from another
    process, sent to it alone: :func:`route`)."""
    out = [None] * len(xs)
    other = route(_group(topo), (((g[src], g[dst]), _rank_of(topo, g[src]),
                                  _rank_of(topo, g[dst]))
                                 for g in topo.axis_groups(axis)
                                 for src, dst in perm),
                  lambda key: xs[key[0]], "ppermute")
    for g in _groups(xs, topo, axis):
        sent = set()
        for src, dst in perm:
            sent.add(dst)
            if not topo.is_local(g[dst]):
                continue
            key = (g[src], g[dst])
            x = other[key] if key in other else xs[g[src]]
            out[g[dst]] = (None if x is None
                           else _on(x, topo.devices[g[dst]], copy=True))
        for i, k in enumerate(g):
            if i not in sent and topo.is_local(k) and xs[k] is not None:
                out[k] = xs[k].new_zeros(xs[k].shape)
    return out


def axis_index(topo: "HybridTopology", axis: Axis) -> List[int]:
    """≙ lax.axis_index: each shard's position along ``axis``."""
    return [topo.axis_index(k, axis) for k in range(topo.world_size)]


def shift_right(xs: Shards, topo: "HybridTopology", axis: str,
                axis_size: Optional[int] = None) -> Shards:
    """Ring shift: position i sends to i+1 (mod n) — the building block
    of ring attention / pipelined CP."""
    n = topo.axis_size(axis) if axis_size is None else axis_size
    return ppermute(xs, topo, axis, [(i, (i + 1) % n) for i in range(n)])


def shard_mapped(topo: "HybridTopology", in_specs, out_specs):
    """≙ shard_map over the topology: the decorated ``fn`` takes, per
    argument, the list of per-shard blocks (``topo.split`` by its spec)
    and returns per-shard lists (one, or a tuple of them), which are
    joined by ``out_specs`` (one Spec, or a tuple of them) into global
    tensors.  ``fn`` calls the
    collectives above on those lists."""
    from paddlebox_tpu_torch.parallel.topology import Spec
    single = isinstance(out_specs, Spec)

    def wrap(fn):
        def run(*args):
            if len(args) != len(in_specs):
                raise ValueError(f"{len(args)} arguments for "
                                 f"{len(in_specs)} in_specs")
            outs = fn(*[topo.split(a, s) for a, s in zip(args, in_specs)])
            if single:
                return topo.join(outs, out_specs)
            return tuple(topo.join(o, s) for o, s in zip(outs, out_specs))
        return run
    return wrap
