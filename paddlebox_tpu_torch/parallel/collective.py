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
copy between cards; a blocking copy into host memory).  The reference's P2P walk paths (heter_comm.h:303) map to
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


def _groups(xs: Sequence, topo: "HybridTopology", axis: Axis):
    if len(xs) != topo.world_size:
        raise ValueError(f"{len(xs)} per-shard values for a topology of "
                         f"{topo.world_size} shards")
    return topo.axis_groups(axis)


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
    in shard order on its first member's device, copied to the others."""
    if op not in ("sum", "max", "min", "mean"):
        raise ValueError(f"unsupported all_reduce op: {op}")
    out = [None] * len(xs)
    for g in _groups(xs, topo, axis):
        acc = _fold([xs[k] for k in g], op, topo.devices[g[0]])
        if op == "mean":
            acc = acc / len(g)
        out[g[0]] = acc
        for k in g[1:]:
            out[k] = _on(acc, topo.devices[k], copy=True)
    return out


def all_gather(xs: Shards, topo: "HybridTopology", axis: Axis, *,
               concat_dim: int = 0, tiled: bool = True) -> Shards:
    """≙ lax.all_gather: the group's tensors in axis order, concatenated
    along ``concat_dim`` (tiled) or stacked on a new dim there, built on
    each member's device."""
    import torch
    from paddlebox_tpu_torch.parallel.topology import (device_key,
                                                       physical_device)
    out = [None] * len(xs)
    for g in _groups(xs, topo, axis):
        made = {}
        for k in g:
            dev = topo.devices[k]
            key = device_key(physical_device(dev))
            if key in made:
                out[k] = made[key].clone()
                continue
            parts = [_on(xs[j], dev) for j in g]
            made[key] = out[k] = (torch.cat(parts, dim=concat_dim) if tiled
                                  else torch.stack(parts, dim=concat_dim))
    return out


def all_to_all(xs: Shards, topo: "HybridTopology", axis: Axis, *,
               split_dim: int = 0, concat_dim: int = 0,
               tiled: bool = True) -> Shards:
    """≙ lax.all_to_all (tiled): member i receives chunk i of every
    member's ``split_dim``, concatenated along ``concat_dim`` in axis
    order."""
    import torch
    if not tiled:
        raise ValueError("all_to_all: only the tiled form is ported")
    out = [None] * len(xs)
    for g in _groups(xs, topo, axis):
        n = len(g)
        chunks = [xs[k].chunk(n, dim=split_dim) for k in g]
        for i, k in enumerate(g):
            out[k] = torch.cat([_on(c[i], topo.devices[k]) for c in chunks],
                               dim=concat_dim)
    return out


def reduce_scatter(xs: Shards, topo: "HybridTopology", axis: Axis, *,
                   scatter_dim: int = 0) -> Shards:
    """≙ lax.psum_scatter (tiled): the group's sum, in shard order, and
    member i keeps block i of ``scatter_dim``.  On one device that is a
    view of one sum (the members' blocks do not overlap); across devices
    member i folds block i of every member on its own device."""
    out = [None] * len(xs)
    for g in _groups(xs, topo, axis):
        size = xs[g[0]].shape[scatter_dim]
        if size % len(g):
            raise ValueError(
                f"reduce_scatter: dim {scatter_dim} of size "
                f"{size} does not split over {len(g)} shards")
        if _one_device(topo, g):
            total = _fold([xs[k] for k in g], "sum", topo.devices[g[0]])
            for i, part in enumerate(total.chunk(len(g), dim=scatter_dim)):
                out[g[i]] = part
            continue
        chunks = [xs[k].chunk(len(g), dim=scatter_dim) for k in g]
        for i, k in enumerate(g):
            out[k] = _fold([c[i] for c in chunks], "sum", topo.devices[k])
    return out


def ppermute(xs: Shards, topo: "HybridTopology", axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> Shards:
    """≙ lax.ppermute: (src, dst) pairs of axis positions; a member that
    no pair sends to receives zeros.  A member may hold None (a pipeline
    stage with no microbatch at a tick): None is moved like a value.
    What a member receives is a copy on its own device."""
    out = [None] * len(xs)
    for g in _groups(xs, topo, axis):
        sent = set()
        for src, dst in perm:
            x = xs[g[src]]
            out[g[dst]] = (None if x is None
                           else _on(x, topo.devices[g[dst]], copy=True))
            sent.add(dst)
        for i, k in enumerate(g):
            if i not in sent and xs[k] is not None:
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
