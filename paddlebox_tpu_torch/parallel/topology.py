"""Hybrid-parallel topology: a mesh of logical shards.

Port of ``paddlebox_tpu/parallel/topology.py`` (≙ CommunicateTopology /
HybridCommunicateGroup, python/paddle/distributed/fleet/base/
topology.py:52,134).  The JAX package builds one ``jax.sharding.Mesh``
over devices and lets XLA place tensors by ``PartitionSpec``.  The port
keeps the single-controller shape of that program (and of HeterPS, one
process per node driving every card): a topology is a grid of logical
shards with the axes [dp, sharding, pp, mp, sp, ep], and one process
drives them all.  Sharded data is a list of per-shard tensors indexed by
the flat shard number; the collectives of ``parallel/collective.py`` are
explicit tensor ops over those lists in fixed shard order.

A :class:`Spec` plays the role of ``PartitionSpec``: one entry per
tensor dim, None (replicated), an axis name, or a tuple of axis names
(the dim is split over their product, the first axis major).  ``split``
gives each shard its block of a global tensor (views); ``join``
assembles per-shard blocks back.

The shards may sit on one device (``single_host_topology``, the
default) or on distinct devices named in an explicit device list, as a
node's cards are (HeterPS drives them from one process).  ``split``
places each block on its shard's device: a view where the block already
lives there, a copy otherwise (a peer copy between cards).  ``place``
keeps the blocks together as a :class:`Sharded` tensor, ≙ a ``jax.Array``
under a ``NamedSharding``.  Devices are told apart by type and ordinal, so
``cpu:0`` and ``cpu:1`` are two devices whose tensors both live in host
memory: the CPU rehearsal of a multi-card placement.  A ``Sharded`` field
of the working set also carries the per-block operations the lowerings
and the device cache use: its row blocks (``row_blocks``, ``locate``),
rows read from and written to the blocks that hold them with an explicit
copy between devices (``gather_rows``, ``scatter_rows``), and an
elementwise op run on each block where it lives (``map_blocks``).

The dp axis may cross processes, one process a node as in HeterPS and in
the JAX package's multi-host mesh (``jax.distributed.initialize``):
``HybridTopology(config, devices, process_group=group)`` over a
``torch.distributed`` group of dp ranks, where rank r holds the shards
whose dp coordinate is r (``local_shards``, on ``devices``).  The table
follows ``table_spec`` as on one process: on the reference's multi-node
layout (dp × sharding, both > 1) it is split within a process and
replicated across them, so every rank holds a whole replica; on every
other mesh its row blocks are split over dp too, so each rank holds its
own shards' rows only.  Remote shards have no device here: ``devices``
and every per-shard list hold None in their places, ``groups`` names the
local devices only, ``split`` / ``place`` / ``Sharded`` work on the local
blocks, and a ``join`` that needs another process's blocks receives them
over the group (a collective then: every rank calls it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddlebox_tpu_torch.config import MeshConfig
from paddlebox_tpu_torch.device import DeviceLike, resolve_device

AXES: Tuple[str, ...] = ("dp", "sharding", "pp", "mp", "sp", "ep")

AxisLike = Union[str, Tuple[str, ...]]


def device_key(device: DeviceLike) -> Tuple[str, Optional[int]]:
    """(type, ordinal) that tells placements apart: an index-less card is
    the current one; ``cpu``, ``cpu:0`` and ``cpu:1`` are three keys."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return ("cuda", torch.cuda.current_device())
    return (d.type, d.index)


def physical_device(device: DeviceLike) -> torch.device:
    """The device a tensor placed on ``device`` reports: host memory has
    no ordinals (``cpu:1`` → ``cpu``)."""
    d = torch.device(device)
    return torch.device("cpu") if d.type == "cpu" else d


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether tensors placed on ``a`` and on ``b`` share one memory."""
    return (device_key(physical_device(a))
            == device_key(physical_device(b)))


def move(t: torch.Tensor, device: DeviceLike) -> torch.Tensor:
    """``t`` as a new tensor on ``device``.  Between cards this is a peer
    copy that PyTorch orders after the source card's stream and before the
    destination's.  Into host memory it is blocking, so the host may read
    the result at once (a non-blocking copy out of a card would return a
    pinned tensor the card has not written yet)."""
    d = torch.device(device)
    if d.type == "cpu":
        return t.to(d, copy=True)
    return t.to(d, non_blocking=True, copy=True)


def on_device(t: torch.Tensor, device: DeviceLike, copy: bool = False
              ) -> torch.Tensor:
    """``t`` where it already lives in ``device``'s memory (with ``copy``,
    a clone of it), else moved there by :func:`move`."""
    if same_device(t.device, device):
        return t.clone() if copy else t
    return move(t, device)


def transfer(t: torch.Tensor, src: DeviceLike, dst: DeviceLike
             ) -> torch.Tensor:
    """``t``, placed on ``src``, as seen from ``dst``: itself where the
    two are one placement, else a copy on ``dst`` (:func:`move`; also
    between ``cpu:0`` and ``cpu:1``, which share one memory)."""
    if device_key(src) == device_key(dst):
        return t
    return move(t, dst)


class Spec(tuple):
    """Per-dim placement, ≙ ``jax.sharding.PartitionSpec``:
    ``Spec(None, ("dp", "sharding"))`` splits dim 1 over dp × sharding
    and replicates dim 0.  Trailing dims left out are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axes(axis: AxisLike) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


CROSS_PROCESS_ITEM = "ROADMAP Queue 1 item 4.5"


class HybridTopology:
    """≙ HybridCommunicateGroup (topology.py:134) over logical shards.

    ``devices``: one device per local shard (flat shard order, ``dp``
    major); without it every shard takes ``resolve_device(device)`` —
    ``cuda`` unless the caller names the CPU.  ``process_group``: a
    ``torch.distributed`` group whose ranks are the dp coordinates (its
    size must be dp); this process then holds the shards of dp
    coordinate ``rank`` only.  Without it every shard is local."""

    def __init__(self, config: Optional[MeshConfig] = None,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 device: DeviceLike = None, process_group=None):
        self.config = config or MeshConfig()
        degrees = [self.config.degrees()[a] for a in AXES]
        world = int(np.prod(degrees))
        self._shape: Dict[str, int] = dict(zip(AXES, degrees))
        # flat shard index at each mesh coordinate (≙ Mesh.devices)
        self.grid = np.arange(world).reshape(degrees)
        self.process_group = process_group
        self.rank, self.nranks = 0, 1
        if process_group is not None:
            import torch.distributed as dist
            self.rank = dist.get_rank(process_group)
            self.nranks = dist.get_world_size(process_group)
            self._check_cross_process()
        # the shards this process holds: dp coordinate == rank
        self.local_shards: List[int] = self.shards_of(self.rank)
        if devices is None:
            devices = [resolve_device(device)] * len(self.local_shards)
        devices = [torch.device(d) for d in devices]
        if len(self.local_shards) != len(devices):
            raise ValueError(
                f"mesh degrees {dict(zip(AXES, degrees))} require "
                f"{len(self.local_shards)} devices"
                + (f" in each of {self.nranks} processes"
                   if self.nranks > 1 else "")
                + f", got {len(devices)}")
        for d in set(devices):
            resolve_device(d)
            if d.type == "cuda" and d.index is not None \
                    and d.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"{d} is not on this machine: it has "
                    f"{torch.cuda.device_count()} CUDA device(s)")
        # one entry a shard, None where another process holds it
        self.devices: List[Optional[torch.device]] = [None] * world
        for k, d in zip(self.local_shards, devices):
            self.devices[k] = d
        self.device: torch.device = devices[0]
        # the distinct local devices in the order they first appear in
        # flat shard order, and the shards each one holds
        self.groups: List[Tuple[torch.device, List[int]]] = []
        for k, d in zip(self.local_shards, devices):
            for dev, ks in self.groups:
                if device_key(dev) == device_key(d):
                    ks.append(k)
                    break
            else:
                self.groups.append((d, [k]))

    def _check_cross_process(self) -> None:
        """A dp axis over the group has one coordinate a rank."""
        dp = self.axis_size("dp")
        if dp != self.nranks:
            raise ValueError(
                f"a dp axis over a process group of {self.nranks} ranks "
                f"needs dp = {self.nranks}, got dp = {dp}")

    @property
    def multi_device(self) -> bool:
        """Whether the shards sit on more than one device (another
        process's count as others)."""
        return len(self.groups) > 1 or self.spans_processes

    @property
    def spans_processes(self) -> bool:
        """Whether some shards are held by another process."""
        return self.nranks > 1

    def is_local(self, shard: int) -> bool:
        """Whether this process holds ``shard``."""
        return self.devices[shard] is not None

    def refuse_cross_process(self, what: str, why: str = "") -> None:
        """Raise for ``what``, which is not carried across processes
        (``why``: the reason, appended to the message)."""
        if self.spans_processes:
            raise NotImplementedError(
                f"{what} over a dp axis that spans processes is "
                f"{CROSS_PROCESS_ITEM}" + (f": {why}" if why else ""))

    def device_of(self, shard: int) -> Optional[torch.device]:
        return self.devices[shard]

    def shards_of(self, rank: int) -> List[int]:
        """The shards process ``rank`` holds (its dp coordinate's)."""
        if self.nranks == 1:
            return list(range(self.world_size))
        return [int(k) for k in self.grid[rank].reshape(-1)]

    # -- ≙ CommunicateTopology.get_dim / get_rank_from_stage ----------------
    def axis_size(self, axis: AxisLike) -> int:
        n = 1
        for a in _axes(axis):
            n *= self._shape[a]
        return n

    @property
    def world_size(self) -> int:
        return int(self.grid.size)

    def coord(self, shard: int) -> Tuple[int, ...]:
        """Mesh coordinate of flat shard ``shard``, in AXES order."""
        return tuple(int(i) for i in np.unravel_index(shard,
                                                      self.grid.shape))

    def axis_index(self, shard: int, axis: AxisLike) -> int:
        """Position of ``shard`` along ``axis`` (a tuple: first axis
        major), ≙ ``lax.axis_index`` inside shard_map."""
        c = dict(zip(AXES, self.coord(shard)))
        idx = 0
        for a in _axes(axis):
            idx = idx * self._shape[a] + c[a]
        return idx

    def axis_groups(self, axis: AxisLike) -> List[List[int]]:
        """The shards that ``axis`` connects: one group per coordinate of
        the other axes (in flat order of their first member), each group
        ordered by :meth:`axis_index`."""
        names = _axes(axis)
        rest = [a for a in AXES if a not in names]
        order = [AXES.index(a) for a in rest + list(names)]
        g = np.transpose(self.grid, order)
        return [list(map(int, row))
                for row in g.reshape(-1, self.axis_size(names))]

    # -- standard layouts ---------------------------------------------------
    def batch_spec(self) -> Spec:
        """Batch dim split over the data-parallel-like axes."""
        return Spec(("dp", "sharding"))

    def table_spec(self) -> Spec:
        """Pass-working-set rows split over the non-pipeline axes in
        contiguous blocks — the analogue of HeterComm's
        ``key % device_count`` placement (heter_comm_inl.h:1117).  With
        both dp > 1 and sharding > 1 the layout flips to the reference's
        multi-node shape: split within a node (sharding), replicated
        across nodes (dp) — the layout gather_multi_node_grad assumes
        (heter_comm_inl.h:2131)."""
        if self.multinode_table():
            return Spec(("sharding", "mp", "sp", "ep"))
        return Spec(("dp", "sharding", "mp", "sp", "ep"))

    def multinode_table(self) -> bool:
        """Single source of the multi-node layout predicate (table_spec
        and the trainer's mxu_sharded step must agree): a pure
        dp × sharding mesh with both axes real."""
        return (self.axis_size("dp") > 1 and self.axis_size("sharding") > 1
                and all(self.axis_size(a) == 1
                        for a in ("pp", "mp", "sp", "ep")))

    def mp_spec(self, dim: int, ndim: int) -> Spec:
        """Tensor-parallel weight: dim ``dim`` of an ndim tensor split
        over mp (≙ Col/RowParallelLinear, mp_layers.py:95,171)."""
        spec = [None] * ndim
        spec[dim] = "mp"
        return Spec(*spec)

    def num_table_shards(self) -> int:
        return self.axis_size(("dp", "sharding", "mp", "sp", "ep"))

    # -- placement ----------------------------------------------------------
    def block(self, spec: Spec, shard: int, dim: int) -> Tuple[int, int]:
        """(block index, block count) of ``shard`` along ``dim``."""
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            return 0, 1
        return self.axis_index(shard, entry), self.axis_size(entry)

    def _slices(self, spec: Spec, shape, shard: int) -> Tuple[slice, ...]:
        out = []
        for dim, size in enumerate(shape):
            idx, n = self.block(spec, shard, dim)
            if size % n:
                raise ValueError(
                    f"dim {dim} of size {size} does not split over {n} "
                    f"shards ({spec})")
            step = size // n
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def split(self, x: torch.Tensor, spec: Spec, copy: bool = False
              ) -> List[Optional[torch.Tensor]]:
        """Each local shard's block of ``x`` under ``spec``, on the
        shard's device: a view of ``x`` where ``x`` lives on that device
        (with ``copy``, a copy there too), else a copy moved there; None
        for another process's shard.  Shards that hold the same block on
        one device get the same tensor."""
        src = device_key(x.device)
        out, made = [None] * self.world_size, {}
        for k in self.local_shards:
            sl = self._slices(spec, x.shape, k)
            key = (tuple((s.start, s.stop) for s in sl),
                   device_key(self.devices[k]))
            if key not in made:
                if key[1] == src:
                    made[key] = x[sl].clone() if copy else x[sl]
                else:
                    made[key] = move(x[sl], self.devices[k])
            out[k] = made[key]
        return out

    def place(self, x: torch.Tensor, spec: Spec) -> "Sharded":
        """``x`` held as copies of its shards' blocks, so no device keeps
        ``x``'s storage alive."""
        return Sharded(self.split(x, spec, copy=True), self, spec)

    def join(self, parts: Sequence[Optional[torch.Tensor]], spec: Spec,
             device: DeviceLike = None) -> torch.Tensor:
        """Assemble the local shards' blocks laid out by ``spec`` into the
        global tensor on ``device`` (default: the first block's).  Shards
        that hold the same block (replicated axes) must agree; the first
        in flat order is taken, as an out_spec that leaves an axis out
        takes any one replica.  Blocks that only other processes hold
        are received over the group, each from the process of its first
        shard and once a process (``collective.route``): a join that
        needs them is a collective, which every rank calls."""
        first = parts[self.local_shards[0]]
        full = [size * self.block(spec, 0, dim)[1]
                for dim, size in enumerate(first.shape)]
        out = torch.empty(full, dtype=first.dtype,
                          device=(first.device if device is None
                                  else physical_device(device)))
        keys = [self._slices(spec, full, k) for k in range(self.world_size)]
        seen = set()
        for k, p in enumerate(parts):
            key = tuple((s.start, s.stop) for s in keys[k])
            if p is not None and key not in seen:
                seen.add(key)
                out[keys[k]] = p
        # each block by its first shard in flat order, and who lacks it
        holder = {}
        for k in range(self.world_size):
            holder.setdefault(tuple((s.start, s.stop) for s in keys[k]), k)
        if len(seen) < len(holder):
            from paddlebox_tpu_torch.parallel import collective as col
            held = [{tuple((s.start, s.stop) for s in keys[k])
                     for k in self.shards_of(r)} for r in range(self.nranks)]
            got = col.route(
                self.process_group,
                [(k, self.axis_index(k, "dp"), r)
                 for key, k in holder.items()
                 for r in range(self.nranks) if key not in held[r]],
                lambda k: parts[k], "join")
            for k, p in got.items():
                out[keys[k]] = p
        return out


class Sharded:
    """A global tensor held as its shards' blocks under ``spec``, each
    block on its shard's device (``parts[k]``; shards that hold the same
    block on one device share the tensor).  It has the global ``shape``
    and ``dtype``; ``join`` assembles it on one device, and numpy reads
    it through the host (``np.asarray``)."""

    def __init__(self, parts: Sequence[torch.Tensor],
                 topo: HybridTopology, spec: Spec):
        if len(parts) != topo.world_size:
            raise ValueError(f"{len(parts)} blocks for a topology of "
                             f"{topo.world_size} shards")
        self.parts = list(parts)
        self.topo = topo
        self.spec = spec
        blk = self.parts[topo.local_shards[0]].shape
        self.shape = torch.Size(size * topo.block(spec, 0, dim)[1]
                                for dim, size in enumerate(blk))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[self.topo.local_shards[0]].dtype

    @property
    def device(self) -> torch.device:
        return self.topo.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def unique(self) -> List[Tuple[int, torch.Tensor]]:
        """(first shard, block) of every distinct local block tensor."""
        seen, out = set(), []
        for k in self.topo.local_shards:
            p = self.parts[k]
            if id(p) not in seen:
                seen.add(id(p))
                out.append((k, p))
        return out

    def rows(self, shard: int) -> slice:
        """The global range of dim 0 that ``shard``'s block holds."""
        return self.topo._slices(self.spec, self.shape, shard)[0]

    def join(self, device: DeviceLike = None) -> torch.Tensor:
        return self.topo.join(self.parts, self.spec, device)

    def zeros_like(self) -> "Sharded":
        return self.map_blocks(torch.zeros_like)

    # -- per-block operations ------------------------------------------------
    def row_blocks(self) -> List[Tuple[int, slice, torch.Tensor]]:
        """(first local shard, global rows, block) of each distinct range
        of dim 0 held here, in row order: the block a row is read from and
        an update steps once; any other shard holding the range holds a
        replica."""
        seen, out = set(), []
        for k in self.topo.local_shards:
            p, sl = self.parts[k], self.rows(k)
            if sl.start not in seen:
                seen.add(sl.start)
                out.append((k, sl, p))
        return sorted(out, key=lambda x: x[1].start)

    def row_homes(self) -> List[Tuple[Tuple[int, ...], slice]]:
        """(homes, global rows) of every distinct range of dim 0 in row
        order, over every process.  ``homes`` names, for each process that
        holds the range (in rank order), its first shard holding it: the
        block that process reads the range from and steps (its
        :meth:`row_blocks` entry), any other shard there holding a
        replica.  Where the table is split across processes a range has
        one home; replicated over dp (the multi-node layout), one a
        process.  :meth:`locate` indexes this list."""
        homes: Dict[int, List[int]] = {}
        rows: Dict[int, slice] = {}
        for r in range(self.topo.nranks):
            seen = set()
            for k in self.topo.shards_of(r):
                sl = self.rows(k)
                if sl.start not in seen:
                    seen.add(sl.start)
                    homes.setdefault(sl.start, []).append(k)
                    rows[sl.start] = sl
        return [(tuple(homes[s]), rows[s]) for s in sorted(homes)]

    def locate(self, rows: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        """(index into :meth:`row_homes`, local row) of each global row:
        the blocks are equal contiguous ranges of ``shape[0]`` over the
        block count of ``spec``'s dim 0."""
        n = self.shape[0] // self.topo.block(self.spec, 0, 0)[1]
        return torch.div(rows, n, rounding_mode="floor"), rows % n

    def gather_rows(self, rows, device: DeviceLike
                    ) -> Tuple[torch.Tensor, int]:
        """The global rows ``rows`` (host ints) as one tensor on
        ``device``: each block's rows selected where the block lives and
        copied over.  Returns (values, rows copied between devices or
        processes).  Where the rows are split across processes this is a
        collective, which every rank calls with its own rows: the rows of
        a block this process does not hold are read by the process of
        the block's first home and sent back (``collective.route``, the
        row numbers, then the values), and each rank gets its own rows in
        its own order."""
        rows = torch.as_tensor(np.asarray(rows, np.int64))
        homes = self.row_homes()
        start = [sl.start for _, sl in homes]
        held = {start.index(sl.start): (k, blk)
                for k, sl, blk in self.row_blocks()}
        if len(held) == len(homes):
            return self._read_held(rows, device, held)
        from paddlebox_tpu_torch.parallel import collective as col
        topo, me = self.topo, self.topo.rank
        ranks = range(topo.nranks)
        # the process each row is read on: here, else its block's first
        # home's
        which, _ = self.locate(rows)
        serve = torch.as_tensor([me if i in held else
                                 topo.axis_index(ks[0], "dp")
                                 for i, (ks, _) in enumerate(homes)])
        pos = {r: torch.nonzero(serve[which] == r).reshape(-1)
               for r in ranks}
        out = torch.empty((len(rows),) + tuple(self.shape[1:]),
                          dtype=self.dtype, device=physical_device(device))
        vals, moved = self._read_held(rows[pos[me]], device, held)
        out[pos[me].to(out.device)] = vals
        pairs = [(q, r) for q in ranks for r in ranks if q != r]
        asked = col.route(topo.process_group, ((p, p[0], p[1])
                                               for p in pairs),
                          lambda p: rows[pos[p[1]]], "gather_rows")
        answer = {q: self._read_held(asked[(q, me)], topo.device, held)[0]
                  for q in ranks if q != me}
        got = col.route(topo.process_group, (((r, q), r, q)
                                             for q, r in pairs),
                        lambda p: answer[p[1]], "gather_rows")
        for r in ranks:
            if r != me and len(pos[r]):
                out[pos[r].to(out.device)] = on_device(got[(r, me)],
                                                       device)
                moved += len(pos[r])
        return out, moved

    def _read_held(self, rows: torch.Tensor, device: DeviceLike,
                   held: Dict[int, Tuple[int, torch.Tensor]]
                   ) -> Tuple[torch.Tensor, int]:
        """The global ``rows``, every one in a block this process holds
        (``held``: index into :meth:`row_homes` → (shard, block)), read
        where each block lives onto ``device``; with the rows copied
        between devices."""
        out = torch.empty((len(rows),) + tuple(self.shape[1:]),
                          dtype=self.dtype, device=physical_device(device))
        which, local = self.locate(rows)
        moved = 0
        for i, (k, blk) in held.items():
            pos = torch.nonzero(which == i).reshape(-1)
            if not len(pos):
                continue
            src = self.topo.devices[k]
            v = blk.index_select(0, local[pos].to(blk.device))
            if device_key(src) != device_key(device):
                moved += len(pos)
            out[pos.to(out.device)] = transfer(v, src, device)
        return out, moved

    def scatter_rows(self, rows, values: torch.Tensor,
                     device: DeviceLike) -> int:
        """Write ``values`` (on ``device``, one per global row of the
        unique host ints ``rows``) into every block that holds each row,
        replicas included, in place.  Returns the rows copied between
        devices."""
        rows = torch.as_tensor(np.asarray(rows, np.int64))
        moved = 0
        for k, blk in self.unique():
            sl = self.rows(k)
            pos = torch.nonzero((rows >= sl.start)
                                & (rows < sl.stop)).reshape(-1)
            if not len(pos):
                continue
            dst = self.topo.devices[k]
            v = values[pos.to(values.device)]
            if device_key(dst) != device_key(device):
                moved += len(pos)
            blk.index_copy_(0, (rows[pos] - sl.start).to(blk.device),
                            transfer(v, device, dst))
        return moved

    def map_blocks(self, fn) -> "Sharded":
        """``fn(block)`` of every distinct block, run where the block
        lives (an elementwise op keeps it there); shards that share a
        block share the result."""
        made = {id(p): fn(p) for _, p in self.unique()}
        return Sharded([None if p is None else made[id(p)]
                        for p in self.parts], self.topo, self.spec)

    def bytes_by_device(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for k, p in self.unique():
            d = str(self.topo.devices[k])
            out[d] = out.get(d, 0) + p.numel() * p.element_size()
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.join("cpu").numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec!r}, devices={sorted(self.bytes_by_device())})")


def split_tree(tree: Dict[str, torch.Tensor], specs, topo: HybridTopology
               ) -> List[Dict[str, torch.Tensor]]:
    """Each shard's dict of blocks of a dict of tensors (≙ shard_map's
    in_specs over a params dict): ``specs`` is a dict of Specs by key, or
    one Spec for every leaf."""
    per_leaf = {k: topo.split(v, specs[k] if isinstance(specs, dict)
                              else specs) for k, v in tree.items()}
    return [{k: blocks[i] for k, blocks in per_leaf.items()}
            for i in range(topo.world_size)]


def join_tree(parts: Sequence[Dict[str, torch.Tensor]], specs,
              topo: HybridTopology) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`split_tree` (≙ out_specs over a dict)."""
    return {k: topo.join([p[k] for p in parts],
                         specs[k] if isinstance(specs, dict) else specs)
            for k in parts[0]}


def single_host_topology(n: Optional[int] = None, device: DeviceLike = None,
                         **degrees) -> HybridTopology:
    """A topology of ``n`` shards on one device.  With degrees only, n is
    their product; with no degrees, pure dp over n shards (1 by
    default)."""
    if not degrees:
        degrees = {"dp": n or 1}
    world = MeshConfig(**degrees).world_size
    return HybridTopology(MeshConfig(**degrees),
                          [resolve_device(device)] * (n or world))
