"""Pass-scoped device-resident batch feed — whole-pass pack, once.

Port of ``paddlebox_tpu/data/pass_feed.py`` (≙ SlotPaddleBoxDataFeed
packing the whole pass on device at feed time, data_feed.h:2036, and the
pass-scope key translation DedupKeysAndFillIdx, box_wrapper_impl.h:129):

* HOST, once per pass (vectorized numpy): ragged slot values →
  translated pass-row ids (one key translation for every occurrence) →
  padded [S, N*B, L] planes (``pack_pass``).
* DEVICE, once per pass: one upload and relayout to the step's
  [N, S, L, B] layout (``upload_pass``), plus the per-batch sorted-spmm
  plans of the mxu lowering (``precompute_plans``, trimmed and with the
  static payload planes) or the CSR plans of the ragged lowering
  (``build_csr_plans``, host numpy).  A ``PlaneStager`` handed to
  ``pack_pass`` starts each plane's upload as soon as the plane is final.
* TRAIN LOOP: the step indexes batch i of the resident tensors.

Besides the step's five planes the pass carries the page-view planes
(``rank_offset`` [N*B, 1+2*max_rank] with batch-local rows, ``ads_offset``
[N, B+1]), the InputTable aux index planes and the uid plane; the uids
stay on the host, where the per-user AUC reads them.  Not ported:
sharded feeds.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data.batch_pack import BatchPacker
from paddlebox_tpu_torch.data.rank_offset import (build_ads_offset_batched,
                                                  build_rank_offset_batched)
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.utils import intervals, workpool
from paddlebox_tpu_torch.utils.monitor import stat_observe


@dataclasses.dataclass
class HostPassArrays:
    """Whole pass, packed host-side (numpy), batch-major."""

    indices: np.ndarray    # [S, N*B, L] int32 pass-local rows (0 = padding)
    lengths: np.ndarray    # [S, N*B] int32
    dense: np.ndarray      # [N*B, D] float32
    labels: np.ndarray     # [N*B] or [N*B, T] float32
    valid: np.ndarray      # [N*B] bool
    n_batches: int
    batch_size: int
    num_real: int          # real record count (pass total)
    ins_ids: Optional[list] = None  # [num_real] instance ids (the dump's)
    # batch_counts packs: per-batch real counts + prefix sums into the
    # real-record order; None = batch i holds rows [i*B, i*B + real_i)
    batch_real: Optional[np.ndarray] = None   # [N] int64
    batch_base: Optional[np.ndarray] = None   # [N] int64
    rank_offset: Optional[np.ndarray] = None  # [N*B, 1+2*max_rank] int32
    ads_offset: Optional[np.ndarray] = None   # [N, B+1] int32 pv offsets
    # InputTable-resolved aux index planes {name: [N*B, cap] int32}
    aux: Optional[Dict[str, np.ndarray]] = None
    uid: Optional[np.ndarray] = None    # [N*B] uint64 (uid_slot), host only
    # ragged-lowering CSR step plans ({seg, inv, occ_w, u_rows, u_slot},
    # each [N, ...]); None until built
    csr: Optional[Dict[str, np.ndarray]] = None

    def extra_planes(self) -> Dict[str, np.ndarray]:
        """Every optional per-record plane the device gets (rank_offset
        and the aux index planes)."""
        out = {}
        if self.rank_offset is not None:
            out["rank_offset"] = self.rank_offset
        if self.aux:
            out.update(self.aux)
        return out

    def real_range(self, i: int):
        """(plane_row_lo, real_count, real_order_base) of batch i: its
        real records are plane rows [lo, lo + count) and records
        [base, base + count) of the pass's real order (``ins_ids``)."""
        if self.batch_real is not None:
            return (i * self.batch_size, int(self.batch_real[i]),
                    int(self.batch_base[i]))
        lo = i * self.batch_size
        return lo, max(0, min(self.batch_size, self.num_real - lo)), lo


def _record_ranges(n: int, threads: int) -> List[tuple]:
    """Split [0, n) into contiguous record ranges for the pack fan-out
    (2x more chunks than threads; workers write disjoint plane rows, so
    any split is bit-identical)."""
    if n == 0:
        return []
    if threads <= 1:
        return [(0, n)]
    chunks = min(threads * 2, max(1, n // 4096))
    bounds = np.linspace(0, n, chunks + 1).astype(np.int64)
    return [(int(bounds[i]), int(bounds[i + 1]))
            for i in range(len(bounds) - 1) if bounds[i + 1] > bounds[i]]


def pack_pass(blocks: Sequence[SlotRecordBlock], feed_config: DataFeedConfig,
              batch_size: int, label_slot="label",
              key_mapper=None,
              batch_counts: Optional[Sequence[int]] = None,
              pack_threads: Optional[int] = None,
              on_plane: Optional[Callable[[str, np.ndarray], None]] = None
              ) -> HostPassArrays:
    """Vectorized whole-pass pack: one call per slot, one key translation
    for every occurrence in the pass.

    batch_counts: per-batch record counts over the concatenated block
    order (pv-aligned cuts, ≤ batch_size each); each batch lands at its
    own batch slot, short batches padded.  Otherwise blocks are
    concatenated and sliced densely every batch_size records.

    pack_threads: fan the per-slot/per-record-range pad+translate work
    over the shared pack WorkPool (None = FLAGS_pass_pack_threads; an int
    uses a private pool of that size).  Every worker writes a disjoint
    row range of the preallocated planes, so the result is bit-identical
    at any thread count.

    on_plane: called on this thread as each plane becomes final (a
    ``PlaneStager`` starts its upload there)."""
    t_pack = time.perf_counter()
    m_pack = time.monotonic()
    packer = BatchPacker(feed_config, batch_size, label_slot)
    own_pool = None
    if pack_threads is None:
        pool = workpool.pack_pool()
    else:
        own_pool = pool = workpool.WorkPool(max(1, int(pack_threads)),
                                            kind="pack")
    blocks = list(blocks)
    merged = SlotRecordBlock.concat(blocks)
    if batch_counts is not None:
        counts = [int(c) for c in batch_counts]
        if sum(counts) != merged.n:
            raise ValueError(
                f"batch_counts sum {sum(counts)} != {merged.n} records")
    else:
        counts = None
    if (feed_config.rank_offset or feed_config.ads_offset) and counts is None:
        # the plane functions treat each batch as whole page views; a pv
        # split across dense cuts would attend over a fragment's peers
        # (≙ GetRankOffset only runs under pv merge, data_feed.cc:1855)
        raise ValueError(
            "rank_offset/ads_offset require pv-aligned batches: pass "
            "batch_counts (dataset.batch_bounds)")
    if counts is not None:
        over = [c for c in counts if c > batch_size]
        if over:
            raise ValueError(
                f"a batch of {over[0]} records exceeds batch_size "
                f"{batch_size}")
        n_batches = max(1, len(counts))
        pos = (np.concatenate(
            [i * batch_size + np.arange(c) for i, c in enumerate(counts)])
            if counts else np.zeros((0,), np.int64)).astype(np.int64)
        batch_real = np.asarray(counts + [0] * (n_batches - len(counts)),
                                np.int64)
        batch_base = np.concatenate([[0], np.cumsum(batch_real)[:-1]])
    else:
        n_batches = max(1, -(-merged.n // batch_size))
        pos = slice(0, merged.n)   # contiguous writes on the dense path
        batch_real = batch_base = None
    n = merged.n
    nb = n_batches * batch_size
    S, L = len(packer.sparse_slots), packer.capacity

    indices = np.zeros((S, nb, L), dtype=np.int32)
    lengths = np.zeros((S, nb), dtype=np.int32)

    def rows_of(r0: int, r1: int):
        return pos[r0:r1] if isinstance(pos, np.ndarray) else slice(r0, r1)

    def pack_sparse_range(si: int, slot, r0: int, r1: int) -> None:
        values, offsets = merged.uint64_slots[slot.name]
        v = values[offsets[r0]:offsets[r1]]
        o = offsets[r0:r1 + 1] - offsets[r0]
        if key_mapper is not None:
            # translate the ragged values ONCE (real occurrences only),
            # then pad the translated int32 plane
            v = key_mapper(v)
        elif len(v) and int(v.max()) > np.iinfo(np.int32).max:
            raise ValueError(
                "pack_pass without a key_mapper stores raw feasigns in the "
                "int32 index plane; keys exceed int32 — pass the engine's "
                "PassKeyMapper (engine.mapper)")
        # _pad_ragged zero-fills positions beyond each record's length, so
        # padding lands on the reserved zero row
        padded, lens = packer._pad_ragged(v, o, L)
        rows = rows_of(r0, r1)
        indices[si, rows] = padded
        lengths[si, rows] = lens

    try:
        # wave 1 — every (sparse slot × record range) pad/translate task,
        # each writing a disjoint [si, rows] region of the planes
        ranges = _record_ranges(n, pool.threads)
        pool.map(lambda t: pack_sparse_range(*t),
                 [(si, slot, r0, r1)
                  for si, slot in enumerate(packer.sparse_slots)
                  for r0, r1 in ranges])
        if on_plane is not None:
            on_plane("indices", indices)
            on_plane("lengths", lengths)

        # wave 2 — the light per-record planes
        dense = np.zeros((nb, packer.dense_dim), dtype=np.float32)
        multi = np.zeros((nb, len(packer.label_slots)), np.float32)
        valid = np.zeros((nb,), dtype=bool)
        uid = np.zeros((nb,), np.uint64) if feed_config.uid_slot else None
        aux = {} if feed_config.string_slots else None

        def pack_dense(slot, col: int) -> None:
            values, offsets = merged.float_slots[slot.name]
            padded, _ = packer._pad_ragged(values, offsets, slot.dim)
            dense[pos, col:col + slot.dim] = padded

        def pack_label(t: int, name: str) -> None:
            src = merged.float_slots if name in merged.float_slots else \
                merged.uint64_slots
            if name in src:
                lv, lo = src[name]
                lp, _ = packer._pad_ragged(lv, lo, 1)
                multi[pos, t] = lp[:, 0].astype(np.float32)

        def pack_uid() -> None:
            vals, offs = merged.uint64_slots[feed_config.uid_slot]
            uid[pos] = packer._pad_ragged(vals, offs, 1)[0][:, 0]

        def pack_aux(slot) -> None:
            # InputTable index planes (≙ InputTableDataFeed,
            # data_feed.h:2224)
            vals, offs = merged.aux_slots[slot.name]
            padded, _ = packer._pad_ragged(vals, offs, slot.capacity)
            plane = np.zeros((nb, slot.capacity), np.int32)
            plane[pos] = padded.astype(np.int32)
            aux[slot.name] = plane

        tasks: List[Callable[[], None]] = []
        col = 0
        for slot in packer.dense_slots:
            tasks.append(functools.partial(pack_dense, slot, col))
            col += slot.dim
        for t, name in enumerate(packer.label_slots):
            tasks.append(functools.partial(pack_label, t, name))
        if uid is not None:
            tasks.append(pack_uid)
        if aux is not None:
            for slot in feed_config.string_slots:
                tasks.append(functools.partial(pack_aux, slot))
        pool.map(lambda fn: fn(), tasks)
        valid[pos] = True
    finally:
        if own_pool is not None:
            own_pool.shutdown()
    labels = multi if len(packer.label_slots) > 1 else multi[:, 0]
    if on_plane is not None:
        on_plane("dense", dense)
        on_plane("labels", labels)
        on_plane("valid", valid)
        for name, plane in (aux or {}).items():
            on_plane(name, plane)

    out = HostPassArrays(indices=indices, lengths=lengths, dense=dense,
                         labels=labels, valid=valid, n_batches=n_batches,
                         batch_size=batch_size, num_real=n,
                         ins_ids=merged.ins_ids, batch_real=batch_real,
                         batch_base=batch_base, aux=aux, uid=uid)
    # wave 3 — the pv planes, vectorized over the whole pass and metered
    # apart from the pad/translate work
    t_planes = time.perf_counter()
    if feed_config.rank_offset:
        # ≙ GetRankOffset per batch (data_feed.cc:1855): batch-local rows
        out.rank_offset = build_rank_offset_batched(
            merged.search_ids, merged.cmatch, merged.rank,
            batch_real, batch_base, batch_size, feed_config.max_rank)
        if on_plane is not None:
            on_plane("rank_offset", out.rank_offset)
    if feed_config.ads_offset:
        # ≙ GetAdsOffset per batch (data_feed.cc:3592): pv prefix offsets
        out.ads_offset = build_ads_offset_batched(
            merged.search_ids, batch_real, batch_base, batch_size)
        if on_plane is not None:
            on_plane("ads_offset", out.ads_offset)
    if feed_config.rank_offset or feed_config.ads_offset:
        stat_observe("data.pass_feed.plane_build_s",
                     time.perf_counter() - t_planes)
    dt = time.perf_counter() - t_pack
    intervals.record("pack", m_pack, time.monotonic())
    stat_observe("data.pass_feed.pack_s", dt)
    stat_observe("data.pass_feed.batch_pack_s", dt / max(1, n_batches))
    return out


@dataclasses.dataclass
class PackedPassFeed:
    """Device-resident pass: stacked per-batch tensors + optional plans.

    data layout (step-ready):
      indices  [N, S, L, B] int32
      lengths  [N, S, B]    int32
      dense    [N, B, D]    float32
      labels   [N, B] / [N, B, T]
      valid    [N, B]       bool
    and, when the feed has them, ``rank_offset`` [N, B, 1+2*max_rank],
    one [N, B, cap] int32 plane per InputTable slot and ``ads_offset``
    [N, B+1].  plans: the mxu lowering's sorted-spmm plans or the ragged
    lowering's CSR plans, each array stacked on axis 0; ``plan_dims``
    identifies the geometry they were built for.  ``uid`` with its
    ``host_labels`` / ``host_valid`` stay on the host (uid_slot only);
    ``host`` is the pass's HostPassArrays when the feed was built to keep
    them (``keep_host``, for the instance dump).
    """

    data: Dict[str, torch.Tensor]
    n_batches: int
    batch_size: int
    plans: Optional[Dict[str, torch.Tensor]] = None
    plan_dims: object = None
    uid: Optional[np.ndarray] = None          # [N*B] uint64
    host_labels: Optional[np.ndarray] = None  # [N*B(, T)]
    host_valid: Optional[np.ndarray] = None   # [N*B] bool
    host: Optional[HostPassArrays] = None     # kept for the dump


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device`` (through pinned memory,
    asynchronously, on a card; the same memory on the CPU)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class PlaneStager:
    """Overlap the upload with the pack: ``pack_pass(on_plane=stager)``
    calls it as each plane becomes final, and it starts that plane's
    copy to ``device`` at once (pinned, ``non_blocking`` on a card);
    ``upload_pass(..., staged=stager)`` then skips the staged planes.

    The copies are CUDA calls, and no CUDA call runs on a worker thread
    of the port (the pass prefetcher's worker and the async pass build
    only pack): a call off the main thread raises."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.staged: Dict[str, torch.Tensor] = {}

    def __call__(self, name: str, a: np.ndarray) -> None:
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                f"PlaneStager called for plane {name!r} on thread "
                f"{threading.current_thread().name!r}: it uploads, so it "
                "may only be handed to a pack that runs on the main thread")
        t0 = time.monotonic()
        self.staged[name] = to_device(a, self.device)
        intervals.record("upload", t0, time.monotonic())


def upload_pass(host_arrays: HostPassArrays, device: torch.device,
                staged: Optional[PlaneStager] = None,
                keep_host: bool = False) -> PackedPassFeed:
    """One upload per plane + a relayout on the device into the
    step-ready stacked layout.  ``staged``: a PlaneStager whose planes
    are already on their way (those skip the upload here).
    ``keep_host``: the feed keeps ``host_arrays`` (the dump's ids,
    labels and real ranges)."""
    t_up = time.perf_counter()
    m_up = time.monotonic()
    h = host_arrays
    N, B = h.n_batches, h.batch_size
    pre = dict(staged.staged) if staged is not None else {}

    def put(name: str, a: np.ndarray) -> torch.Tensor:
        return pre[name] if name in pre else to_device(a, device)

    idx = put("indices", h.indices)                        # [S, N*B, L]
    s, _, l = idx.shape
    lbl = put("labels", h.labels)
    data = {
        "indices": idx.reshape(s, N, B, l).permute(1, 0, 3, 2).contiguous(),
        "lengths": put("lengths", h.lengths).reshape(s, N, B).permute(
            1, 0, 2).contiguous(),
        "dense": put("dense", h.dense).reshape(N, B, -1),
        "labels": lbl.reshape((N, B) + tuple(lbl.shape[1:])),
        "valid": put("valid", h.valid).reshape(N, B),
    }
    for k, v in h.extra_planes().items():    # [N*B, w] -> [N, B, w]
        data[k] = put(k, v).reshape(N, B, -1)
    if h.ads_offset is not None:             # per-batch plane [N, B+1]
        data["ads_offset"] = put("ads_offset", h.ads_offset)
    intervals.record("upload", m_up, time.monotonic())
    stat_observe("data.pass_feed.upload_s", time.perf_counter() - t_up)
    uid = h.uid is not None
    return PackedPassFeed(data=data, n_batches=N, batch_size=B,
                          uid=h.uid, host_labels=h.labels if uid else None,
                          host_valid=h.valid if uid else None,
                          host=h if keep_host else None)


def _static_planes(plan: Dict[str, torch.Tensor], labels_b: torch.Tensor,
                   slot_ids: torch.Tensor, dims: sp.SpmmDims,
                   kd: sp.SpmmDims, shape_slb) -> Dict[str, torch.Tensor]:
    """Static sorted-domain payload planes of one batch:

      bs       [p_pad_kept] int32 — pooled-grad source row b*S + s of each
               kept sorted position
      labelcol [p_pad_kept] f32  — the occurrence's instance label
      slotcol  [p_pad_kept] f32  — slot id x first_occ

    Training-state-independent, so they belong to the pass build."""
    s, l, b = shape_slb
    perm_k = sp.kept_perm(plan["perm"], dims, kd).long()
    s_of = perm_k // (l * b)
    b_of = perm_k % b
    labels1 = labels_b if labels_b.dim() == 1 else labels_b[:, 0]
    return {
        "bs": (b_of * s + s_of).to(torch.int32),
        "labelcol": labels1.to(torch.float32)[b_of],
        "slotcol": slot_ids.to(torch.float32)[s_of] * plan["first_occ"],
    }


_PLAN_KEYS = ("rows2d", "perm", "inv_perm", "ch", "tl", "fg", "fs",
              "first_occ")


def precompute_plans(feed: PackedPassFeed, dims: sp.SpmmDims,
                     eff: Optional[sp.SpmmDims] = None,
                     slot_ids=None) -> None:
    """Per-batch sorted-spmm plans, built on the device once per pass
    and kept resident (the sort depends on the batch alone, never on the
    training state).

    eff (``sorted_spmm.trimmed_dims``, shared by all batches so the
    stacked plans are homogeneous): trim leading padding occurrences.
    slot_ids [S]: also build the static payload planes (bs/labelcol/
    slotcol) so the push crossing moves only the dynamic 1+D grad
    columns; only for 1-D (or single-column) labels."""
    idx_all = feed.data["indices"]
    n, s, l, b = idx_all.shape
    per = []
    for i in range(n):
        plan = dict(zip(_PLAN_KEYS,
                        sp.build_plan(idx_all[i].reshape(-1), dims, eff)))
        per.append(plan)
    labels = feed.data["labels"]
    if slot_ids is not None and (labels.dim() == 2 or labels.shape[-1] == 1):
        sid = torch.as_tensor(np.asarray(slot_ids), device=idx_all.device)
        for i, plan in enumerate(per):
            plan.update(_static_planes(plan, labels[i], sid, dims,
                                       eff or dims, (s, l, b)))
    feed.plans = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    feed.plan_dims = dims


def _round8(n: int) -> int:
    """Pad a plan extent up to a multiple of 8 (a shared max keeps the
    stacked per-batch plan arrays homogeneous)."""
    return max(8, -(-int(n) // 8) * 8)


def build_csr_plans(indices: np.ndarray, slot_ids: Sequence[int],
                    n_batches: int, batch_size: int) -> Dict[str, np.ndarray]:
    """Per-batch CSR step plans for the ragged lowering (host, numpy).

    Lowers each batch's padded [S, B, L] index plane to its valid-
    occurrence frontier once per pass.  Occurrences are enumerated in
    canonical flat order (s-major, then l, then b — ``[S, L, B]
    .reshape(-1)``).  Returns stacked planes, one leading batch axis each:

      seg     [N, P_pad] int32 — pooled segment ``s*B + b`` (pad → 0)
      inv     [N, P_pad] int32 — occurrence → [U] position; position 0 is
              working-set row 0, real unique rows sit at 1.. sorted
      occ_w   [N, P_pad] f32  — 1.0 valid / 0.0 pad
      u_rows  [N, U_pad] int32 — working-set row of each [U] position
              (u_rows[:, 0] == 0; pad → 0)
      u_slot  [N, U_pad] int32 — merged slot id (max over occurrences)

    Padding occurrences (index 0) are dropped: row 0 is the reserved
    all-zero row, so its pull is zero and its push is suppressed."""
    t0 = time.perf_counter()
    m0 = time.monotonic()
    S, NB, L = indices.shape
    B = int(batch_size)
    N = int(n_batches)
    slot_arr = np.asarray(slot_ids, dtype=np.int32)
    per = []
    p_max = u_max = 0
    for i in range(N):
        # [S, B, L] -> [S, L, B]: canonical flat order
        slb = np.ascontiguousarray(
            indices[:, i * B:(i + 1) * B, :].transpose(0, 2, 1))
        flatv = slb.reshape(-1)
        pos = np.flatnonzero(flatv)
        rows = flatv[pos]
        s_of = (pos // (L * B)).astype(np.int32)
        b_of = (pos % B).astype(np.int32)
        uniq = np.unique(rows).astype(np.int32)       # sorted, excludes 0
        inv = (np.searchsorted(uniq, rows) + 1).astype(np.int32)
        per.append((s_of * B + b_of, inv, uniq, s_of))
        p_max = max(p_max, pos.size)
        u_max = max(u_max, uniq.size + 1)
    P_pad, U_pad = _round8(p_max), _round8(u_max)
    seg = np.zeros((N, P_pad), np.int32)
    invp = np.zeros((N, P_pad), np.int32)
    occ_w = np.zeros((N, P_pad), np.float32)
    u_rows = np.zeros((N, U_pad), np.int32)
    u_slot = np.zeros((N, U_pad), np.int32)
    for i, (sg, inv, uniq, s_of) in enumerate(per):
        p, u = sg.size, uniq.size
        seg[i, :p] = sg
        invp[i, :p] = inv
        occ_w[i, :p] = 1.0
        u_rows[i, 1:1 + u] = uniq                      # [0] stays row 0
        np.maximum.at(u_slot[i], inv, slot_arr[s_of])
    intervals.record("csr", m0, time.monotonic())
    stat_observe("data.pass_feed.csr_build_s", time.perf_counter() - t0)
    return {"seg": seg, "inv": invp, "occ_w": occ_w,
            "u_rows": u_rows, "u_slot": u_slot}


def slice_batch(tree: Dict[str, torch.Tensor], i: int
                ) -> Dict[str, torch.Tensor]:
    """Batch i of a dict of stacked tensors (views, no copy)."""
    return {k: v[i] for k, v in tree.items()}


def plan_tuple(p: Dict[str, torch.Tensor]):
    """Plans dict (one batch) → the positional tuple ``build_plan``
    returns: the ragged CSR 5-tuple, or the mxu 8-tuple, extended to 11
    by the static payload planes when present."""
    if "u_rows" in p:      # ragged-lowering CSR plan (build_csr_plans)
        return (p["seg"], p["inv"], p["occ_w"], p["u_rows"], p["u_slot"])
    base = tuple(p[k] for k in _PLAN_KEYS)
    if "bs" in p:
        return base + (p["bs"], p["labelcol"], p["slotcol"])
    return base
