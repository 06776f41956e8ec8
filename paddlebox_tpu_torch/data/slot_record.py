"""SlotRecord storage: struct-of-arrays blocks of instances.

TPU-first redesign of the reference's per-record SlotRecordObject + arena pool
(data_feed.h:97-440: SlotValues, SlotRecordObject, SlotObjPool).  Instead of
millions of tiny heap records recycled through a pool, instances travel in
*blocks*: one contiguous (values, lod-offsets) pair per slot for a batch of
records.  This keeps host memory flat and copies vectorized — the role the
arena played for C++ — and is exactly the layout the device batch-pack wants
(SURVEY.md §7 step 2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Ragged = Tuple[np.ndarray, np.ndarray]  # (values [total], offsets [n+1])


def _empty_ragged(dtype) -> Ragged:
    return (np.empty((0,), dtype=dtype), np.zeros((1,), dtype=np.int64))


def _concat_ragged(parts: Sequence[Ragged], dtype) -> Ragged:
    values = np.concatenate([p[0] for p in parts]) if parts else \
        np.empty((0,), dtype=dtype)
    lens = np.concatenate([np.diff(p[1]) for p in parts]) if parts else \
        np.empty((0,), dtype=np.int64)
    offsets = np.zeros((len(lens) + 1,), dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return values, offsets


def _select_ragged(r: Ragged, idx: np.ndarray) -> Ragged:
    values, offsets = r
    lens = np.diff(offsets)[idx]
    new_off = np.zeros((len(idx) + 1,), dtype=np.int64)
    np.cumsum(lens, out=new_off[1:])
    # gather value spans of the selected records
    starts = offsets[idx]
    total = int(new_off[-1])
    flat_idx = np.empty((total,), dtype=np.int64)
    # vectorized span expansion: for each selected record j with length l_j,
    # flat_idx[new_off[j]:new_off[j+1]] = starts[j] + [0..l_j)
    if total:
        rep_starts = np.repeat(starts - new_off[:-1], lens)
        flat_idx = np.arange(total, dtype=np.int64) + rep_starts
    return values[flat_idx], new_off


@dataclasses.dataclass
class SlotRecordBlock:
    """A batch of instances in struct-of-arrays layout."""

    n: int
    uint64_slots: Dict[str, Ragged] = dataclasses.field(default_factory=dict)
    float_slots: Dict[str, Ragged] = dataclasses.field(default_factory=dict)
    # aux index slots (InputTable-resolved string keys) — NOT feasigns:
    # excluded from all_keys() so they never register in the PS pass build
    aux_slots: Dict[str, Ragged] = dataclasses.field(default_factory=dict)
    ins_ids: Optional[List[str]] = None
    search_ids: Optional[np.ndarray] = None   # uint64, PV/AucRunner merge key
    cmatch: Optional[np.ndarray] = None       # int32
    rank: Optional[np.ndarray] = None         # int32

    # ------------------------------------------------------------------
    @property
    def feasign_count(self) -> int:
        return sum(int(v[1][-1]) for v in self.uint64_slots.values())

    def select(self, idx: np.ndarray) -> "SlotRecordBlock":
        idx = np.asarray(idx, dtype=np.int64)
        out = SlotRecordBlock(n=len(idx))
        out.uint64_slots = {k: _select_ragged(v, idx)
                            for k, v in self.uint64_slots.items()}
        out.float_slots = {k: _select_ragged(v, idx)
                           for k, v in self.float_slots.items()}
        out.aux_slots = {k: _select_ragged(v, idx)
                         for k, v in self.aux_slots.items()}
        if self.ins_ids is not None:
            out.ins_ids = [self.ins_ids[i] for i in idx]
        for f in ("search_ids", "cmatch", "rank"):
            v = getattr(self, f)
            if v is not None:
                setattr(out, f, v[idx])
        return out

    def permute(self, idx: np.ndarray) -> "SlotRecordBlock":
        return self.select(idx)

    def slice(self, start: int, stop: int) -> "SlotRecordBlock":
        return self.select(np.arange(start, min(stop, self.n)))

    @staticmethod
    def concat(blocks: Sequence["SlotRecordBlock"]) -> "SlotRecordBlock":
        blocks = [b for b in blocks if b.n > 0]
        if not blocks:
            return SlotRecordBlock(n=0)
        out = SlotRecordBlock(n=sum(b.n for b in blocks))
        u_keys = blocks[0].uint64_slots.keys()
        f_keys = blocks[0].float_slots.keys()
        out.uint64_slots = {
            k: _concat_ragged([b.uint64_slots[k] for b in blocks], np.uint64)
            for k in u_keys}
        out.float_slots = {
            k: _concat_ragged([b.float_slots[k] for b in blocks], np.float32)
            for k in f_keys}
        out.aux_slots = {
            k: _concat_ragged([b.aux_slots[k] for b in blocks], np.uint64)
            for k in blocks[0].aux_slots.keys()}
        if blocks[0].ins_ids is not None:
            out.ins_ids = [i for b in blocks for i in (b.ins_ids or [])]
        for f in ("search_ids", "cmatch", "rank"):
            if getattr(blocks[0], f) is not None:
                setattr(out, f, np.concatenate([getattr(b, f) for b in blocks]))
        return out

    def all_keys(self) -> np.ndarray:
        """Every uint64 feasign in the block (with repeats) — feeds the
        pass working-set build (≙ MergeInsKeys data_set.cc:2293)."""
        parts = [v[0] for v in self.uint64_slots.values()]
        if not parts:
            return np.empty((0,), dtype=np.uint64)
        return np.concatenate(parts)
