"""AucRunner — in-training feature-importance evaluation.

Copy of ``paddlebox_tpu/metrics/auc_runner.py`` (numpy only).

≙ BoxWrapper AucRunner mode (box_wrapper.h:906-1000: InitializeAucRunner
:908, GetRandomReplace/PostUpdate/RecordReplace :948-989, flag
FLAGS_padbox_auc_runner_mode flags.cc:972): while training runs, keep a
random reservoir of instances; on evaluation passes, replace the feasigns of
one slot with spans sampled from the reservoir and measure the AUC drop —
the importance of that slot.  Phases flip join/update passes
(MetricGroup.flip_phase).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock


class AucRunner:
    def __init__(self, slots: Sequence[str], pool_size: int = 10000,
                 seed: int = 0):
        self.slots = list(slots)
        self.pool_size = pool_size
        self._rng = np.random.default_rng(seed)
        # per slot: list of feasign spans (np arrays)
        self._pool: Dict[str, List[np.ndarray]] = {s: [] for s in self.slots}
        self._seen = 0

    # -- ≙ RecordReplace: reservoir-sample spans during normal training -----
    def record(self, block: SlotRecordBlock) -> None:
        for name in self.slots:
            if name not in block.uint64_slots:
                continue
            values, offsets = block.uint64_slots[name]
            pool = self._pool[name]
            for i in range(block.n):
                span = values[offsets[i]:offsets[i + 1]]
                if len(pool) < self.pool_size:
                    pool.append(span.copy())
                else:
                    j = int(self._rng.integers(0, self._seen + i + 1))
                    if j < self.pool_size:
                        pool[j] = span.copy()
        self._seen += block.n

    # -- ≙ GetRandomReplace: build the ablated copy -------------------------
    def replace(self, block: SlotRecordBlock, slot: str) -> SlotRecordBlock:
        """Return a copy of `block` whose `slot` feasigns are random pool
        spans (other slots untouched)."""
        pool = self._pool.get(slot)
        if not pool:
            return block
        out = SlotRecordBlock(n=block.n, ins_ids=block.ins_ids,
                              search_ids=block.search_ids,
                              cmatch=block.cmatch, rank=block.rank)
        out.float_slots = dict(block.float_slots)
        out.uint64_slots = dict(block.uint64_slots)
        picks = self._rng.integers(0, len(pool), size=block.n)
        spans = [pool[p] for p in picks]
        lens = np.array([len(s) for s in spans], np.int64)
        offsets = np.zeros((block.n + 1,), np.int64)
        np.cumsum(lens, out=offsets[1:])
        values = (np.concatenate(spans) if spans else
                  np.empty((0,), np.uint64))
        out.uint64_slots[slot] = (values, offsets)
        return out

    def pool_sizes(self) -> Dict[str, int]:
        return {s: len(p) for s, p in self._pool.items()}
