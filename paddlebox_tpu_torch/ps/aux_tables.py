"""Auxiliary tables: replica cache + string-keyed input table.

Port of ``paddlebox_tpu/ps/aux_tables.py``.  ≙ GpuReplicaCache
(box_wrapper.h:63-122 + PullCacheValue box_wrapper.cu:1210) — a small
dense table fully replicated on the device, pulled by row index; and
InputTable (box_wrapper.h:124-197, ops lookup_input, InputTableDataFeed
data_feed.h:2224) — a host-side string→index dictionary assigning stable
ids used as replica-cache rows.  ``InputTable`` is copied (host only);
``ReplicaCache`` keeps its rows on the host and uploads them as one
tensor on the device the caller names.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.utils import lockdep


class ReplicaCache:
    """Host-accumulated dense rows, replicated to the device; gather by
    index.

    Row 0 is reserved as the zero/miss row (same convention as the sparse
    working set)."""

    def __init__(self, dim: int):
        self.dim = dim
        self._rows: List[np.ndarray] = [np.zeros((dim,), np.float32)]
        self._device: Optional[torch.Tensor] = None
        self._lock = lockdep.lock("ps.aux_tables.ReplicaCache._lock")

    def add_item(self, vec: np.ndarray) -> int:
        with self._lock:
            self._rows.append(np.asarray(vec, np.float32).reshape(self.dim))
            self._device = None
            return len(self._rows) - 1

    def add_items(self, mat: np.ndarray) -> np.ndarray:
        with self._lock:
            start = len(self._rows)
            for r in np.asarray(mat, np.float32).reshape(-1, self.dim):
                self._rows.append(r)
            self._device = None
            return np.arange(start, len(self._rows))

    def to_device(self, device: DeviceLike = None) -> torch.Tensor:
        """The rows as one [len, dim] f32 tensor on ``device`` (``cuda``
        unless the caller names another; ≙ the h2d copy in
        InitializeGPUAndLoadModel).  Uploaded once and kept until a row is
        added or another device is asked for."""
        dev = resolve_device(device)
        with self._lock:
            held = None if self._device is None else self._device.device
            if held is None or held.type != dev.type or (
                    dev.index is not None and held.index != dev.index):
                self._device = torch.as_tensor(np.stack(self._rows),
                                               device=dev)
            return self._device

    @staticmethod
    def pull(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """Row gather (≙ PullCacheValue kernel)."""
        return table.index_select(0, indices.reshape(-1).long()).reshape(
            tuple(indices.shape) + (table.shape[1],))

    def __len__(self):
        return len(self._rows)


class InputTable:
    """String → stable index (≙ InputTable box_wrapper.h:124; the index is
    then used against a ReplicaCache or dense var)."""

    def __init__(self):
        self._map: Dict[str, int] = {}
        self._lock = lockdep.lock("ps.aux_tables.InputTable._lock")

    def get_or_insert(self, key: str) -> int:
        with self._lock:
            idx = self._map.get(key)
            if idx is None:
                idx = len(self._map) + 1  # 0 = miss
                self._map[key] = idx
            return idx

    def get_or_insert_many(self, keys: Sequence[str]) -> np.ndarray:
        """Batched resolve — one lock round-trip per call, not per token
        (the parser hot loop resolves a whole slot occurrence list)."""
        with self._lock:
            out = np.empty((len(keys),), np.uint64)
            m = self._map
            for i, k in enumerate(keys):
                idx = m.get(k)
                if idx is None:
                    idx = len(m) + 1
                    m[k] = idx
                out[i] = idx
            return out

    def lookup(self, keys: Sequence[str]) -> np.ndarray:
        with self._lock:
            return np.array([self._map.get(k, 0) for k in keys], np.int32)

    def __len__(self):
        return len(self._map)

    def save(self, path: str) -> None:
        # dump must snapshot the map atomically vs concurrent resolve();
        # write-tmp + os.replace so a crash mid-dump never leaves a torn
        # file at the committed name
        tmp = path + ".tmp"
        # pboxlint: disable-next=PB104 -- save is a rare cold verb
        with self._lock, open(tmp, "w") as f:
            for k, v in self._map.items():
                f.write(f"{k}\t{v}\n")
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        # load swaps the whole map; readers must not see a half-built one
        # pboxlint: disable-next=PB104 -- the map swap is the locked op
        with self._lock, open(path) as f:
            self._map = {}
            for line in f:
                k, v = line.rstrip("\n").split("\t")
                self._map[k] = int(v)
