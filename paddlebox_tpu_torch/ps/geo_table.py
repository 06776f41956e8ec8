"""Geo-async sparse table — ≙ MemorySparseGeoTable + GeoRecorder.

Copy of ``paddlebox_tpu/ps/geo_table.py`` with the import paths rewritten
(host code: numpy, files, sockets and threads; no device call).

Reference (ps/table/memory_sparse_geo_table.h, depends/geo_recorder.h): the
GeoSGD protocol for CPU async training — trainers push SGD updates straight
into the server copy, the table records *which* rows each trainer has not
yet seen, and ``PullGeoParam(trainer_id)`` returns exactly those touched
rows (ids + fresh values) and clears the trainer's pending set.  Trainers
thus exchange sparse *row deltas* instead of full tables.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from paddlebox_tpu_torch.utils import lockdep

import numpy as np


class GeoSparseTable:
    def __init__(self, dim: int, num_trainers: int,
                 learning_rate: float = 1.0):
        self.dim = dim
        self.lr = learning_rate
        self._values: Dict[int, np.ndarray] = {}
        self._pending = [set() for _ in range(num_trainers)]
        self._lock = lockdep.lock("ps.geo_table.GeoSparseTable._lock")

    # -- init / direct access ----------------------------------------------
    def push_sparse_param(self, keys: np.ndarray,
                          values: np.ndarray) -> None:
        """Overwrite rows (initial broadcast of trainer-0 params,
        ≙ PushSparseParam)."""
        with self._lock:
            for k, v in zip(keys.tolist(), values):
                self._values[k] = np.array(v, np.float32)

    def pull_sparse(self, keys: np.ndarray) -> np.ndarray:
        with self._lock:
            return np.stack([
                self._values.get(int(k), np.zeros(self.dim, np.float32))
                for k in keys])

    # -- geo protocol -------------------------------------------------------
    def push_sparse(self, keys: np.ndarray, grads: np.ndarray) -> None:
        """Apply a trainer's sparse SGD update and mark the rows pending for
        every trainer (≙ MemorySparseGeoTable::_PushSparse + GeoRecorder
        Update)."""
        with self._lock:
            for k, g in zip(keys.tolist(), grads):
                row = self._values.setdefault(
                    int(k), np.zeros(self.dim, np.float32))
                row -= self.lr * np.asarray(g, np.float32)
            for pend in self._pending:
                pend.update(int(k) for k in keys.tolist())

    def pull_geo_param(self, trainer_id: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Rows touched since this trainer's last geo pull (≙ PullGeoParam:
        GeoRecorder GetAndClear + values gather)."""
        with self._lock:
            ids = sorted(self._pending[trainer_id])
            self._pending[trainer_id].clear()
            if not ids:
                return (np.zeros((0,), np.uint64),
                        np.zeros((0, self.dim), np.float32))
            vals = np.stack([self._values[k] for k in ids])
            return np.asarray(ids, np.uint64), vals

    def size(self) -> int:
        with self._lock:
            return len(self._values)
