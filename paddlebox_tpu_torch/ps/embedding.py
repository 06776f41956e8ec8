"""Device-resident pass working set.

Port of ``paddlebox_tpu/ps/embedding.py``: key→row translation on the
host against the pass's sorted unique key array (``PassKeyMapper``), and
the working set as a dict of tensors on one explicit device, one tensor
per field (``show`` [N], ``mf`` [N, D], ...).

Row 0 is the reserved zero row: padding positions and unknown keys point
at it, pull zeros and push nothing (≙ FLAGS_enable_pull_box_padding_zero).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

def size_bucket(n: int, align: int = 8) -> int:
    """Grow-only size buckets so per-pass working sets of similar size
    keep the same shapes (≙ DCacheBuffer grow-only realloc,
    box_wrapper.h:198)."""
    n = max(n, align)
    bucket = align
    while bucket < n:
        bucket *= 2
    # intermediate steps between powers of two cap padding waste at ~14%
    for frac in (5 * bucket // 8, 3 * bucket // 4, 7 * bucket // 8):
        if frac >= n and frac % align == 0:
            return frac
    return bucket


class PassKeyMapper:
    """Host-side key→pass-row translation over the sorted unique key array.

    Row 0 is reserved (zero row); real keys map to rows 1..n by binary
    search (the JAX package's native hash table is not part of this
    port; both give the same rows)."""

    def __init__(self, sorted_keys: np.ndarray):
        self.sorted_keys = sorted_keys  # unique, ascending, excludes 0

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        if len(self.sorted_keys) == 0:
            return np.zeros(len(keys), np.int32)
        pos = np.searchsorted(self.sorted_keys, keys)
        pos_c = np.minimum(pos, len(self.sorted_keys) - 1)
        found = self.sorted_keys[pos_c] == keys
        return np.where(found, pos_c + 1, 0).astype(np.int32)

    @property
    def num_keys(self) -> int:
        return len(self.sorted_keys)


def build_working_set(host_soa: Dict[str, np.ndarray], device: torch.device,
                      pad_to: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """Assemble the working set from host rows (row 0 = zeros) on
    ``device``: one staging copy per field into a padded host buffer —
    pinned when the device is a card — then one asynchronous
    host→device copy per field (≙ BuildGPUTask's HBM pool fill,
    ps_gpu_wrapper.cc:684-760).

    The reserved all-zero row 0 is load-bearing: the mxu path points
    padding occurrences at it so they pool as exact 0.0.
    """
    n = len(host_soa["show"])
    total = (pad_to if pad_to is not None else size_bucket(n + 1))
    assert total >= n + 1
    pin = device.type == "cuda"
    ws = {}
    for f in host_soa:
        if f == "unseen_days":  # host-only lifecycle field
            continue
        src = host_soa[f]
        dtype = torch.int32 if src.dtype == np.int32 else torch.float32
        buf = torch.zeros((total,) + src.shape[1:], dtype=dtype,
                          pin_memory=pin)
        buf.numpy()[1:n + 1] = src
        # each staging buffer is fresh and owned by its copy, so the
        # non-blocking H2D cannot race a later rewrite
        ws[f] = buf.to(device, non_blocking=True) if pin else buf
    return ws


def dump_working_set(ws: Dict[str, torch.Tensor], n: int
                     ) -> Dict[str, np.ndarray]:
    """Device→host for end_pass write-back (≙ dump_pool_to_cpu_func,
    ps_gpu_wrapper.cc:983+): rows 1..n of every field."""
    return {f: ws[f][1:n + 1].cpu().numpy() for f in ws
            if ws[f].dim() >= 1}


def mf_values(ws: Dict[str, torch.Tensor], gathered: torch.Tensor
              ) -> torch.Tensor:
    """Dequantize gathered mf rows when the working set is frozen int16
    (EmbedxQuantOp: dest = int16 * scale); identity for the f32 store."""
    if not gathered.is_floating_point() and "mf_scale" in ws:
        return gathered.float() * ws["mf_scale"]
    return gathered


def is_quantized(ws: Dict[str, torch.Tensor]) -> bool:
    return "mf_scale" in ws
