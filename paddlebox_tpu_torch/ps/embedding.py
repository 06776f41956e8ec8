"""Device-resident pass working set.

Port of ``paddlebox_tpu/ps/embedding.py``: key→row translation on the
host against the pass's sorted unique key array (``PassKeyMapper``), and
the working set as a dict of tensors on one explicit device, one tensor
per field (``show`` [N], ``mf`` [N, D], ...).

Row 0 is the reserved zero row: padding positions and unknown keys point
at it, pull zeros and push nothing (≙ FLAGS_enable_pull_box_padding_zero).

``pull_sparse`` / ``push_sparse_grads`` are the reference lowering's pull
(a plain gather per field) and merged push; their ``_extended`` forms add
an expand table's ``mf_ex`` columns.  The push merges every float
column with one ``sorted_spmm.segment_sum`` (a stable sort of the row
ids, then the ``scatter_add_sorted`` kernel on a card): the JAX package's
``.at[].add`` in a fixed order, where ``index_add_`` on a card would add
with float atomics in an order that changes from run to run.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.utils.monitor import stat_add


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

    Row 0 is reserved (zero row); real keys map to rows 1..n.  The rows come
    from the native open-addressing hash (native/hash_shard.cc), built once
    here with the keys inserted in sorted order, so row i + 1 is the
    binary search's answer; probes of 65,536 keys or more are threaded.
    Without the native library a binary search gives the same rows.  The
    keys each resolved are counted in ``ps.mapper.native_rows`` /
    ``ps.mapper.sorted_rows``.  The hash is read-only after construction,
    so the packer's threads may call the mapper at once.
    """

    def __init__(self, sorted_keys: np.ndarray):
        from paddlebox_tpu_torch.native import hash_map
        self.sorted_keys = sorted_keys  # unique, ascending, excludes 0
        self._native = None
        if len(sorted_keys) and hash_map.available():
            self._native = hash_map.NativeKeyHash(len(sorted_keys))
            self._native.upsert(sorted_keys)

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        if len(self.sorted_keys) == 0:
            return np.zeros(len(keys), np.int32)
        if self._native is not None:
            stat_add("ps.mapper.native_rows", float(len(keys)))
            return self._native.find_rows1_i32(np.asarray(keys, np.uint64))
        stat_add("ps.mapper.sorted_rows", float(len(keys)))
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


def scatter_device_rows(ws: Dict[str, torch.Tensor], rows,
                        values: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Cached-plane working-set fill: write already-device-resident row
    values (a DeviceRowCache gather) into the pass working set in place —
    no host staging and no H2D for these rows.  ``rows`` are unique, so
    ``index_copy_`` writes each row once and the result is deterministic.
    Dtypes must already match the working set's (the cache stores
    build_working_set's exact casts), so ``pull_sparse`` /
    ``push_sparse_grads`` see bits identical to a wire pull."""
    dev = next(iter(ws.values())).device
    rows_d = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    for f, v in values.items():
        if f in ws:
            ws[f].index_copy_(0, rows_d, v)
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


def cvm_pooled(pooled: torch.Tensor, use_cvm: bool = True) -> torch.Tensor:
    """Sum-pooled pull values [S, B, 3+D] (show, click, w, mf...) →
    [B, S, 3+D], with the CVM transform of the first two columns
    (log(show+1), log(click+1) - log(show+1)) when ``use_cvm`` — the
    tail every lowering's pull shares (≙ ops/cvm.py of the JAX
    package)."""
    show, click = pooled[:, :, 0], pooled[:, :, 1]
    if use_cvm:
        show_t = torch.log(show + 1.0)
        click_t = torch.log(click + 1.0) - show_t
    else:
        show_t, click_t = show, click
    pooled = torch.cat([torch.stack([show_t, click_t], dim=-1),
                        pooled[:, :, 2:]], dim=-1)
    return pooled.permute(1, 0, 2)


def is_quantized(ws: Dict[str, torch.Tensor]) -> bool:
    return "mf_scale" in ws


def pull_sparse(ws: Dict[str, torch.Tensor], indices: torch.Tensor
                ) -> torch.Tensor:
    """Gather pull values [*, 3+D]: (show, click, embed_w, embedx×D).

    ≙ PullSparseCaseGPU + CopyForPull (box_wrapper_impl.h:25,
    box_wrapper.cu:945).  mf is masked until created (mf_size > 0,
    CommonPullValue semantics, feature_value.h:161)."""
    idx = indices.long()
    created = (ws["mf_size"][idx] > 0).to(torch.float32)
    mf = mf_values(ws, ws["mf"][idx]) * created[..., None]
    return torch.cat([ws["show"][idx][..., None], ws["click"][idx][..., None],
                      ws["embed_w"][idx][..., None], mf], dim=-1)


def pull_sparse_extended(ws: Dict[str, torch.Tensor], indices: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """≙ pull_box_extended_sparse / PullCopyNNCross (box_wrapper.cu:147):
    the base pull value [*, 3+D] and the expand ("NNCross") embedding
    [*, Dex], gated by the same mf-created mask."""
    base = pull_sparse(ws, indices)
    idx = indices.long()
    created = (ws["mf_size"][idx] > 0).to(ws["mf_ex"].dtype)
    return base, ws["mf_ex"][idx] * created[..., None]


def push_sparse_grads(ws: Dict[str, torch.Tensor], indices: torch.Tensor,
                      grads: torch.Tensor, slot_ids: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Merge per-occurrence push values into per-row accumulators
    (merge-by-key, ≙ PushMergeCopyAtomic box_wrapper.cu:476).

    indices [S, B, L] pass rows; grads [S, B, L, 3+D], columns (g_show,
    g_click, g_embed, g_embedx...); slot_ids [S] int32.  Returns g_show /
    g_click / g_embed [N], g_embedx [N, D] and the per-row slot id.  Row 0
    (padding) accumulates too; the optimizer's mask ignores it."""
    n = ws["show"].shape[0]
    s, b, l = indices.shape
    flat_idx = indices.reshape(-1)
    flat_g = grads.reshape(-1, grads.shape[-1])
    merged = sp.segment_sum(flat_g, flat_idx, n)            # [N, 3+D]
    # only valid occurrences vote for the row's slot (the show grad column
    # carries the seqpool key mask: ins_show > 0 exactly where the key is
    # real); an integer max is exact in any order
    flat_slot = slot_ids.to(torch.int32)[:, None, None].expand(
        s, b, l).reshape(-1)
    slot = torch.zeros((n,), dtype=torch.int32,
                       device=flat_idx.device).scatter_reduce_(
        0, flat_idx.long(), torch.where(flat_g[:, 0] > 0, flat_slot,
                                        torch.zeros_like(flat_slot)),
        "amax", include_self=True)
    return {"g_show": merged[:, 0], "g_click": merged[:, 1],
            "g_embed": merged[:, 2], "g_embedx": merged[:, 3:],
            "slot": slot}


def push_sparse_grads_extended(ws: Dict[str, torch.Tensor],
                               indices: torch.Tensor, grads: torch.Tensor,
                               grads_ex: torch.Tensor,
                               slot_ids: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
    """Extended push (≙ push_box_extended_sparse): the base accumulators
    of :func:`push_sparse_grads` plus ``g_embedx_ex`` [N, Dex], the
    expand grads [S, B, L, Dex] merged by row the same way."""
    acc = push_sparse_grads(ws, indices, grads, slot_ids)
    acc["g_embedx_ex"] = sp.segment_sum(
        grads_ex.reshape(-1, grads_ex.shape[-1]), indices.reshape(-1),
        ws["show"].shape[0])
    return acc
