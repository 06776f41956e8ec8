"""Device-resident pass working set.

Port of ``paddlebox_tpu/ps/embedding.py``: key→row translation on the
host against the pass's sorted unique key array (``PassKeyMapper``), and
the working set as a dict of tensors on one explicit device, one tensor
per field (``show`` [N], ``mf`` [N, D], ...).

Under a topology whose shards sit on distinct devices, each field is a
``parallel.topology.Sharded``: shard d's block of rows under
``topology.table_spec()`` on shard d's device (≙ the JAX package's
``sharding=``), so no device holds the whole set; the write-back joins
the blocks on the host in row order.  Under a dp axis that spans
processes each process builds its own shards' blocks only: one whole
replica of the set on the multi-node layout, its own row blocks where
the table is split across processes.  Every process reads the whole
pass, so every process builds the same rows; rows are written where
they are held, and the write-back's join receives the other processes'
blocks over the group, so every rank writes every row back into its
host table.

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
from paddlebox_tpu_torch.parallel.topology import Sharded, Spec, transfer
from paddlebox_tpu_torch.utils.monitor import stat_add

def localize(idx: torch.Tensor, row0: int, n: int):
    """Global rows → (rows local to the block [row0, row0 + n), which of
    them the block holds); the others become row ``n``."""
    local = idx - row0
    own = (local >= 0) & (local < n)
    return torch.where(own, local, torch.full_like(local, n)), own


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
                      pad_to: Optional[int] = None, topology=None
                      ) -> Dict[str, torch.Tensor]:
    """Assemble the working set from host rows (row 0 = zeros) on
    ``device``: one staging copy per field into a padded host buffer —
    pinned when the device is a card — then one asynchronous
    host→device copy per field (≙ BuildGPUTask's HBM pool fill,
    ps_gpu_wrapper.cc:684-760).  Under a ``topology`` whose shards sit on
    distinct devices each field is a ``Sharded`` of its
    ``table_spec()`` row blocks, each copied to its local shard's
    device.

    The reserved all-zero row 0 is load-bearing: the mxu path points
    padding occurrences at it so they pool as exact 0.0.
    """
    n = len(host_soa["show"])
    total = (pad_to if pad_to is not None else size_bucket(n + 1))
    assert total >= n + 1
    blocks = topology is not None and topology.multi_device
    pin = device.type == "cuda" and not blocks
    ws = {}
    for f in host_soa:
        if f == "unseen_days":  # host-only lifecycle field
            continue
        src = host_soa[f]
        dtype = torch.int32 if src.dtype == np.int32 else torch.float32
        buf = torch.zeros((total,) + src.shape[1:], dtype=dtype,
                          pin_memory=pin)
        buf.numpy()[1:n + 1] = src
        if blocks:
            ws[f] = topology.place(buf, topology.table_spec())
        else:
            # each staging buffer is fresh and owned by its copy, so the
            # non-blocking H2D cannot race a later rewrite
            ws[f] = buf.to(device, non_blocking=True) if pin else buf
    return ws


def zeros_like(t):
    """A zero field shaped and placed like ``t`` (a tensor or a
    ``Sharded``)."""
    return t.zeros_like() if isinstance(t, Sharded) else torch.zeros_like(t)


def write_rows(ws: Dict[str, torch.Tensor], rows: np.ndarray,
               values: Dict[str, np.ndarray]) -> None:
    """Overwrite the unique pass rows ``rows`` of every field in
    ``values`` with host values, in place; under a ``Sharded`` field
    every block that holds a row takes it (``Sharded.scatter_rows``)."""
    r = None
    for f, t in ws.items():
        if f not in values:
            continue
        if isinstance(t, Sharded):
            t.scatter_rows(rows, torch.as_tensor(values[f], dtype=t.dtype),
                           "cpu")
            continue
        if r is None:
            r = torch.as_tensor(rows.astype(np.int64), device=t.device)
        t[r] = torch.as_tensor(values[f], dtype=t.dtype, device=t.device)


def scatter_device_rows(ws: Dict[str, torch.Tensor], rows,
                        values: Dict[str, torch.Tensor],
                        device=None) -> int:
    """Cached-plane working-set fill: write already-device-resident row
    values (a DeviceRowCache gather, on ``device``) into the pass working
    set in place — no host staging and no H2D for these rows.  ``rows``
    are unique, so ``index_copy_`` writes each row once and the result is
    deterministic.  Dtypes must already match the working set's (the
    cache stores build_working_set's exact casts), so ``pull_sparse`` /
    ``push_sparse_grads`` see bits identical to a wire pull.  A
    ``Sharded`` field takes each row into the blocks that hold it, a copy
    where a block lives on another device.  Returns the rows copied
    between devices (counted once, not per field)."""
    rows_d, moved = None, 0
    for f, v in values.items():
        if f not in ws:
            continue
        if isinstance(ws[f], Sharded):
            n = ws[f].scatter_rows(rows, v, device)
            moved = max(moved, n)
            continue
        if rows_d is None:
            rows_d = torch.as_tensor(rows, dtype=torch.int64,
                                     device=ws[f].device)
        ws[f].index_copy_(0, rows_d, v)
    return moved


def dump_working_set(ws: Dict[str, torch.Tensor], n: int
                     ) -> Dict[str, np.ndarray]:
    """Device→host for end_pass write-back (≙ dump_pool_to_cpu_func,
    ps_gpu_wrapper.cc:983+): rows 1..n of every field (a ``Sharded``
    field's blocks joined on the host in row order; where the set is
    split across processes the join receives the other processes'
    blocks, so every rank calls this and gets every row).  Table-wide
    scalars (a serving freeze's 0-d ``mf_scale``) are not row data and
    are skipped."""
    return {f: (ws[f].join("cpu") if isinstance(ws[f], Sharded)
                else ws[f])[1:n + 1].cpu().numpy()
            for f in ws if ws[f].dim() >= 1}


def quantize_working_set(ws: Dict[str, torch.Tensor], quant_bits: int = 16,
                         scale: float = 1.0 / 32767.0
                         ) -> Dict[str, torch.Tensor]:
    """Serving-mode freeze: re-encode mf as int16 grid points,
    ``clip(round(mf / scale), ±32767)``, so embedx pulls read half the
    bytes and the set holds half the memory (≙ the quant feature value +
    EmbedxQuantOp dequant-on-pull, box_wrapper.cu:37-44, table-wide
    pull_embedx_scale box_wrapper.h:655).  ``mf_scale`` is a 0-d float32
    tensor on the working set's device; the division is by that tensor,
    so it is an IEEE f32 division on either device (a Python float would
    let a card kernel multiply by its reciprocal instead), and
    ``torch.round`` rounds half to even as ``jnp.round`` does.  A
    ``Sharded`` mf is quantized block by block where each block lives,
    and ``mf_scale`` is then a ``Sharded`` of one 0-d scale per shard on
    its device.

    The quantized working set is PULL-ONLY: pushes need the f32 store
    (the reference likewise quantizes only dumped/serving tables)."""
    if quant_bits != 16:
        raise ValueError("only quant_bits=16 (int16 grid) is supported")
    out = dict(ws)
    mf = ws["mf"]

    def scale_on(device):
        return torch.tensor(scale, dtype=torch.float32, device=device)

    def quantize(m, s):
        return torch.clamp(torch.round(m / s), -32767, 32767).to(torch.int16)

    if isinstance(mf, Sharded):
        out["mf"] = mf.map_blocks(lambda m: quantize(m, scale_on(m.device)))
        out["mf_scale"] = Sharded([None if p is None else scale_on(p.device)
                                   for p in mf.parts],
                                  mf.topo, Spec())
        return out
    s = scale_on(mf.device)
    out["mf"] = quantize(mf, s)
    out["mf_scale"] = s
    return out


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


def pull_sparse(ws: Dict[str, torch.Tensor], indices: torch.Tensor,
                row0: Optional[int] = None, device=None) -> torch.Tensor:
    """Gather pull values [*, 3+D]: (show, click, embed_w, embedx×D).

    ≙ PullSparseCaseGPU + CopyForPull (box_wrapper_impl.h:25,
    box_wrapper.cu:945).  mf is masked until created (mf_size > 0,
    CommonPullValue semantics, feature_value.h:161).  ``row0``: ``ws``
    is the block of rows from global row ``row0``, and ids it does not
    hold pull zeros.  Over a ``Sharded`` set each block pulls the ids it
    holds where it lives, and the values are selected into one tensor on
    ``device`` (the placement of ``indices``; default the topology's
    first device)."""
    if isinstance(ws["show"], Sharded):
        return _pull_blocks(ws, indices, device)
    own = None
    if row0 is not None:
        indices, own = localize(indices, row0, ws["show"].shape[0])
        indices = torch.where(own, indices, torch.zeros_like(indices))
    idx = indices.long()
    created = (ws["mf_size"][idx] > 0).to(torch.float32)
    mf = mf_values(ws, ws["mf"][idx]) * created[..., None]
    out = torch.cat([ws["show"][idx][..., None], ws["click"][idx][..., None],
                     ws["embed_w"][idx][..., None], mf], dim=-1)
    if own is not None:
        out = torch.where(own[..., None], out, torch.zeros_like(out))
    return out


def _pull_blocks(ws: Dict, indices: torch.Tensor, device) -> torch.Tensor:
    """:func:`pull_sparse` over a ``Sharded`` set: each row block's
    values of the ids it holds, copied to ``device`` and selected there
    (a select, not a sum, so the bits equal one device's pull)."""
    show = ws["show"]
    topo = show.topo
    if len(show.row_blocks()) < len(show.row_homes()):
        topo.refuse_cross_process("pull_sparse over a working set split "
                                  "across processes")
    device = topo.device if device is None else device
    out = None
    for k, sl, _ in show.row_blocks():
        dev = topo.devices[k]
        blk = {f: t.parts[k] for f, t in ws.items()}
        v = transfer(pull_sparse(blk, transfer(indices, device, dev),
                                 row0=sl.start), dev, device)
        own = ((indices >= sl.start) & (indices < sl.stop))[..., None]
        out = v if out is None else torch.where(own, v, out)
    return out


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
                      grads: torch.Tensor, slot_ids: torch.Tensor,
                      row0: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """Merge per-occurrence push values into per-row accumulators
    (merge-by-key, ≙ PushMergeCopyAtomic box_wrapper.cu:476).

    indices [S, B, L] pass rows; grads [S, B, L, 3+D], columns (g_show,
    g_click, g_embed, g_embedx...); slot_ids [S] int32.  Returns g_show /
    g_click / g_embed [N], g_embedx [N, D] and the per-row slot id.  Row 0
    (padding) accumulates too; the optimizer's mask ignores it.
    ``row0``: ``ws`` is the block of rows from global row ``row0``; the
    occurrences of rows it does not hold merge into a spare row N, cut
    off, so each block merges exactly the rows it owns."""
    n = ws["show"].shape[0]
    s, b, l = indices.shape
    flat_idx = indices.reshape(-1)
    n_seg = n
    if row0 is not None:
        flat_idx, _ = localize(flat_idx, row0, n)
        n_seg = n + 1
    flat_g = grads.reshape(-1, grads.shape[-1])
    merged = sp.segment_sum(flat_g, flat_idx, n_seg)[:n]    # [N, 3+D]
    # only valid occurrences vote for the row's slot (the show grad column
    # carries the seqpool key mask: ins_show > 0 exactly where the key is
    # real); an integer max is exact in any order
    flat_slot = slot_ids.to(torch.int32)[:, None, None].expand(
        s, b, l).reshape(-1)
    slot = torch.zeros((n_seg,), dtype=torch.int32,
                       device=flat_idx.device).scatter_reduce_(
        0, flat_idx.long(), torch.where(flat_g[:, 0] > 0, flat_slot,
                                        torch.zeros_like(flat_slot)),
        "amax", include_self=True)[:n]
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
