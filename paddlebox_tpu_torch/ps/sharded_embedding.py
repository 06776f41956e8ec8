"""Explicit sharded embedding exchange — the HeterComm equivalent.

Port of ``paddlebox_tpu/ps/sharded_embedding.py`` (≙ HeterComm's sharded
pull/push, heter_comm_inl.h: split_input_to_shard :1117 (key %
device_count), walk_to_dest / walk_to_src P2P hops :303/:316, the merged
gradient push :1730 and the inter-node allgather :2027/:2131).

The pass working set is row-sharded in contiguous blocks: shard d of the
table axes owns rows [d*rows_loc, (d+1)*rows_loc), so the owner of a row
is row // rows_loc, with no hash.  Pull: all_gather the batch's row ids
(ids are small beside values), each shard gathers the rows it owns and
reads zeros elsewhere, and one reduce_scatter returns each requester its
own slice.  Push: all_gather the (id, payload) pairs and each shard
merges the rows it owns (≙ gather_one_node_grad's allgather + local
merge, heter_comm_inl.h:2027).

Every function works on one topology's shards from one controller (see
``parallel/collective.py``): it takes and returns lists of per-shard
tensors, indexed by flat shard number, and ``axis`` names the table axes
(a tuple of topology axes).  Each shard's tensors live on its device
(``topology.devices``), where its plan is built and its kernels launch;
values cross between devices only in the collectives.  Under a topology
whose dp axis spans processes the lists hold None for the shards of the
other processes and each process plans and runs its own shards.  On the
multi-node layout only the push's second tier crosses the group; where
the table axes span processes (the flat layout), the ids' and the
payload's all_gather and the pull's reduce_scatter cross it too.

The mxu variants run each shard's random access through the sorted
kernels (``ops/sorted_spmm.py``: a hand-written CUDA kernel on the card,
its plain version on the CPU).  Ids outside a shard's block are parked at
its plan's sentinel row, so ownership masking falls out of the kernel
geometry: the gather reads the zero sentinel tile there, and the scatter
sums them into a tile that is cut off.  Under
``FLAGS_sharded_exchange_bf16`` the exchanged values travel in bfloat16
(ids, plans and the push's slot column stay exact).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.parallel import collective as col
from paddlebox_tpu_torch.parallel.topology import HybridTopology

Shards = List[torch.Tensor]


def _exchange_bf16(exchange_bf16: Optional[bool]) -> bool:
    if exchange_bf16 is None:
        return bool(flags.get_flags("sharded_exchange_bf16"))
    return exchange_bf16


def _map(fn, xs: Sequence) -> list:
    """``fn`` of each local shard's entry; None stays None."""
    return [None if x is None else fn(x) for x in xs]


def _localize(idx_all: torch.Tensor, me: int, rows_loc: int,
              outside: int) -> torch.Tensor:
    """Global row ids → ids local to block ``me``; ids of other blocks
    become ``outside``."""
    local = idx_all - me * rows_loc
    return torch.where((local >= 0) & (local < rows_loc), local,
                       torch.full_like(local, outside))


def pull_rows_sharded(table_local: Shards, idx_local: Shards,
                      topo: HybridTopology, axis) -> Shards:
    """table_local: each shard's [rows_loc, D] block of the [N, D] table;
    idx_local: each shard's [P_loc] global row ids.  → [P_loc, D] each."""
    idx_all = col.all_gather(idx_local, topo, axis)              # [P]
    vals = []
    for k, tab in enumerate(table_local):
        rows_loc = tab.shape[0]
        local = idx_all[k] - topo.axis_index(k, axis) * rows_loc
        mine = (local >= 0) & (local < rows_loc)
        v = tab[torch.clamp(local, 0, rows_loc - 1).long()]
        vals.append(v * mine[:, None].to(tab.dtype))
    return col.reduce_scatter(vals, topo, axis, scatter_dim=0)


def push_rows_sharded(table_local: Shards, idx_local: Shards,
                      grads_local: Shards, topo: HybridTopology,
                      axis) -> Shards:
    """Scatter-add each shard's [P_loc, D] grads into the row-sharded
    table (the merge lands on the owner, ≙ push_sparse_multi_node).
    Non-owned occurrences add zeros to local row 0.  The merge is
    ``sp.segment_sum``: a fixed order, no float atomics."""
    idx_all = col.all_gather(idx_local, topo, axis)
    g_all = col.all_gather(grads_local, topo, axis)
    out = []
    for k, tab in enumerate(table_local):
        rows_loc = tab.shape[0]
        local = idx_all[k] - topo.axis_index(k, axis) * rows_loc
        mine = (local >= 0) & (local < rows_loc)
        safe = torch.where(mine, local, torch.zeros_like(local))
        g = g_all[k] * mine[:, None].to(g_all[k].dtype)
        out.append(tab + sp.segment_sum(g, safe, rows_loc))
    return out


# ---------------------------------------------------------------------------
# mxu variants: the per-shard access through the sorted kernels
# ---------------------------------------------------------------------------

def local_plan(idx_local: Shards, rows_loc: int, topo: HybridTopology,
               axis) -> Tuple[sp.SpmmDims, list]:
    """all_gather the ids over ``axis`` and localize them to each shard's
    row block; ids outside the block park at the sentinel row.  Returns
    (dims, one ``sorted_spmm.Plan`` per shard).

    Pull and push need the identical plan, so callers build it once per
    step (or once per pass) and hand it to both — the sort is the only
    data-dependent cost of the exchange (≙ the reference building its
    shard index once in split_input_to_shard, heter_comm_inl.h:1117).
    all_gather concatenates the shards' ids in axis order, and the stable
    sort keeps that order among equal rows, so each row's first
    occurrence (the slot carry) is its first in the gathered order."""
    idx_all = col.all_gather(idx_local, topo, axis)              # [P]
    dims = sp.spmm_dims(idx_all[topo.local_shards[0]].shape[0], rows_loc)
    plans = [None] * topo.world_size
    for k in topo.local_shards:
        plans[k] = sp.build_plan(_localize(
            idx_all[k], topo.axis_index(k, axis), rows_loc, dims.sentinel),
            dims)
    return dims, plans


def _plan_dims(plan: sp.Plan, rows_loc: int) -> sp.SpmmDims:
    """Geometry a local plan was built with (inv_perm carries the
    gathered occurrence count).  Sharded exchanges take untrimmed plans
    only: a trimmed plan keeps inv_perm full-length while its sorted
    arrays shrink, and its trim assumes padding sorts to the front, where
    a shard's non-owned ids sort to the back."""
    dims = sp.spmm_dims(plan.inv_perm.shape[0], rows_loc)
    if plan.rows2d.shape[0] != dims.n_chunks:
        raise ValueError(
            f"sharded exchange needs an untrimmed local_plan: rows2d has "
            f"{plan.rows2d.shape[0]} chunks, geometry expects "
            f"{dims.n_chunks}")
    return dims


def _plans(idx_local: Shards, rows_loc: int, topo: HybridTopology, axis,
           plans: Optional[Sequence]):
    if plans is None:
        return local_plan(idx_local, rows_loc, topo, axis)
    return _plan_dims(plans[topo.local_shards[0]], rows_loc), plans


def pull_rows_sharded_mxu(table_fm_local: Shards, idx_local: Shards,
                          topo: HybridTopology, axis, plans=None,
                          exchange_bf16: Optional[bool] = None) -> Shards:
    """table_fm_local: each shard's [W, rows_loc] feature-major block;
    idx_local: each shard's [P_loc] global row ids.  → [W, P_loc] pulled
    values each.

    ≙ HeterComm pull_merge_sparse (heter_comm_inl.h:1296) with the shard
    walk replaced by all_gather(ids) + the shard's sorted gather +
    reduce_scatter(values).  ``plans``: the :func:`local_plan` plans of
    these ids (skips the in-step gather + sort; pull and push share
    them).  Every value has exactly one nonzero contributor (its owner),
    so the bf16 exchange only rounds that value."""
    rows_loc = table_fm_local[topo.local_shards[0]].shape[1]
    dims, plans = _plans(idx_local, rows_loc, topo, axis, plans)
    vals = [None] * topo.world_size
    for k in topo.local_shards:
        block = table_fm_local[k]
        rows2d, inv_perm = plans[k].rows2d, plans[k].inv_perm
        # the block padded to the kernel geometry (sentinel tile = zeros)
        tab = torch.zeros((block.shape[0], dims.n_kernel),
                          dtype=torch.float32, device=block.device)
        tab[:, :rows_loc] = block
        g = sp.gather_sorted(tab, rows2d, dims)                  # [W, p_pad]
        vals[k] = g[:, :dims.p][:, inv_perm.long()]              # [W, P]
    if _exchange_bf16(exchange_bf16):
        vals = _map(lambda v: v.to(torch.bfloat16), vals)
        return _map(lambda v: v.to(torch.float32),
                    col.reduce_scatter(vals, topo, axis, scatter_dim=1))
    return col.reduce_scatter(vals, topo, axis, scatter_dim=1)


def push_rows_sharded_mxu(idx_local: Shards, payload_local: Shards,
                          rows_loc: int, topo: HybridTopology, axis,
                          first_only_col: int = -1, plans=None,
                          exchange_bf16: Optional[bool] = None) -> Shards:
    """payload_local: each shard's [W, P_loc] per-occurrence push values.
    → each shard's merged per-row accumulators [W, rows_loc] over its
    block (fed to the optimizer; ≙ gather_one_node_grad + local merge,
    heter_comm_inl.h:2027).

    first_only_col >= 0: that payload row keeps only each table row's
    first occurrence before the merge (the exact carry of the slot id
    instead of a sum — each row is owned by exactly one shard, so its
    first gathered occurrence is the global first).  Under the bf16
    exchange that row still travels in f32 (bf16 rounds integers above
    256, and the slot id is rounded back to an integer)."""
    dims, plans = _plans(idx_local, rows_loc, topo, axis, plans)
    c = first_only_col
    if _exchange_bf16(exchange_bf16):
        if c >= 0:
            body = _map(lambda p: torch.cat([p[:c], p[c + 1:]]).to(
                torch.bfloat16), payload_local)
            body_all = col.all_gather(body, topo, axis, concat_dim=1)
            slot_all = col.all_gather(_map(lambda p: p[c:c + 1],
                                           payload_local),
                                      topo, axis, concat_dim=1)
            pay_all = [None if b is None
                       else torch.cat([b[:c].float(), s, b[c:].float()])
                       for b, s in zip(body_all, slot_all)]
        else:
            pay_all = _map(lambda p: p.float(), col.all_gather(
                _map(lambda p: p.to(torch.bfloat16), payload_local), topo,
                axis, concat_dim=1))
    else:
        pay_all = col.all_gather(payload_local, topo, axis, concat_dim=1)
    out = [None] * topo.world_size
    for k in topo.local_shards:
        pay = pay_all[k]
        plan = plans[k]
        rows2d, perm, first_occ = plan.rows2d, plan.perm, plan.first_occ
        srt = torch.zeros((pay.shape[0], dims.p_pad), dtype=torch.float32,
                          device=pay.device)
        srt[:, :dims.p] = pay[:, perm.long()]
        if c >= 0:
            srt[c] *= first_occ
        delta = sp.scatter_add_sorted(srt, rows2d, first_occ, dims)
        out[k] = delta[:, :rows_loc]
    return out


def push_rows_sharded_mxu_multinode(idx_local: Shards, payload_local: Shards,
                                    rows_loc: int, topo: HybridTopology,
                                    ici_axis, dcn_axis,
                                    first_only_col: int = -1, plans=None,
                                    exchange_bf16: Optional[bool] = None
                                    ) -> Shards:
    """Two-tier push for the reference's multi-node layout: the table is
    split within a node (``ici_axis``) and replicated across nodes
    (``dcn_axis``), and nodes are data-parallel over the batch.

    ≙ gather_one_node_grad + gather_multi_node_grad
    (heter_comm_inl.h:2027,2131): stage 1 merges the node's own batch
    into each shard's row block (all_gather ids/payload + the sorted
    merge); stage 2 sums the node-merged [W, rows_loc] deltas across
    nodes, so the cross-node bytes are one dense block instead of every
    node's raw payload.  The first-only column (slot carry) takes the max
    over nodes instead of the sum (each node's merge elects a first
    occurrence; the sum would add them).  Where ``dcn_axis`` spans
    processes, stage 2 is the collectives' cross-process ``all_reduce``:
    every node's delta exchanged through host memory and folded in node
    order on each."""
    node = push_rows_sharded_mxu(idx_local, payload_local, rows_loc, topo,
                                 ici_axis, first_only_col, plans,
                                 exchange_bf16)
    c = first_only_col
    if c < 0:
        return col.all_reduce(node, topo, dcn_axis)
    slots = col.all_reduce(_map(lambda d: d[c], node), topo, dcn_axis,
                           "max")
    rest = col.all_reduce(_map(lambda d: torch.cat(
        [d[:c], torch.zeros_like(d[c:c + 1]), d[c + 1:]]), node), topo,
        dcn_axis)
    return [None if r is None else torch.cat([r[:c], s[None], r[c + 1:]])
            for r, s in zip(rest, slots)]
