"""mxu sparse step path: pull/pool and push/update via sorted_spmm.

Port of ``paddlebox_tpu/ps/mxu_path.py``.  The per-batch embedding
traffic runs through the sorted gather and merged scatter
(ops/sorted_spmm.py — hand-written CUDA kernels on the card); the
optimizer is ``ps.optimizer.apply_push`` over the merged per-row
accumulators (``g_show``, ``g_click``, ``g_embed``, ``g_embedx``, slot).

≙ reference hot path: PullSparseCaseGPU + CopyForPull
(box_wrapper_impl.h:25, box_wrapper.cu:945), PushMergeCopy merge-by-key
(box_wrapper.cu:417), HashTable::update (hashtable_kernel.cu).

Layout: occurrence order is canonical [S, L, B] flattened; the plan's
``perm``/``inv_perm`` move between canonical and sorted domains.  The
pull table is feature-major [W, n_kernel] with W = 3 + D (+ Dex) + 1
(show, click, embed_w, mf×D, an expand table's mf_ex×Dex, mf_size).  On
the pull the crossing back and the pooling are one kernel
(``sorted_spmm.pool_sorted_cvm``) that reads the sorted domain by
``inv_perm`` and writes the pooled [B, S, 3 + D (+ Dex)] rows; on the
push the payload crosses by one row gather by ``perm``.  Plans come in
the forms of the JAX package: the untrimmed :class:`~sorted_spmm.Plan`
the streaming step builds, and the packed pass feed's trimmed plans
(leading row-0 padding dropped).  The feed's :class:`StepPlan` adds what
the push reads beyond the plan: the static payload planes
(:class:`PayloadPlanes`) and the rows the batch's push reaches
(:class:`RuleRows`); with the rows the optimizer steps those rows alone,
without them every working-set row.
Expand ("NNCross", ``mf_ex``) tables ride the same table and payload:
their Dex columns follow mf, so the kernels run at W = 3 + D + Dex + 1
(pull) and D + Dex + 4 (push), and the pooled output is
[B, S, 3 + D + Dex].
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from paddlebox_tpu_torch.config import SparseSGDConfig
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps import optimizer as sparse_opt
from paddlebox_tpu_torch.ps.embedding import cvm_pooled, mf_values

Tensors = Dict[str, torch.Tensor]


class PayloadPlanes(NamedTuple):
    """A batch's static push payload planes over the kept sorted
    positions, built at feed time (``pass_feed._static_planes``)."""
    bs: torch.Tensor
    labelcol: torch.Tensor
    slotcol: torch.Tensor


class RuleRows(NamedTuple):
    """The rows a batch's push reaches and their mask, built at feed
    time (``pass_feed._rule_planes``)."""
    rows: torch.Tensor
    keep: torch.Tensor


class StepPlan(NamedTuple):
    """One batch's mxu step plan: the sorted-spmm plan, and the push's
    static payload planes and rule rows where the feed built them (the
    streaming step's in-step plan has neither)."""
    plan: sp.Plan
    payload: Optional[PayloadPlanes] = None
    rule: Optional[RuleRows] = None


def make_dims(num_occurrences: int, num_rows: int) -> sp.SpmmDims:
    return sp.spmm_dims(num_occurrences, num_rows)


def build_plan(idx_slb: torch.Tensor, dims: sp.SpmmDims,
               eff: Optional[sp.SpmmDims] = None) -> sp.Plan:
    """idx_slb [S, L, B] pass rows (0 = reserved/padding row)."""
    return sp.build_plan(idx_slb.reshape(-1), dims, eff)


def plan_eff_dims(plan: sp.Plan,
                  dims: sp.SpmmDims) -> Optional[sp.SpmmDims]:
    """Trimmed kernel geometry a plan was built with, recovered from its
    array shapes (None = untrimmed)."""
    n_chunks = plan.rows2d.shape[0]
    if n_chunks == dims.n_chunks:
        return None
    return sp.with_p_pad(dims, n_chunks * dims.chunk)


def _check_plan(plan: sp.Plan, dims: sp.SpmmDims) -> None:
    """A plan no wider than ``dims``."""
    if plan.rows2d.shape[0] > dims.n_chunks:
        raise ValueError(
            f"not a sorted-spmm plan for {dims}: "
            f"{plan.rows2d.shape[0]} chunks")


def _ex_dim(ws: Tensors) -> int:
    """Expand ("NNCross") embedding width, 0 without one.  The ex columns
    ride the feature-major table and payload directly after mf, so the
    kernels (any width) and the pooling (every column between 3 and the
    trailing mf_size is an embedding masked by created) need no
    branches."""
    return ws["mf_ex"].shape[1] if "mf_ex" in ws else 0


def _pull_table(ws: Tensors, dims: sp.SpmmDims) -> torch.Tensor:
    """Feature-major pull view [3 + D (+ Dex) + 1, n_kernel]."""
    n = ws["show"].shape[0]
    d = ws["mf"].shape[1]
    dx = _ex_dim(ws)
    # pboxlint: disable-next=PB301 -- documented pull-table build cost (one relayout per step, not per-row math)
    tab = torch.zeros((3 + d + dx + 1, dims.n_kernel), dtype=torch.float32,
                      device=ws["show"].device)
    tab[0, :n] = ws["show"]
    tab[1, :n] = ws["click"]
    tab[2, :n] = ws["embed_w"]
    # pboxlint: disable-next=PB301 -- documented pull-table build cost (one relayout per step, not per-row math)
    tab[3:3 + d, :n] = mf_values(ws, ws["mf"]).T
    if dx:
        # pboxlint: disable-next=PB301 -- documented pull-table build cost (one relayout per step, not per-row math)
        tab[3 + d:3 + d + dx, :n] = ws["mf_ex"].T
    # pboxlint: disable-next=PB301 -- documented pull-table build cost (one relayout per step, not per-row math)
    tab[3 + d + dx, :n] = ws["mf_size"].to(torch.float32)
    return tab


def pool_cvm_values(v: torch.Tensor, use_cvm: bool = True) -> torch.Tensor:
    """Canonical per-occurrence pull values [S, L, B, 3+D+1] (last column
    mf_size) → pooled [B, S, 3+D].  The pooling of the steps that cross
    to canonical values first: the sharded one and the row blocks."""
    d = v.shape[-1] - 4
    mf = v[..., 3:3 + d] * (v[..., 3 + d:] > 0).to(v.dtype)  # created mask
    show = torch.sum(v[..., 0], dim=1)                     # [S, B]
    click = torch.sum(v[..., 1], dim=1)
    w = torch.sum(v[..., 2], dim=1)
    mf = torch.sum(mf, dim=1)                              # [S, B, D]
    head = torch.stack([show, click, w], dim=-1)           # [S, B, 3]
    return cvm_pooled(torch.cat([head, mf], dim=-1), use_cvm)


def push_payload(d_pooled: torch.Tensor, ins_cvm: torch.Tensor,
                 slot_ids: torch.Tensor,
                 shape_slb: Tuple[int, int, int]) -> torch.Tensor:
    """Canonical per-occurrence push payload [S, L, B, D+4]:
    g_show, g_click, g_embed, g_mf x D, slot (reference push semantics —
    cols 0,1 of d_pooled are ignored, replaced by the instance cvm,
    box_wrapper_impl.h:373)."""
    s, l, b = shape_slb
    d = d_pooled.shape[-1] - 3
    g_show = ins_cvm[None, None, :, 0].expand(s, l, b)
    g_click = ins_cvm[None, None, :, 1].expand(s, l, b)
    d_w = d_pooled[:, :, 2].T                              # [S, B]
    g_embed = d_w[:, None, :].expand(s, l, b)
    d_mf = d_pooled[:, :, 3:].permute(1, 0, 2)             # [S, B, D]
    g_mf = d_mf[:, None].expand(s, l, b, d)
    slot_col = slot_ids.to(torch.float32)[:, None, None].expand(s, l, b)
    return torch.cat(
        [torch.stack([g_show, g_click, g_embed], dim=-1), g_mf,
         slot_col[..., None]], dim=-1)                     # [S,L,B,D+4]


def acc_from_delta(delta: torch.Tensor, n: int,
                   d_main: Optional[int] = None) -> Tensors:
    """Merged per-row accumulators for ps.optimizer.apply_push from the
    scatter output [D(+Dex)+4, >=n] (slot column already first-occurrence-
    exact).  d_main: the mf width when the payload also carries expand
    columns (they split into ``g_embedx_ex``)."""
    d = delta.shape[0] - 4
    if d_main is None:
        d_main = d
    acc = {
        "g_show": delta[0, :n],
        "g_click": delta[1, :n],
        "g_embed": delta[2, :n],
        "g_embedx": delta[3:3 + d_main, :n].T,
        "slot": torch.round(delta[d + 3, :n]).to(torch.int32),
    }
    if d_main < d:
        acc["g_embedx_ex"] = delta[3 + d_main:3 + d, :n].T
    return acc


def pull_pool_cvm(ws: Tensors, plan: sp.Plan, dims: sp.SpmmDims,
                  shape_slb: Tuple[int, int, int],
                  use_cvm: bool = True) -> torch.Tensor:
    """Fused pull + seqpool + CVM → pooled [B, S, 3 + D (+ Dex)],
    contiguous.

    Row 0 and the sentinel tile hold zeros, so padding occurrences and
    unseen keys contribute nothing — no length mask needed on the pull
    side.  Two launches after the table: the sorted gather, then
    ``pool_sorted_cvm``, which reads the gathered values by inv_perm
    (skipping a trimmed plan's dropped row-0 positions), masks the
    embedding columns by created and pools with the CVM."""
    _check_plan(plan, dims)
    eff = plan_eff_dims(plan, dims)
    tab = _pull_table(ws, dims)
    g = sp.gather_sorted(tab, plan.rows2d, eff or dims)    # [3+D+1, p_pad]
    return sp.pool_sorted_cvm(g, plan.inv_perm, shape_slb, use_cvm)


def push_and_update(ws: Tensors, plan: sp.Plan, dims: sp.SpmmDims,
                    idx_slb: torch.Tensor, d_pooled: torch.Tensor,
                    ins_cvm: torch.Tensor, slot_ids: torch.Tensor,
                    cfg: SparseSGDConfig,
                    payload: Optional[PayloadPlanes] = None,
                    rule: Optional[RuleRows] = None) -> Tensors:
    """Merged push + sparse optimizer, updating ``ws`` in place.

    d_pooled [B, S, 3+D(+Dex)] — cols 0,1 are ignored and replaced by the
    instance cvm (reference push semantics, box_wrapper_impl.h:373);
    ins_cvm [B, 2]; slot_ids [S].  The canonical→sorted crossing gathers
    by perm.

    With the static payload planes (``payload``, built at feed time)
    only the DYNAMIC columns cross: g_show ≡ 1 is a constant row,
    g_click and slot are the feed-time planes, and g_embed + D×g_mf are
    gathered from the [B·S, 1+D] pooled-grad matrix by ``bs`` (≙
    CopyForPush building the payload per key slot, box_wrapper.cu:1168).

    With the rule's rows (``rule``, built at feed time) the optimizer
    steps only the rows the batch pushed (≙ HashTable::update over the
    merged keys); without them (the streaming step's in-step plan) it
    sweeps the whole working set, its untouched rows masked."""
    _check_plan(plan, dims)
    s, l, b = idx_slb.shape
    d = ws["mf"].shape[1] + _ex_dim(ws)
    n = ws["show"].shape[0]
    w = d + 4
    eff = plan_eff_dims(plan, dims)
    kd = eff or dims
    if payload is not None:
        p2 = d_pooled[:, :, 2:].reshape(b * s, 1 + d)       # b-major rows
        dyn = p2[payload.bs.long()].T.to(torch.float32)     # [1+D, p_pad]
        ones = torch.ones((1, kd.p_pad), dtype=torch.float32,
                          device=dyn.device)
        srt_cm = torch.cat([ones, payload.labelcol[None], dyn,
                            payload.slotcol[None]], dim=0).contiguous()
    else:
        flat = push_payload(d_pooled, ins_cvm, slot_ids,
                            (s, l, b)).reshape(dims.p, w)
        # trimmed plans keep the suffix of the full bijection: dropped
        # row-0 occurrences never scatter (row 0 is reserved); the
        # sentinel-padded tail carries nothing
        srt_cm = flat[sp.kept_perm(plan.perm, dims, kd).long()
                      ].T.contiguous()
        srt_cm[:, kd.p_pad - (dims.p_pad - dims.p):] = 0.0
        # slot column: keep only each row's FIRST occurrence (plan mask),
        # so the scatter-sum returns that occurrence's slot exactly (≙ the
        # reference's per-key slot from its merge position,
        # box_wrapper.cu:417 PushMergeCopy)
        srt_cm[w - 1] *= plan.first_occ
    delta = sp.scatter_add_sorted(srt_cm, plan.rows2d, plan.first_occ, kd)
    acc = acc_from_delta(delta, n, d_main=ws["mf"].shape[1])
    if rule is None:
        return sparse_opt.apply_push(ws, acc, cfg)
    return sparse_opt.apply_push(ws, acc, cfg, rows=rule.rows,
                                 keep=rule.keep)


# ---------------------------------------------------------------------------
# one row block of a working set split over devices
# ---------------------------------------------------------------------------

def block_plan(idx_slb: torch.Tensor, row0: int, n: int):
    """(dims, plan) of a block of ``n`` rows from global row ``row0``
    over the canonical ids ``idx_slb`` [S, L, B] of the whole batch:
    the ids the block does not hold park at the plan's sentinel, so the
    gather reads zeros there and the scatter sums them into the tile
    that is cut off.  The stable sort keeps canonical order among equal
    rows, so a row's first occurrence is the one-device plan's."""
    flat = idx_slb.reshape(-1)
    dims = make_dims(flat.shape[0], n)
    local = flat - row0
    own = (local >= 0) & (local < n)
    return dims, sp.build_plan(
        torch.where(own, local, torch.full_like(local, dims.sentinel)),
        dims)


def pull_values_block(ws: Tensors, plan: sp.Plan, dims: sp.SpmmDims
                      ) -> torch.Tensor:
    """The block's pull values of every occurrence, canonical [P, W]
    (W = 3 + D (+ Dex) + 1, the last column mf_size): its rows' values,
    zeros at the ids it does not hold.  Summed over the blocks they are
    the one-device values (one block holds each id)."""
    tab = _pull_table(ws, dims)
    g = sp.gather_sorted(tab, plan.rows2d, dims)           # [W, p_pad]
    return g.T[:dims.p][plan.inv_perm.long()]


def push_block(ws: Tensors, plan: sp.Plan, dims: sp.SpmmDims,
               payload: torch.Tensor,
               cfg: SparseSGDConfig, row0: int) -> Tensors:
    """Merged push + sparse optimizer of one block, in place: payload
    [P, D (+ Dex) + 4] the canonical per-occurrence push values of the
    whole batch (:func:`push_payload`, slot id last); the block merges
    the occurrences of its own rows (the rest sum into the cut sentinel
    tile), keeping each row's first occurrence's slot, then steps its
    rows with ``apply_push(row0=)``."""
    w = payload.shape[1]
    srt = torch.zeros((w, dims.p_pad), dtype=torch.float32,
                      device=payload.device)
    srt[:, :dims.p] = payload[plan.perm.long()].T
    srt[w - 1] *= plan.first_occ
    delta = sp.scatter_add_sorted(srt, plan.rows2d, plan.first_occ, dims)
    acc = acc_from_delta(delta, ws["show"].shape[0],
                         d_main=ws["mf"].shape[1])
    return sparse_opt.apply_push(ws, acc, cfg, row0=row0)
