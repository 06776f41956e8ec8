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
``perm``/``inv_perm`` move between canonical and sorted domains (the
"take" crossing: one row gather each way).  The pull table is
feature-major [W, n_kernel] with W = 3 + D (+ Dex) + 1 (show, click,
embed_w, mf×D, an expand table's mf_ex×Dex, mf_size).  Plans come in
the forms of the JAX package: the untrimmed 8-tuple the streaming step
builds, and the packed pass feed's trimmed plans (leading row-0 padding
dropped) with or without the 11-tuple static payload planes.  Either
crossing lowering (ops/crossing.py): "take" gathers by the plan's
permutations, "sort" sorts keyed by the destination positions; the two
give the same bits.  Expand ("NNCross", ``mf_ex``) tables ride the same
table and payload: their Dex columns follow mf, so the kernels run at
W = 3 + D + Dex + 1 (pull) and D + Dex + 4 (push), and the pooled
output is [B, S, 3 + D + Dex].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import SparseSGDConfig
from paddlebox_tpu_torch.ops import crossing as cx
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps import optimizer as sparse_opt
from paddlebox_tpu_torch.ps.embedding import cvm_pooled, mf_values

Tensors = Dict[str, torch.Tensor]


def make_dims(num_occurrences: int, num_rows: int) -> sp.SpmmDims:
    return sp.spmm_dims(num_occurrences, num_rows)


def build_plan(idx_slb: torch.Tensor, dims: sp.SpmmDims,
               eff: Optional[sp.SpmmDims] = None):
    """idx_slb [S, L, B] pass rows (0 = reserved/padding row)."""
    return sp.build_plan(idx_slb.reshape(-1), dims, eff)


def plan_eff_dims(plan, dims: sp.SpmmDims) -> Optional[sp.SpmmDims]:
    """Trimmed kernel geometry a plan was built with, recovered from its
    array shapes (None = untrimmed)."""
    n_chunks = plan[0].shape[0]
    if n_chunks == dims.n_chunks:
        return None
    return sp.with_p_pad(dims, n_chunks * dims.chunk)


def _check_plan(plan, dims: sp.SpmmDims) -> None:
    """An 8-tuple plan, or an 11-tuple one with the static payload planes
    (pass_feed.precompute_plans), no wider than ``dims``."""
    if len(plan) not in (8, 11) or plan[0].shape[0] > dims.n_chunks:
        raise ValueError(
            f"not a sorted-spmm plan for {dims}: {len(plan)} arrays, "
            f"{plan[0].shape[0]} chunks")


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
    tab = torch.zeros((3 + d + dx + 1, dims.n_kernel), dtype=torch.float32,
                      device=ws["show"].device)
    tab[0, :n] = ws["show"]
    tab[1, :n] = ws["click"]
    tab[2, :n] = ws["embed_w"]
    tab[3:3 + d, :n] = mf_values(ws, ws["mf"]).T
    if dx:
        tab[3 + d:3 + d + dx, :n] = ws["mf_ex"].T
    tab[3 + d + dx, :n] = ws["mf_size"].to(torch.float32)
    return tab


def pool_cvm_values(v: torch.Tensor, use_cvm: bool = True) -> torch.Tensor:
    """Canonical per-occurrence pull values [S, L, B, 3+D] → pooled
    [B, S, 3+D].  The created mask is already applied to the mf columns
    (the mxu path does this in the sorted domain; the JAX package's
    ``premasked=True`` form)."""
    mf = v[..., 3:]
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


def _check_crossing(crossing: str) -> None:
    if crossing not in ("take", "sort"):
        raise ValueError(f"crossing must be 'take' or 'sort', got "
                         f"{crossing!r}")


def pull_pool_cvm(ws: Tensors, plan, dims: sp.SpmmDims,
                  shape_slb: Tuple[int, int, int],
                  use_cvm: bool = True,
                  crossing: str = "take") -> torch.Tensor:
    """Fused pull + seqpool + CVM → pooled [B, S, 3 + D (+ Dex)].

    Row 0 and the sentinel tile hold zeros, so padding occurrences and
    unseen keys contribute nothing — no length mask needed on the pull
    side.  crossing: the sorted→canonical lowering — "take" gathers by
    inv_perm, "sort" sorts keyed by perm (the destination index)."""
    _check_crossing(crossing)
    s, l, b = shape_slb
    d = ws["mf"].shape[1] + _ex_dim(ws)
    _check_plan(plan, dims)
    rows2d, perm, inv_perm = plan[0], plan[1], plan[2]
    eff = plan_eff_dims(plan, dims)
    tab = _pull_table(ws, dims)
    g = sp.gather_sorted(tab, rows2d, eff or dims)         # [3+D+1, p_pad]
    # created-mask the mf rows in the SORTED domain: the mf_size column is
    # consumed here and never rides the crossing
    created = (g[3 + d:4 + d] > 0).to(g.dtype)             # [1, p_pad]
    g = torch.cat([g[:3], g[3:3 + d] * created], dim=0)
    w = 3 + d
    if flags.get_flags("mxu_crossing_bf16"):
        g = g.to(torch.bfloat16)
    if crossing == "sort":
        if eff is not None:
            # dropped (row-0) positions re-enter as leading zero columns,
            # exactly the value row 0 holds
            g = torch.cat([torch.zeros((w, dims.p_pad - eff.p_pad),
                                       dtype=g.dtype, device=g.device), g],
                          dim=1)
        # [p, W] in take's layout: a card's sum over L below adds in an
        # order that follows the strides, so a transposed view would pool
        # other bits than take
        v = cx.permute_by_dest(tuple(g[:, :dims.p]), perm).T.contiguous()
    elif eff is None:
        v = g.T[:dims.p][inv_perm.long()]                   # canonical [p,W]
    else:
        # trimmed plan: dropped positions (inv_perm < 0) were row-0
        # occurrences whose pull value is exactly zero — clamp + mask
        v = g.T[torch.clamp(inv_perm, min=0).long()]
        v = v * (inv_perm >= 0).to(v.dtype)[:, None]
    v = v.reshape(s, l, b, w).to(torch.float32)
    return pool_cvm_values(v, use_cvm)


def push_and_update(ws: Tensors, plan, dims: sp.SpmmDims,
                    idx_slb: torch.Tensor, d_pooled: torch.Tensor,
                    ins_cvm: torch.Tensor, slot_ids: torch.Tensor,
                    cfg: SparseSGDConfig, crossing: str = "take") -> Tensors:
    """Merged push + sparse optimizer, updating ``ws`` in place.

    d_pooled [B, S, 3+D(+Dex)] — cols 0,1 are ignored and replaced by the
    instance cvm (reference push semantics, box_wrapper_impl.h:373);
    ins_cvm [B, 2]; slot_ids [S].  crossing: the canonical→sorted
    lowering — "take" gathers by perm, "sort" sorts keyed by inv_perm
    (the destination index; a trimmed plan's dropped occurrences have
    negative ones and sort first, into the cut prefix).

    With the static payload planes (an 11-tuple plan: bs, labelcol,
    slotcol, built at feed time) only the DYNAMIC columns cross: g_show
    ≡ 1 is a constant row, g_click and slot are the feed-time planes, and
    g_embed + D×g_mf are gathered from the [B·S, 1+D] pooled-grad matrix
    by ``bs`` (≙ CopyForPush building the payload per key slot,
    box_wrapper.cu:1168)."""
    _check_plan(plan, dims)
    _check_crossing(crossing)
    s, l, b = idx_slb.shape
    d = ws["mf"].shape[1] + _ex_dim(ws)
    n = ws["show"].shape[0]
    w = d + 4
    rows2d, perm, inv_perm, first_occ = plan[0], plan[1], plan[2], plan[7]
    eff = plan_eff_dims(plan, dims)
    kd = eff or dims

    def sort_cross(can: torch.Tensor) -> torch.Tensor:
        """canonical [p, c] → sorted kept domain [c, kd.p_pad], pad
        columns zero."""
        srt = cx.permute_by_dest(tuple(can.T), inv_perm)
        srt = srt[:, dims.p_pad - kd.p_pad:]
        return torch.cat([srt, torch.zeros(
            (srt.shape[0], kd.p_pad - srt.shape[1]), dtype=srt.dtype,
            device=srt.device)], dim=1)

    if len(plan) > 8:
        bs_ids, labelcol, slotcol = plan[8], plan[9], plan[10]
        p2 = d_pooled[:, :, 2:].reshape(b * s, 1 + d)       # b-major rows
        if flags.get_flags("mxu_crossing_bf16"):
            p2 = p2.to(torch.bfloat16)
        if crossing == "sort":
            # canonical flat [(s, l, b), 1+D]: broadcast over L only here,
            # in the narrow dynamic slice
            can = p2.reshape(b, s, 1 + d).permute(1, 0, 2)[:, None].expand(
                s, l, b, 1 + d).reshape(dims.p, 1 + d)
            dyn = sort_cross(can).to(torch.float32)
        else:
            dyn = p2[bs_ids.long()].T.to(torch.float32)     # [1+D, p_pad]
        ones = torch.ones((1, kd.p_pad), dtype=torch.float32,
                          device=dyn.device)
        srt_cm = torch.cat([ones, labelcol[None], dyn, slotcol[None]],
                           dim=0).contiguous()
    else:
        # the legacy payload carries the exact slot-id column, so it
        # always crosses in f32 (mxu_crossing_bf16 never applies here)
        payload = push_payload(d_pooled, ins_cvm, slot_ids, (s, l, b))
        flat = payload.reshape(dims.p, w)
        if crossing == "sort":
            srt_cm = sort_cross(flat).contiguous()
        else:
            # trimmed plans keep the suffix of the full bijection: dropped
            # row-0 occurrences never scatter (row 0 is reserved); the
            # sentinel-padded tail carries nothing
            srt_cm = flat[sp.kept_perm(perm, dims, kd).long()].T.contiguous()
            srt_cm[:, kd.p_pad - (dims.p_pad - dims.p):] = 0.0
        # slot column: keep only each row's FIRST occurrence (plan mask),
        # so the scatter-sum returns that occurrence's slot exactly (≙ the
        # reference's per-key slot from its merge position,
        # box_wrapper.cu:417 PushMergeCopy)
        srt_cm[w - 1] *= first_occ
    delta = sp.scatter_add_sorted(srt_cm, rows2d, first_occ, kd)
    acc = acc_from_delta(delta, n, d_main=ws["mf"].shape[1])
    return sparse_opt.apply_push(ws, acc, cfg)
