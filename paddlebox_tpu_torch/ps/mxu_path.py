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
feature-major [W, n_kernel] with W = 3 + D + 1 (show, click, embed_w,
mf×D, mf_size).  This port carries the untrimmed 8-tuple plan the step
builds and the "take" crossing only; trimmed plans and the static-plane
payload of the packed pass feed, the "sort" crossing and expand (mf_ex)
tables are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import SparseSGDConfig
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps import optimizer as sparse_opt
from paddlebox_tpu_torch.ps.embedding import mf_values

Tensors = Dict[str, torch.Tensor]


def make_dims(num_occurrences: int, num_rows: int) -> sp.SpmmDims:
    return sp.spmm_dims(num_occurrences, num_rows)


def build_plan(idx_slb: torch.Tensor, dims: sp.SpmmDims):
    """idx_slb [S, L, B] pass rows (0 = reserved/padding row)."""
    return sp.build_plan(idx_slb.reshape(-1), dims)


def _check_plan(plan, dims: sp.SpmmDims) -> None:
    """The port's step builds untrimmed 8-tuple plans; trimmed plans and
    the static-plane payload come from the packed pass feed, which is not
    ported."""
    if len(plan) != 8 or plan[0].shape[0] != dims.n_chunks:
        raise NotImplementedError(
            "trimmed / static-plane plans (packed pass feed) are not "
            "ported to the PyTorch package")


def _pull_table(ws: Tensors, dims: sp.SpmmDims) -> torch.Tensor:
    """Feature-major pull view [3 + D + 1, n_kernel]."""
    if "mf_ex" in ws:
        raise NotImplementedError(
            "expand (mf_ex) tables are not ported to the PyTorch package")
    n = ws["show"].shape[0]
    d = ws["mf"].shape[1]
    tab = torch.zeros((3 + d + 1, dims.n_kernel), dtype=torch.float32,
                      device=ws["show"].device)
    tab[0, :n] = ws["show"]
    tab[1, :n] = ws["click"]
    tab[2, :n] = ws["embed_w"]
    tab[3:3 + d, :n] = mf_values(ws, ws["mf"]).T
    tab[3 + d, :n] = ws["mf_size"].to(torch.float32)
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
    if use_cvm:
        show_t = torch.log(show + 1.0)
        click_t = torch.log(click + 1.0) - show_t
    else:
        show_t, click_t = show, click
    head = torch.stack([show_t, click_t, w], dim=-1)       # [S, B, 3]
    pooled = torch.cat([head, mf], dim=-1)
    return pooled.permute(1, 0, 2)                         # [B, S, E]


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


def acc_from_delta(delta: torch.Tensor, n: int) -> Tensors:
    """Merged per-row accumulators for ps.optimizer.apply_push from the
    scatter output [D+4, >=n] (slot column already first-occurrence-
    exact)."""
    d = delta.shape[0] - 4
    return {
        "g_show": delta[0, :n],
        "g_click": delta[1, :n],
        "g_embed": delta[2, :n],
        "g_embedx": delta[3:3 + d, :n].T,
        "slot": torch.round(delta[d + 3, :n]).to(torch.int32),
    }


def pull_pool_cvm(ws: Tensors, plan, dims: sp.SpmmDims,
                  shape_slb: Tuple[int, int, int],
                  use_cvm: bool = True) -> torch.Tensor:
    """Fused pull + seqpool + CVM → pooled [B, S, 3 + D].

    Row 0 and the sentinel tile hold zeros, so padding occurrences and
    unseen keys contribute nothing — no length mask needed on the pull
    side.  The sorted→canonical crossing gathers by inv_perm ("take")."""
    s, l, b = shape_slb
    d = ws["mf"].shape[1]
    _check_plan(plan, dims)
    rows2d, inv_perm = plan[0], plan[2]
    tab = _pull_table(ws, dims)
    g = sp.gather_sorted(tab, rows2d, dims)                # [3+D+1, p_pad]
    # created-mask the mf rows in the SORTED domain: the mf_size column is
    # consumed here and never rides the crossing
    created = (g[3 + d:4 + d] > 0).to(g.dtype)             # [1, p_pad]
    g = torch.cat([g[:3], g[3:3 + d] * created], dim=0)
    w = 3 + d
    if flags.get_flags("mxu_crossing_bf16"):
        g = g.to(torch.bfloat16)
    v = g.T[:dims.p][inv_perm.long()]                       # canonical [p,W]
    v = v.reshape(s, l, b, w).to(torch.float32)
    return pool_cvm_values(v, use_cvm)


def push_and_update(ws: Tensors, plan, dims: sp.SpmmDims,
                    idx_slb: torch.Tensor, d_pooled: torch.Tensor,
                    ins_cvm: torch.Tensor, slot_ids: torch.Tensor,
                    cfg: SparseSGDConfig) -> Tensors:
    """Merged push + sparse optimizer, updating ``ws`` in place.

    d_pooled [B, S, 3+D] — cols 0,1 are ignored and replaced by the
    instance cvm (reference push semantics, box_wrapper_impl.h:373);
    ins_cvm [B, 2]; slot_ids [S].  The canonical→sorted crossing gathers
    by perm ("take")."""
    _check_plan(plan, dims)
    s, l, b = idx_slb.shape
    d = ws["mf"].shape[1]
    n = ws["show"].shape[0]
    w = d + 4
    rows2d, perm, first_occ = plan[0], plan[1], plan[7]
    # the legacy payload carries the exact slot-id column, so it always
    # crosses in f32 (mxu_crossing_bf16 never applies here)
    payload = push_payload(d_pooled, ins_cvm, slot_ids, (s, l, b))
    srt = payload.reshape(dims.p, w)[perm.long()]           # sorted domain
    srt_cm = torch.cat(
        [srt, torch.zeros((dims.p_pad - dims.p, w), dtype=srt.dtype,
                          device=srt.device)]).T.contiguous()
    # slot column: keep only each row's FIRST occurrence (plan mask), so
    # the scatter-sum returns that occurrence's slot exactly (≙ the
    # reference's per-key slot from its merge position,
    # box_wrapper.cu:417 PushMergeCopy)
    srt_cm[w - 1] *= first_occ
    delta = sp.scatter_add_sorted(srt_cm, rows2d, first_occ, dims)
    acc = acc_from_delta(delta, n)
    return sparse_opt.apply_push(ws, acc, cfg)
