"""fast sparse step path: padded-dense pull/pool and push/update.

Port of ``paddlebox_tpu/ps/fast_path.py``.  Index tensors are
[S, L, B]; per-feature scalars stay [N] 1-D; the mf table is updated in
the batch domain (merged grads gathered back per occurrence, updated row
by row, written back with identical values for every occurrence of a
row), never by a full [N, D] pass.

Pull: one row-major table [N, 3 + D] (show, click, embed_w, and mf
masked by ``mf_size > 0``; the view of a buffer with rows padded to 16
bytes) goes through ``ops.pallas_gather.gather_pool``
— the hand-written CUDA kernel on a card — over idx [S, L, B] laid out as
[S·B, L] rows, then CVM and the [B, S, E] transpose.

Push: the JAX package merges per-row accumulators with ``.at[].add``;
here ``sorted_spmm.segment_sum`` merges them in canonical order with no
float atomics, so the result is the same on every run of the card.  The
integer slot column merges with ``scatter_reduce_(amax)``; duplicate
``index_copy_`` writes of the mf rows carry identical values.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from paddlebox_tpu_torch.config import SparseSGDConfig
from paddlebox_tpu_torch.ops import pallas_gather
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps.embedding import (cvm_pooled, localize,
                                             mf_values)
from paddlebox_tpu_torch.ps.optimizer import _dym_dims, push_touched

Tensors = Dict[str, torch.Tensor]


def step_prelude(idx: torch.Tensor, lengths: torch.Tensor,
                 own: Optional[torch.Tensor] = None):
    """The push's per-step mask/flatten prelude: (m, safe_idx, flat, occ).

    idx [S, L, B]; lengths [S, B]; own [S, L, B] bool, the occurrences a
    block holds (None: all).  m [S, L, B] f32 is 1 where l < lengths
    (and own); safe_idx parks masked positions on row 0."""
    s, l, b = idx.shape
    live = (torch.arange(l, device=idx.device)[None, :, None]
            < lengths[:, None, :])
    m = (live if own is None else live & own).to(torch.float32)
    safe_idx = torch.where(m > 0, idx, torch.zeros_like(idx))
    return m, safe_idx, safe_idx.reshape(-1), m.reshape(-1)


def _pull_table(ws: Tensors, zero_row: bool = False) -> torch.Tensor:
    """Row-major pull table [N, 3 + D]: show, click, embed_w, and the mf
    columns zeroed for rows whose mf is not created yet.  It is the
    [N, 3 + D] view of a buffer whose rows are padded to a multiple of 4
    floats (16 bytes), so ``gather_pool`` reads rows as float4; the
    fields are written straight into the view (one masked multiply, one
    stack), and the pad, which the kernel loads but never writes out, is
    left unset.  ``zero_row``: one more row, N, of zeros (where a
    block's pull parks the ids it does not hold)."""
    n, d = ws["mf"].shape
    e = 3 + d
    # pboxlint: disable-next=PB301 -- documented pull-table build cost (one relayout per step, not per-row math)
    table = torch.empty((n + zero_row, (e + 3) // 4 * 4),
                        dtype=torch.float32, device=ws["mf"].device)[:, :e]
    # pboxlint: disable-next=PB301 -- documented pull-table build cost (one relayout per step, not per-row math)
    created = (ws["mf_size"] > 0).to(torch.float32)
    # pboxlint: disable-next=PB301 -- documented pull-table build cost (one relayout per step, not per-row math)
    torch.mul(mf_values(ws, ws["mf"]), created[:, None],
              out=table[:n, 3:])
    torch.stack([ws["show"], ws["click"], ws["embed_w"]], dim=1,
                out=table[:n, :3])
    if zero_row:
        table[n] = 0.0
    return table


def pull_pool(ws: Tensors, idx: torch.Tensor, lengths: torch.Tensor,
              row0: Optional[int] = None) -> torch.Tensor:
    """Fused pull + seqpool: idx [S, L, B] pass rows (0 = padding),
    lengths [S, B] → the raw pooled sums [S, B, E], E = 3 + D.  The
    kernel reads only the first ``lengths`` ids of each row, so no mask
    is needed here.  ``row0``: ``ws`` is the block of rows from global
    row ``row0``, and ids it does not hold pool its zero row, so the
    sums are the block's part of the pooled value."""
    s, l, b = idx.shape
    table = _pull_table(ws, zero_row=row0 is not None)
    if row0 is not None:
        idx, _ = localize(idx, row0, ws["mf"].shape[0])
    rows = idx.permute(0, 2, 1).reshape(s * b, l).to(torch.int32)
    pooled = pallas_gather.gather_pool(
        table, rows.contiguous(),
        lengths.reshape(s * b).to(torch.int32).contiguous())
    return pooled.reshape(s, b, -1)


def pull_pool_cvm(ws: Tensors, idx: torch.Tensor, lengths: torch.Tensor,
                  use_cvm: bool = True) -> torch.Tensor:
    """Fused pull + seqpool + CVM → pooled [B, S, E] (cvm'show,
    cvm'click, w, mf...)."""
    return cvm_pooled(pull_pool(ws, idx, lengths), use_cvm)


def push_and_update(ws: Tensors, idx: torch.Tensor, lengths: torch.Tensor,
                    d_pooled: torch.Tensor, ins_cvm: torch.Tensor,
                    slot_ids: torch.Tensor, cfg: SparseSGDConfig,
                    row0: Optional[int] = None) -> Tensors:
    """Merged push + sparse adagrad, updating ``ws`` in place.

    idx [S, L, B]; d_pooled [B, S, E] (cols 0,1 ignored, replaced by
    ins_cvm per the reference push semantics); ins_cvm [B, 2]; slot_ids
    [S].  Padding occurrences land on reserved row 0 and are masked.
    An expand table's ``mf_ex`` / ``mf_ex_g2sum`` are carried through
    untouched: this lowering pulls and trains the 3 + D base columns
    only, as the JAX package's fast rule does.  ``row0``: ``ws`` is the
    block of rows from global row ``row0``, and the occurrences of rows
    it does not hold are masked (the owner of each row merges and
    steps it)."""
    s, l, b = idx.shape
    n = ws["show"].shape[0]
    d = ws["mf"].shape[1]
    own = None
    if row0 is not None:
        idx, own = localize(idx, row0, n)
    m, safe_idx, flat, occ = step_prelude(idx, lengths, own)
    row0 = row0 or 0

    # -- merged per-row accumulators ([N] scalars; [N, D] once for mf) ----
    g_show_o = ins_cvm[None, None, :, 0].expand(s, l, b).reshape(-1) * occ
    g_click_o = ins_cvm[None, None, :, 1].expand(s, l, b).reshape(-1) * occ
    d_w = d_pooled[:, :, 2].T                               # [S, B]
    g_embed_o = d_w[:, None, :].expand(s, l, b).reshape(-1) * occ
    d_mf = d_pooled[:, :, 3:].permute(1, 0, 2)              # [S, B, D]
    g_mf_o = (d_mf[:, None].expand(s, l, b, d) * m[..., None]).reshape(-1, d)
    acc = sp.segment_sum(torch.cat(
        [torch.stack([g_show_o, g_click_o, g_embed_o], dim=1), g_mf_o],
        dim=1), flat, n)                                    # [N, 3 + D]
    g_show, g_click, g_embed = acc[:, 0], acc[:, 1], acc[:, 2]
    g_mf = acc[:, 3:]
    slot_occ = slot_ids.to(torch.int32)[:, None, None].expand(
        s, l, b).reshape(-1)
    slot_acc = torch.zeros((n,), dtype=torch.int32,
                           device=flat.device).scatter_reduce_(
        0, flat.long(), torch.where(occ > 0, slot_occ,
                                    torch.zeros_like(slot_occ)),
        "amax", include_self=True)

    # -- scalar state: full-table [N] ops ----------------------------------
    # PB301 suppressions below: these 1-D [N] scalar sweeps are this
    # path's documented contract, as in the JAX package; the [U]-domain
    # alternative is ps/ragged_path.py
    touched = push_touched(ws, {"g_show": g_show}, row0)
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    show = torch.where(touched, ws["show"] + g_show, ws["show"])
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    click = torch.where(touched, ws["click"] + g_click, ws["click"])
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    delta = torch.where(
        touched,
        ws["delta_score"] + cfg.nonclk_coeff * (g_show - g_click)
        + cfg.clk_coeff * g_click,
        ws["delta_score"])
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    slot = torch.where(touched, slot_acc, ws["slot"])
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    lr_embed = torch.where(
        slot == cfg.nodeid_slot,
        torch.full_like(ws["embed_w"], cfg.learning_rate),
        torch.full_like(ws["embed_w"], cfg.feature_learning_rate))
    safe_scale = torch.where(g_show > 0, g_show, torch.ones_like(g_show))
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    ratio = lr_embed * torch.sqrt(cfg.initial_g2sum /
                                  (cfg.initial_g2sum + ws["embed_g2sum"]))
    sg = g_embed / safe_scale
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    embed_w = torch.where(
        touched,
        torch.clamp(ws["embed_w"] + sg * ratio, cfg.min_bound,
                    cfg.max_bound),
        ws["embed_w"])
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    embed_g2sum = torch.where(touched, ws["embed_g2sum"] + sg * sg,
                              ws["embed_g2sum"])
    score = cfg.nonclk_coeff * (show - click) + cfg.clk_coeff * click
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    create = touched & (ws["mf_size"] == 0) & \
        (score >= cfg.mf_create_thresholds)
    # dynamic per-slot dims (≙ CtrDymfAccessor): created rows record their
    # slot's true width, resolved from the MERGED row slot
    dims_row = _dym_dims(cfg, slot, d)
    # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
    mf_size = torch.where(
        create,
        dims_row if dims_row is not None else torch.full_like(
            ws["mf_size"], d),
        ws["mf_size"])

    # -- mf: batch-domain row updates (no [N, D] full pass) ---------------
    # every occurrence of a row computes the identical new row, so the
    # duplicate writes of index_copy_ are deterministic
    fl = flat.long()
    r_gshow = g_show[fl]                                    # [P]
    r_g2 = ws["mf_g2sum"][fl]
    r_trainable = ((ws["mf_size"][fl] > 0) & (r_gshow > 0)
                   & (fl != -row0) & (occ > 0))
    r_scale = torch.where(r_gshow > 0, r_gshow, torch.ones_like(r_gshow))
    r_ratio = cfg.mf_learning_rate * torch.sqrt(
        cfg.mf_initial_g2sum / (cfg.mf_initial_g2sum + r_g2))
    r_g = g_mf[fl] / r_scale[:, None]                       # [P, D]
    r_mf = ws["mf"][fl]
    new_mf = torch.clamp(r_mf + r_g * r_ratio[:, None], cfg.mf_min_bound,
                         cfg.mf_max_bound)
    # the mean-square divisor is the ROW's true dim
    if dims_row is not None:
        new_g2 = r_g2 + torch.sum(r_g * r_g, dim=1) \
            / dims_row[fl].to(torch.float32)
    else:
        new_g2 = r_g2 + torch.sum(r_g * r_g, dim=1) / d
    # the other occurrences write a spare row n, cut off after
    write_idx = torch.where(r_trainable, fl, torch.full_like(fl, n))
    mf = torch.cat([ws["mf"], ws["mf"][:1]]).index_copy_(
        0, write_idx, new_mf)[:n]
    if row0 == 0:
        mf[0] = 0.0   # keep the reserved row zero
    mf_g2sum = torch.cat([ws["mf_g2sum"], ws["mf_g2sum"][:1]]).index_copy_(
        0, write_idx, new_g2)[:n]

    out = {"show": show, "click": click, "delta_score": delta, "slot": slot,
           "embed_w": embed_w, "embed_g2sum": embed_g2sum,
           "mf_size": mf_size, "mf_g2sum": mf_g2sum, "mf": mf}
    if "show_acc" in ws:   # ctr_double: exact pass-delta counters
        # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
        out["show_acc"] = torch.where(touched, ws["show_acc"] + g_show,
                                      ws["show_acc"])
        # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
        out["click_acc"] = torch.where(touched, ws["click_acc"] + g_click,
                                       ws["click_acc"])
    for f, v in out.items():
        # pboxlint: disable-next=PB301 -- documented-cheap [N] scalar pass
        ws[f].copy_(v)
    return ws
