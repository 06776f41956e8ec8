"""fused_seqpool_cvm op-family variants: tradew / with_conv / with_credit /
with_diff_thres / with_pcoc.

Port of ``paddlebox_tpu/ops/seqpool_cvm_variants.py`` (≙ operators/fused/
fused_seqpool_cvm_{tradew,with_conv,with_credit,with_diff_thres,
with_pcoc}_op.{cc,cu}).  The shape contract of ops/seqpool_cvm.py:
``emb [S, B, L, H]`` batch-pack layout with per-(slot, instance)
``lengths``, masked sums over L, output [B, S*W] slot-major.

Each op is a ``torch.autograd.Function`` whose backward is the reference
CUDA grad kernel, not autograd of the forward: the leading "CVM" grad
columns are overwritten with per-instance statistics (show/click/...
counts, or q_values for pcoc) so that the push accumulates lifecycle
counters, and the embedx columns broadcast the pooled output grad over
the valid keys.  Only tradew's trade-weight grad is analytic.  Grads
reach ``emb`` only.

- tradew (fused_seqpool_cvm_tradew_op.cu:34-89,269-425): per-key layout
  ``[cvm(cvm_offset) | trade_w(T) | embedx]``; with ``trade_id >= 0`` the
  embedx pool is weighted by the key's selected trade weight and the
  backward gives the product-rule grad of that weight column.
- with_conv (fused_seqpool_cvm_with_conv_op.cu): ``[show, click, conv]``
  lead, CVM stage show→log1p, click→log1p, conv→log1p(conv)-log1p(click);
  ``show_filter`` drops the show column; ``embedx_concate_size`` C > 1
  emits per-key (not pooled) slices.
- with_credit (fused_seqpool_cvm_with_credit_op.cu): ``[show, click,
  conv, credit]`` lead, each log1p'd; ``show_filter`` drops show.
- with_diff_thres (fused_seqpool_cvm_with_diff_thres_op.cu:95-145): the
  base op with a per-slot threshold vector (``xbox_diff_thres_filter``)
  and ``clk_filter`` (the click column dropped).
- with_pcoc (fused_seqpool_cvm_with_pcoc_op.cu:120-310): lead ``[show,
  clk, show2, clk2, pclk*pclk_num]`` giving a smoothed ctr and pcoc
  ratios; the grad takes a per-instance ``q_values`` input.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

CONV_OFFSET = 3    # show, click, conv
CREDIT_OFFSET = 4  # show, click, conv, credit


def _keymask(lengths: torch.Tensor, L: int) -> torch.Tensor:
    return (torch.arange(L, device=lengths.device)[None, None, :]
            < lengths[:, :, None])                          # [S, B, L]


def _filter_mask(emb, keymask, show_coeff, clk_coeff, threshold):
    """Per-key show/click threshold filter (cols 0/1 of the value
    vector); ``threshold`` a scalar or per-slot [S, 1, 1]."""
    show, click = emb[..., 0], emb[..., 1]
    keep = (show - click) * show_coeff + click * clk_coeff >= threshold
    return keymask & keep


def _masked_sum(vals, mask, pad_value):
    return pad_value + torch.sum(vals * mask.to(vals.dtype)[..., None],
                                 dim=2)                     # [S, B, H]


def _slot_major(out: torch.Tensor) -> torch.Tensor:
    """[S, B, W] → [B, S*W] (the per-slot outputs, concatenated)."""
    s, b, w = out.shape
    return out.permute(1, 0, 2).reshape(b, s * w)


def _unslot_major(dy: torch.Tensor, S: int) -> torch.Tensor:
    b = dy.shape[0]
    return dy.reshape(b, S, -1).permute(1, 0, 2)            # [S, B, W]


def _log1p(x):
    return torch.log(x + 1.0)


def _quantize(x, quant_ratio):
    return torch.floor(x * quant_ratio + 0.5) / quant_ratio


def _lead(ins: torch.Tensor, s: int, width: int, dt) -> torch.Tensor:
    """Per-instance columns [B, width] broadcast to [S, B, width]."""
    return ins.to(dt)[None, :, :width].expand(s, ins.shape[0], width)


def _broadcast_keys(d_pooled, mask):
    """The pooled grad [S, B, E] over the valid keys → [S, B, L, E]."""
    return d_pooled[:, :, None, :] * mask.to(d_pooled.dtype)[..., None]


# ---------------------------------------------------------------------------
# tradew
# ---------------------------------------------------------------------------

def _tradew_fwd(emb, lengths, use_cvm, pad_value, cvm_offset, trade_id,
                trade_num):
    mask = _keymask(lengths, emb.shape[2])
    cvm_part = emb[..., :cvm_offset]
    embedx = emb[..., cvm_offset + trade_num:]
    if trade_id >= 0:
        tw = emb[..., cvm_offset + trade_id:cvm_offset + trade_id + 1]
        embedx = embedx * tw
    vals = torch.cat([cvm_part, embedx], dim=-1)            # [S, B, L, E]
    pooled = _masked_sum(vals, mask, pad_value)             # [S, B, E]
    show = _log1p(pooled[..., 0:1])
    click = _log1p(pooled[..., 1:2]) - show
    if use_cvm:
        # cols 2..cvm_offset (if any) pass through raw, keeping the width
        # E that the backward's dy[..., cvm_offset:] slice expects
        out = torch.cat([show, click, pooled[..., 2:]], dim=-1)
    else:
        out = pooled[..., cvm_offset:]
    return _slot_major(out), mask


class _Tradew(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, lengths, ins_cvm, use_cvm, pad_value, cvm_offset,
                trade_id, trade_num):
        out, mask = _tradew_fwd(emb, lengths, use_cvm, pad_value,
                                cvm_offset, trade_id, trade_num)
        ctx.save_for_backward(emb, mask, ins_cvm)
        ctx.cfg = (use_cvm, cvm_offset, trade_id, trade_num)
        return out

    @staticmethod
    def backward(ctx, dy):
        emb, mask, ins_cvm = ctx.saved_tensors
        use_cvm, cvm_offset, trade_id, trade_num = ctx.cfg
        s, b, l, _ = emb.shape
        dt = emb.dtype
        dy = _unslot_major(dy, s).to(dt)                    # [S, B, W]
        d_out = dy[..., cvm_offset:] if use_cvm else dy     # [S, B, Ex]
        w = mask.to(dt)[..., None]                          # [S, B, L, 1]
        d_trade = torch.zeros((s, b, l, trade_num), dtype=dt,
                              device=emb.device)
        if trade_id >= 0:
            # FusedSeqpoolCVMTradeWGradKernel: cvm cols zeroed, the
            # selected trade col gets the per-key dot(dy_embedx, key
            # embedx), the embedx cols dy * the key's trade weight
            d_cvm = torch.zeros((s, b, l, cvm_offset), dtype=dt,
                                device=emb.device)
            embedx_in = emb[..., cvm_offset + trade_num:]
            d_trade[..., trade_id] = torch.einsum("sble,sbe->sbl",
                                                  embedx_in, d_out)
            tw = emb[..., cvm_offset + trade_id:cvm_offset + trade_id + 1]
            d_ex = d_out[:, :, None, :] * tw
        else:
            # NoTradeId: cvm cols ← the instance cvm, trade cols ← 0,
            # embedx ← dy
            d_cvm = _lead(ins_cvm, s, 2, dt)[:, :, None, :].expand(
                s, b, l, 2)
            if cvm_offset > 2:
                d_cvm = torch.cat([d_cvm, torch.zeros(
                    (s, b, l, cvm_offset - 2), dtype=dt,
                    device=emb.device)], dim=-1)
            d_ex = d_out[:, :, None, :].expand(s, b, l, d_out.shape[-1])
        d_emb = torch.cat([d_cvm, d_trade, d_ex], dim=-1) * w
        return (d_emb,) + (None,) * 7


def fused_seqpool_cvm_tradew(emb: torch.Tensor, lengths: torch.Tensor,
                             ins_cvm: torch.Tensor, use_cvm: bool = True,
                             pad_value: float = 0.0, cvm_offset: int = 2,
                             trade_id: int = -1,
                             trade_num: int = 0) -> torch.Tensor:
    """emb [S, B, L, E + trade_num] with the per-key ``[cvm | trade_w |
    embedx]`` layout, ins_cvm [B, 2] → [B, S*E] (use_cvm) or
    [B, S*(E - cvm_offset)]."""
    return _Tradew.apply(emb, lengths, ins_cvm, use_cvm, pad_value,
                         cvm_offset, trade_id, trade_num)


# ---------------------------------------------------------------------------
# with_conv
# ---------------------------------------------------------------------------

def _conv_pool(emb, lengths, pad_value, need_filter, show_coeff, clk_coeff,
               threshold, C):
    """→ pooled [S, B, C, E], keymask [S, B, L]."""
    L = emb.shape[2]
    mask = _keymask(lengths, L)
    if need_filter:
        mask = _filter_mask(emb, mask, show_coeff, clk_coeff, threshold)
    if C == 1:
        return _masked_sum(emb, mask, pad_value)[:, :, None, :], mask
    # position k pools exactly key k (when k < length), else pad_value
    # (FusedSeqpoolWithConvKernelNormalEmbedxConcate :96-124)
    pos = torch.arange(C, device=emb.device)
    take = torch.clamp(pos, max=L - 1)
    mk = mask[:, :, take] & (pos < L)[None, None, :]
    return pad_value + emb[:, :, take, :] * mk.to(emb.dtype)[..., None], mask


def _conv_transform(pooled, use_cvm, show_filter):
    """The CVM stage on pooled [S, B, C, E] → [S, B, C, W]."""
    show = _log1p(pooled[..., 0:1])
    click = _log1p(pooled[..., 1:2])
    conv = _log1p(pooled[..., 2:3]) - click
    if use_cvm:
        if show_filter:
            return torch.cat([click, conv, pooled[..., 3:]], dim=-1)
        return torch.cat([show, click, conv, pooled[..., 3:]], dim=-1)
    return pooled[..., CONV_OFFSET:]


class _WithConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, lengths, ins_cvm, use_cvm, pad_value, need_filter,
                show_coeff, clk_coeff, threshold, show_filter, C):
        s, b = emb.shape[:2]
        pooled, mask = _conv_pool(emb, lengths, pad_value, need_filter,
                                  show_coeff, clk_coeff, threshold, C)
        out = _conv_transform(pooled, use_cvm, show_filter)  # [S,B,C,W]
        ctx.save_for_backward(mask, ins_cvm)
        ctx.cfg = (use_cvm, show_filter, C)
        return _slot_major(out.reshape(s, b, -1))

    @staticmethod
    def backward(ctx, dy):
        mask, ins_cvm = ctx.saved_tensors
        use_cvm, show_filter, C = ctx.cfg
        s, b, l = mask.shape
        dt = dy.dtype
        dy = _unslot_major(dy, s).reshape(s, b, C, -1)      # [S, B, C, W]
        lead = _lead(ins_cvm, s, CONV_OFFSET, dt)[:, :, None, :].expand(
            s, b, C, CONV_OFFSET)
        if use_cvm and show_filter:
            # WithShow grad (:537-563): the three cvm cols ← the instance
            # cvm, embedx ← dy shifted by the dropped show column
            d_pooled = torch.cat([lead, dy[..., CONV_OFFSET - 1:]], dim=-1)
        elif use_cvm:
            d_pooled = torch.cat([lead, dy[..., CONV_OFFSET:]], dim=-1)
        else:
            d_pooled = torch.cat([lead, dy], dim=-1)
        w = mask.to(dt)[..., None]
        if C == 1:
            d_emb = d_pooled[:, :, 0, None, :] * w
        else:
            # key k takes the grad of concat position min(k, C-1)
            # (GradKernelWithCVMConcate :517-533: the last covers the tail)
            pos = torch.clamp(torch.arange(l, device=dy.device), max=C - 1)
            d_emb = d_pooled[:, :, pos, :] * w
        return (d_emb,) + (None,) * 10


def fused_seqpool_cvm_with_conv(emb: torch.Tensor, lengths: torch.Tensor,
                                ins_cvm: torch.Tensor, use_cvm: bool = True,
                                pad_value: float = 0.0,
                                need_filter: bool = False,
                                show_coeff: float = 0.2,
                                clk_coeff: float = 1.0,
                                threshold: float = 0.96,
                                show_filter: bool = False,
                                embedx_concate_size: int = 1
                                ) -> torch.Tensor:
    """emb [S, B, L, E] with the ``[show, click, conv, embedx]`` per-key
    layout, ins_cvm [B, 3] → [B, S*C*W], C = embedx_concate_size and W
    = E (use_cvm), E-1 (show_filter) or E-3 (no cvm)."""
    return _WithConv.apply(emb, lengths, ins_cvm, use_cvm, pad_value,
                           need_filter, show_coeff, clk_coeff, threshold,
                           show_filter, embedx_concate_size)


# ---------------------------------------------------------------------------
# with_credit
# ---------------------------------------------------------------------------

class _WithCredit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, lengths, ins_cvm, use_cvm, pad_value, show_filter):
        mask = _keymask(lengths, emb.shape[2])
        pooled = _masked_sum(emb, mask, pad_value)          # [S, B, E]
        if use_cvm:
            cvm_cols = _log1p(pooled[..., :CREDIT_OFFSET])
            if show_filter:
                cvm_cols = cvm_cols[..., 1:]
            out = torch.cat([cvm_cols, pooled[..., CREDIT_OFFSET:]], dim=-1)
        else:
            out = pooled[..., CREDIT_OFFSET:]
        ctx.save_for_backward(mask, ins_cvm)
        ctx.cfg = (use_cvm, show_filter)
        return _slot_major(out)

    @staticmethod
    def backward(ctx, dy):
        mask, ins_cvm = ctx.saved_tensors
        use_cvm, show_filter = ctx.cfg
        s = mask.shape[0]
        dt = dy.dtype
        dy = _unslot_major(dy, s)
        if use_cvm:
            d_embedx = dy[..., CREDIT_OFFSET - 1 if show_filter
                          else CREDIT_OFFSET:]
        else:
            d_embedx = dy
        d_pooled = torch.cat([_lead(ins_cvm, s, CREDIT_OFFSET, dt),
                              d_embedx], dim=-1)
        return (_broadcast_keys(d_pooled, mask),) + (None,) * 5


def fused_seqpool_cvm_with_credit(emb: torch.Tensor, lengths: torch.Tensor,
                                  ins_cvm: torch.Tensor,
                                  use_cvm: bool = True,
                                  pad_value: float = 0.0,
                                  show_filter: bool = False) -> torch.Tensor:
    """emb [S, B, L, E] with the ``[show, click, conv, credit, embedx]``
    layout, ins_cvm [B, 4] → [B, S*W]; the four lifecycle columns are
    each log1p'd (FusedCVMWithCreditKernelWithCVM :53-71)."""
    return _WithCredit.apply(emb, lengths, ins_cvm, use_cvm, pad_value,
                             show_filter)


# ---------------------------------------------------------------------------
# with_diff_thres
# ---------------------------------------------------------------------------

class _WithDiffThres(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, lengths, ins_cvm, use_cvm, pad_value, need_filter,
                show_coeff, clk_coeff, threshold, threshold_vec, quant_ratio,
                clk_filter, xbox_diff_thres_filter):
        mask = _keymask(lengths, emb.shape[2])
        if need_filter:
            thr = (torch.as_tensor(threshold_vec, dtype=emb.dtype,
                                   device=emb.device)[:, None, None]
                   if xbox_diff_thres_filter else threshold)
            mask = _filter_mask(emb, mask, show_coeff, clk_coeff, thr)
        vals = emb
        if quant_ratio > 0:
            vals = torch.cat([emb[..., :2],
                              _quantize(emb[..., 2:], quant_ratio)], dim=-1)
        pooled = _masked_sum(vals, mask, pad_value)
        show = _log1p(pooled[..., 0:1])
        click = _log1p(pooled[..., 1:2]) - show
        if use_cvm:
            head = [show] if clk_filter else [show, click]
            out = torch.cat(head + [pooled[..., 2:]], dim=-1)
        else:
            out = pooled[..., 2:]
        ctx.save_for_backward(mask, ins_cvm)
        ctx.cfg = (use_cvm, clk_filter)
        return _slot_major(out)

    @staticmethod
    def backward(ctx, dy):
        mask, ins_cvm = ctx.saved_tensors
        use_cvm, clk_filter = ctx.cfg
        s = mask.shape[0]
        dt = dy.dtype
        dy = _unslot_major(dy, s)
        if use_cvm:
            d_embedx = dy[..., 1:] if clk_filter else dy[..., 2:]
        else:
            d_embedx = dy
        d_pooled = torch.cat([_lead(ins_cvm, s, 2, dt), d_embedx], dim=-1)
        return (_broadcast_keys(d_pooled, mask),) + (None,) * 12


def fused_seqpool_cvm_with_diff_thres(
        emb: torch.Tensor, lengths: torch.Tensor, ins_cvm: torch.Tensor,
        use_cvm: bool = True, pad_value: float = 0.0,
        need_filter: bool = False, show_coeff: float = 0.2,
        clk_coeff: float = 1.0, threshold: float = 0.96,
        threshold_vec: Union[Sequence[float], torch.Tensor] = (),
        quant_ratio: int = 0, clk_filter: bool = False,
        xbox_diff_thres_filter: bool = False) -> torch.Tensor:
    """The base fused_seqpool_cvm plus per-slot thresholds
    (``threshold_vec[slot]`` when xbox_diff_thres_filter) and
    ``clk_filter`` (output [log1p(show), embedx], click dropped).
    ``threshold_vec`` may be a tensor on ``emb``'s device, which spares
    each call its upload."""
    return _WithDiffThres.apply(emb, lengths, ins_cvm, use_cvm, pad_value,
                                need_filter, show_coeff, clk_coeff,
                                threshold, threshold_vec, quant_ratio,
                                clk_filter, xbox_diff_thres_filter)


# ---------------------------------------------------------------------------
# with_pcoc
# ---------------------------------------------------------------------------

class _WithPcoc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, lengths, ins_cvm, q_values, use_cvm, pad_value,
                need_filter, show_coeff, clk_coeff, threshold, cvm_offset,
                max_cvm_offset, quant_ratio):
        pclk_num = cvm_offset - 4
        mask = _keymask(lengths, emb.shape[2])
        if need_filter:
            mask = _filter_mask(emb, mask, show_coeff, clk_coeff, threshold)
        vals = emb
        if quant_ratio > 0:
            vals = torch.cat([emb[..., :max_cvm_offset],
                              _quantize(emb[..., max_cvm_offset:],
                                        quant_ratio)], dim=-1)
        pooled = _masked_sum(vals, mask, pad_value)         # [S, B, E]
        if use_cvm:
            # log1p only the lifecycle columns: embedx sums can be < -1
            lg = _log1p(pooled[..., :4 + pclk_num])
            out = torch.cat(
                [lg[..., 0:1], lg[..., 1:2] - lg[..., 0:1],
                 lg[..., 4:4 + pclk_num] - lg[..., 2:3],
                 lg[..., 4:4 + pclk_num] - lg[..., 3:4],
                 pooled[..., max_cvm_offset:]], dim=-1)
        else:
            out = pooled[..., max_cvm_offset:]
        ctx.save_for_backward(mask, ins_cvm, q_values)
        ctx.cfg = (use_cvm, cvm_offset, max_cvm_offset)
        return _slot_major(out)

    @staticmethod
    def backward(ctx, dy):
        mask, ins_cvm, q_values = ctx.saved_tensors
        use_cvm, cvm_offset, max_cvm_offset = ctx.cfg
        s, b, _ = mask.shape
        dt = dy.dtype
        pclk_num = cvm_offset - 4
        embed_index_diff = max_cvm_offset - 2 - 2 * pclk_num
        dy = _unslot_major(dy, s)
        d_embedx = (dy[..., max_cvm_offset - embed_index_diff:] if use_cvm
                    else dy)
        # cols 0..3 ← the instance show/clk/show2/clk2; cols 4..cvm_offset
        # ← q_values; cols cvm_offset..max_cvm_offset ← 0
        # (GradKernelWithCVM :274-284)
        d_pooled = torch.cat(
            [_lead(ins_cvm, s, 4, dt), _lead(q_values, s, pclk_num, dt),
             torch.zeros((s, b, max_cvm_offset - cvm_offset), dtype=dt,
                         device=dy.device), d_embedx], dim=-1)
        return (_broadcast_keys(d_pooled, mask),) + (None,) * 12


def fused_seqpool_cvm_with_pcoc(emb: torch.Tensor, lengths: torch.Tensor,
                                ins_cvm: torch.Tensor, q_values: torch.Tensor,
                                use_cvm: bool = True, pad_value: float = 0.0,
                                need_filter: bool = False,
                                show_coeff: float = 0.2,
                                clk_coeff: float = 1.0,
                                threshold: float = 0.96, cvm_offset: int = 7,
                                max_cvm_offset: int = 7,
                                quant_ratio: int = 0) -> torch.Tensor:
    """emb [S, B, L, E] with leading ``[show, clk, show2, clk2,
    pclk*(cvm_offset-4)]`` columns; ins_cvm [B, cvm_offset]; q_values
    [B, cvm_offset-4].  Output columns (use_cvm): log1p(show), the
    smoothed ctr, pclk_num pcoc-vs-show2 ratios, pclk_num pcoc-vs-clk2
    ratios, then embedx (FusedCVMWithPCOCKernelWithCVM :122-157)."""
    return _WithPcoc.apply(emb, lengths, ins_cvm, q_values, use_cvm,
                           pad_value, need_filter, show_coeff, clk_coeff,
                           threshold, cvm_offset, max_cvm_offset,
                           quant_ratio)
