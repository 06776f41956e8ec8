"""Fused per-slot sequence sum-pool + CVM transform.

Port of ``paddlebox_tpu/ops/seqpool_cvm.py`` (≙ the fused_seqpool_cvm op
family, fused/fused_seqpool_cvm_op.cu — seqpool kernels :35-369, CVM
stage :371, grad FusedSeqpoolCVMGradKernelWithCVM :814; attributes
fused_seqpool_cvm_op.cc:113-146).

Input is the batch-pack layout ``emb [S, B, L, E]`` (slot, instance,
key capacity, embedding) with per-(slot, instance) ``lengths``: a masked
sum over L.  Attributes, as in the JAX package:

- pad_value       : init value of each pooled output element
- use_cvm         : keep the (log-transformed) show/click columns or
                    strip them
- quant_ratio     : > 0 rounds embedx to the quant grid
- need_filter     : drop keys with show_coeff*(show-click)+clk_coeff*click
                    < threshold
- embed_threshold : with need_filter, also drop keys whose embedx score
                    (L2 of cols 3.. plus |col 2| of the first
                    embed_thres_size embedx columns) is below it

The backward is the reference's, not autograd of the forward: embedx
grads are the pooled-output grads broadcast over the kept keys, and the
show/click grad columns carry the instance's show/click so the push
accumulates counts (see ops/cvm.py).
"""

from __future__ import annotations

import torch

CVM_OFFSET = 2  # show, click


def _quantize(x: torch.Tensor, quant_ratio: int) -> torch.Tensor:
    return torch.floor(x * quant_ratio + 0.5) / quant_ratio


def _pool(emb, lengths, pad_value, quant_ratio, need_filter, show_coeff,
          clk_coeff, threshold, embed_threshold, embed_thres_size):
    s, b, l, e = emb.shape
    keymask = (torch.arange(l, device=emb.device)[None, None, :]
               < lengths[:, :, None])                       # [S, B, L]
    if need_filter:
        show, click = emb[..., 0], emb[..., 1]
        keep = (show - click) * show_coeff + click * clk_coeff >= threshold
        if embed_threshold > 0:
            embedx = emb[..., CVM_OFFSET:CVM_OFFSET + embed_thres_size]
            score = (torch.sqrt(torch.sum(embedx[..., 1:] ** 2, dim=-1))
                     + torch.abs(embedx[..., 0]))
            keep = keep & (score >= embed_threshold)
        keymask = keymask & keep
    w = keymask.to(emb.dtype)[..., None]
    if quant_ratio > 0:
        vals = torch.cat([emb[..., :CVM_OFFSET],
                          _quantize(emb[..., CVM_OFFSET:], quant_ratio)],
                         dim=-1)
    else:
        vals = emb
    pooled = pad_value + torch.sum(vals * w, dim=2)         # [S, B, E]
    return pooled, keymask


class _FusedSeqpoolCvm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, lengths, ins_cvm, use_cvm, pad_value, quant_ratio,
                need_filter, show_coeff, clk_coeff, threshold,
                embed_threshold, embed_thres_size):
        s, b, l, e = emb.shape
        pooled, keymask = _pool(emb, lengths, pad_value, quant_ratio,
                                need_filter, show_coeff, clk_coeff,
                                threshold, embed_threshold, embed_thres_size)
        show = torch.log(pooled[..., 0:1] + 1.0)
        click = torch.log(pooled[..., 1:2] + 1.0) - show
        if use_cvm:
            out = torch.cat([show, click, pooled[..., CVM_OFFSET:]], dim=-1)
        else:
            out = pooled[..., CVM_OFFSET:]
        ctx.save_for_backward(keymask, ins_cvm)
        ctx.use_cvm = use_cvm
        # [S, B, width] → [B, S*width], slot-major
        return out.permute(1, 0, 2).reshape(b, -1)

    @staticmethod
    def backward(ctx, dy):
        keymask, ins_cvm = ctx.saved_tensors
        s, b, l = keymask.shape
        dy = dy.reshape(b, s, -1).permute(1, 0, 2)          # [S, B, width]
        d_embedx = dy[..., CVM_OFFSET:] if ctx.use_cvm else dy
        # show/click grad columns carry the instance counts
        d_cvm = ins_cvm.to(dy.dtype)[None].expand(s, b, CVM_OFFSET)
        d_pooled = torch.cat([d_cvm, d_embedx], dim=-1)     # [S, B, E]
        d_emb = d_pooled[:, :, None, :] * keymask.to(dy.dtype)[..., None]
        return (d_emb,) + (None,) * 11


def fused_seqpool_cvm(emb: torch.Tensor, lengths: torch.Tensor,
                      ins_cvm: torch.Tensor, use_cvm: bool = True,
                      pad_value: float = 0.0, quant_ratio: int = 0,
                      need_filter: bool = False, show_coeff: float = 0.2,
                      clk_coeff: float = 1.0, threshold: float = 0.96,
                      embed_threshold: float = 0.0,
                      embed_thres_size: int = 0) -> torch.Tensor:
    """emb [S, B, L, E], lengths [S, B] int, ins_cvm [B, 2] → [B, S*E]
    (use_cvm) or [B, S*(E-2)].  Gradients reach ``emb`` only."""
    return _FusedSeqpoolCvm.apply(emb, lengths, ins_cvm, use_cvm, pad_value,
                                  quant_ratio, need_filter, show_coeff,
                                  clk_coeff, threshold, embed_threshold,
                                  embed_thres_size)
