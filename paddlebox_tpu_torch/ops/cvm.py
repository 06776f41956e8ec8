"""Standalone CVM op (port of ``paddlebox_tpu/ops/cvm.py``; ≙
operators/cvm_op.{h,cc,cu}).

Forward (cvm_op.h:35-36): for x = [show, click, embedx...]:
    y0 = log(show + 1) ; y1 = log(click + 1) - log(show + 1)
use_cvm=True keeps the transformed columns, False strips them.

Backward (CvmGradComputeKernel, cvm_op.h:44-56) is deliberately NOT the
analytic derivative: dx[2:] = dy[...], and dx[0:2] is the instance's raw
(show, click), so the pushed "gradient" carries impression counts to the
sparse optimizer (it reads them as g_show / g_click).  Plain autograd of
the forward would push the derivative of the logs instead.
"""

from __future__ import annotations

import torch


def _cvm_forward(x: torch.Tensor, use_cvm: bool) -> torch.Tensor:
    show = torch.log(x[..., 0:1] + 1.0)
    click = torch.log(x[..., 1:2] + 1.0) - show
    if use_cvm:
        return torch.cat([show, click, x[..., 2:]], dim=-1)
    return x[..., 2:]


class _Cvm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ins_cvm, use_cvm):
        ctx.save_for_backward(ins_cvm)
        ctx.use_cvm = use_cvm
        return _cvm_forward(x, use_cvm)

    @staticmethod
    def backward(ctx, dy):
        (ins_cvm,) = ctx.saved_tensors
        d_embedx = dy[..., 2:] if ctx.use_cvm else dy
        dx = torch.cat([ins_cvm.to(dy.dtype), d_embedx], dim=-1)
        return dx, None, None


def cvm(x: torch.Tensor, ins_cvm: torch.Tensor,
        use_cvm: bool = True) -> torch.Tensor:
    """x: [..., E] with E >= 2 (cols 0,1 = show, click); ins_cvm: [..., 2]
    with x's leading shape.  No gradient reaches ``ins_cvm``."""
    return _Cvm.apply(x, ins_cvm, use_cvm)
