"""DLRM with DCN-V2's low-rank cross network as its interaction: the
recommendation model of MLPerf Training (``recommendation_v2``,
torchrec_dlrm; Naumov et al. 2019, arXiv:1906.00091; Wang et al. 2021,
arXiv:2008.13535), over the fused_seqpool_cvm output.

A bottom MLP takes the dense features to ``bottom[-1]`` columns (ReLU
after every layer, the last included, as torchrec's DenseArch); its
output is joined in front of the pooled slots, ``x0``; each cross layer
computes ``x = x0 * (W_l (V_l x) + c_l) + x`` with V_l [rank, width] and
no bias, W_l [width, rank] with bias c_l; the top MLP maps the result to
one logit.  The pooled slots are BoxPS's: each slot's show, click and
embed_w columns ride beside its embedx, so the cross width is
``bottom[-1] + num_slots * emb_width``.

With the span tracer on (utils/trace.py) the cross stack opens
``model.dcn.cross`` around its forward and ``model.dcn.cross.backward``
around its backward: from a gradient hook on the stack's output to one
on ``x0``, whose gradient is whole only once the backward has left the
stack.  Both carry ``rows``, ``width``, ``rank`` and ``layers``.  With
the tracer off no hook is registered.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import MLP
from paddlebox_tpu_torch.utils import trace

CROSS = "model.dcn.cross"
CROSS_BACKWARD = "model.dcn.cross.backward"


class DLRMDCNv2(nn.Module):
    def __init__(self, num_slots: int, emb_width: int, dense_dim: int,
                 hidden: Sequence[int] = (1024, 1024, 512, 256),
                 bottom: Sequence[int] = (512, 256, 128),
                 cross_layers: int = 3, cross_rank: int = 512):
        super().__init__()
        self.cross_rank = cross_rank
        width = bottom[-1] + num_slots * emb_width
        self.bottom = MLP((dense_dim,) + tuple(bottom))
        self.cross_v = nn.ModuleList(
            nn.Linear(width, cross_rank, bias=False)
            for _ in range(cross_layers))
        self.cross_w = nn.ModuleList(
            nn.Linear(cross_rank, width) for _ in range(cross_layers))
        self.top = MLP((width,) + tuple(hidden) + (1,))
        self.reset_parameters(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights and zero biases throughout, drawn from
        ``generator`` on the CPU."""
        self.bottom.reset_parameters(generator)
        self.top.reset_parameters(generator)
        for layer in list(self.cross_v) + list(self.cross_w):
            fan_out, fan_in = layer.weight.shape
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            layer.weight.copy_(torch.empty((fan_out, fan_in)).uniform_(
                -bound, bound, generator=generator))
            if layer.bias is not None:
                layer.bias.zero_()

    def cross(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for v, w in zip(self.cross_v, self.cross_w):
            x = x0 * w(v(x)) + x
        return x

    def _traced_cross(self, tracer, x0: torch.Tensor) -> torch.Tensor:
        attrs = {"rows": x0.shape[0], "width": x0.shape[1],
                 "rank": self.cross_rank, "layers": len(self.cross_v)}
        # the backward runs on autograd's thread, whose span stack is not
        # this one's: name the enclosing span as its parent
        parent = tracer.current_context()
        with tracer.span(CROSS, device=x0.device, **attrs):
            x = self.cross(x0)
        if x0.requires_grad:
            opened = []

            def open_backward(grad):
                opened.append(tracer.start_span(
                    CROSS_BACKWARD, parent=parent, device=x0.device,
                    **attrs))

            def close_backward(grad):
                if opened:
                    tracer.finish(opened.pop())

            x.register_hook(open_backward)
            x0.register_hook(close_backward)
        return x

    def forward(self, pooled: torch.Tensor, dense: torch.Tensor
                ) -> torch.Tensor:
        x0 = torch.cat([torch.relu(self.bottom(dense)), pooled], dim=-1)
        tracer = trace.ACTIVE
        x = self.cross(x0) if tracer is None else \
            self._traced_cross(tracer, x0)
        return self.top(x)[:, 0]
