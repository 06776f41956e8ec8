"""Wide&Deep over the fused_seqpool_cvm output (≙
``paddlebox_tpu/models/widedeep.py``, BASELINE.md config 3).

Wide: a linear layer over the pooled slot outputs (the CVM-transformed
show/click columns and each slot's embed_w act as the wide features)
plus the dense features; deep: an MLP over the same input."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import MLP, snapshot


class WideDeep(nn.Module):
    def __init__(self, num_slots: int, emb_width: int, dense_dim: int,
                 hidden: Sequence[int] = (256, 128, 64)):
        super().__init__()
        self.num_slots = num_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        in_dim = num_slots * emb_width + dense_dim
        self.mlp = MLP((in_dim,) + self.hidden + (1,))
        self.wide_w = nn.Parameter(torch.zeros((in_dim, 1)))
        self.wide_b = nn.Parameter(torch.zeros((1,)))
        self.reset_parameters(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier MLP, wide weights U(-0.01, 0.01), zero wide bias (the
        JAX package's distributions, drawn from ``generator``)."""
        self.mlp.reset_parameters(generator)
        self.wide_w.copy_(torch.empty(self.wide_w.shape).uniform_(
            -0.01, 0.01, generator=generator))
        self.wide_b.zero_()

    @torch.no_grad()
    def load_jax_params(self, params) -> None:
        """``{"mlp": [...], "wide_w": [in, 1], "wide_b": [1]}`` (numpy)."""
        self.mlp.load_jax_params(params["mlp"])
        self.wide_w.copy_(torch.tensor(np.asarray(params["wide_w"])))
        self.wide_b.copy_(torch.tensor(np.asarray(params["wide_b"])))

    def jax_params(self):
        """The inverse of :meth:`load_jax_params`, as a snapshot."""
        return {"mlp": self.mlp.jax_params(), "wide_w": snapshot(self.wide_w),
                "wide_b": snapshot(self.wide_b)}

    def forward(self, pooled: torch.Tensor, dense: torch.Tensor
                ) -> torch.Tensor:
        x = torch.cat([pooled, dense], dim=-1)
        wide = x @ self.wide_w + self.wide_b
        return (wide + self.mlp(x))[:, 0]
