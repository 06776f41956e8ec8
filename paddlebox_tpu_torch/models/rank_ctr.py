"""Rank-attention CTR model — the PV-learning join-phase model shape
(≙ ``paddlebox_tpu/models/rank_ctr.py``).

≙ the PaddleBox models that consume the PV-merge ``rank_offset`` feed
(data_feed.cc:1855 GetRankOffset) through the rank_attention op
(operators/rank_attention_op.cu): each ad attends over the other ads of
its page view with a parameter block selected by the (own rank, peer
rank) pair, and the attention output joins the MLP input.

Declares ``extra_inputs = ("rank_offset",)``: the trainer hands the
batch's rank_offset plane to ``forward`` as a keyword argument, on the
streaming and the pass-resident entry points.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import MLP, snapshot
from paddlebox_tpu_torch.ops.rank_attention import rank_attention


class RankAttentionCTR(nn.Module):
    extra_inputs = ("rank_offset",)

    def __init__(self, num_slots: int, emb_width: int, dense_dim: int,
                 att_out: int = 32, max_rank: int = 3,
                 hidden: Sequence[int] = (128, 64)):
        super().__init__()
        self.num_slots = num_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.att_out = att_out
        self.max_rank = max_rank
        self.hidden = tuple(hidden)
        self.in_col = num_slots * emb_width
        in_dim = self.in_col + att_out + dense_dim + 1
        self.mlp = MLP((in_dim,) + self.hidden + (1,))
        # [max_rank*max_rank*in_col, att_out] block layout — the
        # `start = lower*max_rank + faster` addressing of
        # rank_attention.cu.h:90
        self.rank_param = nn.Parameter(torch.zeros(
            (max_rank * max_rank * self.in_col, att_out)))
        self.reset_parameters(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier MLP and rank_param U(-0.01, 0.01) (the JAX package's
        distributions, drawn from ``generator``)."""
        self.mlp.reset_parameters(generator)
        self.rank_param.copy_(torch.empty(self.rank_param.shape).uniform_(
            -0.01, 0.01, generator=generator))

    @torch.no_grad()
    def load_jax_params(self, params) -> None:
        """``{"mlp": [...], "rank_param": [max_rank²·in_col, att_out]}``
        (numpy)."""
        self.mlp.load_jax_params(params["mlp"])
        self.rank_param.copy_(torch.tensor(np.asarray(params["rank_param"])))

    def jax_params(self):
        """The inverse of :meth:`load_jax_params`, as a snapshot."""
        return {"mlp": self.mlp.jax_params(),
                "rank_param": snapshot(self.rank_param)}

    def forward(self, pooled: torch.Tensor, dense: torch.Tensor,
                rank_offset: torch.Tensor) -> torch.Tensor:
        """pooled [B, num_slots·emb_width], dense [B, dense_dim],
        rank_offset [B, 1+2·max_rank] → logits [B]."""
        att, ins_rank = rank_attention(pooled, rank_offset, self.rank_param,
                                       self.max_rank)
        x = torch.cat([pooled, att, dense, ins_rank[:, None]], dim=-1)
        return self.mlp(x)[:, 0]
