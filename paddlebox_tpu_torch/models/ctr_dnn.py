"""Plain DNN CTR model (≙ ``paddlebox_tpu/models/ctr_dnn.py``, BASELINE.md
config 1): fused_seqpool_cvm output concatenated with the dense features
→ MLP → logit."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import MLP


class CtrDnn(nn.Module):
    """Consumes the pooled output [B, S*emb_width] + dense [B, dense_dim]."""

    def __init__(self, num_slots: int, emb_width: int, dense_dim: int,
                 hidden: Sequence[int] = (512, 256, 128)):
        super().__init__()
        self.num_slots = num_slots
        self.emb_width = emb_width   # 3 + mf_dim (show', click', w, embedx)
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        in_dim = num_slots * emb_width + dense_dim
        self.mlp = MLP((in_dim,) + self.hidden + (1,))
        self.reset_parameters(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mlp.reset_parameters(generator)

    @torch.no_grad()
    def load_jax_params(self, params) -> None:
        """``{"mlp": [{"w": [in, out], "b": [out]}, ...]}`` (numpy)."""
        self.mlp.load_jax_params(params["mlp"])

    def jax_params(self):
        """The inverse of :meth:`load_jax_params`, as a snapshot."""
        return {"mlp": self.mlp.jax_params()}

    def forward(self, pooled: torch.Tensor, dense: torch.Tensor
                ) -> torch.Tensor:
        return self.mlp(torch.cat([pooled, dense], dim=-1))[:, 0]
