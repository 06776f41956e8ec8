"""DeepFM over pooled slot embeddings (≙ ``paddlebox_tpu/models/deepfm.py``):
first-order = per-slot scalar weights (the pull value's embed_w column),
second-order = FM interaction over per-slot embedx vectors, deep part =
MLP over the full pooled output + dense features."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import MLP


class DeepFM(nn.Module):
    def __init__(self, num_slots: int, emb_width: int, dense_dim: int,
                 hidden: Sequence[int] = (400, 400, 400)):
        super().__init__()
        self.num_slots = num_slots
        self.emb_width = emb_width  # 3 + mf_dim
        self.mf_dim = emb_width - 3
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        in_dim = num_slots * emb_width + dense_dim
        self.mlp = MLP((in_dim,) + self.hidden + (1,))
        self.dense_w = nn.Parameter(torch.zeros((dense_dim, 1)))
        self.bias = nn.Parameter(torch.zeros((1,)))
        self.reset_parameters(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the dense init from ``generator`` (on the CPU, so every
        device gets the same numbers for one seed)."""
        self.mlp.reset_parameters(generator)
        self.dense_w.copy_(torch.empty(self.dense_w.shape).uniform_(
            -0.01, 0.01, generator=generator))
        self.bias.zero_()

    @torch.no_grad()
    def load_jax_params(self, params) -> None:
        """Carry the JAX package's params pytree across:
        ``{"mlp": [{"w": [in, out], "b": [out]}, ...], "dense_w":
        [dense_dim, 1], "bias": [1]}`` as numpy arrays."""
        self.mlp.load_jax_params(params["mlp"])
        self.dense_w.copy_(torch.tensor(np.asarray(params["dense_w"])))
        self.bias.copy_(torch.tensor(np.asarray(params["bias"])))

    def jax_params(self):
        """The inverse of :meth:`load_jax_params` (numpy, JAX layout)."""
        return {
            "mlp": [{"w": layer.weight.detach().cpu().numpy().T,
                     "b": layer.bias.detach().cpu().numpy()}
                    for layer in self.mlp.layers],
            "dense_w": self.dense_w.detach().cpu().numpy(),
            "bias": self.bias.detach().cpu().numpy(),
        }

    def forward(self, pooled: torch.Tensor, dense: torch.Tensor
                ) -> torch.Tensor:
        """pooled [B, S * emb_width], dense [B, dense_dim] → logits [B]."""
        b = pooled.shape[0]
        per_slot = pooled.reshape(b, self.num_slots, self.emb_width)
        first = torch.sum(per_slot[:, :, 2], dim=1, keepdim=True) \
            + dense @ self.dense_w
        v = per_slot[:, :, 3:]                      # [B, S, D]
        sum_sq = torch.sum(v, dim=1) ** 2           # [B, D]
        sq_sum = torch.sum(v ** 2, dim=1)
        second = 0.5 * torch.sum(sum_sq - sq_sum, dim=1, keepdim=True)
        deep = self.mlp(torch.cat([pooled, dense], dim=-1))
        logit = self.bias + first + second + deep
        return logit[:, 0]
