"""MMoE multi-task recommender (≙ ``paddlebox_tpu/models/mmoe.py``,
BASELINE.md config 4): shared input, a mixture of expert MLPs, and per
task a softmax gate over the experts and a tower.  ``forward`` returns
task 0's logits (the single-label trainer); ``forward_multi`` returns
[B, num_tasks] (``trainer.multitask.MultiTaskSparseTrainer``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import MLP, snapshot


class MMoE(nn.Module):
    def __init__(self, num_slots: int, emb_width: int, dense_dim: int,
                 num_experts: int = 4, num_tasks: int = 2,
                 expert_hidden: Sequence[int] = (64,),
                 tower_hidden: Sequence[int] = (32,)):
        super().__init__()
        self.num_slots = num_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.num_experts = num_experts
        self.num_tasks = num_tasks
        self.expert_hidden = tuple(expert_hidden)
        self.tower_hidden = tuple(tower_hidden)
        in_dim = num_slots * emb_width + dense_dim
        self.experts = nn.ModuleList(
            MLP((in_dim,) + self.expert_hidden) for _ in range(num_experts))
        self.gates = nn.ParameterList(
            nn.Parameter(torch.zeros((in_dim, num_experts)))
            for _ in range(num_tasks))
        self.towers = nn.ModuleList(
            MLP((self.expert_hidden[-1],) + self.tower_hidden + (1,))
            for _ in range(num_tasks))
        self.reset_parameters(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier experts and towers, gates N(0, 0.02²) (the JAX
        package's distributions, drawn from ``generator``)."""
        for e in self.experts:
            e.reset_parameters(generator)
        for g in self.gates:
            g.copy_(torch.randn(g.shape, generator=generator) * 0.02)
        for t in self.towers:
            t.reset_parameters(generator)

    @torch.no_grad()
    def load_jax_params(self, params) -> None:
        """``{"experts": [mlp, ...], "gates": [[in, E], ...], "towers":
        [mlp, ...]}`` (numpy)."""
        for e, p in zip(self.experts, params["experts"], strict=True):
            e.load_jax_params(p)
        for g, p in zip(self.gates, params["gates"], strict=True):
            g.copy_(torch.tensor(np.asarray(p)))
        for t, p in zip(self.towers, params["towers"], strict=True):
            t.load_jax_params(p)

    def jax_params(self):
        """The inverse of :meth:`load_jax_params`, as a snapshot."""
        return {"experts": [e.jax_params() for e in self.experts],
                "gates": [snapshot(g) for g in self.gates],
                "towers": [t.jax_params() for t in self.towers]}

    def forward_multi(self, pooled: torch.Tensor, dense: torch.Tensor
                      ) -> torch.Tensor:
        """→ logits [B, num_tasks]."""
        x = torch.cat([pooled, dense], dim=-1)
        expert_out = torch.stack([torch.relu(e(x)) for e in self.experts],
                                 dim=1)                     # [B, E, H]
        logits = []
        for gate, tower in zip(self.gates, self.towers):
            g = torch.softmax(x @ gate, dim=-1)             # [B, E]
            mixed = torch.einsum("be,beh->bh", g, expert_out)
            logits.append(tower(mixed)[:, 0])
        return torch.stack(logits, dim=1)

    def forward(self, pooled: torch.Tensor, dense: torch.Tensor
                ) -> torch.Tensor:
        return self.forward_multi(pooled, dense)[:, 0]
