"""Minimal NN layers of the port (≙ ``paddlebox_tpu/models/layers.py``)."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn


def snapshot(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``: on the CPU ``.numpy()`` would alias the live
    weights that training updates in place, unlike the JAX package's
    immutable params."""
    return t.detach().cpu().numpy().copy()


class MLP(nn.Module):
    """Linear layers with ReLU between them and none after the last."""

    def __init__(self, sizes: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights and zero biases, as ``init_mlp`` draws
        them (the numbers differ: ``generator`` is torch's, not a JAX
        key).  Drawn on the CPU, then copied to the module's device."""
        for layer in self.layers:
            fan_out, fan_in = layer.weight.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            w = torch.empty((fan_out, fan_in)).uniform_(
                -bound, bound, generator=generator)
            layer.weight.copy_(w)
            layer.bias.zero_()

    @torch.no_grad()
    def load_jax_params(self, params) -> None:
        """``params``: the JAX package's list of {"w": [in, out], "b":
        [out]} (numpy).  ``nn.Linear.weight`` is [out, in], so each
        weight is transposed."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} JAX layers for "
                             f"{len(self.layers)} torch layers")
        for layer, p in zip(self.layers, params):
            layer.weight.copy_(torch.tensor(np.asarray(p["w"])).T)
            layer.bias.copy_(torch.tensor(np.asarray(p["b"])))

    def jax_params(self):
        """The inverse of :meth:`load_jax_params`, as a snapshot."""
        return [{"w": snapshot(layer.weight).T, "b": snapshot(layer.bias)}
                for layer in self.layers]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
