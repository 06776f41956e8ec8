"""The plain multilayer perceptron the CTR nets share: Linear layers,
ReLU between them and none after the last, weights [out, in]."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def specs(prefix: str, sizes: Sequence[int]) -> List[Tuple]:
    """Xavier-uniform weights, zero biases."""
    out = []
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        out.append((f"{prefix}.{i}.weight", (fan_out, fan_in),
                    ("uniform", -bound, bound)))
        out.append((f"{prefix}.{i}.bias", (fan_out,), ("zeros",)))
    return out


def forward(params: Dict[str, torch.Tensor], prefix: str, n_layers: int,
            x: torch.Tensor) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ params[f"{prefix}.{i}.weight"].T + params[f"{prefix}.{i}.bias"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def macs(sizes: Sequence[int]) -> int:
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
