"""Alias-method discrete sampling (≙ operators/alias_method_op.{cc,cu,h}:
Walker's alias method for O(1) draws from a discrete distribution, used
by PaddleBox models for negative sampling).

Port of ``paddlebox_tpu/ops/alias_method.py``.  The table build is host
numpy (once per distribution change), a copy of the JAX package's; a draw
is a uniform column and a coin against ``accept[col]`` (two gathers and a
select), on whatever device the table lies on.  The JAX package takes a
PRNG key; here the caller passes a ``torch.Generator`` on that device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def build_alias_table(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """probs [K] (unnormalized ok) → (accept [K] f32, alias [K] i32)."""
    p = np.asarray(probs, np.float64)
    p = p / p.sum()
    K = len(p)
    accept = np.zeros(K, np.float32)
    alias = np.zeros(K, np.int32)
    scaled = p * K
    small = [i for i in range(K) if scaled[i] < 1.0]
    large = [i for i in range(K) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        accept[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        accept[i] = 1.0
        alias[i] = i
    return accept, alias


def alias_sample(generator: torch.Generator, accept: torch.Tensor,
                 alias: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Draw int32 samples of ``shape`` ~ the distribution encoded by
    (accept, alias), on their device, from ``generator`` (a generator of
    that device)."""
    K = accept.shape[0]
    dev = accept.device
    col = torch.randint(0, K, shape, generator=generator, device=dev)
    u = torch.rand(shape, generator=generator, device=dev)
    return torch.where(u < accept[col], col,
                       alias[col].to(col.dtype)).to(torch.int32)
