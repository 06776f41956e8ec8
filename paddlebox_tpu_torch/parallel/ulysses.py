"""Ulysses-style sequence parallelism: all_to_all head↔sequence reshard.

Port of ``paddlebox_tpu/parallel/ulysses.py`` (absent from the
reference, SURVEY.md §2.7).  With the sequence split over the ``sp``
axis, attention needs the full sequence per head; instead of gathering
T, an all_to_all swaps the split dimension: [B, T/n, H, D] →
[B, T, H/n, D], full-sequence attention on each shard's heads, then the
inverse all_to_all — the MoE global_scatter / global_gather trick
(moe_layer.py:88-151) applied to attention heads.  Every function takes
and returns per-shard lists.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from paddlebox_tpu_torch.parallel import collective
from paddlebox_tpu_torch.parallel.ring_attention import reference_attention
from paddlebox_tpu_torch.parallel.topology import HybridTopology

Shards = List[torch.Tensor]


def seq_to_heads(xs: Shards, topo: HybridTopology, axis: str) -> Shards:
    """[B, T_local, H, D] → [B, T_global, H_local, D] per shard."""
    return collective.all_to_all(xs, topo, axis, split_dim=2, concat_dim=1)


def heads_to_seq(xs: Shards, topo: HybridTopology, axis: str) -> Shards:
    """[B, T_global, H_local, D] → [B, T_local, H, D] per shard."""
    return collective.all_to_all(xs, topo, axis, split_dim=1, concat_dim=2)


def ulysses_attention(qs: Shards, ks: Shards, vs: Shards,
                      topo: HybridTopology, axis: str,
                      attn_fn: Optional[Callable] = None,
                      causal: bool = False) -> Shards:
    """Sequence-parallel attention via head resharding.

    qs / ks / vs: per-shard [B, T_local, H, Dh], the sequence split on
    ``axis``; H must divide by the axis size.  attn_fn defaults to the
    dense golden attention (``ring_attention.reference_attention``)."""
    if attn_fn is None:
        def attn_fn(q, k, v):
            return reference_attention(q, k, v, causal=causal)
    qs, ks, vs = (seq_to_heads(x, topo, axis) for x in (qs, ks, vs))
    outs = [attn_fn(q, k, v) for q, k, v in zip(qs, ks, vs)]
    return heads_to_seq(outs, topo, axis)     # [B, T_local, H, Dh]
