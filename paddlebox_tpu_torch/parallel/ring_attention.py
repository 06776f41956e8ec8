"""Ring attention — context parallelism over the sequence axis.

Port of ``paddlebox_tpu/parallel/ring_attention.py``.  The reference has
no sequence / context parallelism (SURVEY.md §2.7); the JAX package adds
it to the overlap budget of HeterComm's shard walk (§3.3): K/V blocks
rotate around the axis (``shift_right``, a ring of neighbor hops) while
each shard accumulates its queries' attention with a numerically stable
online softmax (flash-style m / l running stats), so a shard holds
O(T_local²) scores at a time.

The math is the JAX package's einsums, with its −inf guards for fully
masked blocks.  q, k, v are per-shard lists of [B, T_local, H, Dh]
blocks of a sequence split over ``axis``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from paddlebox_tpu_torch.parallel import collective
from paddlebox_tpu_torch.parallel.topology import HybridTopology

Shards = List[torch.Tensor]


def _attend_block(q, k_blk, v_blk, m, l, acc, q_pos, k_pos):
    """Fold one K/V block into the running (m, l, acc) of queries q."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk)        # [B,H,Tq,Tk]
    if q_pos is not None:
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, -float("inf")))
    new_m = torch.maximum(m, scores.amax(-1))                 # [B,H,Tq]
    # guard fully masked blocks (−inf max)
    fin_m = torch.isfinite(m)
    safe_m = torch.where(torch.isfinite(new_m), new_m,
                         torch.zeros_like(new_m))
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
    correction = torch.exp(torch.where(fin_m, m - safe_m,
                                       torch.full_like(m, -float("inf"))))
    correction = torch.where(fin_m, correction, torch.zeros_like(correction))
    l = l * correction + p.sum(-1)
    acc = acc * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                     p, v_blk)
    return new_m, l, acc


def ring_attention(qs: Shards, ks: Shards, vs: Shards,
                   topo: HybridTopology, axis: str, axis_size: int,
                   causal: bool = False,
                   scale: Optional[float] = None) -> Shards:
    """Per-shard blockwise attention with rotating K/V.

    qs, ks, vs: per-shard [B, T_local, H, Dh]; returns per-shard
    [B, T_local, H, Dh]."""
    b, tl, h, dh = qs[0].shape
    if scale is None:
        scale = dh ** -0.5
    qs = [q * scale for q in qs]
    my = collective.axis_index(topo, axis)
    dev = qs[0].device
    ar = torch.arange(tl, device=dev)
    state = [(torch.full((b, h, tl), -float("inf"), dtype=q.dtype,
                         device=dev),
              torch.zeros((b, h, tl), dtype=q.dtype, device=dev),
              torch.zeros((b, h, tl, dh), dtype=q.dtype, device=dev))
             for q in qs]
    for step in range(axis_size):
        new = []
        for i, (q, k_blk, v_blk) in enumerate(zip(qs, ks, vs)):
            q_pos = k_pos = None
            if causal:
                # the block held now started at position (my - step) mod n
                src = (my[i] - step) % axis_size
                q_pos, k_pos = my[i] * tl + ar, src * tl + ar
            new.append(_attend_block(q, k_blk, v_blk, *state[i], q_pos,
                                     k_pos))
        state = new
        # rotate K/V to the next shard
        ks = collective.shift_right(ks, topo, axis, axis_size)
        vs = collective.shift_right(vs, topo, axis, axis_size)
    return [(acc / l.clamp(min=1e-30)[..., None]).permute(0, 2, 1, 3)
            for _, l, acc in state]                          # [B,Tq,H,Dh]


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Unsharded golden attention."""
    t, dh = q.shape[1], q.shape[3]
    if scale is None:
        scale = dh ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, -float("inf")))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bhqd", p, v).permute(0, 2, 1, 3)
