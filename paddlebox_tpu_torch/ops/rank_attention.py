"""rank_attention op (≙ operators/rank_attention_op.{cc,cu} +
rank_attention.cu.h kernels expand_input_by_rank_kernel :28 and
expand_rank_attention_param_kernel :67).

Port of ``paddlebox_tpu/ops/rank_attention.py``.  Semantics: each instance
carries its own rank (1-based; 0 or -1 = absent) and up to ``max_rank``
peer entries (rank, input-row-index) in ``rank_offset``
[B, 1 + 2*max_rank].  The op selects, per (own_rank, peer_rank) pair, a
parameter block [in_col, out_col] from rank_param (laid out
[max_rank*max_rank*in_col, out_col], block id = own*max_rank + peer — the
``start = lower*max_rank + faster`` addressing at rank_attention.cu.h:90),
gathers the peer input rows, and contracts:
    out[b] = Σ_k  x[index_bk] @ P[own_b, peer_bk]

The JAX package gathers a [B, K, in_col, out_col] copy of the blocks,
1.8 GB at the bench width.  Here the same sum is one GEMM over a
block-binned input instead:
    Z[b, j*in_col + i] = Σ_k [block_bk = j ∧ valid_bk] · x[index_bk][i]
    out = Z @ rank_param
Z is built by a one-hot batched product ([B, max_rank², K] @ [B, K,
in_col]), so the forward and its backward hold no scatter: the only
summed gather is the backward of the row gather ``x[index]``, which
PyTorch forms by sorting the indices (no float atomics).  The clip
semantics are the JAX package's: indices clip to [0, B-1], ranks to
[0, max_rank-1], and a pair with an absent own or peer rank weighs 0
(it gathers its own row, whose term the one-hot drops).

With the batch split over dense replicas, a replica holds some of the
batch's rows but their peers may sit in any row: ``peers`` is then the
whole batch's input, which ``rank_offset``'s indices address, and
``rows`` the row of ``peers`` that each of ``x``'s rows is.
"""

from __future__ import annotations

from typing import Optional

import torch


def rank_attention(x: torch.Tensor, rank_offset: torch.Tensor,
                   rank_param: torch.Tensor, max_rank: int = 3,
                   peers: Optional[torch.Tensor] = None,
                   rows: Optional[torch.Tensor] = None):
    """x [B, in_col]; rank_offset [B, 1+2*max_rank] integer;
    rank_param [max_rank*max_rank*in_col, out_col]; ``peers``
    [B_all, in_col] the rows ``rank_offset`` indexes (default ``x``),
    ``rows`` [B] the row of ``peers`` each row of ``x`` is (default
    0..B-1).
    → (out [B, out_col], ins_rank [B] in x's dtype)."""
    b, in_col = x.shape
    if peers is None:
        peers = x
    if rows is None:
        rows = torch.arange(b, device=x.device)
    ro = rank_offset.long()
    own = ro[:, 0] - 1                                 # [B]
    peer = ro[:, 1::2] - 1                             # [B, K]
    index = ro[:, 2::2]                                # [B, K]
    valid = (own[:, None] >= 0) & (peer >= 0)          # [B, K]
    block = (own[:, None].clamp(0, max_rank - 1) * max_rank
             + peer.clamp(0, max_rank - 1))            # [B, K]
    # a pair that weighs 0 reads its own row instead of the clipped one:
    # the same product (its term is 0 either way), but the backward's
    # sorted sum no longer runs every absent pair of the batch into row 0
    # as one serial run.  x[index] (not index_select): its backward sums
    # by sorted index, with no float atomics
    src = torch.where(valid, index.clamp(0, peers.shape[0] - 1),
                      rows.to(index.dtype)[:, None])
    xin = peers[src]                                   # [B, K, in_col]
    blocks = torch.arange(max_rank * max_rank, device=x.device)
    onehot = ((block[:, None, :] == blocks[None, :, None])
              & valid[:, None, :]).to(x.dtype)         # [B, mr², K]
    z = torch.bmm(onehot, xin).reshape(b, max_rank * max_rank * in_col)
    out = z @ rank_param
    return out, rank_offset[:, 0].to(x.dtype)


def batch_fc(x: torch.Tensor, w: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """≙ operators/batch_fc_op.cu: per-slot batched FC.
    x [S, B, in], w [S, in, out], bias [S, out] → [S, B, out]."""
    return torch.bmm(x, w) + bias[:, None, :]
