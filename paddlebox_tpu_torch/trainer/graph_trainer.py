"""Graph-embedding training over the sparse PS — the GNN mode's loop.

Port of ``paddlebox_tpu/trainer/graph_trainer.py`` (≙ the reference's
graph-learning mode, SURVEY §2.2: GpuPsGraphTable + graph_gpu_wrapper
walks feeding the SAME sparse embedding PS the CTR trainers use — the
walk engine produces (center, context) pairs and the node embeddings
live as PS feature rows).  The loop: random walks over the device CSR
graph → skip-gram window pairs → pull node mf rows from the pass working
set → NCE loss with K negatives → adagrad on mf (the mf / mf_g2sum rule
of optimizer.cuh.h:31 applied to the graph embedding field).

Where the JAX step takes the gradient of the loss over the whole ``mf``
array (XLA scatters it), the port's pull and push run on the sorted
kernels, as the mxu lowering does: one plan a step over the batch's
concatenated [B·(2+K)] rows (centers, contexts, negatives), the pull by
``gather_sorted`` from a feature-major table, the gradient of the
gathered [B, 2+K, D] block by autograd (the block is a leaf: no index
is differentiated), and the push by ``scatter_add_sorted`` — a
segmented sum in a fixed order, with no float atomics, so a rerun gives
the same bits.  The plan is untrimmed: row-0 (padding) positions occur
only in a tail batch's zero rows, so trimming them would save nothing.

The trainer holds ``mf`` feature-major ([D, n_kernel]) with
``mf_g2sum`` for the length of a ``train_pairs`` epoch and writes both
back into the engine's working set at its end, so ``end_pass`` writes
the trained rows to the table.  Adagrad runs over every row, as the JAX
step does: an untouched row's gradient is exactly 0, so its state keeps
its bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.graph.graph_table import GraphTable
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps import embedding


def walk_pairs(walks: torch.Tensor, window: int) -> torch.Tensor:
    """[W, L] node walks → [P, 2] (center, context) pairs within the
    window (≙ the skip-gram pair extraction the walk engine feeds), in
    the JAX package's order; invalid (-1) ids are kept for the caller to
    mask."""
    pairs = []
    for off in range(1, window + 1):
        a = walks[:, :-off].reshape(-1)
        b = walks[:, off:].reshape(-1)
        pairs.append(torch.stack([a, b], 1))
        pairs.append(torch.stack([b, a], 1))
    return torch.cat(pairs, 0)


def to_feature_major(mf: torch.Tensor, g2sum: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Working-set ``mf`` [N, D] and ``mf_g2sum`` [N] → the sorted
    kernels' feature-major table [D, n_kernel] and [n_kernel] (the rows
    past N, the sentinel tile among them, zero)."""
    n, d = mf.shape
    n_kernel = sp.spmm_dims(1, n).n_kernel
    mf_fm = mf.new_zeros((d, n_kernel))
    mf_fm[:, :n] = mf.T
    g2 = g2sum.new_zeros((n_kernel,))
    g2[:n] = g2sum
    return mf_fm, g2


def skipgram_grad(mf_fm: torch.Tensor, centers: torch.Tensor,
                  contexts: torch.Tensor, negs: torch.Tensor):
    """The loss and gradient of one skip-gram-with-negatives step on a
    feature-major table (the table is not changed).

    centers / contexts [B] and negs [B, K] are pass rows (row 0 is the
    padding row: a pair with a 0 side is masked).  The loss is
    −Σ (log σ(u·v) + Σ_k log σ(−u·v_k)) · valid / max(Σ valid, 1).
    Returns (loss, payload [D, p_pad] — each occurrence's gradient in
    sorted order, pad columns 0 — and the plan (rows2d, first_occ,
    dims) that ``scatter_add_sorted`` merges it by)."""
    b, k = negs.shape
    d = mf_fm.shape[0]
    rows = torch.cat([centers.reshape(-1), contexts.reshape(-1),
                      negs.reshape(-1)]).to(torch.int32)
    dims = sp.spmm_dims(rows.numel(), mf_fm.shape[1] - sp.TILE)
    plan = sp.build_plan(rows, dims)
    rows2d, perm, inv_perm, first_occ = plan[0], plan[1], plan[2], plan[7]
    gathered = sp.gather_sorted(mf_fm, rows2d, dims)          # [D, p_pad]
    block = gathered.index_select(1, inv_perm.long()).T.contiguous()
    block.requires_grad_(True)                                # [P, D] leaf
    valid = ((centers > 0) & (contexts > 0)).to(mf_fm.dtype)
    with torch.enable_grad():
        u, v = block[:b], block[b:2 * b]
        vn = block[2 * b:].reshape(b, k, d)
        pos = F.logsigmoid((u * v).sum(-1))                   # [B]
        neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", u, vn)).sum(-1)
        denom = valid.sum().clamp(min=1.0)
        loss = -((pos + neg) * valid).sum() / denom
        (grad,) = torch.autograd.grad(loss, block)
    payload = mf_fm.new_zeros((d, dims.p_pad))
    payload[:, :dims.p] = grad.index_select(0, perm.long()).T
    return loss.detach(), payload, (rows2d, first_occ, dims)


def adagrad_update(mf_fm: torch.Tensor, g2: torch.Tensor,
                   delta: torch.Tensor, lr: float) -> None:
    """Adagrad on the embedding field (the mf / mf_g2sum rule of
    optimizer.cuh.h:31) from the merged gradient ``delta`` [D, n_kernel],
    in place.  Row 0 is reserved; an untouched row's gradient is exactly
    0, so its state keeps its bits."""
    delta[:, 0] = 0.0
    g2.add_((delta * delta).sum(0) / delta.shape[0])
    scale = lr / (g2.sqrt() + 1e-8)
    mf_fm.sub_(delta * scale)


def skipgram_step(mf_fm: torch.Tensor, g2: torch.Tensor,
                  centers: torch.Tensor, contexts: torch.Tensor,
                  negs: torch.Tensor, lr: float) -> torch.Tensor:
    """One step: :func:`skipgram_grad`, the push (``scatter_add_sorted``
    merges each row's gradient), :func:`adagrad_update`.  Updates
    ``mf_fm`` [D, n_kernel] and ``g2`` [n_kernel] in place; returns the
    loss."""
    loss, payload, (rows2d, first_occ, dims) = skipgram_grad(
        mf_fm, centers, contexts, negs)
    delta = sp.scatter_add_sorted(payload, rows2d, first_occ, dims)
    adagrad_update(mf_fm, g2, delta, lr)
    return loss


class GraphEmbeddingTrainer:
    """Skip-gram-with-negatives over PS-resident node embeddings, on the
    engine's device."""

    def __init__(self, engine, graph: GraphTable, n_negatives: int = 5,
                 learning_rate: float = 0.05, window: int = 2,
                 seed: int = 0):
        topo = getattr(engine, "topology", None)
        if topo is not None and topo.multi_device:
            raise NotImplementedError(
                f"graph learning {embedding.MULTI_DEVICE_TODO}")
        if graph.device != engine.device:
            raise ValueError(f"the graph lives on {graph.device}, the "
                             f"engine's working set on {engine.device}")
        self.engine = engine
        self.graph = graph
        self.k = n_negatives
        self.lr = learning_rate
        self.window = window
        self.device = engine.device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.stats: dict = {}

    # -- node id → pass row translation (host, once per pass) ------------
    def node_rows(self, nodes: np.ndarray) -> np.ndarray:
        """Dense graph node ids → pass working-set rows (nodes are
        feasigns: the graph and the PS share the key space)."""
        return self.engine.mapper(np.asarray(nodes, np.uint64))

    def pair_rows(self, pairs: torch.Tensor) -> np.ndarray:
        """[P, 2] node pairs → pass-row pairs, without the pairs that
        have an invalid side (walk dead-ends) and the self-pairs (stuck
        walks repeat their node — training u·u would only inflate
        norms)."""
        flat = pairs.cpu().numpy().reshape(-1)
        ok = flat >= 0
        rows = np.zeros_like(flat, dtype=np.int32)
        rows[ok] = self.node_rows(flat[ok])
        rows = rows.reshape(pairs.shape)
        both = (rows > 0).all(axis=1) & (rows[:, 0] != rows[:, 1])
        return rows[both]

    def draw_negatives(self, batch: int) -> torch.Tensor:
        """[batch, K] negatives from the REAL rows 1..num_keys: the
        working set is padded to a size bucket, and phantom padding rows
        would weaken the NCE signal and collect updates that end_pass
        discards."""
        return torch.randint(1, self.engine.num_keys + 1, (batch, self.k),
                             generator=self.generator, device=self.device,
                             dtype=torch.int32)

    def train_pairs(self, pairs_rows, batch_size: int = 4096) -> float:
        """One epoch over [P, 2] pass-row pairs (the tail batch padded
        with zero rows); returns the mean loss.  ``self.stats`` holds the
        per-batch ``losses`` and, on a card, ``step_ms`` (CUDA events
        around each step's launches)."""
        ws = self.engine.ws
        if isinstance(pairs_rows, np.ndarray):
            pairs_rows = torch.from_numpy(pairs_rows.astype(np.int32))
        pairs_rows = pairs_rows.to(self.device, torch.int32)
        p = pairs_rows.shape[0]
        if p == 0:
            self.stats = {"losses": [], "step_ms": []}
            return float("nan")
        mf_fm, g2 = to_feature_major(ws["mf"], ws["mf_g2sum"])
        timed = self.device.type == "cuda"
        losses, events = [], []
        for lo in range(0, p, batch_size):
            chunk = pairs_rows[lo:lo + batch_size]
            if chunk.shape[0] < batch_size:   # static-shape tail pad
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (batch_size - chunk.shape[0], 2))])
            negs = self.draw_negatives(batch_size)
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            losses.append(skipgram_step(mf_fm, g2, chunk[:, 0],
                                        chunk[:, 1], negs, self.lr))
            if timed:
                ev[1].record()
                events.append(ev)
        n = ws["mf"].shape[0]
        ws["mf"].copy_(mf_fm[:, :n].T)
        ws["mf_g2sum"].copy_(g2[:n])
        stacked = torch.stack(losses)
        self.stats = {"losses": stacked.tolist(),
                      "step_ms": [a.elapsed_time(b) for a, b in events]}
        return float(stacked.mean())

    def train_walks(self, starts: np.ndarray, length: int = 8,
                    batch_size: int = 4096,
                    seed: Optional[int] = None) -> float:
        """Walks → pairs → one training epoch (the full graph-mode loop).
        seed None (default) draws the walks from the trainer's own
        generator, so repeated epochs explore NEW walks; an explicit seed
        reproduces them."""
        gen = self.generator
        if seed is not None:
            gen = torch.Generator(device=self.graph.device)
            gen.manual_seed(seed)
        walks = self.graph.random_walk(
            torch.as_tensor(np.asarray(starts), device=self.graph.device),
            length, gen)
        pairs = walk_pairs(walks, self.window)   # dense node ids, -1 pad
        return self.train_pairs(self.pair_rows(pairs), batch_size)
