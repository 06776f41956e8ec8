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

Under a topology whose shards sit on distinct devices the working set is
split into row blocks (``Sharded.row_blocks``), and each keeps its own
feature-major table on its device for the epoch, in the owner-computes
pattern of the CTR trainer's ``_blocks_step``: a step's rows are planned
over each block's rows (the ids it does not hold parked at the plan's
sentinel), each block's ``gather_sorted`` pulls the values it holds
(zeros elsewhere) and the parts are summed onto the trainer's device in
row-block order — one contributor a value, so the sum is exact.  The
loss and its gradient run once there, on the trainer's own negatives;
the per-occurrence gradient goes to every block, which merges its rows'
occurrences with ``scatter_add_sorted`` (in the one-device order: the
stable sort keeps each row's occurrences in canonical order) and steps
them by adagrad.  At the epoch's end each block writes back into its own
fields, and into the replicas of it under dp × sharding.  The graph's
CSR and the walks stay on the trainer's device.  Under a dp axis that
spans processes every rank holds the graph, draws the same walks and
negatives from the same seed and sums every block's part in block order
(the other processes' parts cross the group), so every rank computes
the same loss and gradient; each rank steps the blocks it holds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.graph.graph_table import GraphTable
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.parallel import collective as col
from paddlebox_tpu_torch.parallel.topology import (Sharded, physical_device,
                                                   same_device, transfer)
from paddlebox_tpu_torch.ps import mxu_path


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


def step_rows(centers: torch.Tensor, contexts: torch.Tensor,
              negs: torch.Tensor) -> torch.Tensor:
    """A step's [B·(2+K)] occurrence rows: centers, contexts, then the
    negatives."""
    return torch.cat([centers.reshape(-1), contexts.reshape(-1),
                      negs.reshape(-1)]).to(torch.int32)


def skipgram_loss_grad(block: torch.Tensor, centers: torch.Tensor,
                       contexts: torch.Tensor, negs: torch.Tensor):
    """The loss −Σ (log σ(u·v) + Σ_k log σ(−u·v_k)) · valid /
    max(Σ valid, 1) of the pulled rows ``block`` [B·(2+K), D] (in
    :func:`step_rows` order) and its gradient in each row, [B·(2+K), D].
    A pair with a row-0 (padding) side is masked."""
    b, k = negs.shape
    d = block.shape[1]
    block = block.detach().contiguous().requires_grad_(True)  # a leaf
    valid = ((centers > 0) & (contexts > 0)).to(block.dtype)
    with torch.enable_grad():
        u, v = block[:b], block[b:2 * b]
        vn = block[2 * b:].reshape(b, k, d)
        pos = F.logsigmoid((u * v).sum(-1))                   # [B]
        neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", u, vn)).sum(-1)
        denom = valid.sum().clamp(min=1.0)
        loss = -((pos + neg) * valid).sum() / denom
        (grad,) = torch.autograd.grad(loss, block)
    return loss.detach(), grad


def sorted_payload(grad: torch.Tensor, perm: torch.Tensor,
                   dims: sp.SpmmDims) -> torch.Tensor:
    """Per-occurrence grads [P, D] → the plan's sorted payload
    [D, p_pad] (pad columns 0)."""
    payload = grad.new_zeros((grad.shape[1], dims.p_pad))
    payload[:, :dims.p] = grad.index_select(0, perm.long()).T
    return payload


def skipgram_grad(mf_fm: torch.Tensor, centers: torch.Tensor,
                  contexts: torch.Tensor, negs: torch.Tensor):
    """The loss and gradient of one skip-gram-with-negatives step on a
    feature-major table (the table is not changed).

    centers / contexts [B] and negs [B, K] are pass rows (row 0 is the
    padding row: a pair with a 0 side is masked).  The loss is
    :func:`skipgram_loss_grad`'s.  Returns (loss, payload [D, p_pad] —
    each occurrence's gradient in sorted order, pad columns 0 — and the
    plan (rows2d, first_occ, dims) that ``scatter_add_sorted`` merges it
    by)."""
    rows = step_rows(centers, contexts, negs)
    dims = sp.spmm_dims(rows.numel(), mf_fm.shape[1] - sp.TILE)
    plan = sp.build_plan(rows, dims)
    rows2d, perm, inv_perm, first_occ = (plan.rows2d, plan.perm,
                                         plan.inv_perm, plan.first_occ)
    gathered = sp.gather_sorted(mf_fm, rows2d, dims)          # [D, p_pad]
    block = gathered.index_select(1, inv_perm.long()).T       # [P, D]
    loss, grad = skipgram_loss_grad(block, centers, contexts, negs)
    return loss, sorted_payload(grad, perm, dims), (rows2d, first_occ, dims)


def adagrad_update(mf_fm: torch.Tensor, g2: torch.Tensor,
                   delta: torch.Tensor, lr: float, row0: int = 0,
                   n: Optional[int] = None) -> None:
    """Adagrad on the embedding field (the mf / mf_g2sum rule of
    optimizer.cuh.h:31) from the merged gradient ``delta`` [D, n_kernel],
    in place.  Global row 0 is reserved: it is the table's local row 0
    where the table's rows start at ``row0`` = 0.  ``n``: step only the
    first n rows (a block's own: past them the merged gradient of the
    rows other blocks own, parked at the sentinel, is zeroed, so the
    sentinel tile stays zero).  An untouched row's gradient is exactly
    0, so its state keeps its bits.  The mean square is one reduction
    over the table's whole width, a whole number of tiles, so a block's
    rows are reduced as the whole table's are."""
    if row0 == 0:
        delta[:, 0] = 0.0
    if n is not None:
        delta[:, n:] = 0.0
    g2.add_((delta * delta).sum(0) / delta.shape[0])
    scale = lr / (g2.sqrt() + 1e-8)
    mf_fm.sub_(delta * scale)


def skipgram_step(mf_fm: torch.Tensor, g2: torch.Tensor,
                  centers: torch.Tensor, contexts: torch.Tensor,
                  negs: torch.Tensor, lr: float) -> torch.Tensor:
    """One step over the whole table: :func:`skipgram_grad`, the push
    (``scatter_add_sorted`` merges each row's gradient),
    :func:`adagrad_update`.  Updates ``mf_fm`` [D, n_kernel] and ``g2``
    [n_kernel] in place; returns the loss."""
    loss, payload, (rows2d, first_occ, dims) = skipgram_grad(
        mf_fm, centers, contexts, negs)
    delta = sp.scatter_add_sorted(payload, rows2d, first_occ, dims)
    adagrad_update(mf_fm, g2, delta, lr)
    return loss


def skipgram_step_blocks(tables, blocks, topo, centers: torch.Tensor,
                         contexts: torch.Tensor, negs: torch.Tensor,
                         lr: float) -> torch.Tensor:
    """:func:`skipgram_step` over row blocks: ``blocks`` every row
    block's (homes, first global row, rows) in row order over every
    process (``Sharded.row_homes``), ``tables`` each block's
    feature-major (mf_fm, g2) held here, updated in place (None where
    another process alone holds the block); the step's rows and the loss
    live on ``topo.device``.  Each block held here pulls the rows it holds
    (``gather_sorted`` over its ``mxu_path.block_plan``: the other rows
    parked at the sentinel), the parts are summed on every process's
    first shard in block order (``collective.reduce_scatter_onto_shards``:
    under a dp axis across processes the parts of the other processes'
    blocks cross the group), the loss and gradient run there
    (:func:`skipgram_loss_grad`, the same on every rank), and every block
    held here merges its rows' occurrences (``scatter_add_sorted``) and
    steps them.  Returns the loss."""
    device = topo.device
    rows = step_rows(centers, contexts, negs)
    plans, parts = [], []
    for table, (homes, row0, n) in zip(tables, blocks):
        if table is None:
            plans.append(None)
            parts.append(None)
            continue
        dev = topo.devices[next(k for k in homes if topo.is_local(k))]
        dims, plan = mxu_path.block_plan(transfer(rows, device, dev), row0,
                                         n)
        g = sp.gather_sorted(table[0], plan.rows2d, dims)     # [D, p_pad]
        parts.append(g.index_select(1, plan.inv_perm.long()).T)   # [P, D]
        plans.append((dev, dims, plan))
    firsts = [topo.shards_of(r)[0] for r in range(topo.nranks)]
    block = col.reduce_scatter_onto_shards(
        parts, [homes for homes, _, _ in blocks], firsts, topo,
        dim=None)[topo.rank]
    loss, grad = skipgram_loss_grad(block, centers, contexts, negs)
    for table, (_, row0, n), pl in zip(tables, blocks, plans):
        if table is None:
            continue
        dev, dims, plan = pl
        payload = sorted_payload(transfer(grad, device, dev), plan.perm,
                                 dims)
        delta = sp.scatter_add_sorted(payload, plan.rows2d, plan.first_occ,
                                      dims)
        adagrad_update(*table, delta, lr, row0=row0, n=n)
    return loss


class GraphEmbeddingTrainer:
    """Skip-gram-with-negatives over PS-resident node embeddings, on the
    engine's device (under a topology, its first shard's: the graph,
    the walks, the negatives and the loss live there; the working set's
    row blocks step on their own devices).  Under a dp axis that spans
    processes every rank holds the graph and draws the same walks and
    negatives from the same seed, computes the same loss and gradient,
    and steps the row blocks it holds."""

    def __init__(self, engine, graph: GraphTable, n_negatives: int = 5,
                 learning_rate: float = 0.05, window: int = 2,
                 seed: int = 0):
        if not same_device(graph.device, engine.device):
            raise ValueError(f"the graph lives on {graph.device}, the "
                             f"engine's device is {engine.device}")
        self.engine = engine
        self.graph = graph
        self.k = n_negatives
        self.lr = learning_rate
        self.window = window
        self.device = physical_device(engine.device)
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
        held, blocks = self._held_blocks(ws)
        here = {}                        # each row range's home here
        for dev, row0, mf, g2sum in held:
            here.setdefault(row0, (dev, mf, g2sum))
        tables = [to_feature_major(*here[row0][1:]) if row0 in here
                  else None for _, row0, _ in blocks]
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
            if len(tables) == 1:   # the whole table: no row to park
                losses.append(skipgram_step(*tables[0], chunk[:, 0],
                                            chunk[:, 1], negs, self.lr))
            else:
                losses.append(skipgram_step_blocks(
                    tables, blocks, self.engine.topology, chunk[:, 0],
                    chunk[:, 1], negs, self.lr))
            if timed:
                ev[1].record()
                events.append(ev)
        at = {row0: i for i, (_, row0, _) in enumerate(blocks)}
        for dev, row0, mf, g2sum in held:  # replicas included
            (fm, g2), (_, _, n) = tables[at[row0]], blocks[at[row0]]
            src = here[row0][0]
            mf.copy_(transfer(fm[:, :n].T, src, dev))
            g2sum.copy_(transfer(g2[:n], src, dev))
        stacked = torch.stack(losses)
        self.stats = {"losses": stacked.tolist(),
                      "step_ms": [a.elapsed_time(b) for a, b in events]}
        return float(stacked.mean())

    def _held_blocks(self, ws) -> tuple:
        """(held, blocks): (device, first global row, mf block, mf_g2sum
        block) of every block tensor of the working set here, replicas
        included, and (homes, first global row, rows) of every row block
        over every process (``Sharded.row_homes``); a working set on one
        device is one block."""
        mf, g2sum = ws["mf"], ws["mf_g2sum"]
        if not isinstance(mf, Sharded):
            return ([(self.device, 0, mf, g2sum)],
                    [((0,), 0, mf.shape[0])])
        return ([(mf.topo.devices[k], mf.rows(k).start, blk, g2sum.parts[k])
                 for k, blk in mf.unique()],
                [(homes, sl.start, sl.stop - sl.start)
                 for homes, sl in mf.row_homes()])

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
