"""Graph engine for GNN training (graph-learning mode of the PS).

Port of ``paddlebox_tpu/graph/graph_table.py`` (≙ heter_ps/
graph_gpu_ps_table.h GpuPsGraphTable + graph_gpu_wrapper + graph_sampler,
SURVEY §2.2: a device graph table with neighbor sampling and random
walks feeding the sparse-PS embedding path).

The CSR (``indptr`` / ``indices``, int32 as in the JAX package) and the
per-span normalized CDF of a weighted table are built on the host in
f64, exactly as there, then moved to the table's device.  Sampling is
tensor ops on that device: a per-draw offset into each node's neighbor
span, or a weighted draw by the same branchless 32-step binary search
over the span's ``local_cdf``.  Degree-0 nodes yield -1.

Every random draw is kept apart from the selection that uses it:
``draw`` makes the random numbers from a ``torch.Generator``, and
``select`` / ``walk_step`` / ``metapath_step`` turn given draws into
nodes.  The JAX PRNG cannot be reproduced in torch, so tests feed the
JAX package's draws to the selections and compare bit for bit.  A
uniform offset is drawn as ``floor(u · deg)`` clamped to ``deg - 1``
(``torch.randint`` takes no per-row bound, and a modulo would bias).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.device import DeviceLike, resolve_device


class GraphTable:
    """Host-built CSR graph, device-sampled.  Entry point: runs on
    ``cuda`` unless the caller passes ``device="cpu"``."""

    def __init__(self, edges: np.ndarray,
                 weights: Optional[np.ndarray] = None,
                 num_nodes: Optional[int] = None,
                 device: DeviceLike = None):
        """edges: [M, 2] (src, dst) dense node ids."""
        self.device = resolve_device(device)
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        n = int(num_nodes if num_nodes is not None else edges.max() + 1)
        order = np.argsort(edges[:, 0], kind="stable")
        src = edges[order, 0]
        dst = edges[order, 1]
        counts = np.bincount(src, minlength=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        self.num_nodes = n
        self.num_edges = len(edges)
        self.indptr = torch.as_tensor(indptr.astype(np.int32),
                                      device=self.device)
        self.indices = torch.as_tensor(dst.astype(np.int32),
                                       device=self.device)
        if weights is not None and len(edges) > 0:
            # per-span normalized CDF, built in f64: float32 only ever
            # stores values in [0, 1] within a span, so its resolution
            # does not degrade with the graph's size; a zero-weight span
            # gets a uniform CDF
            w = np.asarray(weights, np.float64)[order]
            if np.any(w < 0):
                raise ValueError("negative edge weight")
            m = len(w)
            cums = np.cumsum(w)
            span_id = np.repeat(np.arange(n), counts)
            span_start = indptr[span_id]
            span_end = indptr[span_id + 1]
            base = np.where(span_start > 0, cums[span_start - 1], 0.0)
            tot = cums[span_end - 1] - base
            uniform = ((np.arange(m) - span_start + 1)
                       / np.maximum(span_end - span_start, 1))
            lc = np.where(tot > 0, (cums - base) / np.where(tot > 0, tot, 1.0),
                          uniform)
            self.local_cdf = torch.as_tensor(lc.astype(np.float32),
                                             device=self.device)
        else:
            self.local_cdf = None

    # ------------------------------------------------------------------
    def degrees(self, nodes: torch.Tensor) -> torch.Tensor:
        nodes = nodes.long()
        return self.indptr[nodes + 1] - self.indptr[nodes]

    def draw(self, nodes: torch.Tensor, k: int,
             generator: torch.Generator
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The random numbers of ``k`` neighbor draws per node: (offsets
        [B, k] into each span, None) for a uniform table, (None, u [B, k]
        in [0, 1)) for a weighted one."""
        shape = (nodes.shape[0], k)
        u = torch.rand(shape, generator=generator, device=self.device)
        if self.local_cdf is not None:
            return None, u
        deg = self.degrees(nodes)[:, None]
        off = torch.floor(u.double() * deg).long()
        return torch.minimum(off, (deg - 1).clamp(min=0)), None

    def select(self, nodes: torch.Tensor, off: Optional[torch.Tensor],
               u: Optional[torch.Tensor]) -> torch.Tensor:
        """The neighbors that given draws pick (≙ graph_neighbor_sample,
        graph_gpu_ps_table_inl.cu): nodes [B] → [B, k]; -1 where the
        degree is 0."""
        nodes = nodes.long()
        start = self.indptr[nodes].long()                  # [B]
        deg = self.indptr[nodes + 1].long() - start
        has = deg[:, None] > 0
        if self.num_edges == 0:
            shape = (off if off is not None else u).shape
            return torch.full(shape, -1, dtype=torch.int32,
                              device=self.device)
        if self.local_cdf is None:
            pos = start[:, None] + off.long()
        else:
            # first edge e of the span with local_cdf[e] >= u: branchless
            # binary search (32 steps cover any span)
            lc = self.local_cdf
            m = lc.shape[0]
            end = start + deg
            lo = start[:, None].expand(u.shape)
            hi = end[:, None].expand(u.shape)
            for _ in range(32):
                mid = (lo + hi) // 2
                go = lc[mid.clamp(0, m - 1)] < u
                lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
            pos = torch.minimum(torch.maximum(lo, start[:, None]),
                                (end - 1).clamp(min=0)[:, None])
        # a degree-0 node's position may lie past the last edge: clamp the
        # read (the value is masked below)
        nb = self.indices[pos.clamp(0, self.num_edges - 1)]
        return torch.where(has, nb, torch.full_like(nb, -1))

    def sample_neighbors(self, nodes: torch.Tensor, k: int,
                         generator: torch.Generator) -> torch.Tensor:
        """Uniform (or weighted) sample of k neighbors per node:
        nodes [B] → [B, k]; -1 where the degree is 0."""
        return self.select(nodes, *self.draw(nodes, k, generator))

    def walk_step(self, cur: torch.Tensor, off: Optional[torch.Tensor],
                  u: Optional[torch.Tensor]) -> torch.Tensor:
        """One hop of ``random_walk`` under given draws ([B, 1] each, for
        the nodes ``max(cur, 0)``): a stuck walk repeats its node."""
        nxt = self.select(cur.clamp(min=0), off, u)[:, 0]
        return torch.where((cur >= 0) & (nxt >= 0), nxt, cur)

    def random_walk(self, starts: torch.Tensor, length: int,
                    generator: torch.Generator) -> torch.Tensor:
        """Deepwalk-style walks (≙ graph_sampler walk path):
        starts [B] → [B, length+1]; stuck walks repeat their node."""
        cur = torch.as_tensor(starts, device=self.device).to(torch.int32)
        path = [cur]
        for _ in range(length):
            cur = self.walk_step(cur, *self.draw(cur.clamp(min=0), 1,
                                                 generator))
            path.append(cur)
        return torch.stack(path, 1)

    def sample_nodes(self, generator: torch.Generator,
                     count: int) -> torch.Tensor:
        """Uniform node draws (negative sampling, ≙ graph_node_sample)."""
        return torch.randint(0, self.num_nodes, (count,), generator=generator,
                             device=self.device, dtype=torch.int32)


def sage_aggregate(emb: torch.Tensor, neigh_idx: torch.Tensor,
                   reduce: str = "mean") -> torch.Tensor:
    """GraphSage neighbor aggregation (≙ the feature aggregation the
    reference's GNN mode feeds from graph_neighbor_sample outputs).

    emb [N, D] node-indexed features; neigh_idx [B, K] sampled neighbor
    ids, -1 where a node had no neighbor → [B, D] mean / max over the
    VALID neighbors (all-invalid rows aggregate to zeros)."""
    if reduce not in ("mean", "max"):
        raise ValueError(f"reduce must be mean|max, got {reduce!r}")
    valid = neigh_idx >= 0                                   # [B, K]
    rows = emb[neigh_idx.clamp(min=0).long()]                # [B, K, D]
    if reduce == "mean":
        m = valid[..., None].to(emb.dtype)
        cnt = valid.sum(dim=1, keepdim=True).clamp(min=1)
        return (rows * m).sum(dim=1) / cnt.to(emb.dtype)
    neg = torch.where(valid[..., None], rows,
                      torch.full_like(rows, -float("inf")))
    out = neg.amax(dim=1)
    return torch.where(valid.any(dim=1, keepdim=True), out,
                       torch.zeros_like(out))


def metapath_step(table: GraphTable, node: torch.Tensor, stuck: torch.Tensor,
                  off: Optional[torch.Tensor], u: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of ``metapath_walk`` through ``table`` under given draws
    ([B, 1], for the nodes ``max(node, 0)``) → (next node, stuck)."""
    nxt_raw = table.select(node.clamp(min=0), off, u)[:, 0]
    ok = (nxt_raw >= 0) & ~stuck
    return torch.where(ok, nxt_raw, node), stuck | (nxt_raw < 0)


def metapath_walk(tables: Sequence[GraphTable], starts: torch.Tensor,
                  length: int, generator: torch.Generator) -> torch.Tensor:
    """Meta-path walks over typed edge tables (≙ GraphConfig.meta_path +
    first_node_type, data_feed.proto:29-40: "user2item-item2user" walks
    alternate edge types so each hop lands on the path's next node type).
    tables: one GraphTable per meta-path edge type, applied cyclically;
    starts [B] nodes of the first type → [B, length+1].

    A walk that dead-ends STAYS stuck (repeating its node): id spaces of
    different node types may overlap across tables, so re-sampling a
    stuck node in a later edge type could resume through an unrelated
    entity of the wrong type."""
    if not tables:
        raise ValueError("metapath_walk needs at least one edge table")
    node = torch.as_tensor(starts, device=tables[0].device).to(torch.int32)
    stuck = torch.zeros_like(node, dtype=torch.bool)
    path = [node]
    for t in range(length):
        table = tables[t % len(tables)]
        node, stuck = metapath_step(
            table, node, stuck, *table.draw(node.clamp(min=0), 1, generator))
        path.append(node)
    return torch.stack(path, 1)
