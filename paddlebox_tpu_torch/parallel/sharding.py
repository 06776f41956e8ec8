"""ZeRO-style parameter / optimizer-state sharding over the ``sharding``
axis.

Port of ``paddlebox_tpu/parallel/sharding.py`` (≙ meta_parallel/
sharding/: GroupShardedOptimizerStage2 — optimizer-state slicing,
GroupShardedStage2 — grad scatter + param broadcast, GroupShardedStage3 —
param slicing with on-demand gather):

* ``zero_spec`` / ``zero_sharding`` give the placement: each tensor's
  first dim that divides by the axis size is split over the axis
  (stage 1/3 for optimizer state / params); ``place_like`` applies it,
  giving each leaf's per-shard blocks;
* ``scatter_grads`` / ``gather_params`` are the explicit collectives of
  stage 2/3 (reduce_scatter ≙ grad scatter; all_gather ≙ the on-demand
  param broadcast), over per-shard lists as in ``parallel/collective.py``;
* ``GroupShardedOptimizer`` is the stage-2 update: replicated params,
  reduce-scattered grads, one ``torch.optim`` optimizer per shard over
  the slices it owns, the updated slices all-gathered.

A tree is a tensor, or a dict / list / tuple of trees; the collectives
take trees whose leaves are per-shard lists of tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from paddlebox_tpu_torch.parallel import collective
from paddlebox_tpu_torch.parallel.topology import (HybridTopology, Spec,
                                                   on_device)


def _is_shards(x) -> bool:
    return (isinstance(x, list) and len(x) > 0
            and all(isinstance(t, torch.Tensor) for t in x))


def _tree_map(fn, *trees, shards: bool = False):
    """fn over the leaves of ``trees`` (tensors; with ``shards``, the
    per-shard lists of tensors)."""
    t = trees[0]
    if shards and _is_shards(t):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _tree_map(fn, *[x[k] for x in trees], shards=shards)
                for k in t}
    if isinstance(t, (list, tuple)) and not isinstance(t, Spec):
        return type(t)(_tree_map(fn, *xs, shards=shards)
                       for xs in zip(*trees))
    return fn(*trees)


def _shard_dim(shape, n: int) -> Optional[int]:
    """First dim that splits evenly over n shards, None if none does."""
    for d, size in enumerate(shape):
        if size % n == 0 and size >= n:
            return d
    return None


def zero_spec(x, axis: str = "sharding", axis_size: int = 1) -> Spec:
    """First dim divisible by the axis size gets split; else replicate."""
    d = _shard_dim(tuple(x.shape), axis_size)
    if d is None:
        return Spec()
    spec = [None] * len(x.shape)
    spec[d] = axis
    return Spec(*spec)


def zero_sharding(tree, topo: HybridTopology, axis: str = "sharding"):
    """Tree of tensors → tree of Specs (apply with :func:`place_like`).
    Stage 1: apply to the optimizer state; stage 3: to the params too."""
    n = topo.axis_size(axis)
    return _tree_map(lambda x: zero_spec(x, axis, n), tree)


def place_like(tree, specs, topo: HybridTopology):
    """Each leaf's per-shard blocks under its Spec, each on its shard's
    device (views where the leaf already lives there)."""
    return _tree_map(lambda x, s: topo.split(x, s), tree, specs)


# -- explicit collectives (stage 2/3 semantics) ------------------------------

def scatter_grads(grads, topo: HybridTopology, axis: str = "sharding"):
    """Tree of per-shard grad lists → tree of per-shard lists where each
    shard holds the axis-summed block of the first dim that splits over
    the axis (≙ Stage2 grad scatter); a leaf too small to split is
    summed whole on every shard."""
    n = topo.axis_size(axis)

    def one(gs: List[torch.Tensor]) -> List[torch.Tensor]:
        d = _shard_dim(tuple(gs[0].shape), n)
        if d is None:
            return collective.all_reduce(gs, topo, axis)
        return collective.reduce_scatter(gs, topo, axis, scatter_dim=d)

    return _tree_map(one, grads, shards=True)


def gather_params(local_params, full_shapes, topo: HybridTopology,
                  axis: str = "sharding"):
    """Tree of per-shard owned slices → tree of per-shard full tensors
    (≙ Stage3 on-demand param broadcast).  ``full_shapes``: a tree of
    tensors (or shapes) of the full leaves."""
    n = topo.axis_size(axis)

    def one(ps: List[torch.Tensor], full) -> List[torch.Tensor]:
        shape = tuple(full.shape) if hasattr(full, "shape") else tuple(full)
        d = _shard_dim(shape, n)
        if d is None or ps[0].shape[d] * n != shape[d]:
            return ps
        return collective.all_gather(ps, topo, axis, concat_dim=d)

    return _tree_map(one, local_params, full_shapes, shards=True)


class GroupShardedOptimizer:
    """Stage-2 update: params replicated, grads reduce-scattered, the
    optimizer stepping only each shard's owned slices, the updated
    slices all-gathered.

    ``make_opt(params)`` builds the per-shard optimizer over a list of
    leaf tensors (``lambda ps: torch.optim.Adam(ps, lr=1e-2)``) — the
    port's stand-in for the JAX class's optax ``tx``."""

    def __init__(self, make_opt: Callable[[List[torch.Tensor]],
                                          torch.optim.Optimizer],
                 topo: HybridTopology, axis: str = "sharding"):
        self.make_opt = make_opt
        self.topo = topo
        self.axis = axis
        self.local: List[Dict[str, torch.Tensor]] = []
        self.opts: List[torch.optim.Optimizer] = []

    def _slice(self, p: torch.Tensor, shard: int) -> torch.Tensor:
        n = self.topo.axis_size(self.axis)
        d = _shard_dim(tuple(p.shape), n)
        if d is None:
            return p
        step = p.shape[d] // n
        idx = self.topo.axis_index(shard, self.axis)
        return p.narrow(d, idx * step, step)

    def init(self, params: Dict[str, torch.Tensor]) -> None:
        """Each shard's owned slices of ``params`` (copies on the shard's
        device, the leaves its optimizer steps) and its optimizer."""
        self.local = [{k: on_device(self._slice(p, s).detach(),
                                    self.topo.device_of(s), copy=True)
                       for k, p in params.items()}
                      for s in range(self.topo.world_size)]
        self.opts = [self.make_opt(list(loc.values())) for loc in self.local]

    def update(self, grads: Dict[str, List[torch.Tensor]],
               params: Dict[str, torch.Tensor]
               ) -> Dict[str, List[torch.Tensor]]:
        """``grads``: each param's per-shard grads (summed over the
        shard's own data).  Returns each param's per-shard full tensor
        after the step."""
        g_local = scatter_grads(grads, self.topo, self.axis)
        with torch.no_grad():
            for s, (loc, opt) in enumerate(zip(self.local, self.opts)):
                for k, p in loc.items():
                    p.grad = g_local[k][s].clone()
                opt.step()
        local = {k: [loc[k].detach() for loc in self.local] for k in params}
        return gather_params(local, params, self.topo, self.axis)
