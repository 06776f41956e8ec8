"""Tensor-parallel layers.

Port of ``paddlebox_tpu/parallel/tp_layers.py`` (≙ fleet/meta_parallel/
parallel_layers/mp_layers.py — VocabParallelEmbedding (:30),
ColumnParallelLinear (:95), RowParallelLinear (:171),
ParallelCrossEntropy (:251)).

Layers are functional (``init`` / ``apply``) and come in two flavors
that share parameters: ``param_specs()`` gives each parameter's
:class:`~paddlebox_tpu_torch.parallel.topology.Spec` and ``apply`` is
the plain dense math; ``apply_sharded(params_locals, xs, topo)`` is the
explicit per-shard math over a topology's shards — lists indexed by
flat shard number (``topology.split_tree`` / ``topo.split`` make them)
combined by the named-axis collectives of ``parallel/collective.py``,
where the JAX package calls psum / all_gather inside shard_map.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.parallel import collective
from paddlebox_tpu_torch.parallel.topology import HybridTopology, Spec

Shards = List[torch.Tensor]


def load_jax_params(params, device: DeviceLike = None):
    """The JAX package's params (a dict / tuple / list tree of arrays,
    given as numpy) → the same tree of tensors on ``device`` (``cuda``
    unless the caller names the CPU): JAX's PRNG draws cannot be
    reproduced in torch, so parity runs carry JAX's initial params
    across."""
    if isinstance(params, dict):
        return {k: load_jax_params(v, device) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(load_jax_params(v, device) for v in params)
    return torch.as_tensor(np.array(params), device=resolve_device(device))


def _uniform(shape, bound: float, generator: torch.Generator
             ) -> torch.Tensor:
    return torch.empty(shape, device=generator.device).uniform_(
        -bound, bound, generator=generator)


class ColumnParallelLinear:
    """Weight [in, out] split on out (≙ mp_layers.py:95: identity fwd,
    allreduce grad; optional gather of the column-sharded output)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 gather_output: bool = True, axis: str = "mp"):
        self.in_dim, self.out_dim = in_dim, out_dim
        self.use_bias = use_bias
        self.gather_output = gather_output
        self.axis = axis

    def init(self, generator: torch.Generator) -> Dict:
        """Params on the generator's device."""
        bound = math.sqrt(6.0 / (self.in_dim + self.out_dim))
        p = {"w": _uniform((self.in_dim, self.out_dim), bound, generator)}
        if self.use_bias:
            p["b"] = torch.zeros((self.out_dim,), device=generator.device)
        return p

    def param_specs(self) -> Dict:
        spec = {"w": Spec(None, self.axis)}
        if self.use_bias:
            spec["b"] = Spec(self.axis)
        return spec

    def apply(self, params, x):
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y

    def apply_sharded(self, params_locals: List[Dict], xs: Shards,
                      topo: HybridTopology) -> Shards:
        """Each shard holds its [in, out/mp] block; x is replicated along
        mp → per shard [B, out/mp], or [B, out] with gather_output."""
        ys = [self.apply(p, x) for p, x in zip(params_locals, xs)]
        if self.gather_output:
            ys = collective.all_gather(ys, topo, self.axis,
                                       concat_dim=ys[0].ndim - 1)
        return ys


class RowParallelLinear:
    """Weight [in, out] split on in; partial products sum-reduced
    (≙ mp_layers.py:171)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 input_is_parallel: bool = False, axis: str = "mp"):
        self.in_dim, self.out_dim = in_dim, out_dim
        self.use_bias = use_bias
        self.input_is_parallel = input_is_parallel
        self.axis = axis

    def init(self, generator: torch.Generator) -> Dict:
        bound = math.sqrt(6.0 / (self.in_dim + self.out_dim))
        p = {"w": _uniform((self.in_dim, self.out_dim), bound, generator)}
        if self.use_bias:
            p["b"] = torch.zeros((self.out_dim,), device=generator.device)
        return p

    def param_specs(self) -> Dict:
        spec = {"w": Spec(self.axis, None)}
        if self.use_bias:
            spec["b"] = Spec()  # bias added once after the reduce
        return spec

    def apply(self, params, x):
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y

    def apply_sharded(self, params_locals: List[Dict], xs: Shards,
                      topo: HybridTopology) -> Shards:
        if not self.input_is_parallel:
            # split the replicated input along features to match the rows
            idx = collective.axis_index(topo, self.axis)
            xs = [x[..., i * p["w"].shape[0]:(i + 1) * p["w"].shape[0]]
                  for x, p, i in zip(xs, params_locals, idx)]
        ys = collective.all_reduce([x @ p["w"] for x, p in
                                    zip(xs, params_locals)], topo, self.axis)
        if self.use_bias:
            ys = [y + p["b"] for y, p in zip(ys, params_locals)]
        return ys


class VocabParallelEmbedding:
    """Embedding [vocab, dim] row-split over mp; out-of-shard rows
    contribute zeros, a sum combines (≙ mp_layers.py:30-92 mask +
    allreduce)."""

    def __init__(self, vocab: int, dim: int, axis: str = "mp"):
        if vocab <= 0 or dim <= 0:
            raise ValueError(f"vocab and dim must be positive, got "
                             f"{vocab}, {dim}")
        self.vocab, self.dim = vocab, dim
        self.axis = axis

    def init(self, generator: torch.Generator) -> Dict:
        return {"w": torch.randn((self.vocab, self.dim), generator=generator,
                                 device=generator.device) * 0.02}

    def param_specs(self) -> Dict:
        return {"w": Spec(self.axis, None)}

    def apply(self, params, ids):
        return params["w"][ids.long()]

    def apply_sharded(self, params_locals: List[Dict], ids: Shards,
                      topo: HybridTopology) -> Shards:
        embs = []
        for p, i, pos in zip(params_locals, ids,
                             collective.axis_index(topo, self.axis)):
            shard = p["w"].shape[0]
            local = i.long() - pos * shard
            in_range = (local >= 0) & (local < shard)
            emb = p["w"][local.clamp(0, shard - 1)]
            embs.append(emb * in_range[..., None].to(emb.dtype))
        return collective.all_reduce(embs, topo, self.axis)


def parallel_cross_entropy(logits_locals: Shards, labels: Shards,
                           topo: HybridTopology, axis: str = "mp") -> Shards:
    """Softmax CE over class-sharded logits without forming the full row
    (≙ ParallelCrossEntropy mp_layers.py:251 / c_softmax_with_cross_
    entropy_op): max, sum-exp and the target logit each combined across
    the shards.  ``logits_locals``: each shard's [..., classes/mp] block;
    ``labels``: the global class ids, replicated."""
    gmax = collective.all_reduce([lg.amax(-1) for lg in logits_locals],
                                 topo, axis, op="max")
    zs = [torch.exp(lg - m[..., None]).sum(-1)
          for lg, m in zip(logits_locals, gmax)]
    denom = collective.all_reduce(zs, topo, axis)
    picks = []
    for lg, lb, pos in zip(logits_locals, labels,
                           collective.axis_index(topo, axis)):
        n_local = lg.shape[-1]
        local = lb.long() - pos * n_local
        in_range = (local >= 0) & (local < n_local)
        picked = torch.take_along_dim(
            lg, local.clamp(0, n_local - 1)[..., None], dim=-1)[..., 0]
        picks.append(torch.where(in_range, picked, torch.zeros_like(picked)))
    target = collective.all_reduce(picks, topo, axis)
    return [torch.log(d) + m - t for d, m, t in zip(denom, gmax, target)]
