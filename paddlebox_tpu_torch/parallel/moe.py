"""Mixture-of-Experts with expert parallelism.

Port of ``paddlebox_tpu/parallel/moe.py`` (≙ python/paddle/incubate/
distributed/models/moe/: MoELayer (moe_layer.py:244) with MoEScatter /
MoEGather over the global_scatter / global_gather all2all ops
(:88-151), and the gate zoo (models/moe/gate/): naive, switch (top-1),
gshard (top-2 + aux load-balance loss)).

The JAX package's one-hot einsum form, kept as it is: tokens one-hot
into [E, C] capacity buckets, an ``all_to_all`` over the ``ep`` axis
moves expert shards (the reference's global_scatter), the experts run
batched matmuls on [E_local, n·C, d], then the inverse path.  Bucket
positions are float cumsums, exact below 2^24 tokens; ``argmax`` ties
go to the lowest expert in both packages.  A sort-based dispatch would
move fewer bytes (later speed work).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from paddlebox_tpu_torch.parallel import collective
from paddlebox_tpu_torch.parallel.topology import HybridTopology, Spec


# -- gates (≙ models/moe/gate/{naive,switch,gshard}_gate.py) ---------------

def _buckets(onehot: torch.Tensor, pos: torch.Tensor, capacity: int
             ) -> torch.Tensor:
    """[T, E, C] dispatch mask: token t to slot pos[t, e] of expert e
    where onehot[t, e] and the slot is within capacity."""
    keep = (pos >= 0) & (pos < capacity) & (onehot > 0)
    pc = pos.clamp(0, capacity - 1).long()
    slots = torch.arange(capacity, device=pos.device)
    return ((pc[..., None] == slots) & keep[..., None]).to(onehot.dtype)


def top1_gate(logits: torch.Tensor, capacity: int):
    """Switch-style top-1 routing → (dispatch [T,E,C], combine [T,E,C],
    aux_loss).  T = local tokens, E = global experts."""
    _, n_exp = logits.shape
    probs = torch.softmax(logits, -1)
    expert = probs.argmax(-1)                              # [T]
    onehot = torch.nn.functional.one_hot(expert, n_exp).to(probs.dtype)
    # position of each token within its expert's capacity bucket
    pos = onehot.cumsum(0) * onehot - 1.0                  # [T,E]
    dispatch = _buckets(onehot, pos, capacity)
    gate_val = (probs * onehot).sum(-1)                    # [T]
    combine = dispatch * gate_val[:, None, None]
    # switch aux loss: E * sum(fraction_tokens * fraction_probs)
    aux = n_exp * (onehot.mean(0) * probs.mean(0)).sum()
    return dispatch, combine, aux


def top2_gate(logits: torch.Tensor, capacity: int):
    """GShard top-2 gate (second expert weighted, shared capacity)."""
    _, n_exp = logits.shape
    probs = torch.softmax(logits, -1)
    oh1 = torch.nn.functional.one_hot(probs.argmax(-1), n_exp).to(probs.dtype)
    probs2 = probs * (1 - oh1)
    oh2 = torch.nn.functional.one_hot(probs2.argmax(-1),
                                      n_exp).to(probs.dtype)
    g1 = (probs * oh1).sum(-1)
    g2 = (probs * oh2).sum(-1)
    denom = (g1 + g2).clamp(min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    pos1 = oh1.cumsum(0) * oh1 - 1.0
    # second choices queue behind all first choices of the same expert
    pos2 = (oh2.cumsum(0) + oh1.sum(0, keepdim=True)) * oh2 - 1.0
    d1 = _buckets(oh1, pos1, capacity)
    d2 = _buckets(oh2, pos2, capacity)
    aux = n_exp * (oh1.mean(0) * probs.mean(0)).sum()
    return d1 + d2, d1 * g1[:, None, None] + d2 * g2[:, None, None], aux


GATES = {"switch": top1_gate, "gshard": top2_gate, "naive": top1_gate}


# -- expert-parallel layer --------------------------------------------------

@dataclasses.dataclass
class MoEConfig:
    d_model: int
    d_hidden: int
    num_experts: int          # global expert count (divisible by ep size)
    capacity_factor: float = 1.25
    gate: str = "gshard"


class MoELayer:
    """``apply_sharded`` over a topology's shards with tokens split (or
    replicated) over ``ep``.

    params: gate [d, E] replicated; w1 [E, d, h], b1 [E, h], w2 [E, h, d],
    b2 [E, d] — the expert dim split over ep.
    """

    def __init__(self, config: MoEConfig, axis: str = "ep"):
        self.cfg = config
        self.axis = axis

    def init(self, generator: torch.Generator) -> Dict:
        """Params on the generator's device."""
        c = self.cfg
        dev = generator.device
        s1 = math.sqrt(6.0 / (c.d_model + c.d_hidden))

        def uniform(shape):
            return torch.empty(shape, device=dev).uniform_(
                -s1, s1, generator=generator)

        return {
            "gate": torch.randn((c.d_model, c.num_experts),
                                generator=generator, device=dev) * 0.02,
            "w1": uniform((c.num_experts, c.d_model, c.d_hidden)),
            "b1": torch.zeros((c.num_experts, c.d_hidden), device=dev),
            "w2": uniform((c.num_experts, c.d_hidden, c.d_model)),
            "b2": torch.zeros((c.num_experts, c.d_model), device=dev),
        }

    def param_specs(self) -> Dict:
        ax = self.axis
        return {"gate": Spec(), "w1": Spec(ax), "b1": Spec(ax),
                "w2": Spec(ax), "b2": Spec(ax)}

    def capacity(self, tokens_local: int, ep: int) -> int:
        cap = int(self.cfg.capacity_factor * tokens_local * ep
                  / self.cfg.num_experts)
        return max(cap, 4)

    @staticmethod
    def _experts(p: Dict, buckets: torch.Tensor) -> torch.Tensor:
        h = torch.relu(torch.einsum("ecd,edh->ech", buckets, p["w1"])
                       + p["b1"][:, None, :])
        return torch.einsum("ech,ehd->ecd", h, p["w2"]) + p["b2"][:, None, :]

    def apply_sharded(self, params_locals: List[Dict],
                      xs: List[torch.Tensor], topo: HybridTopology, ep: int
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """xs: each shard's [T_local, d]; params_locals: each shard's
        experts [E/ep, ...].  Returns (per-shard y [T_local, d], per-shard
        aux loss)."""
        gate = GATES[self.cfg.gate]
        routes = [gate(x @ p["gate"], self.capacity(x.shape[0], ep))
                  for x, p in zip(xs, params_locals)]
        # local buckets per global expert [E, C, d]
        buckets = [torch.einsum("td,tec->ecd", x, r[0])
                   for x, r in zip(xs, routes)]
        # ≙ global_scatter: each shard receives its experts' buckets from
        # every peer: [E, C, d] → [E/ep, ep·C, d] (global expert id =
        # owner position · E/ep + local expert)
        buckets = collective.all_to_all(buckets, topo, self.axis,
                                        split_dim=0, concat_dim=1)
        outs = [self._experts(p, b) for p, b in zip(params_locals, buckets)]
        # ≙ global_gather: the inverse all_to_all back to the sources
        outs = collective.all_to_all(outs, topo, self.axis, split_dim=1,
                                     concat_dim=0)       # [E, C, d]
        ys = [torch.einsum("ecd,tec->td", o, r[1])
              for o, r in zip(outs, routes)]
        return ys, [r[2] for r in routes]

    def apply_dense(self, params: Dict, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Unsharded golden path (all experts local)."""
        dispatch, combine, aux = GATES[self.cfg.gate](
            x @ params["gate"], self.capacity(x.shape[0], 1))
        buckets = torch.einsum("td,tec->ecd", x, dispatch)
        out = self._experts(params, buckets)
        return torch.einsum("ecd,tec->td", out, combine), aux
