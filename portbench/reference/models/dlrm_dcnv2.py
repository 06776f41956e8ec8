"""DLRM-DCNv2, MLPerf Training's recommendation model (recommendation_v2,
torchrec_dlrm; Naumov et al. 2019, arXiv:1906.00091, with the low-rank
cross network of Wang et al. 2021, arXiv:2008.13535), over BoxPS's
pooled slots.

    b      = relu(bottom MLP(dense))        ReLU after every layer
    x0     = [b, pooled]                     the bottom output first
    x_l+1  = x0 * (W_l (V_l x_l) + c_l) + x_l     l < cross_layers
    logit  = top MLP(x_L)                    no ReLU after the last

V_l is [cross_rank, width] with no bias, W_l [width, cross_rank] with
bias c_l.  Departures from the published model: each pooled slot is
BoxPS's (CVM show and click, the first-order embed_w, then the embedx),
so the width is ``bottom[-1] + num_slots * (3 + embedding_dim)``, not
``bottom[-1] + num_slots * embedding_dim``; the weights are drawn
Xavier-uniform with zero biases throughout (torchrec draws the cross
weights Xavier-normal).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.models import mlp


def _bottom(cfg: Dict) -> List[int]:
    return [cfg["dense_dim"]] + list(cfg["bottom_mlp"])


def _width(cfg: Dict) -> int:
    slot = 3 + cfg["embedding_dim"]
    return cfg["bottom_mlp"][-1] + cfg["num_slots"] * slot


def _top(cfg: Dict) -> List[int]:
    return [_width(cfg)] + list(cfg["hidden"]) + [1]


def param_specs(cfg: Dict) -> List[Tuple]:
    n, r = _width(cfg), cfg["cross_rank"]
    bound = (6.0 / (n + r)) ** 0.5
    cross = []
    for i in range(cfg["cross_layers"]):
        cross += [(f"cross_v.{i}.weight", (r, n), ("uniform", -bound, bound)),
                  (f"cross_w.{i}.weight", (n, r), ("uniform", -bound, bound)),
                  (f"cross_w.{i}.bias", (n,), ("zeros",))]
    return (mlp.specs("bottom.layers", _bottom(cfg)) + cross
            + mlp.specs("top.layers", _top(cfg)))


def logits(params: Dict[str, torch.Tensor], pooled: torch.Tensor,
           dense: torch.Tensor, cfg: Dict) -> torch.Tensor:
    b = pooled.shape[0]
    bottom = torch.relu(mlp.forward(params, "bottom.layers",
                                    len(_bottom(cfg)) - 1, dense))
    x0 = torch.cat([bottom, pooled.reshape(b, -1)], dim=1)
    x = x0
    for i in range(cfg["cross_layers"]):
        low = x @ params[f"cross_v.{i}.weight"].T
        x = x0 * (low @ params[f"cross_w.{i}.weight"].T
                  + params[f"cross_w.{i}.bias"]) + x
    return mlp.forward(params, "top.layers", len(_top(cfg)) - 1, x)[:, 0]


def macs_per_record(cfg: Dict) -> int:
    """The bottom MLP's, the cross layers' two low-rank products each and
    the top MLP's."""
    cross = 2 * _width(cfg) * cfg["cross_rank"] * cfg["cross_layers"]
    return mlp.macs(_bottom(cfg)) + cross + mlp.macs(_top(cfg))
