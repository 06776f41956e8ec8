"""Wide & Deep (Cheng et al., 2016) over BoxPS's pooled slots: a linear
wide part and an MLP, both over every pooled column and the dense
features; the logit is their sum."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.models import mlp


def _in_dim(cfg: Dict) -> int:
    return cfg["num_slots"] * (3 + cfg["embedding_dim"]) + cfg["dense_dim"]


def _sizes(cfg: Dict) -> List[int]:
    return [_in_dim(cfg)] + list(cfg["hidden"]) + [1]


def param_specs(cfg: Dict) -> List[Tuple]:
    return mlp.specs("mlp.layers", _sizes(cfg)) + [
        ("wide_w", (_in_dim(cfg), 1), ("uniform", -0.01, 0.01)),
        ("wide_b", (1,), ("zeros",))]


def logits(params: Dict[str, torch.Tensor], pooled: torch.Tensor,
           dense: torch.Tensor, cfg: Dict) -> torch.Tensor:
    b = pooled.shape[0]
    x = torch.cat([pooled.reshape(b, -1), dense], dim=1)
    wide = (x @ params["wide_w"])[:, 0] + params["wide_b"][0]
    return wide + mlp.forward(params, "mlp.layers", len(_sizes(cfg)) - 1,
                              x)[:, 0]


def macs_per_record(cfg: Dict) -> int:
    """The MLP's products and the wide part's."""
    return mlp.macs(_sizes(cfg)) + _in_dim(cfg)
