"""The dense weights of a run, drawn on the device from the seed in one
call: one uniform buffer, cut into the leaves of the configuration's net
(``param_specs`` of its reference model) and scaled to each leaf's
range."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def draw(specs: List[Tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    dev = torch.device(device)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=dev)
    out, off = {}, 0
    for (name, shape, init), n in zip(specs, sizes):
        if init[0] == "zeros":
            out[name] = torch.zeros(shape, device=dev)
        elif init[0] == "uniform":
            lo, hi = init[1], init[2]
            out[name] = (lo + (hi - lo) * u[off:off + n]).reshape(shape)
        else:
            raise ValueError(f"{name}: unknown init {init[0]!r}")
        off += n
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, params: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``params`` into the module's parameters of the same names;
    the two sets of names and shapes must be equal."""
    named = dict(module.named_parameters())
    if set(named) != set(params):
        raise ValueError(f"the program's parameters {sorted(named)} are not "
                         f"the reference's {sorted(params)}")
    for k, p in named.items():
        if tuple(p.shape) != tuple(params[k].shape):
            raise ValueError(f"{k}: program shape {tuple(p.shape)}, "
                             f"reference {tuple(params[k].shape)}")
        p.copy_(params[k])
