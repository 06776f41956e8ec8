"""The one general traffic generator: a pass of sparse-CTR records made
from a traffic file's parameters and ``--seed``.

A traffic file (``traffic/<name>.json``) gives the slots' key spaces
(``cardinalities``), the Zipf exponent of the draws inside each slot,
the keys a slot holds in a record (``keys_per_slot``, inclusive), the
share of positive labels, the dense features a record carries and the
batches that make a pass.  Every seed gets the same sizes: each slot's
multiset of key counts is fixed (lengths cycle through the range and are
then shuffled), so a pass always holds the same number of records and of
key occurrences; the seed only orders them and draws the keys.

Keys are 64-bit feasigns: slot ``s``'s Zipf rank ``r`` (1 is the most
frequent) becomes ``splitmix64((s + 1) << 40 | r)``, a bijection, so the
slots' key spaces are disjoint and the hot keys land anywhere in the
sorted key order, as hashed feasigns do.  The draws run on ``device``
(a card, in a few large calls); the records are handed over on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of ``seed`` (traffic, table,
    dense weights): splitmix64 of the pair, cut to 63 bits."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream) & ((1 << 64) - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 31)) & _MASK63


def feasigns(slot: int, ranks: np.ndarray) -> np.ndarray:
    """uint64 feasign of each Zipf rank of ``slot``."""
    with np.errstate(over="ignore"):
        z = (np.uint64(slot + 1) << np.uint64(40)) | ranks.astype(np.uint64)
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    if not z.all():
        raise ValueError(f"slot {slot}: a rank hashed to the reserved key 0")
    return z


def zipf_cdf(n: int, exponent: float, device) -> torch.Tensor:
    """float64 CDF of the bounded Zipf law over ranks 1..n."""
    p = torch.arange(1, n + 1, dtype=torch.float64,
                     device=device).pow_(-exponent)
    cdf = torch.cumsum(p, 0)
    cdf /= cdf[-1].clone()
    cdf[-1] = 1.0
    return cdf


@dataclasses.dataclass
class Records:
    """One pass of records, in order (batch i = records [i*B, (i+1)*B))."""

    n: int
    batch_size: int
    slot_ids: List[int]
    keys: List[Tuple[np.ndarray, np.ndarray]]   # per slot (uint64, offsets)
    labels: np.ndarray                          # float32 [n]
    dense: np.ndarray                           # float32 [n, F]

    def all_keys(self) -> np.ndarray:
        return np.concatenate([k for k, _ in self.keys])

    def batch(self, i: int):
        """Batch ``i``: per slot (keys, lengths), labels, dense."""
        lo, hi = i * self.batch_size, (i + 1) * self.batch_size
        slots = []
        for keys, off in self.keys:
            slots.append((keys[off[lo]:off[hi]], np.diff(off[lo:hi + 1])))
        return slots, self.labels[lo:hi], self.dense[lo:hi]


def check_spec(spec: dict) -> None:
    lo, hi = spec["keys_per_slot"]
    if not 1 <= lo <= hi <= spec["capacity"]:
        raise ValueError(f"{spec['name']}: keys_per_slot {lo}..{hi} must "
                         f"lie in 1..capacity ({spec['capacity']})")
    if min(spec["cardinalities"]) < 1 or max(spec["cardinalities"]) >= 1 << 40:
        raise ValueError(f"{spec['name']}: a cardinality is out of range")


def make_pass(spec: dict, batch_size: int, seed: int,
              device="cpu") -> Records:
    """The pass of ``spec`` for ``seed``, drawn on ``device``."""
    check_spec(spec)
    dev = torch.device(device)
    n = batch_size * int(spec["batches_per_pass"])
    lo, hi = spec["keys_per_slot"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(sub_seed(seed, 1))
    # the same multiset of lengths in every slot and for every seed
    cycle = lo + torch.arange(n, device=dev) % (hi - lo + 1)
    keys = []
    for s, card in enumerate(spec["cardinalities"]):
        lens = cycle[torch.randperm(n, generator=gen, device=dev)]
        cdf = zipf_cdf(int(card), float(spec["zipf_exponent"]), dev)
        u = torch.rand(int(lens.sum()), generator=gen, device=dev,
                       dtype=torch.float64)
        ranks = torch.searchsorted(cdf, u, right=True) + 1
        ranks = torch.clamp_(ranks, max=int(card))
        del cdf, u
        off = np.zeros(n + 1, np.int64)
        np.cumsum(lens.cpu().numpy(), out=off[1:])
        keys.append((feasigns(s, ranks.cpu().numpy()), off))
    labels = (torch.rand(n, generator=gen, device=dev)
              < float(spec["positive_rate"])).to(torch.float32)
    dense = torch.randn((n, int(spec["dense_features"])), generator=gen,
                        device=dev)
    base = int(spec["slot_id_base"])
    return Records(n=n, batch_size=batch_size,
                   slot_ids=[base + s for s in range(len(keys))], keys=keys,
                   labels=labels.cpu().numpy(), dense=dense.cpu().numpy())
