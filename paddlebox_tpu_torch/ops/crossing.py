"""Permutation crossings between the sorted and canonical occurrence domains.

Port of ``paddlebox_tpu/ops/crossing.py``.  The mxu step (ps/mxu_path.py)
moves per-occurrence values between canonical [S, L, B] order and the
plan's sorted order twice per step.  Two interchangeable lowerings:

* "take" — gather rows by source index.
* "sort" — applying a known permutation is a key-value sort keyed by the
  DESTINATION positions: a stable sort of ``dest`` carries each value to
  position dest[j].

Both give the same values bit for bit.  ``best_mode`` reads
FLAGS_mxu_crossing first; "auto" takes "take" on the CPU and, on a card,
times both lowerings once per geometry with CUDA events and caches the
answer.  A failing lowering raises: there is no quiet fallback.
"""

from __future__ import annotations

import functools
import logging
from typing import Sequence

import torch

from paddlebox_tpu_torch import flags

log = logging.getLogger(__name__)

MODES = ("take", "sort", "auto")


def permute_by_dest(channels: Sequence[torch.Tensor],
                    dest: torch.Tensor) -> torch.Tensor:
    """out[:, rank(dest[j])] = values[:, j]: for a permutation ``dest`` of
    0..n-1, value j lands at position dest[j]; ``dest`` may be shifted
    (a trimmed plan's negative kept positions sort first).

    channels: a sequence of [n] tensors (channel-major payload).  Returns
    them permuted and stacked [w, n]."""
    order = torch.sort(dest, stable=True).indices
    return torch.stack(tuple(channels), dim=0)[:, order]


def _time_ms(fn, args, reps: int = 3) -> float:
    """Mean device ms of ``fn(*args)`` over ``reps`` calls after one
    warm-up call, between CUDA events."""
    fn(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def best_mode(take_rows: int, sort_n: int, w: int, device_type: str,
              dtype: str = "float32") -> str:
    """Lowering of a crossing that "take" serves with ``take_rows`` output
    rows and "sort" with an ``sort_n``-element sort carrying ``w``
    channels.  The flag is read outside the cache, so pinning it works
    after a tuned pass too."""
    mode = flags.get_flags("mxu_crossing")
    if mode not in MODES:
        raise ValueError(
            f"FLAGS_mxu_crossing={mode!r}: must be take | sort | auto")
    if mode != "auto":
        return mode
    if device_type == "cpu":
        return "take"
    return measure(take_rows, sort_n, w, dtype)[0]


@functools.lru_cache(maxsize=None)
def measure(take_rows: int, sort_n: int, w: int, dtype: str = "float32"):
    """(winner, take ms, sort ms) on the current card for one geometry,
    from seeded random operands; cached per geometry."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    src = torch.randn((sort_n, w), generator=g, device=dev).to(
        getattr(torch, dtype))
    idx = torch.randint(0, sort_n, (take_rows,), generator=g, device=dev)
    dest = torch.randperm(sort_n, generator=g, device=dev).to(torch.int32)
    t_take = _time_ms(lambda v, i: v[i], (src, idx))
    t_sort = _time_ms(lambda v, d: permute_by_dest(tuple(v.T), d),
                      (src, dest))
    mode = "sort" if t_sort < t_take else "take"
    log.info("crossing auto-tune (take_rows=%d sort_n=%d w=%d %s): "
             "take=%.3fms sort=%.3fms -> %s", take_rows, sort_n, w, dtype,
             t_take, t_sort, mode)
    return mode, t_take, t_sort
