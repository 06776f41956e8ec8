"""The sparse table of the reference, in key space.

Rows are the sorted unique feasigns the followed batches hold.  A fresh
row is a pure function of (table seed, feasign, column): the
splitmix64-keyed uniform below, the rule BoxPS's host table uses for
unseen keys (lr weight U(-initial_range, initial_range), embedx
U(0, mf_initial_range), every statistic 0, embedx not yet created).

The step's sparse half, after BoxPS (box_wrapper_impl.h PullSparse /
PushSparseGrad, optimizer.cuh.h SparseAdagradOptimizer):
pull [show, click, embed_w, embedx if created] a key, sum them over a
record's keys of a slot, CVM (log(show + 1), log(click + 1) - log(show +
1)); push per occurrence (g_show 1, g_click the label, the pooled grads
of embed_w and embedx), merged by key; then the adagrad rule on every
touched row, embedx created once the show/click score reaches the
threshold (a row created by a push keeps its fresh values for that push).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def keyed_uniform(keys: np.ndarray, seed: int, col: int, lo: float,
                  hi: float) -> np.ndarray:
    """U(lo, hi) as a pure function of (seed, key, column), float32."""
    salt = np.uint64(_mix64(seed * 2654435761 + col))
    with np.errstate(over="ignore"):
        z = (keys.astype(np.uint64) ^ salt) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    u = (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    return (lo + (hi - lo) * u).astype(np.float32)


def fresh_rows(keys: np.ndarray, mf_dim: int, seed: int, sgd: Dict,
               device) -> Dict[str, torch.Tensor]:
    """The table's rows of ``keys`` before any push."""
    n = len(keys)
    f32 = dict(dtype=torch.float32, device=device)
    ir = float(sgd["initial_range"])
    embed_w = (keyed_uniform(keys, seed, 0, -ir, ir) if ir > 0
               else np.zeros(n, np.float32))
    mf = np.stack([keyed_uniform(keys, seed, 1 + d, 0.0,
                                 float(sgd["mf_initial_range"]))
                   for d in range(mf_dim)], axis=1)
    return {"show": torch.zeros(n, **f32), "click": torch.zeros(n, **f32),
            "delta_score": torch.zeros(n, **f32),
            "slot": torch.zeros(n, dtype=torch.int32, device=device),
            "embed_w": torch.as_tensor(embed_w, device=device),
            "embed_g2sum": torch.zeros(n, **f32),
            "mf_size": torch.zeros(n, dtype=torch.int32, device=device),
            "mf_g2sum": torch.zeros(n, **f32),
            "mf": torch.as_tensor(mf, device=device)}


def pull_pool_cvm(t: Dict[str, torch.Tensor], occ_row: torch.Tensor,
                  occ_seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Pooled, CVM-transformed pull values [n_seg, 3 + D]."""
    created = (t["mf_size"][occ_row] > 0).to(torch.float32)
    vals = torch.cat([t["show"][occ_row, None], t["click"][occ_row, None],
                      t["embed_w"][occ_row, None],
                      t["mf"][occ_row] * created[:, None]], dim=1)
    pooled = torch.zeros((n_seg, vals.shape[1]), dtype=torch.float32,
                         device=vals.device).index_add_(0, occ_seg, vals)
    show = torch.log(pooled[:, 0] + 1.0)
    click = torch.log(pooled[:, 1] + 1.0) - show
    return torch.cat([show[:, None], click[:, None], pooled[:, 2:]], dim=1)


def merged_push(n: int, occ_row: torch.Tensor, occ_seg: torch.Tensor,
                occ_label: torch.Tensor, occ_slot: torch.Tensor,
                d_pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-key sums of the occurrences' push values; d_pooled
    [n_seg, 3 + D] the grads of the pooled values."""
    dev = d_pooled.device
    g = d_pooled[occ_seg]
    d = g.shape[1] - 3
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return {
        "g_show": zeros(n).index_add_(0, occ_row,
                                      torch.ones_like(occ_label)),
        "g_click": zeros(n).index_add_(0, occ_row, occ_label),
        "g_embed": zeros(n).index_add_(0, occ_row, g[:, 2].contiguous()),
        "g_embedx": zeros(n, d).index_add_(0, occ_row, g[:, 3:].contiguous()),
        # the slots' key spaces are disjoint: every occurrence of a key
        # names its one slot
        "slot": torch.zeros(n, dtype=torch.int32, device=dev).scatter_(
            0, occ_row, occ_slot),
    }


def adagrad(t: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor],
            sgd: Dict) -> None:
    """BoxPS's sparse adagrad rule on the touched rows, in place."""
    touched = acc["g_show"] > 0
    g_show = acc["g_show"]
    show = torch.where(touched, t["show"] + g_show, t["show"])
    click = torch.where(touched, t["click"] + acc["g_click"], t["click"])
    t["delta_score"] = torch.where(
        touched, t["delta_score"]
        + sgd["nonclk_coeff"] * (g_show - acc["g_click"])
        + sgd["clk_coeff"] * acc["g_click"], t["delta_score"])
    slot = torch.where(touched, acc["slot"], t["slot"])
    scale = torch.where(touched, g_show, torch.ones_like(g_show))

    lr = torch.where(slot == int(sgd["nodeid_slot"]),
                     torch.full_like(scale, sgd["learning_rate"]),
                     torch.full_like(scale, sgd["feature_learning_rate"]))
    ratio = lr * torch.sqrt(sgd["initial_g2sum"]
                            / (sgd["initial_g2sum"] + t["embed_g2sum"]))
    sg = acc["g_embed"] / scale
    w = torch.clamp(t["embed_w"] + sg * ratio, sgd["min_bound"],
                    sgd["max_bound"])
    t["embed_w"] = torch.where(touched, w, t["embed_w"])
    t["embed_g2sum"] = torch.where(touched, t["embed_g2sum"] + sg * sg,
                                   t["embed_g2sum"])

    d = t["mf"].shape[1]
    score = sgd["nonclk_coeff"] * (show - click) + sgd["clk_coeff"] * click
    create = touched & (t["mf_size"] == 0) & \
        (score >= sgd["mf_create_thresholds"])
    mf_touched = touched & (t["mf_size"] > 0)
    ratio = sgd["mf_learning_rate"] * torch.sqrt(
        sgd["mf_initial_g2sum"] / (sgd["mf_initial_g2sum"] + t["mf_g2sum"]))
    sgm = acc["g_embedx"] / scale[:, None]
    mf = torch.clamp(t["mf"] + sgm * ratio[:, None], sgd["mf_min_bound"],
                     sgd["mf_max_bound"])
    t["mf"] = torch.where(mf_touched[:, None], mf, t["mf"])
    t["mf_g2sum"] = torch.where(
        mf_touched, t["mf_g2sum"] + torch.sum(sgm * sgm, dim=1) / d,
        t["mf_g2sum"])
    t["mf_size"] = torch.where(create, torch.full_like(t["mf_size"], d),
                               t["mf_size"])
    t["show"], t["click"], t["slot"] = show, click, slot
