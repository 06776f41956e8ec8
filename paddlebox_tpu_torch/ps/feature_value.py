"""Feature value schema — struct-of-arrays on host and device.

≙ CommonFeatureValue (heter_ps/feature_value.h:44-57 layout comment:
delta_score, show, click, slot, embed_w, embed_g2sum, mf_dim, mf_size,
mf_g2sum?, embedx...) and CommonPullValue/CommonPushValue
(feature_value.h:161,185).  Instead of packed float rows with index
arithmetic, each field is its own array — the layout XLA/TPU wants (no
byte-offset gymnastics, every field contiguously vectorizable).

Pull value layout delivered to the model is [show, click, embed_w,
embedx x D] — the first two columns feed the CVM transform (cvm_offset=2),
col 2 is the lr/"join" scalar weight (what PaddleBox models call the q value).
Push value is the same width plus implicit slot: [g_show, g_click, g_embed,
g_embedx x D].
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

CVM_COLS = 2          # show, click
PULL_EXTRA = 3        # show, click, embed_w


HOST_FIELDS = (
    # (name, dtype, per-key shape suffix)
    ("show", np.float32, ()),
    ("click", np.float32, ()),
    ("delta_score", np.float32, ()),
    ("slot", np.int32, ()),
    ("embed_w", np.float32, ()),
    ("embed_g2sum", np.float32, ()),
    ("mf_size", np.int32, ()),      # 0 until mf created (lazy, threshold)
    ("mf_g2sum", np.float32, ()),
    ("unseen_days", np.float32, ()),
    ("mf", np.float32, ("D",)),     # embedx weights (random candidate init
                                    # until mf_size > 0 — see optimizer.py)
)

# optional expand ("NNCross") embedding fields, present when
# EmbeddingTableConfig.expand_dim > 0 (≙ PullCopyNNCross box_wrapper.cu:147
# and pull_box_extended_sparse_op)
EXPAND_FIELDS = (
    ("mf_ex", np.float32, ("E",)),
    ("mf_ex_g2sum", np.float32, ()),
)

# extra per-row state for the (shared-)adam optimizers: shared first/second
# moments + beta-power trackers for the embed and embedx groups
# (≙ SparseAdamSharedOptimizer state layout, optimizer.cuh.h:455-467:
# GSum/G2Sum/Beta1Pow/Beta2Pow — here G2Sum reuses embed_g2sum/mf_g2sum)
ADAM_FIELDS = (
    ("embed_gsum", np.float32, ()),
    ("embed_b1p", np.float32, ()),
    ("embed_b2p", np.float32, ()),
    ("mf_gsum", np.float32, ()),
    ("mf_b1p", np.float32, ()),
    ("mf_b2p", np.float32, ()),
)


# per-dim optimizer state (≙ CPU SparseAdamSGDRule sparse_sgd_rule.h:126 /
# GPU SparseAdamOptimizer optimizer.cuh.h:148, and StdAdaGradSGDRule
# sparse_sgd_rule.h:109): embedx moments/g2sum per dimension
DIM_ADAM_FIELDS = (
    ("mf_gsum_d", np.float32, ("D",)),
    ("mf_g2sum_d", np.float32, ("D",)),
)
DIM_ADAGRAD_FIELDS = (
    ("mf_g2sum_d", np.float32, ("D",)),
)


def state_fields(optimizer: str):
    """Extra per-row state fields an optimizer rule needs."""
    return {
        "shared_adam": ADAM_FIELDS,
        "adam": ADAM_FIELDS + DIM_ADAM_FIELDS,
        "std_adagrad": DIM_ADAGRAD_FIELDS,
    }.get(optimizer, ())


def empty_soa(n: int, mf_dim: int, expand_dim: int = 0, adam: bool = False,
              optimizer: str = "",
              double_stats: bool = False) -> Dict[str, np.ndarray]:
    """double_stats: f64 show/click on the host tier — the
    CtrDoubleAccessor layout (ctr_double_accessor.h: DownpourCtrDouble
    keeps show/click as double so billion-impression counters never
    saturate f32's 2^24 integer range)."""
    out = {}
    extra = state_fields(optimizer) if optimizer else \
        (ADAM_FIELDS if adam else ())
    fields = HOST_FIELDS + (EXPAND_FIELDS if expand_dim > 0 else ()) \
        + extra
    for name, dtype, suffix in fields:
        if double_stats and name in ("show", "click"):
            dtype = np.float64
        shape = (n,) + tuple(
            mf_dim if s == "D" else (expand_dim if s == "E" else s)
            for s in suffix)
        out[name] = np.zeros(shape, dtype=dtype)
    return out


def default_rows(n: int, mf_dim: int, rng: np.random.Generator,
                 mf_initial_range: float, initial_range: float = 0.0,
                 expand_dim: int = 0, adam: bool = False,
                 beta1: float = 0.9, beta2: float = 0.999,
                 optimizer: str = "",
                 double_stats: bool = False) -> Dict[str, np.ndarray]:
    """Fresh feature rows for keys unseen by the host table.

    embed_w ~ U(-initial_range, initial_range) (CPU rule init; default range 0
    ⇒ 0, optimizer_conf.h:29); mf gets its creation-time candidate init
    ~ U(0, mf_initial_range) (≙ curand_uniform * mf_initial_range,
    optimizer.cuh.h:119-121) which stays masked until mf_size > 0.
    """
    soa = empty_soa(n, mf_dim, expand_dim, adam, optimizer, double_stats)
    if initial_range > 0:
        soa["embed_w"] = rng.uniform(
            -initial_range, initial_range, size=(n,)).astype(np.float32)
    soa["mf"] = rng.uniform(
        0.0, mf_initial_range, size=(n, mf_dim)).astype(np.float32)
    if expand_dim > 0:
        soa["mf_ex"] = rng.uniform(
            0.0, mf_initial_range, size=(n, expand_dim)).astype(np.float32)
    if "embed_b1p" in soa:
        # fresh features start their beta-power trackers at the decay rates
        # (≙ creation init optimizer.cuh.h:436-441 / adam accessor InitValue)
        soa["embed_b1p"][:] = beta1
        soa["embed_b2p"][:] = beta2
        soa["mf_b1p"][:] = beta1
        soa["mf_b2p"][:] = beta2
    return soa


_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer on a Python int (scalar seeds/column ids)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _keyed_hash(keys: np.ndarray, salt: int) -> np.ndarray:
    """Vectorized splitmix64 of (key ^ salt) — uint64 in, uint64 out."""
    z = (keys.astype(np.uint64) ^ np.uint64(salt)) + \
        np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def keyed_uniform(keys: np.ndarray, seed: int, col: int,
                  lo: float, hi: float) -> np.ndarray:
    """U(lo, hi) as a PURE FUNCTION of (seed, key, col) — float32, one
    value per key.  Used for fresh-row defaults so initialization is
    invariant to pull order, retries, and which worker pulls first."""
    h = _keyed_hash(np.asarray(keys, np.uint64), _mix64(seed * 2654435761
                                                        + col))
    u = (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    return (lo + (hi - lo) * u).astype(np.float32)


def default_rows_keyed(keys: np.ndarray, mf_dim: int, seed: int,
                       mf_initial_range: float, initial_range: float = 0.0,
                       expand_dim: int = 0, adam: bool = False,
                       beta1: float = 0.9, beta2: float = 0.999,
                       optimizer: str = "",
                       double_stats: bool = False) -> Dict[str, np.ndarray]:
    """:func:`default_rows`, but KEY-DETERMINISTIC: every random init is a
    pure function of (table seed, feasign, column) via a splitmix64 hash
    instead of a shared stateful Generator.  Two pulls of the same unseen
    key — across retries, chunk orders, or workers — produce identical
    rows, which is what makes a chaos-replayed day bit-identical to the
    fault-free run (tests/test_chaos_soak.py) and multi-trainer bases
    consistent without relying on who pulls first."""
    keys = np.asarray(keys, np.uint64)
    n = len(keys)
    soa = empty_soa(n, mf_dim, expand_dim, adam, optimizer, double_stats)
    if initial_range > 0:
        soa["embed_w"] = keyed_uniform(keys, seed, 0,
                                       -initial_range, initial_range)
    soa["mf"] = np.stack(
        [keyed_uniform(keys, seed, 1 + d, 0.0, mf_initial_range)
         for d in range(mf_dim)], axis=1) if mf_dim else \
        np.zeros((n, 0), np.float32)
    if expand_dim > 0:
        soa["mf_ex"] = np.stack(
            [keyed_uniform(keys, seed, 1 + mf_dim + d,
                           0.0, mf_initial_range)
             for d in range(expand_dim)], axis=1)
    if "embed_b1p" in soa:
        soa["embed_b1p"][:] = beta1
        soa["embed_b2p"][:] = beta2
        soa["mf_b1p"][:] = beta1
        soa["mf_b2p"][:] = beta2
    return soa


def select_rows(soa: Dict[str, np.ndarray], idx: np.ndarray
                ) -> Dict[str, np.ndarray]:
    return {k: v[idx] for k, v in soa.items()}


def concat_soa(parts) -> Dict[str, np.ndarray]:
    keys = parts[0].keys()
    return {k: np.concatenate([p[k] for p in parts]) for k in keys}
