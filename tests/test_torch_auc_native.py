"""The AUC calculator's native finalisation (native/auc_finalize.cc)
against its Python loops and the JAX package's calculator: the bucket
error and the fold to coarse buckets are bit-identical (``==`` on the
doubles), and ``compute()`` returns the same dict with the library
unavailable, counting which path ran."""

import numpy as np
import pytest

from paddlebox_tpu.metrics.auc import AucCalculator as JaxAucCalculator
from paddlebox_tpu_torch.metrics import auc as auc_mod
from paddlebox_tpu_torch.metrics.auc import AucCalculator
from paddlebox_tpu_torch.native import auc_finalize as native_auc
from paddlebox_tpu_torch.utils.monitor import stat_get

NATIVE = "metrics.auc.bucket_error_native"
PYTHON = "metrics.auc.bucket_error_python"


def _random_tables(seed: int, table_size: int, spread: float,
                   records: int = 1_000_000, weighted: bool = False):
    """Bucket tables of ``records`` predictions around a seeded mean
    with standard deviation ``spread``, labels drawn from them; with
    ``weighted``, non-integer record weights (masks of any value)."""
    rng = np.random.default_rng(seed)
    pred = np.clip(rng.normal(rng.uniform(0.05, 0.6), spread, records),
                   0.0, 1.0)
    label = (rng.random(records) < pred).astype(np.float64)
    w = rng.uniform(0.1, 3.0, records) if weighted else np.ones(records)
    bucket = np.clip((pred * table_size).astype(np.int64), 0,
                     table_size - 1)
    pos = np.bincount(bucket, w * label, table_size)
    neg = np.bincount(bucket, w * (1.0 - label), table_size)
    return pos, neg


def _edge_tables(name: str, table_size: int = 100_000):
    pos = np.zeros(table_size)
    neg = np.zeros(table_size)
    rng = np.random.default_rng(7)
    if name == "all_zero":
        pass
    elif name == "one_bucket":
        pos[31_234], neg[31_234] = 3.0, 7.0
    elif name == "all_positive":
        pos[:] = rng.integers(0, 5, table_size)
    elif name == "all_negative":
        neg[:] = rng.integers(0, 5, table_size)
    elif name == "first_only":
        pos[0], neg[0] = 12.0, 30.0
    elif name == "last_only":
        pos[-1], neg[-1] = 12.0, 30.0
    elif name == "first_and_last":
        pos[0], neg[0], pos[-1], neg[-1] = 5.0, 2.0, 9.0, 1.0
    elif name == "large_counts":
        # counts near 2^40 a bucket: the running sums carry ~2^50
        pos[:] = rng.integers(0, 1 << 40, table_size).astype(np.float64)
        neg[:] = rng.integers(0, 1 << 40, table_size).astype(np.float64)
        neg[rng.random(table_size) < 0.3] = 0.0
        pos[rng.random(table_size) < 0.3] = 0.0
    elif name == "large_and_tiny":
        # huge and fractional weights side by side: every addition rounds
        pos[:] = rng.random(table_size) * 10.0 ** rng.integers(
            -6, 13, table_size)
        neg[:] = rng.random(table_size) * 10.0 ** rng.integers(
            -6, 13, table_size)
    else:
        raise ValueError(name)
    return pos, neg


# 32 seeded random tables: 20 at the trainer's 100,000 buckets, 12 at the
# registry's 1,000,000; spreads 0.01-0.4; every fourth with non-integer
# weights
_RANDOM = [("random", seed, 100_000 if seed < 20 else 1_000_000,
            float(np.geomspace(0.01, 0.4, 8)[seed % 8]), seed % 4 == 3)
           for seed in range(32)]
_EDGE = [("edge", name, 100_000, 0.0, False)
         for name in ("all_zero", "one_bucket", "all_positive",
                      "all_negative", "first_only", "last_only",
                      "first_and_last", "large_counts", "large_and_tiny")]


def _tables(case):
    kind, key, table_size, spread, weighted = case
    if kind == "edge":
        return _edge_tables(key, table_size)
    return _random_tables(key, table_size, spread, weighted=weighted)


def _calcs(pos, neg):
    port = AucCalculator(table_size=len(pos))
    jax_calc = JaxAucCalculator(table_size=len(pos))
    for c in (port, jax_calc):
        c._pos, c._neg = pos.copy(), neg.copy()
    return port, jax_calc


@pytest.mark.parametrize("case", _RANDOM + _EDGE,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_native_bucket_error_is_the_python_loop_bit_for_bit(case):
    assert native_auc.available()
    pos, neg = _tables(case)
    port, jax_calc = _calcs(pos, neg)
    native = port._bucket_error()
    python = port._bucket_error_python()
    reference = jax_calc._bucket_error()
    assert type(native) is float and type(python) is float
    assert native == python == reference, (native, python, reference)
    # the tables are read, never written
    assert (port._pos == pos).all() and (port._neg == neg).all()
    if case[0] == "random" and not case[4]:
        assert native > 0.0


def _fold_at(pos, neg, bins):
    """``folded_buckets`` as two ``np.add.at``."""
    idx = (np.arange(len(pos)) * bins) // len(pos)
    out_pos = np.zeros((bins,), np.float64)
    out_neg = np.zeros((bins,), np.float64)
    np.add.at(out_pos, idx, pos)
    np.add.at(out_neg, idx, neg)
    return out_pos, out_neg


@pytest.mark.parametrize("path", ["native", "python"])
def test_compute_and_fold_are_equal_on_either_path(path, monkeypatch):
    """With the library made unavailable (its loader fails), compute()
    returns the same dict and folded_buckets the same arrays; the
    counters record which path ran."""
    cases = [_random_tables(101, 100_000, 0.15),
             _random_tables(102, 100_000, 0.05, weighted=True),
             _edge_tables("large_and_tiny"), _edge_tables("all_zero")]
    want = []
    for pos, neg in cases:
        calc, _ = _calcs(pos, neg)
        calc._scalars[:] = [1.5, 2.25, 3.0, 4.0, pos.sum() + neg.sum(), 0]
        want.append((calc, calc.compute(),
                     {b: calc.folded_buckets(b) for b in (50, 7, 1, 3)}))
    if path == "python":
        monkeypatch.setattr(native_auc, "_load", lambda: None)
        assert not native_auc.available()
    before = {k: stat_get(k) for k in (NATIVE, PYTHON)}
    for (pos, neg), (calc, out, folds) in zip(cases, want):
        again, _ = _calcs(pos, neg)
        again._scalars[:] = calc._scalars
        got = again.compute()
        assert got == out
        assert {k: type(v) for k, v in got.items()} == \
            {k: type(v) for k, v in out.items()}
        for bins, (fp, fn) in folds.items():
            gp, gn = again.folded_buckets(bins)
            ap, an = _fold_at(pos, neg, bins)
            assert gp.tobytes() == fp.tobytes() == ap.tobytes()
            assert gn.tobytes() == fn.tobytes() == an.tobytes()
    ran = {k: stat_get(k) - before[k] for k in (NATIVE, PYTHON)}
    assert ran == ({NATIVE: len(cases), PYTHON: 0} if path == "native"
                   else {NATIVE: 0, PYTHON: len(cases)})


@pytest.mark.parametrize("path", ["native", "python"])
def test_negative_weights_raise_as_the_python_loop(path, monkeypatch):
    """A negative impression sum under the square root raises the same
    ValueError on either path."""
    if path == "python":
        monkeypatch.setattr(native_auc, "_load", lambda: None)
    calc = AucCalculator(table_size=1000)
    calc._pos[5] = -5.0
    with pytest.raises(ValueError, match="math domain error"):
        calc._bucket_error()


def test_native_walk_reads_the_module_constants():
    """The walk reads the module's span and bound: a changed bound
    changes the native result as it does the loop's."""
    pos, neg = _random_tables(5, 100_000, 0.2)
    calc, _ = _calcs(pos, neg)
    base = calc._bucket_error()
    for name, value in (("K_RELATIVE_ERROR_BOUND", 0.2),
                        ("K_MAX_SPAN", 0.002)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(auc_mod, name, value)
            native = calc._bucket_error()
            assert native == calc._bucket_error_python()
            assert native != base
