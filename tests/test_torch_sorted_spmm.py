"""The port's sorted_spmm against the JAX package's.

Same row ids (numpy seed) through both planners and both gathers /
scatters.  The JAX side runs its Pallas kernels in interpret mode on the
CPU; the port runs its plain versions (the wrappers' CPU path).

Tolerances:
* plans: exact (integer outputs, and first_occ is 0/1);
* gather: bit-exact against ``gather_sorted_xla`` (both copy f32
  values); rtol 2e-5 against the Pallas kernel, which sums a hi/lo bf16
  split of the table (mxu_path.py:11-12);
* scatter: rtol/atol 1e-6 against ``scatter_add_sorted_xla`` on the
  table rows (the same f32 adds, possibly in another order); against
  the Pallas kernel's hi/lo split, rtol 2e-5 plus 2e-5 of each row's
  sum of absolute payload values (the split's rounding scales with
  the terms, and a cancelling sum can be far smaller than they are).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.ops import sorted_spmm as jsp
from paddlebox_tpu_torch.ops import sorted_spmm as tsp

CASES = {
    "uniform": lambda rng: (rng.integers(0, 200, 300), 200),
    "skew_one_row": lambda rng: (np.full(300, 7), 200),
    "two_extremes": lambda rng: (np.r_[np.zeros(150), np.full(150, 199)], 200),
    "sparse_gaps": lambda rng: (np.array([3, 500, 501, 1999]), 2000),
    "tiny": lambda rng: (np.array([5]), 64),
    "zipf": lambda rng: (np.minimum(rng.zipf(1.2, 400), 999), 1000),
    "padding_heavy": lambda rng: (np.where(rng.random(300) < 0.4, 0,
                                           rng.integers(1, 200, 300)), 200),
}


def _rows(case, seed=0):
    rows, n_rows = CASES[case](np.random.default_rng(seed))
    return np.asarray(rows, np.int32), n_rows


def _dims(rows, n_rows, trim):
    dims_j = jsp.spmm_dims(len(rows), n_rows, chunk=8, tile=32)
    dims_t = tsp.spmm_dims(len(rows), n_rows, chunk=8, tile=32)
    eff_j = eff_t = None
    if trim:
        n_real = int((rows != 0).sum())
        eff_j = jsp.trimmed_dims(dims_j, n_real)
        eff_t = tsp.trimmed_dims(dims_t, n_real)
    return dims_j, dims_t, eff_j, eff_t


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_plan_matches_jax(case, trim):
    rows, n_rows = _rows(case)
    dims_j, dims_t, eff_j, eff_t = _dims(rows, n_rows, trim)
    assert dataclass_fields(dims_j) == dataclass_fields(dims_t)
    if trim:
        assert dataclass_fields(eff_j) == dataclass_fields(eff_t)
    pj = jsp.build_plan(jnp.asarray(rows), dims_j, eff_j)
    pt = tsp.build_plan(torch.as_tensor(rows), dims_t, eff_t)
    assert len(pj) == len(pt) == 8
    for a, b in zip(pj, pt):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def dataclass_fields(d):
    return (d.p, d.p_pad, d.n_chunks, d.n_kernel, d.n_tiles, d.n_work,
            d.chunk, d.tile)


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_plain_matches_jax(case, trim):
    rows, n_rows = _rows(case)
    dims_j, dims_t, eff_j, eff_t = _dims(rows, n_rows, trim)
    rng = np.random.default_rng(1)
    w = 12
    table = np.zeros((w, dims_j.n_kernel), np.float32)
    table[:, 1:n_rows] = rng.normal(0, 1, (w, n_rows - 1))
    pj = jsp.build_plan(jnp.asarray(rows), dims_j, eff_j)
    pt = tsp.build_plan(torch.as_tensor(rows), dims_t, eff_t)
    got = tsp.gather_sorted(torch.as_tensor(table), pt[0],
                            eff_t or dims_t).numpy()
    xla = np.asarray(jsp.gather_sorted_xla(jnp.asarray(table), *pj[:5],
                                           eff_j or dims_j))
    np.testing.assert_array_equal(got, xla)
    pallas = np.asarray(jsp.gather_sorted(jnp.asarray(table), pj[0], pj[3],
                                          pj[4], pj[5], eff_j or dims_j,
                                          interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_plain_matches_jax(case, trim):
    rows, n_rows = _rows(case)
    dims_j, dims_t, eff_j, eff_t = _dims(rows, n_rows, trim)
    kd_j = eff_j or dims_j
    rng = np.random.default_rng(2)
    w = 12
    payload = rng.normal(0, 1, (w, kd_j.p_pad)).astype(np.float32)
    pj = jsp.build_plan(jnp.asarray(rows), dims_j, eff_j)
    pt = tsp.build_plan(torch.as_tensor(rows), dims_t, eff_t)
    got = tsp.scatter_add_sorted(torch.as_tensor(payload), pt[0], pt[7],
                                 eff_t or dims_t).numpy()
    assert got.shape == (w, dims_j.n_kernel)
    xla = np.asarray(jsp.scatter_add_sorted_xla(
        jnp.asarray(payload), pj[0], pj[3], pj[4], pj[6], kd_j))
    n = n_rows
    np.testing.assert_allclose(got[:, :n], xla[:, :n], rtol=1e-6, atol=1e-6)
    pallas = np.asarray(jsp.scatter_add_sorted(
        jnp.asarray(payload), pj[0], pj[3], pj[4], pj[6], kd_j,
        interpret=True))
    # the hi/lo split rounds each term at ~2^-16 of its own size, so the
    # error scales with the sum of |terms|, not with their (cancelling)
    # sum: bound it by 2e-5 of the per-row absolute sum
    abs_sum = np.asarray(jsp.scatter_add_sorted_xla(
        jnp.asarray(np.abs(payload)), pj[0], pj[3], pj[4], pj[6], kd_j))
    err = np.abs(got[:, :n] - pallas[:, :n])
    assert np.all(err <= 2e-5 * np.abs(pallas[:, :n])
                  + 2e-5 * abs_sum[:, :n] + 1e-7)
    # untouched rows are exactly zero (the optimizer's touched mask)
    untouched = np.setdiff1d(np.arange(n), rows)
    assert np.all(got[:, untouched] == 0.0)


def test_wrappers_count_no_cpu_launches():
    """The CPU path is the plain version: it launches nothing."""
    rows, n_rows = _rows("uniform")
    _, dims, _, _ = _dims(rows, n_rows, False)
    plan = tsp.build_plan(torch.as_tensor(rows), dims)
    g0, s0 = tsp.gather_sorted.launches, tsp.scatter_add_sorted.launches
    tsp.gather_sorted(torch.zeros((3, dims.n_kernel)), plan[0], dims)
    tsp.scatter_add_sorted(torch.zeros((3, dims.p_pad)), plan[0], plan[7],
                           dims)
    assert (tsp.gather_sorted.launches, tsp.scatter_add_sorted.launches) \
        == (g0, s0)


@pytest.mark.parametrize("n_ids,n_seg,n_rows", [(20, 25, 300), (30, 40, 200)])
def test_segment_sum_sums_each_segment_in_order(n_ids, n_seg, n_rows):
    """The deterministic merge of the fast push and of both ragged sums
    equals a sequential per-segment sum; segments no id names stay
    exactly 0."""
    rng = np.random.default_rng(n_ids)
    seg = rng.integers(0, n_ids, n_rows).astype(np.int32)
    vals = rng.normal(0, 1, (n_rows, 4)).astype(np.float32)
    got = tsp.segment_sum(torch.as_tensor(vals), torch.as_tensor(seg), n_seg)
    want = np.zeros((n_seg, 4), np.float32)
    for s_, v in zip(seg, vals):
        want[s_] += v
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[n_ids:].any()
