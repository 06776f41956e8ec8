"""The hand-written CUDA kernels against their plain versions, on a card.

JAX-free on purpose, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

(``--noconftest`` skips the repository's conftest, which pins JAX to the
CPU.)  Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from torch_port_fixtures import cuda_device  # noqa: F401

from paddlebox_tpu_torch.ops import pallas_gather as tpg
from paddlebox_tpu_torch.ops import sorted_spmm as tsp

CASES = {
    "uniform": lambda rng: (rng.integers(0, 200, 300), 200),
    "skew_one_row": lambda rng: (np.full(300, 7), 200),
    "sparse_gaps": lambda rng: (np.array([3, 500, 501, 1999]), 2000),
    "tiny": lambda rng: (np.array([5]), 64),
    "zipf": lambda rng: (np.minimum(rng.zipf(1.2, 4000), 999), 1000),
    "padding_heavy": lambda rng: (np.where(rng.random(3000) < 0.4, 0,
                                           rng.integers(1, 200, 3000)), 200),
    # long runs, and runs that end on multiples of 256 positions
    "long_runs": lambda rng: (rng.permutation(
        np.repeat([0, 5, 9, 11], [1000, 512, 700, 3])), 64),
    "piece_aligned": lambda rng: (np.repeat([1, 2, 3], [256, 768, 256]),
                                  64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_on_card(cuda_device, case, trim):
    """The gather bit-exact; the scatter at rtol 1e-5 plus 1e-5 of each
    row's sum of |terms| (the plain index_add_ sums with atomics in
    another order); launch counters advance once per call."""
    rows, n_rows = CASES[case](np.random.default_rng(0))
    rows = np.asarray(rows, np.int32)
    dims = tsp.spmm_dims(len(rows), n_rows, chunk=8, tile=32)
    eff = tsp.trimmed_dims(dims, int((rows != 0).sum())) if trim else None
    kd = eff or dims
    plan = tsp.build_plan(torch.as_tensor(rows, device=cuda_device), dims,
                          eff)
    g = torch.Generator().manual_seed(3)
    table = torch.randn((12, dims.n_kernel), generator=g)
    table[:, 0] = 0
    table[:, n_rows:] = 0
    table = table.to(cuda_device)
    n0 = tsp.gather_sorted.launches
    got = tsp.gather_sorted(table, plan[0], kd)
    assert tsp.gather_sorted.launches == n0 + 1
    want = tsp.gather_sorted_plain(table, plan[0], kd)
    assert torch.equal(got, want)
    pay = torch.randn((12, kd.p_pad), generator=g).to(cuda_device)
    n0 = tsp.scatter_add_sorted.launches
    got = tsp.scatter_add_sorted(pay, plan[0], plan[7], kd)
    assert tsp.scatter_add_sorted.launches == n0 + 1
    _assert_scatter_matches_plain(got, pay, plan, kd)


def _assert_scatter_matches_plain(got, pay, plan, kd):
    want = tsp.scatter_add_sorted_plain(pay, plan[0], plan[7], kd)
    abs_sum = tsp.scatter_add_sorted_plain(pay.abs(), plan[0], plan[7], kd)
    again = tsp.scatter_add_sorted(pay, plan[0], plan[7], kd)
    torch.cuda.synchronize()
    # rounding of a sum in another order scales with the sum of |terms|
    # (row 0 sums every padding occurrence): rtol 1e-5 plus 1e-5 of it
    assert bool(((got - want).abs()
                 <= 1e-5 * want.abs() + 1e-5 * abs_sum + 1e-6).all())
    assert torch.equal(got, again)       # a fixed order of adds


T = tsp.SCATTER_TILE
# sorted domains longer than one scatter tile (SCATTER_TILE positions)
TILE_CASES = {
    "run_spans_many_tiles": lambda rng: (
        np.repeat([1, 2, 3], [5, 5 * T + 37, 100]), 64),
    "runs_end_on_tile_edges": lambda rng: (
        np.repeat([1, 2, 3, 4, 5], [T, T + 1, T - 1, 2 * T, 50]), 64),
    "one_row_fills_domain": lambda rng: (np.full(3 * T, 5), 64),
    "whole_tiles_inside_run": lambda rng: (
        np.repeat([1, 2, 3], [T // 2, 3 * T, T // 2 + 7]), 64),
    "padding_heavy_big": lambda rng: (np.where(
        rng.random(4 * T + 300) < 0.4, 0,
        rng.integers(1, 200, 4 * T + 300)), 200),
    # a hot row, then tiles whose few runs are spread over many rows
    "sparse_tail": lambda rng: (np.r_[np.full(T + 500, 3),
                                      rng.integers(1, 200_000, 2 * T)],
                                200_000),
}


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (the kernel then stages with 4-byte copies)."""
    buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["w12", "w11", "w20", "misaligned"])
@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_scatter_across_tiles_on_card(cuda_device, case, trim, layout):
    """Runs that cross, end on, or fill scatter tiles, at payload widths
    of one and two column rounds, on the 16-byte and the 4-byte staging
    route: within tolerance of the plain version, bit-identical on a
    second call."""
    rows, n_rows = TILE_CASES[case](np.random.default_rng(0))
    rows = np.asarray(rows, np.int32)
    dims = tsp.spmm_dims(len(rows), n_rows, chunk=8, tile=32)
    eff = tsp.trimmed_dims(dims, int((rows != 0).sum())) if trim else None
    kd = eff or dims
    plan = tsp.build_plan(torch.as_tensor(rows, device=cuda_device), dims,
                          eff)
    w = {"w12": 12, "w11": 11, "w20": 20, "misaligned": 12}[layout]
    g = torch.Generator().manual_seed(4)
    pay = torch.randn((w, kd.p_pad), generator=g).to(cuda_device)
    if layout == "misaligned":
        pay = _misaligned(pay)
        plan = (_misaligned(plan[0]),) + tuple(plan[1:])
    n0 = tsp.scatter_add_sorted.launches
    got = tsp.scatter_add_sorted(pay, plan[0], plan[7], kd)
    assert tsp.scatter_add_sorted.launches == n0 + 1
    _assert_scatter_matches_plain(got, pay, plan, kd)


@pytest.mark.cuda
def test_wrappers_reject_what_kernels_do_not_take(cuda_device):
    rows = torch.arange(16, dtype=torch.int32, device=cuda_device)
    dims = tsp.spmm_dims(16, 64, chunk=8, tile=32)
    plan = tsp.build_plan(rows, dims)
    with pytest.raises(TypeError):
        tsp.gather_sorted(torch.zeros((3, dims.n_kernel), dtype=torch.float64,
                                      device=cuda_device), plan[0], dims)
    with pytest.raises(ValueError):
        tsp.gather_sorted(torch.zeros((3, dims.n_kernel), device=cuda_device),
                          plan[0].cpu(), dims)


# (R, L, D, N, ids, lengths) builders for gather_pool
POOL_CASES = {
    "uniform": lambda rng: (256, 3, 11, 500, "uniform", "random"),
    "one_hot_row": lambda rng: (512, 3, 11, 500, "one_row", "random"),
    "all_lengths_zero": lambda rng: (128, 3, 11, 500, "uniform", "zero"),
    "all_lengths_full": lambda rng: (128, 3, 11, 500, "uniform", "full"),
    # R * D not a multiple of the 256-thread block
    "ragged_edge": lambda rng: (37, 3, 11, 64, "uniform", "random"),
    "single_slot": lambda rng: (300, 1, 8, 64, "uniform", "random"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_gather_pool_matches_plain_on_card(cuda_device, case):
    """The kernel sums the same terms in the same order (l = 0, 1, ...)
    as the plain version, so the two agree bit for bit; ids past each
    row's length point outside the table and must never be read."""
    rng = np.random.default_rng(0)
    r, l_cap, d, n, ids, lens = POOL_CASES[case](rng)
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    table[0] = 0.0
    idx = (np.full((r, l_cap), 7) if ids == "one_row"
           else rng.integers(0, n, (r, l_cap))).astype(np.int32)
    lengths = {"random": rng.integers(0, l_cap + 1, r),
               "zero": np.zeros(r), "full": np.full(r, l_cap)}[lens]
    lengths = lengths.astype(np.int32)
    live = np.arange(l_cap)[None, :] < lengths[:, None]
    idx = np.where(live, idx, 10 ** 9).astype(np.int32)  # never read
    t = torch.as_tensor(table, device=cuda_device)
    i = torch.as_tensor(idx, device=cuda_device)
    ln = torch.as_tensor(lengths, device=cuda_device)
    n0 = tpg.gather_pool.launches
    got = tpg.gather_pool(t, i, ln)
    torch.cuda.synchronize()
    assert tpg.gather_pool.launches == n0 + 1
    want = tpg.gather_pool_plain(torch.as_tensor(table),
                                 torch.as_tensor(np.where(live, idx, 0)),
                                 torch.as_tensor(lengths))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def _table_view(table: np.ndarray, layout: str, dev) -> torch.Tensor:
    """table [N, D] as a view of a wider buffer: row stride 11 (packed),
    12 or 16 (16-byte rows), or starting at column 1 of a 12-wide buffer
    (16-byte row stride, base 4 bytes past a 16-byte boundary)."""
    n, d = table.shape
    ld, col = {"packed": (d, 0), "stride12": (12, 0), "stride16": (16, 0),
               "col1": (12, 1), "wide": ((d + 3) // 4 * 4, 0)}[layout]
    buf = torch.full((n, ld), float("nan"), device=dev)
    view = buf[:, col:col + d]
    view.copy_(torch.as_tensor(table))
    return view


# (layout, L, D): ids of L > 4 need more than one group chunk when rows
# are 16-byte words; D = 130 needs more than 32 lanes of floats
LAYOUT_CASES = [("packed", 3, 11), ("stride12", 3, 11), ("stride16", 3, 11),
                ("col1", 3, 11), ("stride12", 20, 11), ("packed", 20, 11),
                ("wide", 5, 67), ("packed", 5, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,l_cap,d", LAYOUT_CASES)
def test_gather_pool_table_layouts_on_card(cuda_device, layout, l_cap, d):
    """Row strides 11, 12 and 16 and an unaligned base: bit-equal to the
    plain version (same terms, same order), bit-identical on a second
    call; ids past each length are 10**9 and must never be read (the
    NaN pad columns must never reach the output)."""
    rng = np.random.default_rng(1)
    r, n = 300, 500
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    table[0] = 0.0
    lengths = rng.integers(0, l_cap + 1, r).astype(np.int32)
    live = np.arange(l_cap)[None, :] < lengths[:, None]
    idx = rng.integers(0, n, (r, l_cap))
    t = _table_view(table, layout, cuda_device)
    i = torch.as_tensor(np.where(live, idx, 10 ** 9).astype(np.int32),
                        device=cuda_device)
    ln = torch.as_tensor(lengths, device=cuda_device)
    got = tpg.gather_pool(t, i, ln)
    again = tpg.gather_pool(t, i, ln)
    want = tpg.gather_pool_plain(
        torch.as_tensor(table, device=cuda_device),
        torch.as_tensor(np.where(live, idx, 0).astype(np.int32),
                        device=cuda_device), ln)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_gather_pool_rejects_what_the_kernel_does_not_take(cuda_device):
    t = torch.zeros((16, 4), device=cuda_device)
    i = torch.zeros((8, 3), dtype=torch.int32, device=cuda_device)
    ln = torch.zeros((8,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tpg.gather_pool(t.double(), i, ln)
    with pytest.raises(TypeError):
        tpg.gather_pool(t, i.long(), ln)
    with pytest.raises(ValueError):
        tpg.gather_pool(t, i.cpu(), ln)
    with pytest.raises(ValueError):
        tpg.gather_pool(t, i.t(), ln[:3])
    with pytest.raises(ValueError):
        tpg.gather_pool(t, torch.zeros((3, 8), dtype=torch.int32,
                                       device=cuda_device).t(), ln)
    with pytest.raises(ValueError):          # column stride 2
        tpg.gather_pool(torch.zeros((16, 8), device=cuda_device)[:, ::2],
                        i, ln)
