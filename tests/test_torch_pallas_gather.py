"""The port's gather_pool against the JAX package's Pallas kernel.

One table, one id plane and one length vector, made from a numpy seed,
go through ``paddlebox_tpu.ops.pallas_gather.gather_pool`` (Pallas, in
interpret mode on the CPU) and the port's ``gather_pool`` on the CPU
(its plain version).  Lengths include 0 and L, and ids past a row's
length are nonzero rows that must not be pooled.

Tolerance rtol 1e-5 / atol 1e-6, as the JAX package's own test: the
sums have at most L terms, added in another order by the interpreter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.ops import pallas_gather as jpg
from paddlebox_tpu_torch.ops import pallas_gather as tpg

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(L, seed=0, N=512, D=11, R=256):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (N, D)).astype(np.float32)
    table[0] = 0.0
    idx = rng.integers(1, N, (R, L)).astype(np.int32)   # nonzero everywhere
    lengths = rng.integers(0, L + 1, (R,)).astype(np.int32)
    lengths[:2] = [0, L]
    return table, idx, lengths


@pytest.mark.parametrize("L", [1, 3])
def test_gather_pool_matches_pallas(L):
    table, idx, lengths = _inputs(L)
    want = jpg.gather_pool(jnp.asarray(table), jnp.asarray(idx),
                           jnp.asarray(lengths), interpret=True)
    n0 = tpg.gather_pool.launches
    got = tpg.gather_pool(torch.as_tensor(table), torch.as_tensor(idx),
                          torch.as_tensor(lengths))
    assert tpg.gather_pool.launches == n0   # CPU tensors: no kernel launch
    assert tuple(got.shape) == (idx.shape[0], table.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()                  # length 0 pools nothing


def test_gather_pool_plain_ignores_ids_past_the_length():
    """Ids at or past lengths[r] are never looked up, so they may hold
    anything — even ids outside the table."""
    table, idx, lengths = _inputs(3, seed=1)
    live = np.arange(3)[None, :] < lengths[:, None]
    got = tpg.gather_pool_plain(
        torch.as_tensor(table),
        torch.as_tensor(np.where(live, idx, 10 ** 6).astype(np.int32)),
        torch.as_tensor(lengths))
    want = np.stack([table[idx[r, :lengths[r]]].sum(0)
                     for r in range(len(lengths))])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("ld,col", [(12, 0), (16, 0), (12, 1)])
def test_gather_pool_on_a_column_view(ld, col):
    """A table seen as [:, col:col + D] of a wider buffer (the fast
    path's padded rows) pools the same values as the contiguous table,
    bit for bit, and as the JAX package's Pallas kernel."""
    table, idx, lengths = _inputs(3, seed=2)
    n, d = table.shape
    buf = torch.full((n, ld), float("nan"))
    view = buf[:, col:col + d]
    view.copy_(torch.as_tensor(table))
    assert view.stride() == (ld, 1) and not view.is_contiguous()
    i, ln = torch.as_tensor(idx), torch.as_tensor(lengths)
    dense = tpg.gather_pool(torch.as_tensor(table), i, ln)
    for fn in (tpg.gather_pool, tpg.gather_pool_plain):
        assert torch.equal(fn(view, i, ln), dense)
    want = jpg.gather_pool(jnp.asarray(table), jnp.asarray(idx),
                           jnp.asarray(lengths), interpret=True)
    np.testing.assert_allclose(tpg.gather_pool(view, i, ln).numpy(),
                               np.asarray(want), **TOL)
