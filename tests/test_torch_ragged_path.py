"""The port's ragged pull/push against the JAX package's.

One working set (host rows from a numpy seed) and one batch, lowered to
its CSR plan by ``build_csr_plans`` (the port's and the JAX package's
give the same arrays), go through ``ragged_path.pull_pool_cvm`` and
``ragged_path.push_and_update`` of both packages; the port runs on the
CPU.  The batch holds empty and full lengths and a row shared by slots.

Tolerance rtol 1e-5 / atol 1e-5: the same f32 arithmetic, with the
segment sums in another order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.data import pass_feed as jpf
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu.ps import ragged_path as jrag
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.data import pass_feed as tpf
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import ragged_path as trag

N, D, S, L, B = 300, 4, 5, 3, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _host(seed=0):
    rng = np.random.default_rng(seed)
    host = jfv.default_rows(N - 1, D, rng, 1e-2)
    host["show"][:] = rng.integers(1, 50, N - 1).astype(np.float32)
    host["click"][:] = rng.integers(0, 5, N - 1).astype(np.float32)
    host["mf_size"][:] = np.where(rng.random(N - 1) < 0.7, D, 0)
    host["embed_g2sum"][:] = rng.random(N - 1).astype(np.float32)
    host["mf_g2sum"][:] = rng.random(N - 1).astype(np.float32)
    return host


def _plan(seed=1):
    """(jax plan, port plan) of one [S, B, L] batch plane; lengths 0 and
    L in every slot; padding is row 0, as pack_pass leaves it."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, N, (S, B, L)).astype(np.int32)
    idx[:, :4, 0] = 7
    lengths = rng.integers(0, L + 1, (S, B))
    lengths[:, 0], lengths[:, 1] = 0, L
    idx[np.arange(L)[None, None, :] >= lengths[..., None]] = 0
    slot_ids = 100 + np.arange(S)
    want = jpf.build_csr_plans(idx, slot_ids, 1, B)
    got = tpf.build_csr_plans(idx, slot_ids, 1, B)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return (tuple(jnp.asarray(want[k][0]) for k in
                  ("seg", "inv", "occ_w", "u_rows", "u_slot")),
            tuple(torch.as_tensor(got[k][0]) for k in
                  ("seg", "inv", "occ_w", "u_rows", "u_slot")))


def _both_ws():
    host = _host()
    return (jemb.build_working_set(host, D, pad_to=N),
            temb.build_working_set(host, torch.device("cpu"), pad_to=N))


@pytest.mark.parametrize("use_cvm", [True, False])
def test_pull_pool_cvm_matches_jax(use_cvm):
    jws, tws = _both_ws()
    jplan, tplan = _plan()
    want = jrag.pull_pool_cvm(jws, jplan, (S, L, B), use_cvm)
    got = trag.pull_pool_cvm(tws, tplan, (S, L, B), use_cvm)
    assert tuple(got.shape) == (B, S, 3 + D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("thresh", [0.0, 5.0, 1e9])
def test_push_and_update_matches_jax(thresh):
    jws, tws = _both_ws()
    jplan, tplan = _plan()
    rng = np.random.default_rng(2)
    d_pooled = rng.normal(0, 1, (B, S, 3 + D)).astype(np.float32)
    ins_cvm = np.stack([np.ones(B), rng.integers(0, 2, B)], 1).astype(
        np.float32)
    want = jrag.push_and_update(jws, jplan, jnp.asarray(d_pooled),
                                jnp.asarray(ins_cvm), (S, L, B),
                                JSgd(mf_create_thresholds=thresh))
    show_before = tws["show"]
    got = trag.push_and_update(tws, tplan, torch.as_tensor(d_pooled),
                               torch.as_tensor(ins_cvm), (S, L, B),
                               TSgd(mf_create_thresholds=thresh))
    assert got is tws and got["show"] is show_before      # in place
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype, k
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)

