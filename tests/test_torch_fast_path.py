"""The port's fast pull/push against the JAX package's.

One working set (host rows from a numpy seed) and one batch go through
``fast_path.pull_pool_cvm`` and ``fast_path.push_and_update`` (adagrad)
of both packages; the port runs on the CPU (``gather_pool`` and the
sorted scatter take their plain versions there).  The push is checked
at mf-creation thresholds 0, 5 and 1e9, with per-slot dynamic mf dims,
and with the ctr_double pass-delta counters.

Tolerance rtol 1e-5 / atol 1e-5: the same f32 arithmetic, with the
pooling and the per-row merges summed in another order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu.ps import fast_path as jfast
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import fast_path as tfast

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


def _batch(seed=1):
    """idx [S, L, B] with nonzero ids past each length (the mask must
    hide them), lengths including 0 and L; a hot row shared by slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, N, (S, L, B)).astype(np.int32)
    idx[:, 0, :4] = 7
    lengths = rng.integers(0, L + 1, (S, B)).astype(np.int32)
    lengths[:, 0], lengths[:, 1] = 0, L
    d_pooled = rng.normal(0, 1, (B, S, 3 + D)).astype(np.float32)
    ins_cvm = np.stack([np.ones(B), rng.integers(0, 2, B)], 1).astype(
        np.float32)
    slot_ids = (100 + np.arange(S)).astype(np.int32)
    return idx, lengths, d_pooled, ins_cvm, slot_ids


def _both_ws(ctr_double=False):
    host = _host()
    jws = jemb.build_working_set(host, D, pad_to=N)
    tws = temb.build_working_set(host, torch.device("cpu"), pad_to=N)
    if ctr_double:
        jws["show_acc"] = jnp.zeros_like(jws["show"])
        jws["click_acc"] = jnp.zeros_like(jws["click"])
        tws["show_acc"] = torch.zeros_like(tws["show"])
        tws["click_acc"] = torch.zeros_like(tws["click"])
    return jws, tws


@pytest.mark.parametrize("use_cvm", [True, False])
def test_pull_pool_cvm_matches_jax(use_cvm):
    jws, tws = _both_ws()
    idx, lengths = _batch()[:2]
    want = jfast.pull_pool_cvm(jws, jnp.asarray(idx), jnp.asarray(lengths),
                               use_cvm)
    got = tfast.pull_pool_cvm(tws, torch.as_tensor(idx),
                              torch.as_tensor(lengths), use_cvm)
    assert tuple(got.shape) == (B, S, 3 + D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pull_table_rows_are_padded_to_16_bytes():
    """The pull table is the [N, 3 + D] view of a buffer whose rows are
    padded to a multiple of 4 floats; the view holds the JAX fast path's
    pulled values (show, click, embed_w, mf masked by mf_size > 0)."""
    jws, tws = _both_ws()
    table = tfast._pull_table(tws)
    assert tuple(table.shape) == (N, 3 + D)
    assert table.stride() == (8, 1)            # 3 + 4 = 7 → 8 floats
    created = (jws["mf_size"] > 0).astype(jnp.float32)[:, None]
    want = jnp.concatenate(
        [jws["show"][:, None], jws["click"][:, None], jws["embed_w"][:, None],
         jemb.mf_values(jws, jws["mf"]) * created], axis=1)
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))


@pytest.mark.parametrize("thresh,dym,ctr_double", [
    (0.0, False, False), (5.0, False, False), (1e9, False, False),
    (0.0, True, False), (5.0, False, True)])
def test_push_and_update_matches_jax(thresh, dym, ctr_double):
    """Every working-set field after one merged push, updated in place;
    dym: slot 101 trains 2 of the 4 mf columns (≙ CtrDymfAccessor)."""
    jws, tws = _both_ws(ctr_double)
    idx, lengths, d_pooled, ins_cvm, slot_ids = _batch()
    dims = ((101, 2),) if dym else ()
    want = jfast.push_and_update(
        jws, jnp.asarray(idx), jnp.asarray(lengths), jnp.asarray(d_pooled),
        jnp.asarray(ins_cvm), jnp.asarray(slot_ids),
        JSgd(mf_create_thresholds=thresh, slot_mf_dims=dims))
    show_before = tws["show"]
    got = tfast.push_and_update(
        tws, torch.as_tensor(idx), torch.as_tensor(lengths),
        torch.as_tensor(d_pooled), torch.as_tensor(ins_cvm),
        torch.as_tensor(slot_ids),
        TSgd(mf_create_thresholds=thresh, slot_mf_dims=dims))
    assert got is tws and got["show"] is show_before      # in place
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype, k
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    assert not got["mf"][0].any()                         # reserved row

