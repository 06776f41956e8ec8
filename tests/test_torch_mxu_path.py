"""The port's mxu pull/push against the JAX package's.

One working set (host rows from a numpy seed) and one batch (planned
untrimmed, and trimmed as the packed feed plans it) go through
``mxu_path.pull_pool_cvm`` and ``mxu_path.push_and_update`` (adagrad) of
both packages.  The JAX side runs its Pallas kernels in interpret mode;
the port runs on the CPU (the kernels' plain versions).

Tolerance rtol 1e-5 / atol 1e-5: the Pallas kernels sum a hi/lo bf16
split of their f32 inputs (~1e-5 relative, mxu_path.py:11-12), while the
port's plain versions copy and add in f32; everything else is the same
elementwise f32 math.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu.ops import sorted_spmm as jsp
from paddlebox_tpu.ps import mxu_path as jmxu
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ops import sorted_spmm as tsp
from paddlebox_tpu_torch.ps import mxu_path as tmxu

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


def _batch(seed=1, B=B):
    rng = np.random.default_rng(seed)
    per = (N - 1) // S
    idx = np.zeros((S, L, B), np.int32)
    for s in range(S):      # slot-disjoint key ranges, like real feasigns
        idx[s] = 1 + s * per + rng.integers(0, per, (L, B))
    idx[rng.random((S, L, B)) < 0.1] = 0
    lengths = rng.integers(0, L + 1, (S, B)).astype(np.int32)
    for s in range(S):
        for b in range(B):
            idx[s, lengths[s, b]:, b] = 0
    d_pooled = rng.normal(0, 1, (B, S, 3 + D)).astype(np.float32)
    ins_cvm = np.stack([np.ones(B), rng.integers(0, 2, B)], 1).astype(
        np.float32)
    slot_ids = (100 + np.arange(S)).astype(np.int32)
    return idx, d_pooled, ins_cvm, slot_ids


def _both_ws():
    host = _host()
    jws = jemb.build_working_set(host, D, pad_to=N)
    tws = temb.build_working_set(host, torch.device("cpu"), pad_to=N)
    return jws, tws


@pytest.mark.parametrize("use_cvm", [True, False])
def test_pull_pool_cvm_matches_jax(use_cvm):
    jws, tws = _both_ws()
    idx = _batch()[0]
    jd, td = jmxu.make_dims(S * L * B, N), tmxu.make_dims(S * L * B, N)
    want = jmxu.pull_pool_cvm(jws, jmxu.build_plan(jnp.asarray(idx), jd),
                              jd, (S, L, B), use_cvm, interpret=True)
    got = tmxu.pull_pool_cvm(tws, tmxu.build_plan(torch.as_tensor(idx), td),
                             td, (S, L, B), use_cvm)
    assert tuple(got.shape) == (B, S, 3 + D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("thresh", [0.0, 5.0, 1e9])
def test_push_and_update_matches_jax(thresh):
    """Adagrad push over the merged scatter: every working-set field,
    including mf creation at several thresholds, and the in-place update
    of the port's working set."""
    jws, tws = _both_ws()
    idx, d_pooled, ins_cvm, slot_ids = _batch()
    jd, td = jmxu.make_dims(S * L * B, N), tmxu.make_dims(S * L * B, N)
    want = jmxu.push_and_update(
        jws, jmxu.build_plan(jnp.asarray(idx), jd), jd, jnp.asarray(idx),
        jnp.asarray(d_pooled), jnp.asarray(ins_cvm), jnp.asarray(slot_ids),
        JSgd(mf_create_thresholds=thresh), interpret=True)
    show_before = tws["show"]
    got = tmxu.push_and_update(
        tws, tmxu.build_plan(torch.as_tensor(idx), td), td,
        torch.as_tensor(idx), torch.as_tensor(d_pooled),
        torch.as_tensor(ins_cvm), torch.as_tensor(slot_ids),
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


@pytest.mark.parametrize("thresh", [0.0, 1e9])
def test_trimmed_plan_matches_jax(thresh):
    """Plans trimmed to the real occurrences (the packed feed's form,
    8-tuple): the pull clamps and masks the dropped row-0 positions, the
    push scatters the kept suffix of the bijection."""
    b = 128                      # wide enough for the trim to bite
    jws, tws = _both_ws()
    idx, d_pooled, ins_cvm, slot_ids = _batch(2, b)
    jd, td = jmxu.make_dims(S * L * b, N), tmxu.make_dims(S * L * b, N)
    real = int((idx != 0).sum())
    jeff = jsp.trimmed_dims(jd, real)
    teff = tsp.trimmed_dims(td, real)
    assert teff.p_pad == jeff.p_pad < td.p_pad
    jplan = jmxu.build_plan(jnp.asarray(idx), jd, jeff)
    tplan = tmxu.build_plan(torch.as_tensor(idx), td, teff)
    assert tmxu.plan_eff_dims(tplan, td) == teff
    want = jmxu.pull_pool_cvm(jws, jplan, jd, (S, L, b), interpret=True)
    got = tmxu.pull_pool_cvm(tws, tplan, td, (S, L, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jmxu.push_and_update(
        jws, jplan, jd, jnp.asarray(idx), jnp.asarray(d_pooled),
        jnp.asarray(ins_cvm), jnp.asarray(slot_ids),
        JSgd(mf_create_thresholds=thresh), interpret=True)
    got = tmxu.push_and_update(
        tws, tplan, td, torch.as_tensor(idx), torch.as_tensor(d_pooled),
        torch.as_tensor(ins_cvm), torch.as_tensor(slot_ids),
        TSgd(mf_create_thresholds=thresh))
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
