"""The port's one crossing against both of the JAX package's.

The mxu step moves values between the canonical occurrence order and
the plan's sorted order by gathering ("take").  The JAX package also
lowers that crossing as a key-value sort ("sort"), bit-equal to its take
by construction; the port keeps one lowering and is held to each:

* the mxu pull and push, on untrimmed and trimmed plans, against the
  JAX package's ``pull_pool_cvm`` / ``push_and_update`` under each of its
  crossings (its Pallas kernels in interpret mode), within
  tests/test_torch_mxu_path.py's rtol 1e-5 / atol 1e-5: the Pallas
  kernels sum a hi/lo bf16 split of their f32 inputs;
* whole mxu passes of the trainer on both entry points (the packed one
  plans trimmed, with the static payload planes) against the JAX
  trainer's with its FLAGS_mxu_crossing pinned to "sort", within
  tests/test_torch_trainer.py::test_deepfm_pass_matches_jax's rtol 1e-4 /
  atol 1e-6;
* the port has no crossing flags: a script that still reads or sets one
  gets a ``KeyError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu import flags as jflags
from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ops import sorted_spmm as jsp
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu.ps import mxu_path as jmxu
from paddlebox_tpu_torch import flags as tflags
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ops import sorted_spmm as tsp
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import mxu_path as tmxu

import torch_parity_helpers as h

N, D, S, L, B = 300, 4, 5, 3, 128
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
PASS_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def jax_crossing():
    """Pin the JAX package's FLAGS_mxu_crossing for one test, restored
    after it."""
    prev = jflags.get_flags("mxu_crossing")
    yield lambda v: jflags.set_flags({"mxu_crossing": v})
    jflags.set_flags({"mxu_crossing": prev})


def _both_ws():
    rng = np.random.default_rng(0)
    host = jfv.default_rows(N - 1, D, rng, 1e-2)
    host["show"][:] = rng.integers(1, 50, N - 1)
    host["mf_size"][:] = np.where(rng.random(N - 1) < 0.7, D, 0)
    return (jemb.build_working_set(host, D, pad_to=N),
            temb.build_working_set(host, torch.device("cpu"), pad_to=N))


def _assert_fields(got, want, **tol):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype, k
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


@pytest.mark.parametrize("trim", [False, True], ids=["untrimmed", "trimmed"])
@pytest.mark.parametrize("crossing", ["take", "sort"])
def test_mxu_pull_push_match_both_jax_crossings(crossing, trim):
    rng = np.random.default_rng(1)
    idx = rng.integers(1, N, (S, L, B)).astype(np.int32)
    lengths = rng.integers(0, L + 1, (S, B))
    idx[np.arange(L)[None, :, None] >= lengths[:, None, :]] = 0
    jd, td = jmxu.make_dims(S * L * B, N), tmxu.make_dims(S * L * B, N)
    jeff = teff = None
    if trim:
        real = int((idx != 0).sum())
        jeff, teff = jsp.trimmed_dims(jd, real), tsp.trimmed_dims(td, real)
        assert teff.p_pad == jeff.p_pad < td.p_pad
    jplan = jmxu.build_plan(jnp.asarray(idx), jd, jeff)
    tplan = tmxu.build_plan(torch.as_tensor(idx), td, teff)
    d_pooled = rng.normal(0, 1, (B, S, 3 + D)).astype(np.float32)
    ins_cvm = np.stack([np.ones(B), rng.integers(0, 2, B)], 1).astype(
        np.float32)
    slot_ids = np.arange(100, 100 + S, dtype=np.int32)
    jws, tws = _both_ws()
    want = jmxu.pull_pool_cvm(jws, jplan, jd, (S, L, B), True,
                              interpret=True, crossing=crossing)
    got = tmxu.pull_pool_cvm(tws, tplan, td, (S, L, B), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    want = jmxu.push_and_update(
        jws, jplan, jd, jnp.asarray(idx), jnp.asarray(d_pooled),
        jnp.asarray(ins_cvm), jnp.asarray(slot_ids),
        JSgd(mf_create_thresholds=0.0), interpret=True, crossing=crossing)
    got = tmxu.push_and_update(
        tws, tplan, td, torch.as_tensor(idx), torch.as_tensor(d_pooled),
        torch.as_tensor(ins_cvm), torch.as_tensor(slot_ids),
        TSgd(mf_create_thresholds=0.0))
    _assert_fields(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("packed", [False, True], ids=["stream", "packed"])
def test_trainer_matches_the_jax_sort_crossing(jax_crossing, packed):
    b = 256                      # wide enough for the packed plans to trim
    jax_crossing("sort")
    jcfg, jdata = h.datasets(h.JAX, b=b, nb=2)
    tcfg, tdata = h.datasets(h.TORCH, b=b, nb=2)
    jeng, teng = h.engine(h.JAX, jdata), h.engine(h.TORCH, tdata)
    jtr = h.JAX.Trainer(jeng, JDeepFM(h.S, 3 + h.MF, h.DENSE,
                                      hidden=(16, 16)),
                        jcfg, batch_size=b, seed=3, sparse_path="mxu")
    ttr = h.TORCH.Trainer(teng, TDeepFM(h.S, 3 + h.MF, h.DENSE,
                                        hidden=(16, 16)),
                          tcfg, batch_size=b, seed=3, sparse_path="mxu",
                          device="cpu")
    ttr.model.load_jax_params(jax.tree.map(np.asarray, jtr.params))
    for jd, td in zip(jdata, tdata):
        if packed:
            jd, td = jtr.build_pass_feed(jd), ttr.build_pass_feed(td)
            assert td.plans["rows2d"].shape[1] < td.plan_dims.n_chunks
            assert "bs" in td.plans and "bs" in jd.plans
        js, ts = jtr.train_pass(jd), ttr.train_pass(td)
        assert jtr._mxu_crossing == ("sort", "sort")
        np.testing.assert_allclose(ts["loss"], js["loss"], **PASS_TOL)
    np.testing.assert_allclose(ts["auc"], js["auc"], **PASS_TOL)
    h.assert_ws_close(h.ws_numpy(teng), h.ws_numpy(jeng), **PASS_TOL)
    h.assert_tree_close(ttr.model.jax_params(),
                        jax.tree.map(np.asarray, jtr.params), **PASS_TOL)


@pytest.mark.parametrize("name", ["mxu_crossing", "mxu_crossing_bf16"])
def test_crossing_flags_are_gone(name):
    with pytest.raises(KeyError, match=name):
        tflags.get_flags(name)
    with pytest.raises(KeyError, match=name):
        tflags.set_flags({name: "take"})
    assert name not in tflags.all_flags()
