"""The port's sorted<->canonical crossings (ops/crossing.py).

* ``permute_by_dest`` against the JAX package's, on a permutation and on
  a trimmed plan's shifted destinations (negatives first);
* ``best_mode``: "take" on the CPU under "auto", pinned by
  FLAGS_mxu_crossing, and a bad flag value raises;
* the mxu pull and push with the "sort" crossing are bit-equal to
  "take", on untrimmed and trimmed plans, and so are whole passes of the
  trainer on both entry points (the packed one plans trimmed, with the
  static payload planes).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.ops import crossing as jcx
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ops import crossing as tcx
from paddlebox_tpu_torch.ops import sorted_spmm as tsp
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import mxu_path as tmxu

import torch_parity_helpers as h


@pytest.fixture
def crossing_flag():
    """Set FLAGS_mxu_crossing for one test, restored after it."""
    prev = flags.get_flags("mxu_crossing")
    yield lambda v: flags.set_flags({"mxu_crossing": v})
    flags.set_flags({"mxu_crossing": prev})


@pytest.mark.parametrize("shift", [0, 37])
def test_permute_by_dest_matches_jax(shift):
    rng = np.random.default_rng(shift)
    n = 257
    dest = (rng.permutation(n) - shift).astype(np.int32)
    vals = rng.normal(0, 1, (5, n)).astype(np.float32)
    want = np.asarray(jcx.permute_by_dest(tuple(jnp.asarray(vals)),
                                          jnp.asarray(dest)))
    got = tcx.permute_by_dest(tuple(torch.as_tensor(vals)),
                              torch.as_tensor(dest)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, dest + shift], vals)


def test_best_mode_takes_take_on_the_cpu(crossing_flag):
    crossing_flag("auto")
    assert tcx.best_mode(1000, 1000, 12, "cpu") == "take"


@pytest.mark.parametrize("mode", ["take", "sort"])
def test_best_mode_follows_the_flag(crossing_flag, mode):
    crossing_flag(mode)
    assert tcx.best_mode(1000, 1000, 12, "cpu") == mode
    assert tcx.best_mode(1000, 1000, 12, "cuda") == mode   # not measured


def test_best_mode_rejects_a_bad_flag(crossing_flag):
    crossing_flag("gather")
    with pytest.raises(ValueError, match="take | sort | auto"):
        tcx.best_mode(1000, 1000, 12, "cpu")


N, D, S, L, B = 300, 4, 5, 3, 128


def _ws():
    rng = np.random.default_rng(0)
    host = jfv.default_rows(N - 1, D, rng, 1e-2)
    host["show"][:] = rng.integers(1, 50, N - 1)
    host["mf_size"][:] = np.where(rng.random(N - 1) < 0.7, D, 0)
    return temb.build_working_set(host, torch.device("cpu"), pad_to=N)


@pytest.mark.parametrize("trim", [False, True], ids=["untrimmed", "trimmed"])
def test_mxu_sort_crossing_equals_take(trim):
    rng = np.random.default_rng(1)
    idx = rng.integers(1, N, (S, L, B)).astype(np.int32)
    lengths = rng.integers(0, L + 1, (S, B))
    idx[np.arange(L)[None, :, None] >= lengths[:, None, :]] = 0
    idx = torch.as_tensor(idx)
    dims = tmxu.make_dims(S * L * B, N)
    eff = tsp.trimmed_dims(dims, int((idx != 0).sum())) if trim else None
    if trim:
        assert eff.p_pad < dims.p_pad
    plan = tmxu.build_plan(idx, dims, eff)
    d_pooled = torch.as_tensor(rng.normal(0, 1, (B, S, 3 + D))
                               .astype(np.float32))
    ins_cvm = torch.as_tensor(np.stack([np.ones(B), rng.integers(0, 2, B)],
                                       1).astype(np.float32))
    slot_ids = torch.arange(100, 100 + S, dtype=torch.int32)
    out = {}
    for mode in ("take", "sort"):
        ws = _ws()
        pooled = tmxu.pull_pool_cvm(ws, plan, dims, (S, L, B), True, mode)
        tmxu.push_and_update(ws, plan, dims, idx, d_pooled, ins_cvm,
                             slot_ids, TSgd(mf_create_thresholds=0.0), mode)
        out[mode] = (pooled, ws)
    assert torch.equal(out["sort"][0], out["take"][0])
    for f in out["take"][1]:
        assert torch.equal(out["sort"][1][f], out["take"][1][f]), f
    with pytest.raises(ValueError, match="crossing"):
        tmxu.pull_pool_cvm(_ws(), plan, dims, (S, L, B), True, "scan")


@pytest.mark.parametrize("packed", [False, True], ids=["stream", "packed"])
def test_trainer_sort_crossing_equals_take(crossing_flag, packed):
    b = 256                      # wide enough for the packed plans to trim
    out = {}
    for mode in ("take", "sort"):
        crossing_flag(mode)
        cfg, data = h.datasets(h.TORCH, b=b, nb=2)
        eng = h.engine(h.TORCH, data)
        tr = h.TORCH.Trainer(eng, TDeepFM(h.S, 3 + h.MF, h.DENSE,
                                          hidden=(16, 16)),
                             cfg, batch_size=b, seed=3, sparse_path="mxu",
                             device="cpu")
        losses = []
        for ds in data:
            if packed:
                ds = tr.build_pass_feed(ds)
                assert ds.plans["rows2d"].shape[1] < ds.plan_dims.n_chunks
                assert "bs" in ds.plans          # static payload planes
            losses += tr.train_pass(ds)["losses"]
        assert tr._mxu_crossing == (mode, mode)
        out[mode] = (losses, h.ws_numpy(eng))
    assert out["sort"][0] == out["take"][0]
    for f in out["take"][1]:
        np.testing.assert_array_equal(out["sort"][1][f], out["take"][1][f],
                                      err_msg=f)
