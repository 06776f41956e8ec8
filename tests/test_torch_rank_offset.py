"""The port's page-view planes, rank_attention and RankAttentionCTR against
the JAX package's.

* The rank_offset / ads_offset plane functions (per batch and whole
  pass) give the JAX package's planes bit for bit.
* ``rank_attention``: forward within rtol 1e-5 / atol 1e-6 and the
  grads in x and rank_param within rtol 1e-4 (atol 1e-5 of the grads'
  scale), with absent, duplicate and out-of-range entries, at max_rank 3
  and 2.  The port bins the input by block and runs one GEMM; the JAX
  package gathers the blocks: the same f32 sums in another order.
* ``RankAttentionCTR`` with the JAX init carried across by
  ``load_jax_params`` gives the JAX model's logits.
* A pass of pv-grouped batches (4 slots, mf_dim 4, batches of up to 64
  records) through ``SparseTrainer`` on mxu, fast, ragged and reference
  in both packages: first-step loss within rtol 1e-5, every batch's loss
  and the AUC within rtol 1e-4; under AMP within rtol 1e-2 (bf16).
* A pass of several pv-aligned batches (the packed feed slices each
  batch's batch-local rank_offset rows) on mxu and ragged against the
  JAX pass (rtol 1e-4) and, on mxu, against the port's streaming pass.
* The port's streaming entry point equals its packed one, and the three
  guards (missing plane, max_rank mismatch, ungrouped dataset) raise as
  the JAX package's do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.data import rank_offset as jro
from paddlebox_tpu.models.rank_ctr import RankAttentionCTR as JRankCTR
from paddlebox_tpu.ops.rank_attention import rank_attention as j_rank_att
from paddlebox_tpu_torch.data import rank_offset as tro
from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR as TRankCTR
from paddlebox_tpu_torch.ops.rank_attention import (batch_fc,
                                                    rank_attention)

import torch_parity_helpers as h

E = 3 + h.MF
MODEL_KW = dict(att_out=8, max_rank=3, hidden=(16,))


def _pv_columns(seed, n_pvs=30):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 6, n_pvs)
    n = int(sizes.sum())
    sid = np.repeat(rng.choice(10_000, n_pvs, replace=False)
                    .astype(np.uint64), sizes)
    # ranked join ads (222/223), other cmatches, rank 0 and out-of-range
    # ranks: every filter branch of data_feed.cc:1873
    cmatch = rng.choice([222, 223, 224, 0], n).astype(np.int32)
    rank = rng.integers(0, 6, n).astype(np.int32)
    return sizes, sid, cmatch, rank


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_rank", [3, 2])
def test_plane_functions_match_jax(seed, max_rank):
    sizes, sid, cmatch, rank = _pv_columns(seed)
    n = len(sid)
    np.testing.assert_array_equal(
        tro.build_rank_offset(sid, cmatch, rank, n + 3, max_rank),
        jro.build_rank_offset(sid, cmatch, rank, n + 3, max_rank))
    np.testing.assert_array_equal(tro.build_ads_offset(sid, n, n + 2),
                                  jro.build_ads_offset(sid, n, n + 2))
    # pv-aligned cuts of the same records, one short batch and an empty one
    ends = np.cumsum(sizes)
    cut = [0, int(ends[9]), int(ends[19]), n, n]
    real = np.diff(cut).astype(np.int64)
    base = np.asarray(cut[:-1], np.int64)
    bsz = int(real.max()) + 2
    np.testing.assert_array_equal(
        tro.build_rank_offset_batched(sid, cmatch, rank, real, base, bsz,
                                      max_rank),
        jro.build_rank_offset_batched(sid, cmatch, rank, real, base, bsz,
                                      max_rank))
    np.testing.assert_array_equal(
        tro.build_ads_offset_batched(sid, real, base, bsz),
        jro.build_ads_offset_batched(sid, real, base, bsz))
    # no pv data parsed: every entry absent
    np.testing.assert_array_equal(
        tro.build_rank_offset(None, None, None, 4, max_rank),
        jro.build_rank_offset(None, None, None, 4, max_rank))
    with pytest.raises(ValueError, match="search_ids"):
        tro.build_ads_offset(None, 3, 4)


def _att_inputs(seed, max_rank, b=48, in_col=20, out_col=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, in_col)).astype(np.float32)
    ro = np.full((b, 1 + 2 * max_rank), -1, np.int32)
    ro[:, 0] = rng.integers(-1, max_rank + 2, b)      # absent, out of range
    for m in range(max_rank):
        present = rng.random(b) < 0.7
        ro[:, 1 + 2 * m] = np.where(present, m + 1, -1)
        ro[:, 2 + 2 * m] = np.where(present, rng.integers(0, b, b), -1)
    # duplicate peer ranks, ranks past max_rank, rows outside the batch
    ro[:4, 3] = 1
    ro[4:8, 1] = max_rank + 1
    ro[8:12, 2] = b + 5
    ro[12:14, 2] = -3
    param = rng.normal(0, 0.1, (max_rank * max_rank * in_col, out_col)
                       ).astype(np.float32)
    g = rng.normal(0, 1, (b, out_col)).astype(np.float32)
    return x, ro, param, g


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_rank", [3, 2])
def test_rank_attention_matches_jax(seed, max_rank):
    x, ro, param, g = _att_inputs(seed, max_rank)

    def jloss(xx, pp):
        out, rk = j_rank_att(xx, jnp.asarray(ro), pp, max_rank)
        return jnp.sum(out * g), (out, rk)

    (_, (jout, jrk)), (jgx, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                             jnp.asarray(param))
    tx = torch.tensor(x, requires_grad=True)
    tp = torch.tensor(param, requires_grad=True)
    out, rk = rank_attention(tx, torch.as_tensor(ro), tp, max_rank)
    (out * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk))
    for got, want in ((tx.grad, jgx), (tp.grad, jgp)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_batch_fc_matches_jax():
    from paddlebox_tpu.ops.rank_attention import batch_fc as j_batch_fc
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (3, 16, 5)).astype(np.float32)
    w = rng.normal(0, 1, (3, 5, 4)).astype(np.float32)
    bias = rng.normal(0, 1, (3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        batch_fc(*map(torch.as_tensor, (x, w, bias))).numpy(),
        np.asarray(j_batch_fc(x, w, bias)), rtol=1e-5, atol=1e-6)


def test_rank_ctr_forward_matches_jax():
    jm = JRankCTR(h.S, E, h.DENSE, **MODEL_KW)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = TRankCTR(h.S, E, h.DENSE, **MODEL_KW)
    tm.load_jax_params(params)
    h.assert_tree_close(tm.jax_params(), params, rtol=0, atol=0)
    rng = np.random.default_rng(1)
    b = 40
    pooled = rng.normal(0, 1, (b, h.S * E)).astype(np.float32)
    dense = rng.normal(0, 1, (b, h.DENSE)).astype(np.float32)
    _, ro, _, _ = _att_inputs(2, 3, b=b)
    want = np.asarray(jm.apply(params, jnp.asarray(pooled),
                               jnp.asarray(dense), jnp.asarray(ro)))
    with torch.no_grad():
        got = tm(torch.as_tensor(pooled), torch.as_tensor(dense),
                 torch.as_tensor(ro)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _rank_run(pkg, cls, path, packed, params=None, amp=False, **feed_kw):
    """One train_pass per pv-grouped batch; returns (per-batch losses,
    last AUC, the model's initial params as numpy)."""
    cfg, data = h.pv_datasets(pkg, rank_offset=True, **feed_kw)
    eng = h.engine(pkg, data)
    tr = pkg.Trainer(eng, cls(h.S, E, h.DENSE, **MODEL_KW), cfg,
                     batch_size=h.B, seed=3, sparse_path=path, amp=amp,
                     **pkg.kw)
    if params is not None:
        tr.model.load_jax_params(params)
    p0 = (jax.tree.map(np.asarray, tr.params) if pkg is h.JAX
          else tr.model.jax_params())
    stats = h.train_batches(tr, data, packed)
    return [s["loss"] for s in stats], stats[-1]["auc"], p0


@pytest.mark.parametrize("path", ["mxu", "fast", "ragged", "reference"])
def test_rank_pass_matches_jax(path):
    jl, jauc, params = _rank_run(h.JAX, JRankCTR, path, True)
    tl, tauc, _ = _rank_run(h.TORCH, TRankCTR, path, True, params)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tauc, jauc, rtol=1e-4)


def test_rank_pass_amp_matches_jax():
    jl, _, params = _rank_run(h.JAX, JRankCTR, "mxu", True, amp=True)
    tl, _, _ = _rank_run(h.TORCH, TRankCTR, "mxu", True, params, amp=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


@pytest.mark.parametrize("path", ["mxu", "ragged"])
def test_multi_batch_pass_matches_jax(path):
    """One pass of several pv-aligned batches from one dataset: the packed
    feed slices batch i's rank_offset rows (batch-local) and the trainer
    hands them to the step.  Mean loss and AUC against the JAX pass; on
    mxu the port's streaming pass gives the same per-batch losses."""
    out = {}
    for pkg, cls in ((h.JAX, JRankCTR), (h.TORCH, TRankCTR)):
        cfg, ds = h.pv_pass(pkg, rank_offset=True)
        eng = h.engine(pkg, [ds])
        tr = pkg.Trainer(eng, cls(h.S, E, h.DENSE, **MODEL_KW), cfg,
                         batch_size=h.B, seed=3, sparse_path=path, **pkg.kw)
        if pkg is h.JAX:
            params = jax.tree.map(np.asarray, tr.params)
        else:
            tr.model.load_jax_params(params)
        out[pkg is h.JAX] = tr.train_pass(tr.build_pass_feed(ds))
    got, want = out[False], out[True]
    assert got["batches"] == want["batches"] > 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-4)
    if path == "mxu":
        cfg, ds = h.pv_pass(h.TORCH, rank_offset=True)
        eng = h.engine(h.TORCH, [ds])
        tr = h.TORCH.Trainer(eng, TRankCTR(h.S, E, h.DENSE, **MODEL_KW),
                             cfg, batch_size=h.B, seed=3, device="cpu")
        tr.model.load_jax_params(params)
        np.testing.assert_allclose(tr.train_pass(ds)["losses"],
                                   got["losses"], rtol=1e-6)


@pytest.mark.parametrize("path", ["mxu", "fast", "reference"])
def test_streaming_equals_packed(path):
    """The same pv batches through the streaming entry point and through
    build_pass_feed (with ads_offset on, an extra plane the model does not
    read): the same step, so the same losses."""
    stream, sauc, params = _rank_run(h.TORCH, TRankCTR, path, False,
                                     ads_offset=True)
    packed, pauc, _ = _rank_run(h.TORCH, TRankCTR, path, True, params,
                                ads_offset=True)
    np.testing.assert_allclose(packed, stream, rtol=1e-6)
    np.testing.assert_allclose(pauc, sauc, rtol=1e-6)


def test_guards_fail_loud():
    """The JAX package's three guards: a rank model without the plane, a
    max_rank mismatch, and an ungrouped dataset."""
    for pkg, cls in ((h.JAX, JRankCTR), (h.TORCH, TRankCTR)):
        cfg, data = h.pv_datasets(pkg, nb=1, rank_offset=True)
        eng = h.engine(pkg, data)
        model = cls(h.S, E, h.DENSE, **MODEL_KW)
        with pytest.raises(ValueError, match="rank_offset"):
            pkg.Trainer(eng, model, dataclasses.replace(cfg,
                                                        rank_offset=False),
                        batch_size=h.B, **pkg.kw)
        with pytest.raises(ValueError, match="max_rank"):
            pkg.Trainer(eng, model, dataclasses.replace(cfg, max_rank=2),
                        batch_size=h.B, **pkg.kw)
        tr = pkg.Trainer(eng, model, cfg, batch_size=h.B, **pkg.kw)
        ds = data[0]
        ds._pv_grouped = False           # dense cuts would split pvs
        with pytest.raises(ValueError, match="preprocess_instance"):
            tr.train_pass(ds)
        with pytest.raises(ValueError, match="preprocess_instance"):
            tr.build_pass_feed(ds)
