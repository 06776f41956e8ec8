"""One DeepFM training pass in both packages, step for step.

A small DeepFM (4 slots, mf_dim 4, hidden (16, 16), batch 64, 3
batches) trains one engine pass through ``BoxPSEngine`` →
``SparseTrainer.train_pass`` (mxu lowering) → ``end_pass`` in the JAX
package (Pallas kernels in interpret mode) and in the port (on the CPU).
The port starts from the JAX dense init, carried across with
``DeepFM.load_jax_params``; the host rows come from the same seeded
splitmix64 defaults in both.  Each batch is its own ``train_pass`` so
the per-batch losses can be compared.

Tolerance rtol 1e-4 / atol 1e-6: f32 sums run in another order in XLA
and in torch (matmuls, poolings, the Pallas kernels' hi/lo split), and
the differences compound over the steps through the optimizers.
"""

import numpy as np
import jax
import torch

from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu_torch.config import EmbeddingTableConfig as TTable
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine as TEngine

import torch_parity_helpers as h

S, MF, DENSE, B = h.S, h.MF, h.DENSE, h.B
TOL = dict(rtol=1e-4, atol=1e-6)


def test_deepfm_pass_matches_jax():
    jcfg, jdata = h.datasets(h.JAX)
    tcfg, tdata = h.datasets(h.TORCH)
    jeng = h.engine(h.JAX, jdata)
    teng = h.engine(h.TORCH, tdata)
    for f in jeng.ws:
        np.testing.assert_array_equal(teng.ws[f].numpy(),
                                      np.asarray(jeng.ws[f]), err_msg=f)

    jtr = h.JAX.Trainer(jeng, JDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)),
                        jcfg, batch_size=B, seed=3)
    ttr = h.TORCH.Trainer(teng, TDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)),
                          tcfg, batch_size=B, seed=3, device="cpu")
    ttr.model.load_jax_params(jax.tree.map(np.asarray, jtr.params))

    for jd, td in zip(jdata, tdata):
        js, ts = jtr.train_pass(jd), ttr.train_pass(td)
        assert ts["batches"] == js["batches"] == 1
        np.testing.assert_allclose(ts["loss"], js["loss"], **TOL)
    # AUC over the whole pass (the bucket state accumulates across calls)
    np.testing.assert_allclose(ts["auc"], js["auc"], **TOL)
    assert 0.0 <= ts["auc"] <= 1.0

    for f in jeng.ws:
        w, g = np.asarray(jeng.ws[f]), teng.ws[f].numpy()
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, err_msg=f, **TOL)
    want = jax.tree.map(np.asarray, jtr.params)
    got = ttr.model.jax_params()
    for lw, lg in zip(want["mlp"], got["mlp"]):
        np.testing.assert_allclose(lg["w"], lw["w"], **TOL)
        np.testing.assert_allclose(lg["b"], lw["b"], **TOL)
    np.testing.assert_allclose(got["dense_w"], want["dense_w"], **TOL)
    np.testing.assert_allclose(got["bias"], want["bias"], **TOL)

    # end_pass writes the same rows back to both host tables
    keys = np.asarray(jeng.mapper.sorted_keys)
    jeng.end_pass()
    teng.end_pass()
    assert teng.ws is None and teng.table.size() == jeng.table.size()
    jrows, trows = jeng.table.bulk_pull(keys), teng.table.bulk_pull(keys)
    for f in jrows:
        np.testing.assert_allclose(trows[f], jrows[f], err_msg=f, **TOL)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    """No silent move to the CPU: without CUDA the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import pytest
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(TTable(embedding_dim=MF))
    assert TEngine(TTable(embedding_dim=MF), device="cpu").device.type \
        == "cpu"


def test_jax_params_is_a_snapshot():
    """The JAX package's params are immutable, so a tree taken before
    training still holds the initial weights after it.  The port's
    ``jax_params`` must not alias the live weights (on the CPU a bare
    ``.numpy()`` would, and the "initial" weights would move with every
    dense update)."""
    tcfg, tdata = h.datasets(h.TORCH)
    teng = h.engine(h.TORCH, tdata)
    ttr = h.TORCH.Trainer(teng, TDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)),
                          tcfg, batch_size=B, seed=3, device="cpu")
    before = ttr.model.jax_params()
    w0 = before["mlp"][0]["w"].copy()
    ttr.train_pass(tdata[0])
    np.testing.assert_array_equal(before["mlp"][0]["w"], w0)
    assert not np.array_equal(ttr.model.jax_params()["mlp"][0]["w"], w0)
