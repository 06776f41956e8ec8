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

from paddlebox_tpu.config import (DataFeedConfig as JFeed,
                                  EmbeddingTableConfig as JTable,
                                  SlotConfig as JSlot,
                                  SparseSGDConfig as JSgd)
from paddlebox_tpu.data.dataset import SlotDataset as JDataset
from paddlebox_tpu.data.slot_record import SlotRecordBlock as JBlock
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.trainer.trainer import SparseTrainer as JTrainer
from paddlebox_tpu_torch.config import (DataFeedConfig as TFeed,
                                        EmbeddingTableConfig as TTable,
                                        SlotConfig as TSlot,
                                        SparseSGDConfig as TSgd)
from paddlebox_tpu_torch.data.dataset import SlotDataset as TDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock as TBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine as TEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer as TTrainer

S, MF, DENSE, CAP, B, NB, KEYS = 4, 4, 3, 3, 64, 3, 400
TOL = dict(rtol=1e-4, atol=1e-6)


def _raw_batches(seed=0):
    """Per batch: ({slot: (values, offsets)}, labels, dense) in numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(NB):
        slots = {}
        for i in range(S):
            lens = rng.integers(1, CAP + 1, B)
            off = np.zeros(B + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            slots[f"s{i}"] = (rng.integers(1, KEYS, int(off[-1]))
                              .astype(np.uint64), off)
        out.append((slots, rng.integers(0, 2, B).astype(np.float32),
                    rng.normal(0, 1, B * DENSE).astype(np.float32)))
    return out


def _pkg(Feed, Slot, Block, Dataset):
    cfg = Feed(slots=tuple(
        [Slot("label", dtype="float", is_dense=True, dim=1),
         Slot("dense0", dtype="float", is_dense=True, dim=DENSE)]
        + [Slot(f"s{i}", slot_id=100 + i, capacity=CAP) for i in range(S)]))
    datasets = []
    for slots, labels, dense in _raw_batches():
        blk = Block(n=B)
        blk.uint64_slots = dict(slots)
        blk.float_slots["label"] = (labels, np.arange(B + 1, dtype=np.int64))
        blk.float_slots["dense0"] = (dense,
                                     np.arange(B + 1, dtype=np.int64) * DENSE)
        ds = Dataset(cfg)
        ds._blocks = [blk]
        datasets.append(ds)
    return cfg, datasets


def _engine(Engine, Table, Sgd, datasets, **kw):
    eng = Engine(Table(embedding_dim=MF, shard_num=4,
                       sgd=Sgd(mf_create_thresholds=1.0)), seed=7, **kw)
    eng.begin_feed_pass()
    for ds in datasets:
        for blk in ds.get_blocks():
            eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    return eng


def test_deepfm_pass_matches_jax():
    jcfg, jdata = _pkg(JFeed, JSlot, JBlock, JDataset)
    tcfg, tdata = _pkg(TFeed, TSlot, TBlock, TDataset)
    jeng = _engine(JEngine, JTable, JSgd, jdata)
    teng = _engine(TEngine, TTable, TSgd, tdata, device="cpu")
    for f in jeng.ws:
        np.testing.assert_array_equal(teng.ws[f].numpy(),
                                      np.asarray(jeng.ws[f]), err_msg=f)

    jtr = JTrainer(jeng, JDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)), jcfg,
                   batch_size=B, seed=3)
    ttr = TTrainer(teng, TDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)), tcfg,
                   batch_size=B, seed=3, device="cpu")
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
