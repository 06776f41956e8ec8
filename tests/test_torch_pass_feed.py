"""The port's pass-resident feed against the JAX package's.

A small pass (4 slots × capacity 3, mf_dim 4, 600 records in batches of
256, so the last batch is short; wide enough that the trainer's mxu
plans really trim their row-0 padding), made from a numpy seed, goes through
both packages:

* ``pack_pass``, ``upload_pass``, ``precompute_plans`` (trimmed, with
  the static payload planes) and ``build_csr_plans`` give the JAX
  package's arrays, value for value (integers and f32 copies: exact);
  the port's plans carry the sparse rule's row list besides;
* the port's packed mxu and fast passes equal its own streaming passes
  (the same step on the same batches: exact on the CPU, rtol 1e-6);
* one packed pass per lowering (mxu, fast, ragged) through
  ``build_pass_feed`` → ``train_pass(feed)`` → ``end_pass`` matches the
  JAX package's packed pass (Pallas kernels in interpret mode): mean
  loss, AUC, working set, dense params and the rows written back, at
  rtol 1e-4 / atol 1e-6 — f32 sums run in another order in XLA and in
  torch, and differences compound through the optimizers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import (DataFeedConfig as JFeed,
                                  EmbeddingTableConfig as JTable,
                                  SlotConfig as JSlot,
                                  SparseSGDConfig as JSgd)
from paddlebox_tpu.data import pass_feed as jpf
from paddlebox_tpu.data.dataset import SlotDataset as JDataset
from paddlebox_tpu.data.slot_record import SlotRecordBlock as JBlock
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ops import sorted_spmm as jsp
from paddlebox_tpu.ps.embedding import PassKeyMapper as JMapper
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.trainer.trainer import SparseTrainer as JTrainer
from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import (DataFeedConfig as TFeed,
                                        EmbeddingTableConfig as TTable,
                                        SlotConfig as TSlot,
                                        SparseSGDConfig as TSgd)
from paddlebox_tpu_torch.data import pass_feed as tpf
from paddlebox_tpu_torch.data.dataset import SlotDataset as TDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock as TBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ops import sorted_spmm as tsp
from paddlebox_tpu_torch.ps.embedding import PassKeyMapper as TMapper
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine as TEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer as TTrainer

S, MF, DENSE, CAP, B, N_REC, KEYS = 4, 4, 3, 3, 256, 600, 2000
TOL = dict(rtol=1e-4, atol=1e-6)
CPU = torch.device("cpu")


def _raw(seed=0):
    rng = np.random.default_rng(seed)
    slots = {}
    for i in range(S):
        lens = rng.integers(0, CAP + 1, N_REC)       # empty and full slots
        off = np.zeros(N_REC + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        slots[f"s{i}"] = (rng.integers(1, KEYS, int(off[-1]))
                          .astype(np.uint64), off)
    return (slots, rng.integers(0, 2, N_REC).astype(np.float32),
            rng.normal(0, 1, N_REC * DENSE).astype(np.float32))


def _pkg(Feed, Slot, Block, Dataset, seed=0):
    cfg = Feed(slots=tuple(
        [Slot("label", dtype="float", is_dense=True, dim=1),
         Slot("dense0", dtype="float", is_dense=True, dim=DENSE)]
        + [Slot(f"s{i}", slot_id=100 + i, capacity=CAP) for i in range(S)]))
    slots, labels, dense = _raw(seed)
    blk = Block(n=N_REC)
    blk.uint64_slots = dict(slots)
    blk.float_slots["label"] = (labels, np.arange(N_REC + 1, dtype=np.int64))
    blk.float_slots["dense0"] = (dense,
                                 np.arange(N_REC + 1, dtype=np.int64) * DENSE)
    ds = Dataset(cfg)
    ds._blocks = [blk]
    return cfg, ds


def _keys(ds):
    return np.unique(np.concatenate(
        [v[0] for b in ds.get_blocks() for v in b.uint64_slots.values()]))


def _both_host_arrays():
    jcfg, jds = _pkg(JFeed, JSlot, JBlock, JDataset)
    tcfg, tds = _pkg(TFeed, TSlot, TBlock, TDataset)
    keys = _keys(jds)
    want = jpf.pack_pass(jds.get_blocks(), jcfg, B, "label",
                         key_mapper=JMapper(keys), pack_threads=2)
    got = tpf.pack_pass(tds.get_blocks(), tcfg, B, "label",
                        key_mapper=TMapper(keys), pack_threads=2)
    return want, got


def test_pack_pass_matches_jax():
    want, got = _both_host_arrays()
    for f in ("indices", "lengths", "dense", "labels", "valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.n_batches, got.batch_size, got.num_real) == \
        (want.n_batches, want.batch_size, want.num_real) == (3, B, N_REC)


def test_pack_pass_batch_counts_match_jax():
    """pv-aligned cuts: short batches padded at their own batch slot."""
    jcfg, jds = _pkg(JFeed, JSlot, JBlock, JDataset)
    tcfg, tds = _pkg(TFeed, TSlot, TBlock, TDataset)
    counts = [250, 256, 94]
    want = jpf.pack_pass(jds.get_blocks(), jcfg, B, "label",
                         key_mapper=JMapper(_keys(jds)), batch_counts=counts)
    got = tpf.pack_pass(tds.get_blocks(), tcfg, B, "label",
                        key_mapper=TMapper(_keys(jds)), batch_counts=counts)
    for f in ("indices", "lengths", "dense", "labels", "valid",
              "batch_real", "batch_base"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_pack_pass_uid_plane_matches_jax():
    """uid_slot: the first feasign of the slot a record, kept on the
    host (the upload leaves it out of the device planes)."""
    jcfg, jds = _pkg(JFeed, JSlot, JBlock, JDataset)
    tcfg, tds = _pkg(TFeed, TSlot, TBlock, TDataset)
    jcfg = dataclasses.replace(jcfg, uid_slot="s0")
    tcfg = dataclasses.replace(tcfg, uid_slot="s0")
    keys = _keys(jds)
    want = jpf.pack_pass(jds.get_blocks(), jcfg, B, "label",
                         key_mapper=JMapper(keys))
    got = tpf.pack_pass(tds.get_blocks(), tcfg, B, "label",
                        key_mapper=TMapper(keys))
    assert got.uid.dtype == want.uid.dtype == np.uint64
    np.testing.assert_array_equal(got.uid, want.uid)
    feed = tpf.upload_pass(got, CPU)
    assert set(feed.data) == {"indices", "lengths", "dense", "labels",
                              "valid"}
    np.testing.assert_array_equal(feed.uid, want.uid)
    np.testing.assert_array_equal(feed.host_valid, want.valid)


def test_upload_and_plans_match_jax():
    """upload_pass's [N, S, L, B] layout, the trimmed sorted-spmm plans
    with the static payload planes, and the CSR plans."""
    want_h, got_h = _both_host_arrays()
    jfeed = jpf.upload_pass(want_h)
    tfeed = tpf.upload_pass(got_h, CPU)
    assert set(tfeed.data) == set(jfeed.data)
    for k in jfeed.data:
        np.testing.assert_array_equal(tfeed.data[k].numpy(),
                                      np.asarray(jfeed.data[k]), err_msg=k)
    n, s, l, b = got_h.n_batches, S, CAP, B
    per_batch = got_h.lengths.reshape(s, n, b).sum(axis=(0, 2))
    n_rows = 2500     # small chunks and tiles: a many-item worklist
    jd = jsp.spmm_dims(s * l * b, n_rows, chunk=64, tile=128)
    td = tsp.spmm_dims(s * l * b, n_rows, chunk=64, tile=128)
    jeff = jsp.trimmed_dims(jd, int(per_batch.max()))
    teff = tsp.trimmed_dims(td, int(per_batch.max()))
    assert teff.p_pad == jeff.p_pad < td.p_pad      # really trimmed
    slot_ids = 100 + np.arange(S)
    jpf.precompute_plans(jfeed, jd, jeff, slot_ids=slot_ids)
    tpf.precompute_plans(tfeed, td, teff, slot_ids=slot_ids)
    # the port's plans add the sparse rule's row list (port only; held
    # to the batches' ids in test_torch_mxu_compact_rule.py)
    assert set(tfeed.plans) == set(jfeed.plans) | {"rule_rows", "rule_keep"}
    for k in jfeed.plans:
        np.testing.assert_array_equal(tfeed.plans[k].numpy(),
                                      np.asarray(jfeed.plans[k]), err_msg=k)
    step = tpf.mxu_step_plan(tpf.slice_batch(tfeed.plans, 1))
    for k, a in zip(tpf.PLAN_KEYS, step.plan):
        assert torch.equal(a, tfeed.plans[k][1]), k
    assert torch.equal(step.payload.bs, tfeed.plans["bs"][1])
    assert torch.equal(step.rule.rows, tfeed.plans["rule_rows"][1])

    want = jpf.build_csr_plans(want_h.indices, slot_ids, n, b)
    got = tpf.build_csr_plans(got_h.indices, slot_ids, n, b)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# whole packed passes
# ---------------------------------------------------------------------------

def _engine(Engine, Table, Sgd, ds, **kw):
    eng = Engine(Table(embedding_dim=MF, shard_num=4,
                       sgd=Sgd(mf_create_thresholds=1.0)), seed=7, **kw)
    eng.begin_feed_pass()
    for blk in ds.get_blocks():
        eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    return eng


def _port_trainer(path, params=None):
    tcfg, tds = _pkg(TFeed, TSlot, TBlock, TDataset)
    eng = _engine(TEngine, TTable, TSgd, tds, device="cpu")
    tr = TTrainer(eng, TDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)), tcfg,
                  batch_size=B, seed=3, sparse_path=path, device="cpu")
    if params is not None:
        tr.model.load_jax_params(params)
    return tds, eng, tr


@pytest.mark.parametrize("path", ["mxu", "fast"])
def test_packed_pass_equals_streaming_pass(path):
    ds1, eng1, tr1 = _port_trainer(path)
    s1 = tr1.train_pass(ds1)
    ds2, eng2, tr2 = _port_trainer(path)
    feed = tr2.build_pass_feed(ds2)
    if path == "mxu":
        assert feed.plans is not None and "bs" in feed.plans
        assert feed.plans["rows2d"].shape[1] < feed.plan_dims.n_chunks
    s2 = tr2.train_pass(feed)
    assert s1["batches"] == s2["batches"] == 3
    np.testing.assert_allclose(s2["losses"], s1["losses"], rtol=1e-6)
    np.testing.assert_allclose(s2["auc"], s1["auc"], rtol=1e-6)
    for k in eng1.ws:
        np.testing.assert_allclose(eng2.ws[k].numpy(), eng1.ws[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("path", ["mxu", "fast", "ragged"])
def test_packed_pass_matches_jax(path):
    jcfg, jds = _pkg(JFeed, JSlot, JBlock, JDataset)
    jeng = _engine(JEngine, JTable, JSgd, jds)
    jtr = JTrainer(jeng, JDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)), jcfg,
                   batch_size=B, seed=3, sparse_path=path)
    tds, teng, ttr = _port_trainer(
        path, params=jax.tree.map(np.asarray, jtr.params))

    js = jtr.train_pass(jtr.build_pass_feed(jds))
    tfeed = ttr.build_pass_feed(tds)
    ts = ttr.train_pass(tfeed)
    assert ts["batches"] == js["batches"] == 3
    np.testing.assert_allclose(ts["loss"], js["loss"], **TOL)
    np.testing.assert_allclose(ts["auc"], js["auc"], **TOL)

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

    keys = np.asarray(jeng.mapper.sorted_keys)
    jeng.end_pass()
    teng.end_pass()
    jrows, trows = jeng.table.bulk_pull(keys), teng.table.bulk_pull(keys)
    for f in jrows:
        np.testing.assert_allclose(trows[f], jrows[f], err_msg=f, **TOL)


def test_ragged_needs_the_packed_feed_and_fresh_plans():
    tds, eng, tr = _port_trainer("ragged")
    with pytest.raises(ValueError, match="pass-resident feed"):
        tr.train_pass(tds)
    feed = tr.build_pass_feed(tds)
    feed.plan_dims = ("ragged", (), 0)           # as if the table resized
    with pytest.raises(ValueError, match="rebuild the feed"):
        tr.train_pass(feed)


def test_unported_and_invalid_paths_raise():
    # mxu_sharded is ported; with no topology it is refused with the JAX
    # package's message
    tds, eng, tr = _port_trainer("mxu_sharded")
    with pytest.raises(ValueError, match="'mxu_sharded' needs a topology"):
        tr.build_pass_feed(tds)
    tds, eng, tr = _port_trainer("nonesuch")
    with pytest.raises(ValueError, match="unknown sparse_path"):
        tr.build_pass_feed(tds)
    tds, eng, tr = _port_trainer("fast")
    eng.config = dataclasses.replace(eng.config, sgd=dataclasses.replace(
        eng.config.sgd, optimizer="shared_adam"))
    with pytest.raises(ValueError, match="adagrad"):
        tr.train_pass(tds)


def test_auto_resolves_to_mxu_unless_the_flag_steers_it():
    tds, eng, tr = _port_trainer("auto")
    assert tr._resolve_path() == "mxu"
    prev = flags.get_flags("sparse_step_path")
    flags.set_flags({"sparse_step_path": "ragged"})
    try:
        tds, eng, tr = _port_trainer("auto")
        assert tr._resolve_path() == "ragged"
        tds, eng, tr = _port_trainer("fast")       # an explicit path wins
        assert tr._resolve_path() == "fast"
    finally:
        flags.set_flags({"sparse_step_path": prev})
