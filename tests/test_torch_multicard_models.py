"""The page-view models, the multi-task trainer, graph learning and the
plane stager with the shards on distinct devices.

Two devices on the CPU: ``cpu:0`` and ``cpu:1``
(``tests/test_torch_multicard.py``'s layouts ``halves`` and
``interleaved``), every move between them a copy.  The configuration is
``tests/test_torch_mxu_sharded_trainer.py``'s: 4 slots × capacity 3,
mf_dim 4, 3 dense, batch 64, three batches.

* ``RankAttentionCTR`` on a pv-aligned feed (``preprocess_instance()``,
  ``rank_offset`` and ``ads_offset`` on, max_rank 3, page views of 1-4
  records that straddle the batch blocks) on ``auto`` (→ mxu_sharded),
  ``mxu``, ``fast`` and ``reference``, streaming and packed: against the
  JAX package on the same mesh (its 8 virtual CPU devices,
  ``tests/conftest.py``) and against the port with every shard on one
  device.  Each replica reads its own rows' ``rank_offset``, the whole
  ``ads_offset`` and the whole batch's input for its peer rows.
* ``MultiTaskSparseTrainer`` (MMoE, two tasks), streaming and packed.
  The JAX multi-task trainer steps one device only (its packed entry
  point is the single-task step), so the port on two devices is held
  against the JAX package's one-device streaming run of the same pass:
  the function GSPMD computes for the sharded table and batch.
* ``GraphEmbeddingTrainer.train_pairs`` over a small graph with the JAX
  trainer's negatives fed in; the JAX graph trainer takes no mesh, so
  against its one-device run, as above.
* A ``PlaneStager`` made for the topology: the staged feed equals the
  unstaged one bit for bit, each plane on its shard's device.

Tolerances: the pass loss rtol 1e-4; the working set and the dense
params rtol 1e-5 / atol 1e-6; integer fields equal; a task's AUC within
1e-6; the graph's loss, ``mf`` and ``mf_g2sum`` against JAX within rtol
1e-5 / atol 1e-7.  Against the port on one device the rank model keeps
the JAX tolerances (its peers' grads sum in another order), the
multi-task loss is held within rtol 1e-6 (a loss denominator off by the
task count would be off by a factor of 2) and the graph is held bit for
bit: each pulled value has one contributor, each block merges its rows'
occurrences in the one-device order, and adagrad's mean square is one
reduction over the table's whole width, a whole number of tiles, on one
device and in every block.  Reruns are held bit for bit.
"""

import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.graph.graph_table import GraphTable as JGraph
from paddlebox_tpu.models.mmoe import MMoE as JMMoE
from paddlebox_tpu.models.rank_ctr import RankAttentionCTR as JRankCTR
from paddlebox_tpu.trainer import graph_trainer as jgt
from paddlebox_tpu.trainer.multitask import (
    MultiTaskSparseTrainer as JMultiTask)
from paddlebox_tpu_torch.config import EmbeddingTableConfig, SparseSGDConfig
from paddlebox_tpu_torch.data import pass_feed as pf
from paddlebox_tpu_torch.graph.graph_table import GraphTable
from paddlebox_tpu_torch.models.mmoe import MMoE as TMMoE
from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR as TRankCTR
from paddlebox_tpu_torch.parallel.topology import (Sharded, device_key,
                                                   same_device)
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer import graph_trainer as tgt
from paddlebox_tpu_torch.trainer.multitask import (
    MultiTaskSparseTrainer as TMultiTask)

import test_torch_graph_trainer as gtest
import test_torch_multicard as mc
import test_torch_mxu_sharded_trainer as base
import torch_parity_helpers as h

E = 3 + h.MF
RANK_KW = dict(att_out=8, max_rank=3, hidden=(16,))
MMOE_KW = dict(num_experts=3, num_tasks=2, expert_hidden=(16, 8),
               tower_hidden=(8,))
PATHS = ("auto", "mxu", "fast", "reference")
TOL = dict(rtol=1e-5, atol=1e-6)


def _params(tr):
    return [p.detach().numpy().copy() for p in tr.model.parameters()]


def _engine(pkg, datasets, topo):
    """A pass over every key of ``datasets`` on ``topo``, begun (host
    rows from seed 7)."""
    table = pkg.Table(embedding_dim=h.MF, shard_num=4,
                      sgd=pkg.Sgd(mf_create_thresholds=1.0))
    kw = {"device": "cpu"} if pkg is h.TORCH and topo is None else {}
    eng = pkg.Engine(table, seed=7, topology=topo, **kw)
    eng.begin_feed_pass()
    for ds in datasets:
        for blk in ds.get_blocks():
            eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    return eng


# -- the page-view model ------------------------------------------------------------

def rank_setup(pkg, topo, path, seed=1, model_cls=None, params=None,
               batch=h.B):
    """(dataset, engine, trainer) of ``pkg`` over ``topo``: a pv-aligned
    pass of three batches of up to ``batch`` records."""
    cfg, ds = h.pv_pass(pkg, seed, nb=4, b=h.B, rank_offset=True,
                        ads_offset=True, max_rank=3)
    eng = _engine(pkg, [ds], topo)
    cls = model_cls or (JRankCTR if pkg is h.JAX else TRankCTR)
    kw = {} if pkg is h.JAX else {"device": "cpu"}
    tr = pkg.Trainer(eng, cls(h.S, E, h.DENSE, **RANK_KW), cfg,
                     batch_size=batch, seed=3, sparse_path=path,
                     topology=topo, **kw)
    if params is not None:
        tr.model.load_jax_params(params)
    return ds, eng, tr


def rank_run(topo, path, packed, params, seed=1, batch=h.B):
    ds, eng, tr = rank_setup(h.TORCH, topo, path, seed, params=params,
                             batch=batch)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    return stats, h.ws_numpy(eng), tr


def _jax_rank_params(seed=1):
    _, _, jtr = rank_setup(h.JAX, None, "reference", seed)
    return jax.tree.map(np.asarray, jtr.params)


def _assert_ws(got, want, **tol):
    for k in want:
        if want[k].dtype == np.int32:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **(tol or TOL))


@pytest.mark.parametrize("blocks", [2, 4])
def test_page_views_straddle_the_batch_blocks(blocks):
    """The feed this file trains on: three pv-aligned batches, with
    ranked ads whose peers sit in another batch block (another replica's
    rows under dp 2, and under dp 4 or dp 2 × sharding 2)."""
    ds, _, tr = rank_setup(h.TORCH, None, "auto")
    arrays = tr.pack_pass_host(ds)
    assert arrays.n_batches == 3
    ro = arrays.rank_offset.reshape(3, h.B, -1)
    width = h.B // blocks
    crossing = 0
    for i in range(3):
        for r in range(h.B):
            if ro[i, r, 0] <= 0:
                continue
            peers = ro[i, r, 2::2][ro[i, r, 1::2] > 0]
            crossing += int(np.any(peers // width != r // width))
    assert crossing > 0


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("path", PATHS)
def test_rank_model_matches_jax(path, packed):
    """Each lowering on dp 2, its halves on cpu:0 and cpu:1, against the
    JAX package's same lowering on the same mesh."""
    degrees = dict(dp=2)
    jds, jeng, jtr = rank_setup(h.JAX, base.jax_topo(**degrees), path)
    params = jax.tree.map(np.asarray, jtr.params)
    tds, teng, ttr = rank_setup(h.TORCH, mc.two_devices(**degrees), path,
                                params=params)
    assert isinstance(teng.ws["show"], Sharded)
    assert ttr._resolve_path() == jtr._resolve_path()
    assert ttr._resolve_path() == ("mxu_sharded" if path == "auto"
                                   else path)
    h.assert_ws_close(h.ws_numpy(teng), h.ws_numpy(jeng), rtol=0, atol=0)
    js = jtr.train_pass(jtr.build_pass_feed(jds) if packed else jds)
    ts = ttr.train_pass(ttr.build_pass_feed(tds) if packed else tds)
    assert ts["batches"] == js["batches"] == 3
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-4)
    np.testing.assert_allclose(ts["auc"], js["auc"], rtol=1e-4)
    _assert_ws(h.ws_numpy(teng), h.ws_numpy(jeng))
    h.assert_tree_close(ttr.model.jax_params(),
                        jax.tree.map(np.asarray, jtr.params), **TOL)


@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
@pytest.mark.parametrize("path", PATHS)
def test_rank_model_matches_one_device(path, layout):
    """Streaming and packed on dp 2 × sharding 2, from the same dense
    weights: within the JAX tolerances of the same mesh with every shard
    on one device."""
    degrees = dict(dp=2, sharding=2)
    params = _jax_rank_params()
    for packed in (False, True):
        ref, ws_ref, tr_ref = rank_run(mc.one_device(**degrees), path,
                                       packed, params)
        got, ws, tr = rank_run(mc.two_devices(layout, **degrees), path,
                               packed, params)
        assert tr._resolve_path() == tr_ref._resolve_path()
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["auc"], ref["auc"], rtol=1e-4)
        _assert_ws(ws, ws_ref)
        for a, b in zip(_params(tr), _params(tr_ref)):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("path", PATHS)
def test_rank_model_reruns_bit_identical(path):
    topo = mc.two_devices("interleaved", dp=2, sharding=2)
    params = _jax_rank_params()
    for packed in (False, True):
        a, ws_a, tr_a = rank_run(topo, path, packed, params)
        b, ws_b, tr_b = rank_run(topo, path, packed, params)
        assert a["losses"] == b["losses"]
        for k in ws_a:
            np.testing.assert_array_equal(ws_a[k], ws_b[k], err_msg=k)
        for x, y in zip(_params(tr_a), _params(tr_b)):
            np.testing.assert_array_equal(x, y)


class _SpyRankCTR(TRankCTR):
    """The rank model reading ``ads_offset`` too, recording what each
    replica's forward is handed."""

    extra_inputs = ("rank_offset", "ads_offset")
    seen = []

    def forward(self, pooled, dense, rank_offset, ads_offset=None,
                peers=None, peer_rows=None):
        self.seen.append(dict(
            device=pooled.device, rows=pooled.shape[0],
            rank_offset=rank_offset.clone(), ads_offset=ads_offset.clone(),
            peers=None if peers is None else peers.detach().clone(),
            peer_rows=None if peer_rows is None else peer_rows.clone(),
            pooled=pooled.detach().clone()))
        return super().forward(pooled, dense, rank_offset, peers, peer_rows)


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
def test_each_replica_sees_its_rows_and_the_whole_batch(layout, packed):
    """dp 4 on two devices: each replica's forward runs on its device
    over its batch blocks' rows, with those rows' rank_offset, the whole
    ads_offset and the whole batch's input as its peers, whose rows
    ``peer_rows`` are its own; the loss is the one-device topology's."""
    params = _jax_rank_params()
    out = []
    for topo in (mc.one_device(dp=4), mc.two_devices(layout, dp=4)):
        ds, eng, tr = rank_setup(h.TORCH, topo, "fast",
                                 model_cls=_SpyRankCTR, params=params)
        arrays = tr.pack_pass_host(ds)
        _SpyRankCTR.seen = []
        stats = tr.train_pass(tr.finish_pass_feed(arrays) if packed else ds)
        out.append((stats, list(_SpyRankCTR.seen), arrays))
    (ref, seen_ref, arrays), (got, seen, _) = out
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    assert len(seen_ref) == 3 and len(seen) == 6
    ro = arrays.rank_offset.reshape(3, h.B, -1)
    blocks = mc.LAYOUTS[layout](4)
    for i in range(3):
        step = seen[2 * i:2 * i + 2]
        for g, dev in enumerate(mc.TWO):
            s = step[g]
            mine = [b for b in range(4) if blocks[b] == dev]
            rows = np.concatenate([np.arange(b * 16, (b + 1) * 16)
                                   for b in mine])
            assert same_device(s["device"], dev) and s["rows"] == 32
            assert s["peer_rows"].tolist() == rows.tolist()
            np.testing.assert_array_equal(s["rank_offset"].numpy(),
                                          ro[i][rows])
            np.testing.assert_array_equal(s["ads_offset"].numpy(),
                                          arrays.ads_offset[i])
            assert s["peers"].shape == (h.B, seen_ref[i]["pooled"].shape[1])
            assert torch.equal(s["peers"][s["peer_rows"]], s["pooled"])
            np.testing.assert_allclose(s["peers"].numpy(),
                                       seen_ref[i]["pooled"].numpy(),
                                       rtol=1e-5, atol=1e-6)
    assert all(s["peers"] is None for s in seen_ref)


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
def test_rank_model_batch_the_shards_do_not_divide(packed):
    """pv-aligned batches of up to 60 records over dp 8 (auto resolves
    to fast): each shard's block of ceil(60 / 8) = 8 columns, the
    padding at the end of the last block, so rank_offset's batch-local
    rows address the same records; the pass is the one-device
    topology's."""
    params = _jax_rank_params()
    out = []
    for topo in (mc.one_device(dp=8), mc.two_devices("interleaved", dp=8)):
        stats, ws, tr = rank_run(topo, "auto", packed, params, batch=60)
        assert tr._resolve_path() == "fast"
        assert stats["batches"] >= 3
        out.append((stats, ws, tr))
    (ref, ws_ref, tr_ref), (got, ws, tr) = out
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    _assert_ws(ws, ws_ref)
    for a, b in zip(_params(tr), _params(tr_ref)):
        np.testing.assert_allclose(a, b, **TOL)


# -- the multi-task trainer ----------------------------------------------------------

def multitask_setup(pkg, topo, params=None):
    cfg, data = h.datasets(pkg, n_labels=2)
    eng = _engine(pkg, data, topo)
    if pkg is h.JAX:
        tr = JMultiTask(eng, JMMoE(h.S, E, h.DENSE, **MMOE_KW), cfg,
                        batch_size=h.B, label_slots=h.label_names(2),
                        seed=3)
    else:
        tr = TMultiTask(eng, TMMoE(h.S, E, h.DENSE, **MMOE_KW), cfg,
                        batch_size=h.B, label_slots=h.label_names(2),
                        seed=3, topology=topo, device="cpu")
        if params is not None:
            tr.model.load_jax_params(params)
    return data, eng, tr


def multitask_run(topo, packed, params):
    data, eng, tr = multitask_setup(h.TORCH, topo, params)
    stats = h.train_batches(tr, data, packed)
    return stats, h.ws_numpy(eng), tr


def _jax_multitask():
    data, eng, tr = multitask_setup(h.JAX, None)
    params = jax.tree.map(np.asarray, tr.params)
    stats = h.train_batches(tr, data)
    return params, stats, h.ws_numpy(eng), tr


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("degrees", [dict(dp=2), dict(dp=2, sharding=2)],
                         ids=["dp2", "dp2xsharding2"])
def test_multitask_matches_jax(degrees, packed):
    """Against the JAX package's one-device streaming run of the same
    passes (its multi-task step takes no mesh)."""
    params, js, jws, jtr = _jax_multitask()
    ts, tws, ttr = multitask_run(mc.two_devices("halves", **degrees),
                                 packed, params)
    assert ttr._resolve_path() == "reference"
    np.testing.assert_allclose([s["loss"] for s in ts],
                               [s["loss"] for s in js], rtol=1e-4)
    for t in range(2):
        np.testing.assert_allclose(ts[-1][f"task{t}_auc"],
                                   js[-1][f"task{t}_auc"], rtol=0,
                                   atol=1e-6)
    _assert_ws(tws, jws)
    h.assert_tree_close(ttr.model.jax_params(),
                        jax.tree.map(np.asarray, jtr.params), **TOL)


@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
@pytest.mark.parametrize("degrees", [dict(dp=2), dict(dp=2, sharding=2)],
                         ids=["dp2", "dp2xsharding2"])
def test_multitask_matches_one_device(degrees, layout):
    """Streaming and packed: the per-batch losses within rtol 1e-6 of
    the one-device topology's (the loss divides by the global valid
    count times the task count), the task AUCs within 1e-6, the working
    set and the params within the file's tolerances."""
    params = _jax_multitask()[0]
    for packed in (False, True):
        ref, ws_ref, tr_ref = multitask_run(mc.one_device(**degrees),
                                            packed, params)
        got, ws, tr = multitask_run(mc.two_devices(layout, **degrees),
                                    packed, params)
        np.testing.assert_allclose([s["loss"] for s in got],
                                   [s["loss"] for s in ref], rtol=1e-6)
        for t in range(2):
            np.testing.assert_allclose(got[-1][f"task{t}_auc"],
                                       ref[-1][f"task{t}_auc"], rtol=0,
                                       atol=1e-6)
        _assert_ws(ws, ws_ref)
        for a, b in zip(_params(tr), _params(tr_ref)):
            np.testing.assert_allclose(a, b, **TOL)


def test_multitask_reruns_bit_identical():
    topo = mc.two_devices("interleaved", dp=2, sharding=2)
    params = _jax_multitask()[0]
    for packed in (False, True):
        a, ws_a, tr_a = multitask_run(topo, packed, params)
        b, ws_b, tr_b = multitask_run(topo, packed, params)
        assert [s["losses"] for s in a] == [s["losses"] for s in b]
        assert [s["task1_auc"] for s in a] == [s["task1_auc"] for s in b]
        for k in ws_a:
            np.testing.assert_array_equal(ws_a[k], ws_b[k], err_msg=k)
        for x, y in zip(_params(tr_a), _params(tr_b)):
            np.testing.assert_array_equal(x, y)


# -- graph learning -------------------------------------------------------------------

K, LR, SEED, GBATCH = 4, 0.1, 7, 1024


def graph_run(topo, pairs, n, edges, negs):
    """A port engine over keys 1..n on ``topo`` and one ``train_pairs``
    epoch fed ``negs``; returns (loss, mf, mf_g2sum, engine, trainer)."""
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=8, shard_num=4,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0,
                            mf_initial_range=0.1)),
        seed=0, topology=topo)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, n + 1, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    size = eng.ws["mf_size"]
    for _, blk in (size.unique() if isinstance(size, Sharded)
                   else [(0, size)]):
        blk.fill_(8)
    tr = tgt.GraphEmbeddingTrainer(
        eng, GraphTable(edges, num_nodes=n + 1, device="cpu"),
        n_negatives=K, learning_rate=LR, seed=SEED)
    it = iter(negs)
    tr.draw_negatives = lambda b: torch.from_numpy(next(it))
    loss = tr.train_pairs(pairs, batch_size=GBATCH)
    return (loss, np.array(eng.ws["mf"]), np.array(eng.ws["mf_g2sum"]),
            eng, tr)


def _graph_case(seed=5000):
    rng = np.random.default_rng(seed)
    edges, n = gtest._two_communities(rng)
    pairs = rng.integers(0, n + 1, (seed, 2)).astype(np.int32)
    steps = -(-len(pairs) // GBATCH)
    return edges, n, pairs, gtest._jax_negatives(SEED, steps, GBATCH, K, n)


GRAPH_MESHES = {"dp2": dict(dp=2), "dp2xsharding2": dict(dp=2, sharding=2)}


@pytest.mark.parametrize("mesh", list(GRAPH_MESHES))
@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
def test_graph_matches_jax_and_one_device(monkeypatch, layout, mesh):
    """A five-step epoch on two devices: the loss, mf and mf_g2sum
    against the JAX trainer's one-device run (its graph trainer takes no
    mesh) within rtol 1e-5 / atol 1e-7, and equal to the port's
    one-device topology bit for bit; each sorted kernel runs once a row
    block a step."""
    edges, n, pairs, negs = _graph_case()
    jeng, _ = gtest._engines(n)
    jtr = jgt.GraphEmbeddingTrainer(jeng, JGraph(edges, num_nodes=n + 1),
                                    n_negatives=K, learning_rate=LR,
                                    seed=SEED)
    want = jtr.train_pairs(jnp.asarray(pairs), batch_size=GBATCH)
    degrees = GRAPH_MESHES[mesh]
    ref = graph_run(mc.one_device(**degrees), pairs, n, edges, negs)
    calls = gtest._count_launches(monkeypatch)
    topo = mc.two_devices(layout, **degrees)
    got = graph_run(topo, pairs, n, edges, negs)
    n_blocks = len(got[3].ws["mf"].row_blocks())
    assert n_blocks == topo.axis_size(("sharding",) if "sharding" in mesh
                                      else ("dp",))
    assert calls == {"gather_sorted": len(negs) * n_blocks,
                     "scatter_add_sorted": len(negs) * n_blocks}
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    for f, a in (("mf", got[1]), ("mf_g2sum", got[2])):
        np.testing.assert_allclose(a, np.asarray(jeng.ws[f]), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    assert got[0] == ref[0]
    assert got[4].stats["losses"] == ref[4].stats["losses"]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


def test_graph_replicas_equal_and_rerun_bit_identical():
    """dp 2 × sharding 2 interleaved: each table block's two replicas
    (one a node) hold the same trained bits, on their own devices, and a
    rerun gives the same bits."""
    edges, n, pairs, negs = _graph_case(3000)
    topo = mc.two_devices("interleaved", dp=2, sharding=2)
    a = graph_run(topo, pairs, n, edges, negs)
    b = graph_run(topo, pairs, n, edges, negs)
    assert a[4].stats["losses"] == b[4].stats["losses"]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    mf = a[3].ws["mf"]
    first = {}
    for k, blk in mf.unique():
        assert same_device(blk.device, topo.device_of(k))
        row0 = mf.rows(k).start
        if row0 in first:
            assert torch.equal(blk, first[row0])
            assert blk.data_ptr() != first[row0].data_ptr()
        first.setdefault(row0, blk)
    assert len(first) == 2


def test_graph_end_pass_writes_the_trained_rows():
    """``end_pass`` after a two-device epoch writes the trained rows to
    the host table: the same table as the one-device topology's."""
    edges, n, pairs, negs = _graph_case(2000)
    tables = []
    for topo in (mc.one_device(dp=2), mc.two_devices("halves", dp=2)):
        _, mf, _, eng, _ = graph_run(topo, pairs, n, edges, negs)
        keys = np.arange(1, n + 1, dtype=np.uint64)
        eng.end_pass()
        tables.append(eng.table.bulk_pull(keys))
        rows = eng.table.bulk_pull(keys)["mf"]
        np.testing.assert_array_equal(rows, mf[1:n + 1])
    for f in tables[0]:
        np.testing.assert_array_equal(tables[1][f], tables[0][f], err_msg=f)


def test_graph_walks_on_two_devices():
    """The whole graph-mode loop (walks on the trainer's device → pairs →
    an epoch over the row blocks) trains and equals the one-device
    topology's walks and epoch bit for bit."""
    rng = np.random.default_rng(11)
    edges, n = gtest._two_communities(rng)
    out = []
    for topo in (mc.one_device(dp=2), mc.two_devices("interleaved", dp=2)):
        eng = BoxPSEngine(EmbeddingTableConfig(
            embedding_dim=8, shard_num=4,
            sgd=SparseSGDConfig(mf_create_thresholds=0.0,
                                mf_initial_range=0.1)),
            seed=0, topology=topo)
        eng.begin_feed_pass()
        eng.add_keys(np.arange(1, n + 1, dtype=np.uint64))
        eng.end_feed_pass()
        eng.begin_pass()
        tr = tgt.GraphEmbeddingTrainer(
            eng, GraphTable(edges, num_nodes=n + 1, device="cpu"),
            n_negatives=K, learning_rate=LR, seed=SEED)
        loss = tr.train_walks(np.arange(1, n + 1), length=6,
                              batch_size=256, seed=3)
        assert np.isfinite(loss)
        out.append((tr.stats["losses"], np.array(eng.ws["mf"])))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


# -- the plane stager -----------------------------------------------------------------

def _staged_and_plain(topo, path="auto"):
    """The same pass packed twice for ``topo``: once through a stager
    made for it, once uploaded after the pack."""
    ds, _, tr = rank_setup(h.TORCH, topo, path)
    arrays = tr.pack_pass_host(ds)
    stager = pf.PlaneStager(topo, tr.batch_size)
    staged_arrays = tr.pack_pass_host(ds, on_plane=stager)
    return tr, arrays, staged_arrays, stager


@pytest.mark.parametrize("degrees", [dict(dp=2), dict(dp=4, mp=2)],
                         ids=["dp2", "dp4xmp2"])
@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
def test_staged_upload_equals_unstaged(layout, degrees):
    """Every plane staged as it became final: the feed equals the
    unstaged upload bit for bit, each plane a ``Sharded`` whose shards'
    columns sit on their devices, shards with the same columns on one
    device sharing one copy; no staged plane is ever whole on a device
    (ads_offset, a per-batch plane, is whole on every device)."""
    topo = mc.two_devices(layout, **degrees)
    tr, arrays, staged_arrays, stager = _staged_and_plain(topo)
    b = arrays.batch_size
    assert set(stager.staged) == {"indices", "lengths", "dense", "labels",
                                  "valid", "rank_offset", "ads_offset"}
    for name, parts in stager.staged.items():
        assert len(parts) == topo.world_size
        for k, p in enumerate(parts):
            assert same_device(p.device, topo.device_of(k))
            if name == "ads_offset":
                np.testing.assert_array_equal(p.numpy(), arrays.ads_offset)
            else:
                dim = 1 if name in ("indices", "lengths") else 0
                assert p.shape[dim] * topo.axis_size(("dp", "sharding")) \
                    == getattr(arrays, name).shape[dim]
        for i in range(len(parts)):
            for j in range(i + 1, len(parts)):
                same = parts[i] is parts[j]
                assert same == (device_key(topo.device_of(i))
                                == device_key(topo.device_of(j))
                                and topo.axis_index(i, ("dp", "sharding"))
                                == topo.axis_index(j, ("dp", "sharding")))
    shardings = tr.pass_shardings(arrays)
    plain = pf.upload_pass(arrays, tr.device, topology=topo,
                           shardings=shardings)
    staged = pf.upload_pass(staged_arrays, tr.device, staged=stager,
                            topology=topo, shardings=shardings)
    assert set(staged.data) == set(plain.data)
    for name in plain.data:
        s, p = staged.data[name], plain.data[name]
        assert isinstance(s, Sharded)
        for k in range(topo.world_size):
            assert torch.equal(s.parts[k], p.parts[k]), name
            assert same_device(s.parts[k].device, topo.device_of(k))
    assert b == h.B


@pytest.mark.parametrize("path", ["auto", "mxu"])
def test_staged_feed_trains_the_unstaged_pass(path):
    """A pass built from the staged planes (``finish_pass_feed(staged=)``)
    trains to the bits of the unstaged build."""
    topo = mc.two_devices("interleaved", dp=2, sharding=2)
    params = _jax_rank_params()
    out = []
    for staged in (False, True):
        ds, eng, tr = rank_setup(h.TORCH, topo, path, params=params)
        stager = None
        if staged:
            stager = pf.PlaneStager(topo, tr.batch_size)
        arrays = tr.pack_pass_host(ds, on_plane=stager)
        feed = tr.finish_pass_feed(arrays, staged=stager)
        out.append((tr.train_pass(feed), h.ws_numpy(eng)))
    (a, ws_a), (b, ws_b) = out
    assert a["losses"] == b["losses"]
    for k in ws_a:
        np.testing.assert_array_equal(ws_a[k], ws_b[k], err_msg=k)


def test_stager_refuses_a_worker_thread_and_a_mismatched_pass():
    topo = mc.two_devices("halves", dp=2)
    ds, _, tr = rank_setup(h.TORCH, topo, "auto")
    stager = pf.PlaneStager(topo, tr.batch_size)
    err = []

    def work():
        try:
            tr.pack_pass_host(ds, on_plane=stager)
        except RuntimeError as e:
            err.append(str(e))
    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert err and "main thread" in err[0]
    with pytest.raises(ValueError, match="batch_size"):
        pf.PlaneStager(topo)
    arrays = tr.pack_pass_host(ds)
    shardings = tr.pass_shardings(arrays)
    other_layout = mc.two_devices("interleaved", dp=2)
    for wrong in (pf.PlaneStager("cpu"),
                  pf.PlaneStager(other_layout, tr.batch_size),
                  pf.PlaneStager(topo, tr.batch_size // 2)):
        with pytest.raises(ValueError, match="PlaneStager"):
            pf.upload_pass(arrays, tr.device, staged=wrong, topology=topo,
                           shardings=shardings)
