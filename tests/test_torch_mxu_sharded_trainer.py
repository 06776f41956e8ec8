"""The mxu_sharded lowering in both packages: the sharded exchange as the
trainer's step, against the JAX package's on the same mesh.

The configuration is ``tests/test_mxu_sharded_trainer.py``'s (4 slots ×
capacity 3, mf_dim 4, 3 dense, DeepFM (16,), batch 64, 192 records, so a
pass of 3 batches).  JAX runs on the 8 virtual CPU devices of
``tests/conftest.py`` with its Pallas kernels in interpret mode; the port
runs every shard on ``device="cpu"``, where its kernels take their plain
versions.  The port starts from the JAX trainer's dense init
(``DeepFM.load_jax_params``); both engines build the working set from
the same seeded host rows, asserted equal before the first step.

Tolerances: the pass's mean loss rtol 1e-4; the working set and the
dense params rtol 1e-5 / atol 1e-6 (f32 sums run in another order in XLA
and in torch — the matmuls, the poolings, the interpret kernels' hi/lo
split — and compound over three steps), except under shared_adam (see
its test); integer fields (mf_size, slot) equal: both packages gather
the shards' ids in the same order, so the same occurrence carries each
row's slot.
"""

import numpy as np
import pytest
import jax
import torch

from paddlebox_tpu import config as jcfg
from paddlebox_tpu import flags as jflags
from paddlebox_tpu.data.dataset import SlotDataset as JDataset
from paddlebox_tpu.data.slot_record import SlotRecordBlock as JBlock
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.parallel.topology import HybridTopology as JTopology
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.trainer.trainer import SparseTrainer as JTrainer
from paddlebox_tpu_torch import config as tcfg
from paddlebox_tpu_torch import flags as tflags
from paddlebox_tpu_torch.data.dataset import SlotDataset as TDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock as TBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.parallel.topology import HybridTopology as TTopology
from paddlebox_tpu_torch.parallel.topology import Spec
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine as TEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer as TTrainer

N_SLOTS, DENSE_DIM, MF, CAP, B = 4, 3, 4, 3, 64
LOSS_TOL = dict(rtol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-6)


def _feed_config(c):
    return c.DataFeedConfig(slots=tuple(
        [c.SlotConfig("label", dtype="float", is_dense=True, dim=1),
         c.SlotConfig("dense0", dtype="float", is_dense=True, dim=DENSE_DIM)]
        + [c.SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(N_SLOTS)]))


def _block(block_cls, seed=0, n=192):
    """The JAX test's ``_make_blocks`` for either package's block class."""
    rng = np.random.default_rng(seed)
    blk = block_cls(n=n)
    for i in range(N_SLOTS):
        lens = rng.integers(1, CAP + 1, size=n)
        off = np.zeros((n + 1,), np.int64)
        np.cumsum(lens, out=off[1:])
        blk.uint64_slots[f"s{i}"] = (
            rng.integers(1, 400, size=int(off[-1])).astype(np.uint64), off)
    blk.float_slots["label"] = (
        rng.integers(0, 2, size=n).astype(np.float32),
        np.arange(n + 1, dtype=np.int64))
    blk.float_slots["dense0"] = (
        rng.normal(0, 1, size=n * DENSE_DIM).astype(np.float32),
        np.arange(n + 1, dtype=np.int64) * DENSE_DIM)
    return blk


def jax_topo(**degrees):
    n = jcfg.MeshConfig(**degrees).world_size
    return JTopology(jcfg.MeshConfig(**degrees), jax.devices()[:n])


def torch_topo(**degrees):
    return TTopology(tcfg.MeshConfig(**degrees), device="cpu")


def _setup(pkg, seed, degrees, sparse_path, optimizer="adagrad",
           expand_dim=0, jparams=None, batch=B):
    """(dataset, engine, trainer) of ``pkg`` ("jax" or "torch") with the
    pass's working set built; ``degrees`` None means no topology."""
    c = jcfg if pkg == "jax" else tcfg
    cfg = _feed_config(c)
    ds = (JDataset if pkg == "jax" else TDataset)(cfg)
    ds._blocks = [_block(JBlock if pkg == "jax" else TBlock, seed)]
    topo = None
    if degrees is not None:
        topo = (jax_topo if pkg == "jax" else torch_topo)(**degrees)
    table = c.EmbeddingTableConfig(
        embedding_dim=MF, expand_dim=expand_dim,
        sgd=c.SparseSGDConfig(optimizer=optimizer, mf_create_thresholds=0.0))
    if pkg == "jax":
        eng = JEngine(table, topology=topo)
    else:
        eng = TEngine(table, topology=topo, device="cpu")
    eng.begin_feed_pass()
    for b in ds.get_blocks():
        eng.add_keys(b.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    emb = 3 + MF + expand_dim
    if pkg == "jax":
        tr = JTrainer(eng, JDeepFM(num_slots=N_SLOTS, emb_width=emb,
                                   dense_dim=DENSE_DIM, hidden=(16,)),
                      cfg, batch_size=batch, seed=0, topology=topo,
                      sparse_path=sparse_path)
    else:
        tr = TTrainer(eng, TDeepFM(N_SLOTS, emb, DENSE_DIM, hidden=(16,)),
                      cfg, batch_size=batch, seed=0, topology=topo,
                      sparse_path=sparse_path, device="cpu")
        if jparams is not None:
            tr.model.load_jax_params(jparams)
    return ds, eng, tr


def _train(ds, tr, packed):
    return tr.train_pass(tr.build_pass_feed(ds) if packed else ds)


def _ws(eng):
    return {k: np.array(v, copy=True) for k, v in eng.ws.items()}


def run_both(seed, degrees, sparse_path="mxu_sharded", packed=False,
             optimizer="adagrad", expand_dim=0):
    """The same pass through both packages; returns (jax stats, jax ws,
    jax params, torch stats, torch ws, torch trainer)."""
    jds, jeng, jtr = _setup("jax", seed, degrees, sparse_path, optimizer,
                            expand_dim)
    jparams = jax.tree.map(np.asarray, jtr.params)
    tds, teng, ttr = _setup("torch", seed, degrees, sparse_path, optimizer,
                            expand_dim, jparams)
    ws0_j, ws0_t = _ws(jeng), _ws(teng)
    assert set(ws0_j) == set(ws0_t)
    for k in ws0_j:
        np.testing.assert_array_equal(ws0_t[k], ws0_j[k], err_msg=k)
    js = _train(jds, jtr, packed)
    ts = _train(tds, ttr, packed)
    return (js, _ws(jeng), jax.tree.map(np.asarray, jtr.params), ts,
            _ws(teng), ttr)


def assert_matches_jax(js, jws, jparams, ts, tws, ttr, ws_tol=TOL):
    assert ts["batches"] == js["batches"] == 3
    np.testing.assert_allclose(ts["loss"], js["loss"], **LOSS_TOL)
    np.testing.assert_allclose(ts["auc"], js["auc"], **LOSS_TOL)
    for k in jws:
        if jws[k].dtype == np.int32:
            np.testing.assert_array_equal(tws[k], jws[k], err_msg=k)
        else:
            np.testing.assert_allclose(tws[k], jws[k], err_msg=k, **ws_tol)
    got = ttr.model.jax_params()
    for lw, lg in zip(jparams["mlp"], got["mlp"]):
        np.testing.assert_allclose(lg["w"], lw["w"], **TOL)
        np.testing.assert_allclose(lg["b"], lw["b"], **TOL)
    for k in ("dense_w", "bias"):
        np.testing.assert_allclose(got[k], jparams[k], **TOL)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degrees", [dict(dp=8), dict(dp=4, sharding=2)],
                         ids=["dp8", "dp4xsharding2"])
def test_auto_resolves_to_mxu_sharded_on_pure_dp_mesh(degrees):
    for pkg in ("jax", "torch"):
        _, _, tr = _setup(pkg, 0, degrees, "auto")
        assert tr._resolve_path() == "mxu_sharded", pkg


@pytest.mark.parametrize("packed", [False, True],
                         ids=["streaming", "packed"])
def test_mxu_sharded_matches_jax(packed):
    """The JAX test's ``_topo8`` (dp 4 × sharding 2: the multi-node
    layout), streaming and through build_pass_feed."""
    out = run_both(0, dict(dp=4, sharding=2), packed=packed)
    assert out[-1]._resolve_path() == "mxu_sharded"
    assert_matches_jax(*out)


def test_mxu_sharded_shared_adam_rule():
    """The exchange feeds every rule.  Working set rtol 1e-4 / atol 2e-6
    here (measured: mf 4.1e-6 abs at 9e-5 relative, embed_w 1.4e-6 abs):
    Adam's m / sqrt(v) step turns the last-bit differences of tiny
    gradients into relative ones, as on one device."""
    assert_matches_jax(*run_both(3, dict(dp=4, sharding=2),
                                 optimizer="shared_adam"),
                       ws_tol=dict(rtol=1e-4, atol=2e-6))


@pytest.mark.parametrize("degrees,batch", [(dict(dp=4, mp=2), B),
                                          (dict(dp=8), 60)],
                         ids=["non_dp_mesh", "batch_not_divisible"])
def test_mxu_sharded_rejects_unshardable_mesh(degrees, batch):
    """Not pure dp × sharding, or a batch the shards do not divide: both
    packages refuse with the same message."""
    msgs = []
    for pkg in ("jax", "torch"):
        ds, _, tr = _setup(pkg, 0, degrees, "mxu_sharded", batch=batch)
        with pytest.raises(ValueError, match="mxu_sharded") as e:
            tr.train_pass(ds)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_multinode_layout_matches_jax():
    """dp 2 × sharding 4: the table split within a node (sharding),
    replicated across nodes (dp); the push merges per node, then sums
    across nodes (slots: the max)."""
    out = run_both(7, dict(dp=2, sharding=4), sparse_path="auto")
    ttr = out[-1]
    assert ttr._resolve_path() == "mxu_sharded"
    assert ttr.topology.table_spec() == Spec(("sharding", "mp", "sp", "ep"))
    assert tuple(ttr.topology.table_spec()) == tuple(
        jax_topo(dp=2, sharding=4).table_spec())
    assert_matches_jax(*out)


def test_flat_pool_layout_matches_jax():
    """sharding = 1 keeps the flat HeterComm pool over every shard."""
    out = run_both(9, dict(dp=8), sparse_path="auto")
    ttr = out[-1]
    assert ttr._resolve_path() == "mxu_sharded"
    assert tuple(ttr.topology.table_spec()) == tuple(
        jax_topo(dp=8).table_spec())
    assert_matches_jax(*out)


@pytest.mark.parametrize("expand_dim", [3, 4])
def test_extended_table_sharded_matches_jax(expand_dim):
    """Expand (mf_ex) columns join the per-shard table and payload and
    split back into g_embedx / g_embedx_ex."""
    out = run_both(13, dict(dp=4, sharding=2), sparse_path="auto",
                   expand_dim=expand_dim)
    assert out[-1]._resolve_path() == "mxu_sharded"
    assert_matches_jax(*out)
    assert not np.allclose(out[4]["mf_ex"], 0.0)


@pytest.fixture
def bf16_exchange():
    old = (jflags.get_flags("sharded_exchange_bf16"),
           tflags.get_flags("sharded_exchange_bf16"))
    jflags.set_flags({"sharded_exchange_bf16": True})
    tflags.set_flags({"sharded_exchange_bf16": True})
    try:
        yield
    finally:
        jflags.set_flags({"sharded_exchange_bf16": old[0]})
        tflags.set_flags({"sharded_exchange_bf16": old[1]})


def test_bf16_exchange_matches_jax_and_exact(bf16_exchange):
    """FLAGS_sharded_exchange_bf16 in both packages: the port's loss
    within the JAX test's atol 2e-2 of the exact run, each package's
    working set within that of the other's, and the slot column (an f32
    exchange beside the bf16 body) id-exact in both."""
    js, jws, _, ts, tws, _ = run_both(21, dict(dp=4, sharding=2))
    tflags.set_flags({"sharded_exchange_bf16": False})
    _, _, jtr = _setup("jax", 21, dict(dp=4, sharding=2), "mxu_sharded")
    ds_x, eng_x, tr_x = _setup("torch", 21, dict(dp=4, sharding=2),
                               "mxu_sharded",
                               jparams=jax.tree.map(np.asarray, jtr.params))
    exact = tr_x.train_pass(ds_x)
    assert np.isclose(ts["loss"], exact["loss"], atol=2e-2), \
        (ts["loss"], exact["loss"])
    assert np.isclose(ts["loss"], js["loss"], atol=2e-2)
    np.testing.assert_array_equal(tws["slot"], jws["slot"])
    xs = np.asarray(eng_x.ws["slot"])
    assert np.array_equal(xs != 0, tws["slot"] != 0)
    assert set(np.unique(tws["slot"][tws["slot"] != 0])) <= set(
        range(100, 100 + N_SLOTS))


# -- the port against itself ---------------------------------------------------

def _torch_run(seed, degrees, path, packed=False):
    ds, eng, tr = _setup("torch", seed, degrees, path)
    stats = _train(ds, tr, packed)
    return stats, _ws(eng), tr


@pytest.mark.parametrize("degrees", [dict(dp=8), dict(dp=2, sharding=4)],
                         ids=["flat", "multinode"])
def test_mxu_sharded_matches_one_device_mxu(degrees):
    """The port's mxu_sharded against its one-device mxu on the same data
    and weights: losses rtol 1e-4, working set rtol 1e-5 (the slot
    column: the same touched rows, each with one of the data's slots —
    which occurrence's slot wins depends on the order the exchange
    gathers them, as in the reference's PushMergeCopyAtomic)."""
    ref, ws_ref, _ = _torch_run(5, None, "mxu")
    for packed in (False, True):
        got, ws, tr = _torch_run(5, degrees, "auto", packed)
        assert tr._resolve_path() == "mxu_sharded"
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        for k in ws_ref:
            if k == "slot":
                assert np.array_equal(ws[k] != 0, ws_ref[k] != 0)
                assert set(np.unique(ws[k][ws[k] != 0])) <= set(
                    range(100, 100 + N_SLOTS))
            else:
                np.testing.assert_allclose(ws[k], ws_ref[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


@pytest.mark.parametrize("packed", [False, True],
                         ids=["streaming", "packed"])
def test_mxu_sharded_reruns_bit_identical(packed):
    a, ws_a, _ = _torch_run(11, dict(dp=4, sharding=2), "mxu_sharded",
                            packed)
    b, ws_b, _ = _torch_run(11, dict(dp=4, sharding=2), "mxu_sharded",
                            packed)
    assert a["losses"] == b["losses"]
    for k in ws_a:
        np.testing.assert_array_equal(ws_a[k], ws_b[k], err_msg=k)


@pytest.mark.parametrize("path", ["mxu", "fast", "reference"])
def test_one_device_lowerings_under_a_topology(path):
    """Explicit mxu, fast and reference under a topology run their
    one-device lowering over the global batch — the lowering that runs
    is the one ``_resolve_path()`` names, with the bits of the same
    lowering with no topology."""
    ref, ws_ref, _ = _torch_run(17, None, path)
    got, ws, tr = _torch_run(17, dict(dp=8), path)
    assert tr._resolve_path() == path
    assert got["losses"] == ref["losses"]
    for k in ws_ref:
        np.testing.assert_array_equal(ws[k], ws_ref[k], err_msg=k)


def test_auto_on_an_unshardable_mesh_matches_jax():
    """auto on a mesh mxu_sharded cannot take resolves as in JAX: fast
    for adagrad, reference for the other rules; ragged is refused with
    JAX's message."""
    for optimizer, want in (("adagrad", "fast"), ("adam", "reference")):
        for pkg in ("jax", "torch"):
            _, _, tr = _setup(pkg, 0, dict(dp=4, mp=2), "auto", optimizer)
            assert tr._resolve_path() == want, (pkg, optimizer)
    msgs = []
    for pkg in ("jax", "torch"):
        ds, _, tr = _setup(pkg, 0, dict(dp=8), "ragged")
        with pytest.raises(ValueError, match="mxu_sharded under a topology"
                           ) as e:
            tr.build_pass_feed(ds)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_packed_feed_plans_and_bytes():
    """The packed feed carries untrimmed per-shard plans [N, shards, ...]
    keyed to the exchange geometry; ``device_bytes`` counts them, and a
    feed built for another table height is refused."""
    ds, eng, tr = _setup("torch", 0, dict(dp=4, sharding=2), "auto")
    feed = tr.build_pass_feed(ds)
    n_rows = eng.ws["show"].shape[0]
    assert feed.plans["rows2d"].shape[:2] == (3, 8)
    dims = sp.spmm_dims(N_SLOTS * CAP * B // 4, n_rows // 2)
    assert feed.plans["rows2d"].shape[2] == dims.n_chunks
    assert feed.plan_dims == ("mxu_sharded", (3, N_SLOTS, CAP, B), n_rows,
                              ("sharding",), 2)
    planes = sum(t.numel() * t.element_size() for t in feed.data.values())
    plans = sum(t.numel() * t.element_size() for t in feed.plans.values())
    assert feed.device_bytes() == planes + plans
    feed.plan_dims = ("mxu_sharded", (3, N_SLOTS, CAP, B), n_rows // 2,
                      ("sharding",), 2)
    with pytest.raises(ValueError, match="sharded plans were built for"):
        tr.train_pass(feed)


def test_topology_device_must_match():
    topo = torch_topo(dp=8)
    eng = TEngine(tcfg.EmbeddingTableConfig(embedding_dim=MF),
                  topology=topo)
    assert eng.device == torch.device("cpu") and eng.topology is topo
    meta = TTopology(tcfg.MeshConfig(dp=2), device="meta")
    with pytest.raises(ValueError, match="topology's shards live on"):
        TEngine(tcfg.EmbeddingTableConfig(embedding_dim=MF),
                topology=meta, device="cpu")


@pytest.mark.parametrize("packed", [False, True],
                         ids=["streaming", "packed"])
def test_async_dense_table_on_mxu_sharded(packed):
    """The async dense table rides mxu_sharded as the JAX package allows
    it: the step pushes each batch's dense grads, the table applies them
    all, and the module ends on the table's params."""
    ds = TDataset(_feed_config(tcfg))
    ds._blocks = [_block(TBlock, 23)]
    topo = torch_topo(dp=4, sharding=2)
    eng = TEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=MF, sgd=tcfg.SparseSGDConfig(
            mf_create_thresholds=0.0)), topology=topo)
    eng.begin_feed_pass()
    for b in ds.get_blocks():
        eng.add_keys(b.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    tr = TTrainer(eng, TDeepFM(N_SLOTS, 3 + MF, DENSE_DIM, hidden=(16,)),
                  _feed_config(tcfg), batch_size=B, device="cpu",
                  topology=topo, trainer_config=tcfg.TrainerConfig(
                      dense_sync_mode="async_table", sync_weight_step=1))
    assert tr._resolve_path() == "mxu_sharded"
    stats = _train(ds, tr, packed)
    assert stats["batches"] == 3 and np.all(np.isfinite(stats["losses"]))
    table = tr.async_dense
    assert table.pushed == table.applied == 3
    final = table.pull()
    for n, p in tr.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), final[n])
