"""The mxu_sharded lowering with its shards on distinct devices.

Two devices on the CPU: ``cpu:0`` and ``cpu:1`` are told apart by the
topology (every tensor still lives in host memory), so the per-device
working-set blocks, the per-shard feed planes and plans, the dense
replica per device and the device-ordered gradient sum all run here,
and a value crosses between the two only as a copy.  The configuration
is ``tests/test_torch_mxu_sharded_trainer.py``'s (4 slots × capacity 3,
mf_dim 4, 3 dense, DeepFM (16,), batch 64, three batches); JAX runs on
its 8 virtual CPU devices of ``tests/conftest.py``, and the port's dense
weights start from the JAX trainer's (``DeepFM.load_jax_params``).

Layouts: ``halves`` puts shards 0..n/2-1 on ``cpu:0`` and the rest on
``cpu:1`` (dp 2 × sharding 4: one node a device); ``interleaved``
alternates them (each device holds non-adjacent batch columns, and under
dp 2 × sharding 4 each device holds both nodes' replicas of half the
table blocks).

Tolerances are that file's: the pass loss rtol 1e-4; the working set and
the dense params rtol 1e-5 / atol 1e-6; mf_size equal; the slot
column's touched rows equal (against JAX, every slot equal: the exchange
gathers the shards' ids in the same order).
"""

import numpy as np
import pytest
import jax
import torch

from paddlebox_tpu_torch import config as tcfg
from paddlebox_tpu_torch import flags as tflags
from paddlebox_tpu_torch import fleet as tfleet
from paddlebox_tpu_torch.data import pass_feed as pf
from paddlebox_tpu_torch.data.dataset import SlotDataset as TDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock as TBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.parallel import collective as tcol
from paddlebox_tpu_torch.parallel import sharding as tsharding
from paddlebox_tpu_torch.parallel.topology import (HybridTopology, Sharded,
                                                   Spec, same_device)
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import sharded_embedding as tse
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine as TEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer as TTrainer
from paddlebox_tpu_torch.utils.monitor import stat_get

import test_torch_mxu_sharded_trainer as base

TWO = (torch.device("cpu", 0), torch.device("cpu", 1))
LAYOUTS = {"halves": lambda n: [TWO[2 * k // n] for k in range(n)],
           "interleaved": lambda n: [TWO[k % 2] for k in range(n)]}
MESHES = {"flat": dict(dp=8), "multinode": dict(dp=2, sharding=4)}


def two_devices(layout="halves", **degrees) -> HybridTopology:
    n = tcfg.MeshConfig(**degrees).world_size
    return HybridTopology(tcfg.MeshConfig(**degrees),
                          devices=LAYOUTS[layout](n))


def one_device(**degrees) -> HybridTopology:
    return HybridTopology(tcfg.MeshConfig(**degrees), device="cpu")


def _open_pass(eng, ds):
    eng.begin_feed_pass()
    for b in ds.get_blocks():
        eng.add_keys(b.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()


def torch_setup(seed, topo, path="auto", jparams=None, optimizer="adagrad",
                n=192, **table_kw):
    cfg = base._feed_config(tcfg)
    ds = TDataset(cfg)
    ds._blocks = [base._block(TBlock, seed, n)]
    eng = TEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=base.MF, sgd=tcfg.SparseSGDConfig(
            optimizer=optimizer, mf_create_thresholds=0.0), **table_kw),
        topology=topo)
    _open_pass(eng, ds)
    tr = TTrainer(eng, TDeepFM(base.N_SLOTS, 3 + base.MF, base.DENSE_DIM,
                               hidden=(16,)),
                  cfg, batch_size=base.B, seed=0, topology=topo,
                  sparse_path=path, device="cpu")
    if jparams is not None:
        tr.model.load_jax_params(jparams)
    return ds, eng, tr


def _jax_params(seed, degrees):
    _, _, jtr = base._setup("jax", seed, degrees, "mxu_sharded")
    return jax.tree.map(np.asarray, jtr.params)


def torch_run(seed, topo, packed, jparams=None, progress=None):
    ds, eng, tr = torch_setup(seed, topo, jparams=jparams)
    feed = tr.build_pass_feed(ds) if packed else ds
    stats = tr.train_pass(feed, progress=(None if progress is None
                                          else lambda i: progress(tr, i)))
    return stats, base._ws(eng), tr


def close_to(got, ws, ref, ws_ref, params=None, params_ref=None):
    """The file's tolerances between two runs of the port."""
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    for k in ws_ref:
        if k == "slot":
            assert np.array_equal(ws[k] != 0, ws_ref[k] != 0)
        elif ws_ref[k].dtype == np.int32:
            np.testing.assert_array_equal(ws[k], ws_ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(ws[k], ws_ref[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    if params is not None:
        for a, b in zip(params, params_ref):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _params(tr):
    return [p.detach().numpy().copy() for p in tr.model.parameters()]


# -- against the JAX package on the same mesh ----------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_multicard_matches_jax(mesh, packed):
    degrees = MESHES[mesh]
    jds, jeng, jtr = base._setup("jax", 7, degrees, "mxu_sharded")
    jparams = jax.tree.map(np.asarray, jtr.params)
    topo = two_devices(**degrees)
    tds, teng, ttr = torch_setup(7, topo, jparams=jparams)
    assert ttr._resolve_path() == "mxu_sharded"
    assert isinstance(teng.ws["show"], Sharded)
    ws0_j, ws0_t = base._ws(jeng), base._ws(teng)
    for k in ws0_j:
        np.testing.assert_array_equal(ws0_t[k], ws0_j[k], err_msg=k)
    js = base._train(jds, jtr, packed)
    ts = base._train(tds, ttr, packed)
    base.assert_matches_jax(js, base._ws(jeng),
                            jax.tree.map(np.asarray, jtr.params), ts,
                            base._ws(teng), ttr)


# -- against the port's one-device topology -------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_multicard_matches_one_device(mesh, layout):
    """Streaming and packed, from the same dense weights: the losses,
    working set and dense params within the file's tolerances of the same
    mesh on one device."""
    degrees = MESHES[mesh]
    jparams = _jax_params(5, degrees)
    for packed in (False, True):
        ref, ws_ref, tr_ref = torch_run(5, one_device(**degrees), packed,
                                        jparams)
        got, ws, tr = torch_run(5, two_devices(layout, **degrees), packed,
                                jparams)
        assert tr._resolve_path() == "mxu_sharded"
        np.testing.assert_allclose(got["auc"], ref["auc"], rtol=1e-4)
        close_to(got, ws, ref, ws_ref, _params(tr), _params(tr_ref))


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
def test_multicard_reruns_bit_identical(packed):
    topo = two_devices("interleaved", dp=2, sharding=4)
    a, ws_a, tr_a = torch_run(11, topo, packed)
    b, ws_b, tr_b = torch_run(11, topo, packed)
    assert a["losses"] == b["losses"]
    for k in ws_a:
        np.testing.assert_array_equal(ws_a[k], ws_b[k], err_msg=k)
    for x, y in zip(_params(tr_a), _params(tr_b)):
        np.testing.assert_array_equal(x, y)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _by_rows(t: Sharded) -> dict:
    """The distinct block tensors of ``t`` by the global row they start
    at: a table block's replicas share a key."""
    out = {}
    for k, blk in t.unique():
        out.setdefault(t.rows(k).start, []).append(blk)
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_step_places_each_shard_on_its_device(layout, packed,
                                                    monkeypatch):
    """At every step each shard's table block, ids and plan sit on its
    shard's device, no tensor of one device shares storage with the
    other's, the exchange's results are each shard's own, and the two
    dense replicas, and the nodes' replicas of each table block, are
    bit-equal (and apart) after the step."""
    topo = two_devices(layout, dp=2, sharding=4)
    seen = {"pulls": 0, "steps": 0, "replicated": 0}
    pull = tse.pull_rows_sharded_mxu

    def spy(tables, idx, topo_, axis, plans, bf16):
        seen["pulls"] += 1
        stores = {}
        for k in range(topo.world_size):
            dev = topo.device_of(k)
            for t in (tables[k], idx[k], *plans[k]):
                assert same_device(t.device, dev)
                stores.setdefault(_storage(t), set()).add(dev)
        assert all(len(d) == 1 for d in stores.values())
        vals = pull(tables, idx, topo_, axis, plans, bf16)
        # disjoint blocks: a one-device group's are views of one sum
        assert len({v.data_ptr() for v in vals}) == len(vals)
        return vals
    monkeypatch.setattr(tse, "pull_rows_sharded_mxu", spy)

    def check(tr, i):
        seen["steps"] += 1
        reps = tr.dense_replicas()
        assert len(reps) == 2
        for a, b in zip(reps[0].parameters(), reps[1].parameters()):
            assert torch.equal(a, b) and _storage(a) != _storage(b)
        ws = tr.engine.ws
        for f, t in ws.items():
            for k, blk in t.unique():
                assert same_device(blk.device, topo.device_of(k))
        owners = {}
        for k, blk in ws["mf"].unique():
            owners.setdefault(_storage(blk), set()).add(topo.device_of(k))
        assert all(len(d) == 1 for d in owners.values())
        for f, t in ws.items():
            for first, *rest in _by_rows(t).values():
                for blk in rest:
                    assert torch.equal(blk, first), f
                    assert _storage(blk) != _storage(first)
        seen["replicated"] += sum(
            len(v) > 1 for v in _by_rows(ws["mf"]).values())

    stats, _, _ = torch_run(3, topo, packed, progress=check)
    assert seen["pulls"] == seen["steps"] == stats["batches"] == 3
    # halves: one node a device, so each of the 4 table blocks has a
    # replica on each device at each of the 3 steps; interleaved: both
    # nodes' replicas of a block sit on one device, one shared tensor
    assert seen["replicated"] == (12 if layout == "halves" else 0)


def test_packed_feed_places_each_shard_on_its_device():
    """The packed feed: each plane a ``Sharded`` of the shards' batch
    columns and each plan a list of per-shard [N, ...] stacks, on the
    shards' devices; ``bytes_by_device`` counts each device's own."""
    topo = two_devices("halves", dp=4, sharding=2)
    ds, eng, tr = torch_setup(0, topo)
    feed = tr.build_pass_feed(ds)
    idx = feed.data["indices"]
    assert isinstance(idx, Sharded) and idx.shape == (3, base.N_SLOTS,
                                                      base.CAP, base.B)
    assert all(p.shape == (3, base.N_SLOTS, base.CAP, base.B // 8)
               for p in idx.parts)
    assert len(feed.plans["rows2d"]) == 8
    for k in range(8):
        assert feed.plans["rows2d"][k].shape[0] == 3
    one = torch_setup(0, one_device(dp=4, sharding=2))
    ref = one[2].build_pass_feed(one[0])
    for name, t in ref.data.items():
        np.testing.assert_array_equal(np.asarray(feed.data[name]),
                                      t.numpy(), err_msg=name)
    for k in range(8):
        for key in pf.PLAN_KEYS:
            np.testing.assert_array_equal(feed.plans[key][k].numpy(),
                                          ref.plans[key][:, k].numpy())
    per = feed.bytes_by_device()
    assert set(per) == {"cpu:0", "cpu:1"}
    assert sum(per.values()) == feed.device_bytes() == ref.device_bytes()
    # each device holds two nodes' replicas of the table's two blocks:
    # one copy of each block, shared by the shards that hold it there
    ws_per = eng.ws["mf"].bytes_by_device()
    assert ws_per["cpu:0"] == ws_per["cpu:1"] == (
        eng.ws["mf"].shape[0] * base.MF * 4)
    assert len(eng.ws["mf"].unique()) == 4
    with pytest.raises(ValueError, match="placed for shards on distinct"):
        one[2].train_pass(feed)


def test_two_pass_day_write_back_matches_one_device():
    """Two passes, the second built while the first trains (its stale
    rows refreshed block by block at adoption), each written back by
    end_pass: the host table (export_keys + bulk_pull) equals the one
    device topology's within the file's tolerances; under ctr_double the
    f64 show/click take the per-block pass deltas."""
    out = []
    for topo in (one_device(dp=2, sharding=4),
                 two_devices("interleaved", dp=2, sharding=4)):
        cfg = base._feed_config(tcfg)
        days = []
        for seed in (31, 32):
            ds = TDataset(cfg)
            ds._blocks = [base._block(TBlock, seed)]
            days.append(ds)
        eng = TEngine(tcfg.EmbeddingTableConfig(
            embedding_dim=base.MF,
            accessor=tcfg.AccessorConfig(accessor_type="ctr_double"),
            sgd=tcfg.SparseSGDConfig(mf_create_thresholds=0.0)),
            topology=topo)
        _open_pass(eng, days[0])
        tr = TTrainer(eng, TDeepFM(base.N_SLOTS, 3 + base.MF,
                                   base.DENSE_DIM, hidden=(16,)),
                      cfg, batch_size=base.B, seed=0, topology=topo,
                      device="cpu")
        eng.begin_feed_pass()
        for b in days[1].get_blocks():
            eng.add_keys(b.all_keys())
        eng.end_feed_pass(async_build=True)
        losses = tr.train_pass(days[0])["losses"]
        eng.end_pass()
        stale = stat_get("ps.engine.stale_refresh_rows")
        eng.begin_pass()
        assert stat_get("ps.engine.stale_refresh_rows") > stale
        losses += tr.train_pass(tr.build_pass_feed(days[1]))["losses"]
        eng.end_pass()
        keys = np.sort(eng.table.export_keys())
        out.append((losses, keys, eng.table.bulk_pull(keys)))
    (l1, k1, t1), (l2, k2, t2) = out
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    np.testing.assert_array_equal(k2, k1)
    assert t1["show"].dtype == np.float64
    for f in t1:
        if t1[f].dtype.kind in "iu":
            np.testing.assert_array_equal(t2[f], t1[f], err_msg=f)
        else:
            np.testing.assert_allclose(t2[f], t1[f], rtol=1e-5, atol=1e-6,
                                       err_msg=f)


# -- the collectives over distinct devices ---------------------------------------

def _collectives(topo, xs):
    return {
        **{f"all_reduce_{op}": tcol.all_reduce(xs, topo, "sharding", op)
           for op in ("sum", "max", "min", "mean")},
        "all_gather": tcol.all_gather(xs, topo, ("dp", "sharding")),
        "all_gather_stacked": tcol.all_gather(xs, topo, "sharding",
                                              tiled=False, concat_dim=1),
        "all_to_all": tcol.all_to_all(xs, topo, "sharding", split_dim=0,
                                      concat_dim=1),
        "reduce_scatter": tcol.reduce_scatter(xs, topo, "dp"),
        "ppermute": tcol.ppermute(xs, topo, "sharding",
                                  [(i, (i + 1) % 4) for i in range(3)]),
    }


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collectives_bit_equal_and_unaliased(layout):
    """Every named-axis collective over two devices gives the bits of the
    one-device run, each member's result on its own device and sharing
    storage with no other member's (nor with an input)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 1, (8, 8, 3)).astype(np.float32))
    ref_topo = one_device(dp=2, sharding=4)
    topo = two_devices(layout, dp=2, sharding=4)
    want = _collectives(ref_topo, [x[k].clone() for k in range(8)])
    xs = topo.split(x, Spec(("dp", "sharding")))
    xs = [t[0] for t in xs]
    got = _collectives(topo, xs)
    ins = {_storage(t) for t in xs}
    for name, outs in got.items():
        ptrs = [_storage(t) for t in outs]
        if name != "reduce_scatter":
            assert len(set(ptrs)) == len(ptrs), name
        assert not (set(ptrs) & ins), name
        for k, (g, w) in enumerate(zip(outs, want[name])):
            assert torch.equal(g, w), (name, k)
    # the members of a one-device reduce_scatter hold disjoint views of
    # one sum: a write through one leaves the others
    rs = got["reduce_scatter"]
    before = [t.clone() for t in rs]
    rs[0].add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(rs[1:], before[1:]))


def test_group_sharded_optimizer_places_shards():
    """ZeRO stage 2 over two devices: each shard's owned slices on its
    device and the updated params bit-equal to the one-device run."""
    rng = np.random.default_rng(1)
    params = {"w": torch.as_tensor(rng.normal(0, 1, (8, 4))
                                   .astype(np.float32)),
              "b": torch.as_tensor(rng.normal(0, 1, (3,))
                                   .astype(np.float32))}
    grads = [{k: torch.as_tensor(rng.normal(0, 1, tuple(v.shape))
                                 .astype(np.float32))
              for k, v in params.items()} for _ in range(8)]
    outs = []
    for topo in (one_device(dp=2, sharding=4),
                 two_devices("interleaved", dp=2, sharding=4)):
        opt = tsharding.GroupShardedOptimizer(
            lambda ps: torch.optim.Adam(ps, lr=1e-2), topo)
        opt.init(params)
        for s, loc in enumerate(opt.local):
            for t in loc.values():
                assert same_device(t.device, topo.device_of(s))
        placed = tsharding.place_like(
            params, tsharding.zero_sharding(params, topo), topo)
        assert len(placed["w"]) == 8
        outs.append(opt.update({k: [g[k] for g in grads] for k in params},
                               params))
    for k in params:
        for a, b in zip(outs[0][k], outs[1][k]):
            assert torch.equal(a, b)


def test_fleet_init_carries_the_device_list():
    """fleet.init(strategy, topology) hands the two-device topology to
    the engine, which places the working set block by block."""
    topo = two_devices("halves", dp=4)
    f = tfleet.Fleet(None, topo)
    eng = f.init_engine(tcfg.EmbeddingTableConfig(embedding_dim=base.MF))
    assert eng.topology is topo and eng.device == TWO[0]
    ds = TDataset(base._feed_config(tcfg))
    ds._blocks = [base._block(TBlock, 0)]
    _open_pass(eng, ds)
    assert isinstance(eng.ws["mf"], Sharded)
    assert eng.ws["mf"].bytes_by_device().keys() == {"cpu:0", "cpu:1"}


def test_async_dense_table_on_two_devices():
    """The async dense table rides the replicas: the summed grads are
    pushed, the table's params land in every replica."""
    topo = two_devices("interleaved", dp=4, sharding=2)
    cfg = base._feed_config(tcfg)
    ds = TDataset(cfg)
    ds._blocks = [base._block(TBlock, 23)]
    eng = TEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=base.MF, sgd=tcfg.SparseSGDConfig(
            mf_create_thresholds=0.0)), topology=topo)
    _open_pass(eng, ds)
    tr = TTrainer(eng, TDeepFM(base.N_SLOTS, 3 + base.MF, base.DENSE_DIM,
                               hidden=(16,)), cfg, batch_size=base.B,
                  device="cpu", topology=topo,
                  trainer_config=tcfg.TrainerConfig(
                      dense_sync_mode="async_table", sync_weight_step=1))
    stats = tr.train_pass(tr.build_pass_feed(ds))
    assert stats["batches"] == 3 and np.all(np.isfinite(stats["losses"]))
    assert tr.async_dense.pushed == tr.async_dense.applied == 3
    final = tr.async_dense.pull()
    for rep in tr.dense_replicas():
        for n, p in rep.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), final[n])


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
def test_instance_dump_on_two_devices(tmp_path, packed):
    """The dump route reads the preds joined in batch order: the same ids
    and labels as the one-device topology's dump, the preds within the
    file's loss tolerance."""
    dumps = []
    for i, topo in enumerate((one_device(dp=4, sharding=2),
                              two_devices("interleaved", dp=4, sharding=2))):
        ds, eng, tr = torch_setup(17, topo)
        tr.trainer_config = tcfg.TrainerConfig(
            dump_path=str(tmp_path / str(i)))
        tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
        with open(tmp_path / str(i) / f"dump-pass-{eng.pass_id}.txt") as f:
            dumps.append([ln.rstrip("\n").split("\t") for ln in f])
    ref, got = dumps
    assert len(got) == len(ref) == 192
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    np.testing.assert_allclose([float(r[2]) for r in got],
                               [float(r[2]) for r in ref], rtol=1e-4,
                               atol=2e-6)


# -- what this slice does not place raises ----------------------------------------

def _refusal(what):
    return pytest.raises(NotImplementedError, match="item 4")


@pytest.mark.parametrize("path", ["mxu", "fast", "reference"])
def test_one_device_lowerings_refused(path):
    ds, _, tr = torch_setup(0, two_devices(dp=8), path=path)
    with _refusal(path):
        tr.train_pass(ds)


def test_auto_on_an_unshardable_mesh_refused():
    """auto on a mesh mxu_sharded cannot take resolves to fast, which
    has no placement on distinct devices."""
    _, _, tr = torch_setup(0, two_devices(dp=4, mp=2))
    with _refusal("fast"):
        tr._resolve_path()


def test_device_cache_refused():
    old = (tflags.get_flags("ps_device_cache"),
           tflags.get_flags("ps_device_cache_rows"))
    tflags.set_flags({"ps_device_cache": True, "ps_device_cache_rows": 64})
    try:
        with _refusal("cache"):
            TEngine(tcfg.EmbeddingTableConfig(embedding_dim=base.MF),
                    topology=two_devices(dp=2))
    finally:
        tflags.set_flags({"ps_device_cache": old[0],
                          "ps_device_cache_rows": old[1]})


def test_serving_freeze_and_quantize_refused():
    _, eng, _ = torch_setup(0, two_devices(dp=2))
    with _refusal("freeze"):
        eng.freeze_for_serving()
    with _refusal("quantize"):
        temb.quantize_working_set(eng.ws)


def test_page_view_models_refused():
    from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR
    topo = two_devices(dp=2)
    _, eng, _ = torch_setup(0, topo)
    cfg = tcfg.DataFeedConfig(slots=base._feed_config(tcfg).slots,
                              rank_offset=True, max_rank=3)
    model = RankAttentionCTR(base.N_SLOTS, 3 + base.MF, base.DENSE_DIM,
                             max_rank=3)
    with _refusal("rank_offset"):
        TTrainer(eng, model, cfg, batch_size=base.B, device="cpu",
                 topology=topo)


def test_plane_stager_refused():
    topo = two_devices(dp=2)
    ds, _, tr = torch_setup(0, topo)
    arrays = tr.pack_pass_host(ds)
    with _refusal("stager"):
        pf.upload_pass(arrays, tr.device, staged=pf.PlaneStager("cpu"),
                       topology=topo, shardings=tr.pass_shardings(arrays))


def test_multitask_trainer_refused():
    """The multi-task trainer's step is the one-device reference
    lowering: it refuses distinct devices when it is built."""
    from paddlebox_tpu_torch.models.mmoe import MMoE
    from paddlebox_tpu_torch.trainer.multitask import MultiTaskSparseTrainer
    topo = two_devices(dp=2)
    _, eng, _ = torch_setup(0, topo)
    model = MMoE(base.N_SLOTS, 3 + base.MF, base.DENSE_DIM, num_tasks=1)
    with _refusal("multitask"):
        MultiTaskSparseTrainer(eng, model, base._feed_config(tcfg),
                               base.B, ["label"], device="cpu",
                               topology=topo)


def test_graph_trainer_refused():
    from paddlebox_tpu_torch.graph.graph_table import GraphTable
    from paddlebox_tpu_torch.trainer.graph_trainer import \
        GraphEmbeddingTrainer
    _, eng, _ = torch_setup(0, two_devices(dp=2))
    graph = GraphTable(np.array([[1, 2], [2, 3]], np.int64), num_nodes=4,
                       device="cpu")
    with _refusal("graph"):
        GraphEmbeddingTrainer(eng, graph)
