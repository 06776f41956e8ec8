"""The one-device lowerings, the device row cache and the serving freeze
with the shards on distinct devices.

Explicit ``mxu``, ``fast`` and ``reference``, and ``auto`` on a mesh that
``mxu_sharded`` cannot take, run over a working set split into per-device
row blocks: each block pulls, merges and steps the rows it holds on its
own device, and the batch columns, the pooled values and the grads move
between devices only through the collectives.  Two devices on the CPU:
``cpu:0`` and ``cpu:1`` (``tests/test_torch_multicard.py``'s layouts
``halves`` and ``interleaved``), every move between them a copy.  The
configuration is ``tests/test_torch_mxu_sharded_trainer.py``'s (4 slots ×
capacity 3, mf_dim 4, 3 dense, DeepFM (16,), batch 64, three batches);
JAX runs the same lowering on the same mesh on its 8 virtual CPU devices
(``tests/conftest.py``), and the port's dense weights start from the JAX
trainer's.

Tolerances: the pass loss rtol 1e-4; the working set and the dense
params rtol 1e-5 / atol 1e-6; integer fields equal against JAX (the
blocks merge each row's occurrences in the one-device order, so the
same occurrence carries each row's slot); against the port's one-device
topology the slot column's touched rows equal.  Reruns, the cache on
against off, serial against prefetched, and the freeze against the
one-device freeze are held bit for bit.
"""

import numpy as np
import pytest
import jax
import torch

from paddlebox_tpu_torch import config as tcfg
from paddlebox_tpu_torch import fleet as tfleet
from paddlebox_tpu_torch import flags as tflags
from paddlebox_tpu_torch.data import pass_feed as pf
from paddlebox_tpu_torch.data.dataset import SlotDataset as TDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock as TBlock
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.parallel import collective as tcol
from paddlebox_tpu_torch.parallel.topology import (HybridTopology, Sharded,
                                                   Spec, same_device)
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine as TEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer as TTrainer
from paddlebox_tpu_torch.utils.monitor import stat_get

import test_torch_multicard as mc
import test_torch_mxu_sharded_trainer as base
import torch_day_loop as dl

PATHS = ("mxu", "fast", "reference")
MESHES = mc.MESHES


def setup(seed, topo, path, optimizer="adagrad", jparams=None, batch=base.B):
    """(dataset, engine, trainer) of the port over ``topo`` with the
    pass's working set built."""
    cfg = base._feed_config(tcfg)
    ds = TDataset(cfg)
    ds._blocks = [base._block(TBlock, seed)]
    eng = TEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=base.MF, sgd=tcfg.SparseSGDConfig(
            optimizer=optimizer, mf_create_thresholds=0.0)),
        topology=topo)
    mc._open_pass(eng, ds)
    tr = TTrainer(eng, TDeepFM(base.N_SLOTS, 3 + base.MF, base.DENSE_DIM,
                               hidden=(16,)),
                  cfg, batch_size=batch, seed=0, topology=topo,
                  sparse_path=path, device="cpu")
    if jparams is not None:
        tr.model.load_jax_params(jparams)
    return ds, eng, tr


def against_jax(seed, degrees, path, packed, layout, optimizer="adagrad",
                batch=base.B):
    """The same pass through the JAX package on ``degrees`` and the port
    on two devices; returns the trainer's resolved lowering."""
    jds, jeng, jtr = base._setup("jax", seed, degrees, path, optimizer,
                                 batch=batch)
    jparams = jax.tree.map(np.asarray, jtr.params)
    tds, teng, ttr = setup(seed, mc.two_devices(layout, **degrees), path,
                           optimizer, jparams, batch)
    assert isinstance(teng.ws["show"], Sharded)
    ws0_j, ws0_t = base._ws(jeng), base._ws(teng)
    for k in ws0_j:
        np.testing.assert_array_equal(ws0_t[k], ws0_j[k], err_msg=k)
    js = base._train(jds, jtr, packed)
    ts = base._train(tds, ttr, packed)
    base.assert_matches_jax(js, base._ws(jeng),
                            jax.tree.map(np.asarray, jtr.params), ts,
                            base._ws(teng), ttr)
    assert ttr._resolve_path() == jtr._resolve_path()
    return ttr._resolve_path()


def port_run(seed, topo, path, packed, jparams=None, optimizer="adagrad",
             progress=None):
    ds, eng, tr = setup(seed, topo, path, optimizer, jparams)
    feed = tr.build_pass_feed(ds) if packed else ds
    stats = tr.train_pass(feed, progress=(None if progress is None
                                          else lambda i: progress(tr, i)))
    return stats, base._ws(eng), tr


# -- against the JAX package on the same mesh ----------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("path", PATHS)
def test_lowering_matches_jax(path, mesh, packed):
    """Explicit mxu / fast / reference, streaming and packed, against the
    JAX package's same lowering on the same mesh (GSPMD's answer for the
    sharded table and batch)."""
    layout = "interleaved" if packed else "halves"
    assert against_jax(7, MESHES[mesh], path, packed, layout) == path


@pytest.mark.parametrize("optimizer,want", [("adagrad", "fast"),
                                            ("adam", "reference")])
def test_auto_on_an_unshardable_mesh_matches_jax(optimizer, want):
    """dp 4 × mp 2 is no mesh for mxu_sharded: auto resolves to fast
    under adagrad and to reference under the other rules, as in JAX,
    and trains there; shards 2k and 2k + 1 hold the same batch columns,
    counted once (halves: on one device; interleaved: on two)."""
    for layout, packed in (("halves", False), ("interleaved", True)):
        assert against_jax(3, dict(dp=4, mp=2), "auto", packed, layout,
                           optimizer) == want


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
def test_batch_the_shards_do_not_divide(packed):
    """A batch of 60 over dp 8: auto resolves to fast in both packages
    (the JAX package's device_put then refuses the uneven split); here
    each shard's block of ceil(60 / 8) = 8 columns ends in empty records
    that pool nothing, weigh nothing in the loss and push nothing, so the
    pass is the one-device topology's."""
    _, _, jtr = base._setup("jax", 5, dict(dp=8), "auto", batch=60)
    out = []
    for topo in (mc.one_device(dp=8), mc.two_devices("interleaved", dp=8)):
        ds, eng, tr = setup(5, topo, "auto", batch=60)
        assert tr._resolve_path() == jtr._resolve_path() == "fast"
        stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
        assert stats["batches"] == 4
        out.append((stats, base._ws(eng), tr))
    (ref, ws_ref, tr_ref), (got, ws, tr) = out
    mc.close_to(got, ws, ref, ws_ref, mc._params(tr), mc._params(tr_ref))


# -- against the port's one-device topology --------------------------------------

@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("path", PATHS)
def test_lowering_matches_one_device(path, mesh, layout):
    """Streaming and packed, from the same dense weights: within the
    file's tolerances of the same mesh with every shard on one device."""
    degrees = MESHES[mesh]
    jparams = mc._jax_params(5, degrees)
    for packed in (False, True):
        ref, ws_ref, tr_ref = port_run(5, mc.one_device(**degrees), path,
                                       packed, jparams)
        got, ws, tr = port_run(5, mc.two_devices(layout, **degrees), path,
                               packed, jparams)
        assert tr._resolve_path() == path
        np.testing.assert_allclose(got["auc"], ref["auc"], rtol=1e-4)
        mc.close_to(got, ws, ref, ws_ref, mc._params(tr), mc._params(tr_ref))


@pytest.mark.parametrize("path", PATHS)
def test_reruns_bit_identical(path):
    topo = mc.two_devices("interleaved", dp=2, sharding=4)
    for packed in (False, True):
        a, ws_a, tr_a = port_run(11, topo, path, packed)
        b, ws_b, tr_b = port_run(11, topo, path, packed)
        assert a["losses"] == b["losses"]
        for k in ws_a:
            np.testing.assert_array_equal(ws_a[k], ws_b[k], err_msg=k)
        for x, y in zip(mc._params(tr_a), mc._params(tr_b)):
            np.testing.assert_array_equal(x, y)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("path", PATHS)
def test_every_step_places_each_block_on_its_device(path):
    """After every step of the packed pass: each working-set block, feed
    column and (mxu) row-block plan on its shard's device, no storage
    shared between the devices, the table replicas (dp × sharding) and
    the dense replicas bit-equal and apart."""
    topo = mc.two_devices("halves", dp=2, sharding=4)
    ds, eng, tr = setup(13, topo, path)
    feed = tr.build_pass_feed(ds)
    seen = {"steps": 0}

    def owners(tensors_by_shard):
        out = {}
        for k, t in tensors_by_shard:
            assert same_device(t.device, topo.device_of(k))
            out.setdefault(_storage(t), set()).add(str(topo.device_of(k)))
        assert all(len(d) == 1 for d in out.values())

    def check(i):
        seen["steps"] += 1
        for f, t in eng.ws.items():
            owners(t.unique())
            first = {}
            for k, blk in t.unique():
                row0 = t.rows(k).start
                if row0 in first:
                    assert torch.equal(blk, first[row0]), f
                    assert _storage(blk) != _storage(first[row0])
                first.setdefault(row0, blk)
        for name, t in feed.data.items():
            owners(t.unique())
        if path == "mxu":
            homes = [k for k, _, _ in eng.ws["show"].row_blocks()]
            assert feed.plan_shards == homes
            for key, parts in feed.plans.items():
                owners(list(zip(homes, parts)))
        else:
            assert feed.plans is None
        reps = tr.dense_replicas()
        assert len(reps) == 2
        for a, b in zip(reps[0].parameters(), reps[1].parameters()):
            assert torch.equal(a, b) and _storage(a) != _storage(b)

    stats = tr.train_pass(feed, progress=check)
    assert seen["steps"] == stats["batches"] == 3
    per = feed.bytes_by_device()
    assert set(per) == {"cpu:0", "cpu:1"}


def test_batch_columns_pad_the_last_block():
    a = np.arange(2 * 10).reshape(2, 10)
    blocks = [pf.batch_columns(a, 1, i, 4) for i in range(4)]
    assert all(x.shape == (2, 3) for x in blocks)
    np.testing.assert_array_equal(np.concatenate(blocks, 1)[:, :10], a)
    np.testing.assert_array_equal(blocks[3][:, 1:], 0)


# -- the per-block operations and the collectives they use ------------------------

@pytest.mark.parametrize("layout,crossed", [("halves", (0, 6)),
                                             ("interleaved", (3, 3))])
def test_sharded_row_operations_match_one_tensor(layout, crossed):
    """``Sharded.gather_rows`` / ``scatter_rows`` / ``map_blocks`` /
    ``locate`` on two devices give what the same ops give on one tensor,
    and count the rows that crossed between devices.  dp 2 × sharding 4:
    halves puts node 1's replica of every block on cpu:1 (reads come
    from node 0, writes reach both); interleaved puts blocks 1 and 3,
    both replicas, on cpu:1."""
    topo = mc.two_devices(layout, dp=2, sharding=4)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 1, (64, 3)).astype(np.float32))
    t = topo.place(x, topo.table_spec())
    assert len(t.row_blocks()) == 4
    rows = np.array([63, 0, 17, 16, 40, 5])
    which, local = t.locate(torch.as_tensor(rows))
    assert which.tolist() == [3, 0, 1, 1, 2, 0]
    assert local.tolist() == [15, 0, 1, 0, 8, 5]
    got, moved = t.gather_rows(rows, "cpu:0")
    assert torch.equal(got, x[torch.as_tensor(rows)])
    assert moved == crossed[0]
    vals = torch.as_tensor(rng.normal(0, 1, (6, 3)).astype(np.float32))
    moved = t.scatter_rows(rows, vals, "cpu:0")
    want = x.clone()
    want[torch.as_tensor(rows)] = vals
    for k, blk in t.unique():
        assert torch.equal(blk, want[t.rows(k)])
    assert moved == crossed[1]
    neg = t.map_blocks(torch.neg)
    assert torch.equal(neg.join("cpu"), -want)
    assert {id(p) for p in neg.parts} & {id(p) for p in t.parts} == set()


@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
def test_gather_and_reduce_scatter_onto(layout):
    devs = mc.LAYOUTS[layout](4)
    rng = np.random.default_rng(1)
    xs = [torch.as_tensor(rng.normal(0, 1, (3, 8)).astype(np.float32))
          for _ in range(4)]
    got = tcol.gather_onto(xs, devs, devs[:2], dim=1)
    want = torch.cat(xs, dim=1)
    assert all(torch.equal(g, want) for g in got)
    assert _storage(got[0]) not in {_storage(x) for x in xs}
    topo = HybridTopology(tcfg.MeshConfig(dp=4), devices=devs)
    srcs = [(k,) for k in range(4)]
    red = tcol.reduce_scatter_onto_shards(xs, srcs, range(4), topo, dim=1)
    total = xs[0] + xs[1] + xs[2] + xs[3]
    for j, r in enumerate(red):
        assert torch.equal(r, total[:, 2 * j:2 * j + 2])
        assert same_device(r.device, devs[j])
    assert len({_storage(r) for r in red}) == 4
    with pytest.raises(ValueError, match="does not split"):
        tcol.reduce_scatter_onto_shards(xs, srcs, range(3), topo, dim=1)
    whole = tcol.reduce_scatter_onto_shards(xs, srcs, [1], topo, dim=None)
    assert torch.equal(whole[0], total)


# -- the day loop with the device row cache ---------------------------------------

@pytest.fixture
def clean_flags():
    names = ("ps_device_cache", "ps_device_cache_rows", "ps_fault_injection")
    old = {n: tflags.get_flags(n) for n in names}
    yield
    faults.uninstall()
    tflags.set_flags(old)


def _day_trio(topo, path):
    cfg = base._feed_config(tcfg)
    eng = TEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=base.MF, shard_num=4,
        sgd=tcfg.SparseSGDConfig(mf_create_thresholds=0.0)),
        seed=0, topology=topo)
    ds = tfleet.BoxPSDataset(cfg, engine=eng, read_threads=1)
    tr = TTrainer(eng, TDeepFM(base.N_SLOTS, 3 + base.MF, base.DENSE_DIM,
                               hidden=(16,)),
                  cfg, batch_size=32, seed=0, topology=topo,
                  sparse_path=path, device="cpu")
    return eng, ds, tr


def _pass_files(tmp_path, n=4):
    files = []
    for p in range(n):
        path = str(tmp_path / f"p{p}.txt")
        rng = np.random.default_rng(p)
        with open(path, "w") as f:
            for _ in range(64):
                parts = [f"1 {rng.integers(0, 2)}",
                         "3 " + " ".join(f"{rng.normal():.4f}"
                                         for _ in range(3))]
                for _s in range(base.N_SLOTS):
                    k = rng.integers(1, base.CAP + 1)
                    parts.append(f"{k} " + " ".join(
                        str(rng.integers(1, 300)) for _ in range(k)))
                f.write(" ".join(parts) + "\n")
        files.append([path])
    return files


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["serial", "prefetch"])
@pytest.mark.parametrize("path,degrees", [("auto", dict(dp=2)),
                                          ("mxu", dict(dp=2, sharding=2))],
                         ids=["mxu_sharded_dp2", "mxu_dp2xsharding2"])
def test_day_loop_cache_on_equals_off(tmp_path, clean_flags, prefetch, path,
                                      degrees):
    """Four passes of a day on two devices (interleaved): with the
    device cache on and a kill at the second write-back (resumed from
    the checkpoint) the host table, the losses and the dense state equal
    the cache-off fault-free run bit for bit, the warm passes hit, and
    the hits crossed between the store and the blocks as copies."""
    files = _pass_files(tmp_path)
    topo = mc.two_devices("interleaved", **degrees)
    dl.cache_off()
    eng1, ds1, tr1 = _day_trio(topo, path)
    base_run = tfleet.train_passes(tr1, ds1, files, date="20260801",
                                   prefetch=False)
    dl.cache_on(4096)
    tflags.set_flags({"ps_fault_injection": True})
    eng2, ds2, tr2 = _day_trio(topo, path)
    assert eng2.cache is not None
    hits0 = stat_get("ps.cache.hits")
    copies0 = stat_get("ps.cache.device_copy_rows")
    faults.install(faults.FaultPlan(seed=13).kill_at("end_pass", at=(1,)))
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    run = tfleet.train_passes(tr2, ds2, files, date="20260801",
                              prefetch=prefetch, checkpoint=ck, resume=4)
    faults.uninstall()
    dl.assert_same_bits((base_run, eng1, tr1), (run, eng2, tr2))
    assert stat_get("ps.fault.lifecycle.kill") >= 1
    assert stat_get("ps.cache.hits") > hits0
    assert stat_get("ps.cache.device_copy_rows") > copies0


def test_day_loop_serial_equals_prefetched_with_the_cache(tmp_path,
                                                          clean_flags):
    """The prefetched day (pass N + 1's snapshot taken before pass N
    folds back) lands on the serial day's bits with the cache on."""
    files = _pass_files(tmp_path)
    topo = mc.two_devices("halves", dp=4, mp=2)
    dl.cache_on(4096)
    out = []
    for prefetch in (False, True):
        eng, ds, tr = _day_trio(topo, "auto")
        out.append((tfleet.train_passes(tr, ds, files, date="20260801",
                                        prefetch=prefetch), eng, tr))
    dl.assert_same_bits(*out)


# -- the serving freeze -------------------------------------------------------------

def _frozen_pair(layout, degrees):
    """Two engines over the same keys and rows, one on one device and one
    on two, both frozen."""
    out = []
    for topo in (mc.one_device(**degrees), mc.two_devices(layout,
                                                          **degrees)):
        _, eng, _ = setup(21, topo, "auto")
        # trained values: a pass of the one-device lowering's rule
        rng = np.random.default_rng(4)
        mf = rng.normal(0, 0.01, tuple(eng.ws["mf"].shape)).astype(
            np.float32)
        mf[0] = 0.0
        n = eng.num_keys
        temb.write_rows(eng.ws, np.arange(1, n + 1),
                        {"mf": mf[1:n + 1],
                         "mf_size": np.full((n,), base.MF, np.int32)})
        eng.freeze_for_serving()
        out.append(eng)
    return out


@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_freeze_blocks_equal_the_one_device_freeze(layout, mesh):
    one, two = _frozen_pair(layout, MESHES[mesh])
    q = two.ws["mf"]
    assert isinstance(q, Sharded) and q.dtype == torch.int16
    assert torch.equal(q.join("cpu"), one.ws["mf"])
    topo = q.topo
    for k, blk in q.unique():
        sl = q.rows(k)
        assert torch.equal(blk, one.ws["mf"][sl])
        scale = two.ws["mf_scale"].parts[k]
        assert scale.dim() == 0 and scale.dtype == torch.float32
        assert same_device(scale.device, topo.device_of(k))
        assert torch.equal(scale, one.ws["mf_scale"])
    stores = {}
    for k, blk in q.unique():
        stores.setdefault(_storage(blk), set()).add(str(topo.device_of(k)))
    assert all(len(d) == 1 for d in stores.values())


@pytest.mark.parametrize("layout", list(mc.LAYOUTS))
def test_frozen_pull_equals_the_one_device_pull(layout):
    one, two = _frozen_pair(layout, dict(dp=2, sharding=4))
    rng = np.random.default_rng(8)
    idx = torch.as_tensor(rng.integers(0, one.num_keys + 1,
                                       (base.N_SLOTS, 16, base.CAP)),
                          dtype=torch.int32)
    want = temb.pull_sparse(one.ws, idx)
    got = temb.pull_sparse(two.ws, idx)
    assert torch.equal(got, want)
    assert not torch.equal(want[..., 3:], torch.zeros_like(want[..., 3:]))


def test_frozen_set_refuses_training_and_write_back():
    topo = mc.two_devices("interleaved", dp=2)
    ds, eng, tr = setup(2, topo, "fast")
    eng.freeze_for_serving()
    with pytest.raises(ValueError, match="serving-frozen"):
        tr.train_pass(ds)
    with pytest.raises(RuntimeError, match="serving-frozen"):
        eng.end_pass()


def test_quantize_working_set_on_blocks():
    """``quantize_working_set`` on a ``Sharded`` set: each block's grid
    is the one-tensor grid of its rows; the f32 set stays as it was."""
    topo = mc.two_devices("halves", dp=4)
    rng = np.random.default_rng(3)
    mf = torch.as_tensor(rng.normal(0, 0.2, (64, 4)).astype(np.float32))
    ws = {"mf": topo.place(mf, topo.table_spec())}
    out = temb.quantize_working_set(ws)
    want = temb.quantize_working_set({"mf": mf})
    assert torch.equal(out["mf"].join("cpu"), want["mf"])
    assert out["mf_scale"].spec == Spec()
    assert torch.equal(ws["mf"].join("cpu"), mf)
