"""``fleet.train_passes`` of the PyTorch port over slot text files: against
the JAX package, prefetched against serial, and crash-resumed against a
fault-free run.

Three passes of 48 records (4 slots, mf_dim 4, DeepFM hidden (8,), batch
32) are written as MultiSlot text files and read with one reader thread,
so block order is deterministic.

* JAX ↔ port on the mxu lowering: per-pass losses and the final table
  within rtol 1e-4 / atol 1e-6 (f32 sums run in another order in XLA and
  in torch), integer fields equal.
* Port only, bit-identical: the prefetched loop against the serial one;
  each seeded kill point (``end_pass`` serial and prefetched,
  ``ckpt_sparse``, ``ckpt_commit``) resumed from a ``TrainCheckpoint``
  against the fault-free run (losses, table, dense weights); and a
  completed day re-run is a no-op (counterparts of the JAX package's
  test_crash_recovery.py).
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu import fleet as jfleet
from paddlebox_tpu.config import DataFeedConfig as JFeed
from paddlebox_tpu.config import EmbeddingTableConfig as JTable
from paddlebox_tpu.config import SlotConfig as JSlot
from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.trainer.trainer import SparseTrainer as JTrainer
from paddlebox_tpu_torch import flags, fleet
from paddlebox_tpu_torch.config import DataFeedConfig, EmbeddingTableConfig
from paddlebox_tpu_torch.config import SlotConfig, SparseSGDConfig
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.ps.service import ServerErrorReply
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get

N_PASSES, CAP, RECORDS = 3, 3, 48
TOL = dict(rtol=1e-4, atol=1e-6)
DATE = "20260801"


@pytest.fixture(autouse=True)
def _clean():
    StatRegistry.instance().reset()
    flags.set_flags({"ps_fault_injection": True})
    yield
    faults.uninstall()
    flags.set_flags({"ps_fault_injection": False})


def feed_slots(slot):
    return tuple([slot("label", dtype="float", is_dense=True, dim=1),
                  slot("dense0", dtype="float", is_dense=True, dim=3)]
                 + [slot(f"s{i}", slot_id=100 + i, capacity=CAP)
                    for i in range(4)])


def write_slot_file(path, rng, n):
    with open(path, "w") as f:
        for _ in range(n):
            parts = [f"1 {rng.integers(0, 2)}",
                     "3 " + " ".join(f"{rng.normal():.4f}"
                                     for _ in range(3))]
            for _s in range(4):
                k = rng.integers(1, CAP + 1)
                parts.append(f"{k} " + " ".join(
                    str(rng.integers(1, 500)) for _ in range(k)))
            f.write(" ".join(parts) + "\n")


@pytest.fixture(scope="module")
def pass_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch-passes")
    files = []
    for p in range(N_PASSES):
        path = str(d / f"p{p}.txt")
        write_slot_file(path, np.random.default_rng(p), RECORDS)
        files.append([path])
    return files


def fresh(path="fast", params=None):
    """A deterministic engine/dataset/trainer trio of the port."""
    cfg = DataFeedConfig(slots=feed_slots(SlotConfig))
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=4, shard_num=4,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0,
        device="cpu")
    ds = fleet.BoxPSDataset(cfg, engine=eng, read_threads=1)
    tr = SparseTrainer(eng, DeepFM(4, 3 + 4, 3, hidden=(8,)), cfg,
                       batch_size=32, seed=0, sparse_path=path,
                       device="cpu")
    if params is not None:
        tr.model.load_jax_params(params)
    return eng, ds, tr


def table_state(table):
    keys = np.sort(table.export_keys())
    return keys, table.bulk_pull(keys)


def assert_same_run(a, b):
    (eng_a, tr_a, m_a), (eng_b, tr_b, m_b) = a, b
    assert [m["losses"] for m in m_a] == [m["losses"] for m in m_b]
    ka, sa = table_state(eng_a.table)
    kb, sb = table_state(eng_b.table)
    np.testing.assert_array_equal(ka, kb)
    for f in sa:
        np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
    for k, v in tr_a.model.state_dict().items():
        assert torch.equal(v, tr_b.model.state_dict()[k]), k


@pytest.fixture(scope="module")
def baseline(pass_files):
    """Fault-free serial run — the state every resumed run must hit."""
    eng, ds, tr = fresh()
    metrics = fleet.train_passes(tr, ds, pass_files, date=DATE,
                                 prefetch=False)
    return eng, tr, metrics


def test_train_passes_matches_jax(pass_files):
    jcfg = JFeed(slots=feed_slots(JSlot))
    jeng = JEngine(JTable(embedding_dim=4, shard_num=4,
                          sgd=JSgd(mf_create_thresholds=0.0)), seed=0)
    jds = jfleet.BoxPSDataset(jcfg, engine=jeng, read_threads=1)
    jtr = JTrainer(jeng, JDeepFM(4, 3 + 4, 3, hidden=(8,)), jcfg,
                   batch_size=32, seed=0, sparse_path="mxu")
    teng, tds, ttr = fresh("mxu", jax.tree.map(np.asarray, jtr.params))
    jm = jfleet.train_passes(jtr, jds, pass_files, date=DATE,
                             prefetch=False)
    tm = fleet.train_passes(ttr, tds, pass_files, date=DATE, prefetch=True)
    assert [m["batches"] for m in tm] == [m["batches"] for m in jm] \
        == [2] * N_PASSES
    np.testing.assert_allclose([m["loss"] for m in tm],
                               [m["loss"] for m in jm], **TOL)
    jkeys, jrows = table_state(jeng.table)
    tkeys, trows = table_state(teng.table)
    np.testing.assert_array_equal(tkeys, jkeys)
    for f in jrows:
        want = np.asarray(jrows[f])
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(trows[f], want, err_msg=f)
        else:
            np.testing.assert_allclose(trows[f], want, err_msg=f, **TOL)


@pytest.mark.parametrize("path", ["fast", "ragged"])
def test_prefetched_train_passes_bit_identical(pass_files, baseline, path):
    runs = []
    for prefetch in (False, True):
        eng, ds, tr = fresh(path)
        runs.append((eng, tr, fleet.train_passes(
            tr, ds, pass_files, date=DATE, prefetch=prefetch)))
    assert_same_run(*runs)
    if path == "fast":
        assert_same_run(baseline, runs[1])


@pytest.mark.parametrize("point,hit,prefetch", [
    ("end_pass", 1, False),      # pass-1 write-back dies, serial loop
    ("end_pass", 1, True),       # the same death through the prefetcher
    ("ckpt_sparse", 1, False),   # shard files down, generation not built
    ("ckpt_commit", 1, False),   # generation built, MANIFEST not swapped
])
def test_kill_point_resume_bit_identical(pass_files, baseline, tmp_path,
                                         point, hit, prefetch):
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    eng, ds, tr = fresh()
    faults.install(faults.FaultPlan(seed=13).kill_at(point, at=(hit,)))
    metrics = fleet.train_passes(tr, ds, pass_files, date=DATE,
                                 prefetch=prefetch, checkpoint=ck, resume=4)
    faults.uninstall()
    assert len(metrics) == N_PASSES and all(m is not None for m in metrics)
    assert_same_run(baseline, (eng, tr, metrics))
    assert stat_get("ps.fleet.auto_resume") >= 1
    assert stat_get("ps.fault.lifecycle.kill") >= 1
    assert flight.events(kind="resume_ok")
    assert not [n for n in os.listdir(ck.root) if n.endswith(".tmp")]


def test_completed_day_rerun_is_noop(pass_files, tmp_path):
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    eng, ds, tr = fresh()
    m1 = fleet.train_passes(tr, ds, pass_files, date=DATE, prefetch=False,
                            checkpoint=ck, resume=2)
    assert all(m is not None for m in m1)
    eng2, ds2, tr2 = fresh()
    m2 = fleet.train_passes(tr2, ds2, pass_files, date=DATE, prefetch=True,
                            checkpoint=ck, resume=2)
    assert m2 == [None] * N_PASSES
    ka, sa = table_state(eng.table)
    kb, sb = table_state(eng2.table)
    np.testing.assert_array_equal(ka, kb)
    for f in sa:
        np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, tr2.model.state_dict()[k]), k


def test_dataset_verbs(pass_files):
    """The BoxPSDataset verbs a reference user drives by hand."""
    eng, ds, tr = fresh()
    ds2 = fleet.DatasetFactory().create_dataset(
        "BoxPSDataset", feed_config=ds.feed_config, engine=eng,
        read_threads=1)
    assert isinstance(ds2, fleet.BoxPSDataset)
    with pytest.raises(ValueError):
        fleet.DatasetFactory().create_dataset("QueueDataset")
    ds.set_date(DATE)
    ds.set_filelist(pass_files[0])
    ds.preload_into_memory()
    ds.wait_preload_done()
    assert ds.get_memory_data_size() == RECORDS
    before = [b.uint64_slots["s1"][0].copy() for b in ds.dataset.get_blocks()]
    ds.slots_shuffle(["s1"])
    after = [b.uint64_slots["s1"][0] for b in ds.dataset.get_blocks()]
    assert sorted(np.concatenate(before)) == sorted(np.concatenate(after))
    ds.begin_pass()
    stats = fleet.train_from_dataset(tr, ds)
    assert stats["batches"] == 2 and np.isfinite(stats["loss"])
    ds.end_pass()
    assert eng.pass_id == 1 and eng.table.size() > 0
    f = fleet.init()
    assert fleet.instance() is f and f.worker_num == 1
    assert f.init_engine(eng.config, device="cpu").device.type == "cpu"


def test_kill_under_slow_prefetch_load_waits_for_worker(pass_files, baseline,
                                                        tmp_path):
    """A kill at end_pass while the prefetch worker is still inside the
    next pass's (slow) load: the resume tier must not reset the feed or
    reload the table until the worker has returned, and the re-driven
    day matches the fault-free run."""
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    eng, ds, tr = fresh()
    state = {"calls": 0, "in_load": False, "resets_in_load": []}
    load = ds.dataset.load_into_memory

    def slow_load(*a, **kw):
        state["calls"] += 1
        state["in_load"] = True
        try:
            if state["calls"] == 3:       # pass 2, loading under pass 1
                time.sleep(0.5)
            return load(*a, **kw)
        finally:
            state["in_load"] = False

    reset = eng.reset_feed_state

    def watched_reset():
        state["resets_in_load"].append(state["in_load"])
        reset()

    ds.dataset.load_into_memory = slow_load
    eng.reset_feed_state = watched_reset
    faults.install(faults.FaultPlan(seed=13).kill_at("end_pass", at=(1,)))
    metrics = fleet.train_passes(tr, ds, pass_files, date=DATE,
                                 prefetch=True, checkpoint=ck, resume=4)
    faults.uninstall()
    assert state["calls"] >= 4 and state["resets_in_load"]
    assert not any(state["resets_in_load"])
    assert stat_get("ps.fleet.auto_resume") >= 1
    assert_same_run(baseline, (eng, tr, metrics))


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("exc,resumed", [
    (ConnectionError, True),     # a lost peer: rolled back and re-driven
    (ServerErrorReply, True),    # a PS server's error reply, as in JAX
    (AssertionError, False),     # a fault of the program: propagates
    (RuntimeError, False),       # not caused by a lost connection
])
def test_resume_tier_takes_only_connection_faults(pass_files, baseline,
                                                  tmp_path, prefetch, exc,
                                                  resumed):
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    eng, ds, tr = fresh()
    calls = [0]

    def before_pass(_ds):
        calls[0] += 1
        if calls[0] == 2:
            raise exc("pass 1 fails once")

    if resumed:
        metrics = fleet.train_passes(tr, ds, pass_files, date=DATE,
                                     before_pass=before_pass,
                                     prefetch=prefetch, checkpoint=ck,
                                     resume=4)
        assert stat_get("ps.fleet.auto_resume") == 1
        assert_same_run(baseline, (eng, tr, metrics))
    else:
        with pytest.raises((exc, RuntimeError)) as info:
            fleet.train_passes(tr, ds, pass_files, date=DATE,
                               before_pass=before_pass, prefetch=prefetch,
                               checkpoint=ck, resume=4)
        cause = info.value.__cause__ if prefetch else info.value
        assert type(cause) is exc
        assert stat_get("ps.fleet.auto_resume") == 0
