"""The multi-pass day loop of the PyTorch port, against the JAX package
and against itself.

A small DeepFM (4 slots, mf_dim 4, hidden (16, 16), batch 64, 2 batches
per pass) trains 2 days × 3 passes through the engine lifecycle
(``set_date`` / ``begin_feed_pass`` / ``end_feed_pass`` / ``begin_pass`` /
``build_pass_feed`` / ``train_pass`` / ``end_pass``).  Inputs are numpy
seeded; the port runs on the CPU and starts from the JAX dense init.

* JAX ↔ port, serial loop, on the mxu and fast lowerings: per-pass losses
  and the final table (every key, every field) within rtol 1e-4 /
  atol 1e-6, integer fields equal.  f32 sums run in another order in XLA
  and in torch, and the differences compound over the passes through the
  optimizers.
* Port only, bit-identical: the ``PassPrefetcher`` loop against the
  serial loop on mxu, fast and ragged (losses, table, dense weights and
  the dense optimizer's state).
* Port only, the JAX package's own lifecycle tests: the stale-row
  refresh, a prefetch failure surfacing at ``next_pass``, and
  ``peek_next_mapper`` equal to the adopted mapper.
* The copied ``quality`` and ``faults`` modules give the same results
  through both packages.
"""

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.metrics import quality as jquality
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ps import faults as jfaults
from paddlebox_tpu_torch import flags as tflags
from paddlebox_tpu_torch.data.prefetch import PassPrefetcher
from paddlebox_tpu_torch.metrics import quality as tquality
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ps import faults as tfaults
from paddlebox_tpu_torch.utils.monitor import stat_get

import torch_parity_helpers as h

S, MF, DENSE, B = h.S, h.MF, h.DENSE, h.B
N_DAYS, N_PASSES, NB = 2, 3, 2
TOL = dict(rtol=1e-4, atol=1e-6)
DAYS = [f"2026080{d + 1}" for d in range(N_DAYS)]


def pass_data(pkg, day, p):
    """(feed config, one dataset of NB batches) of pass p of day."""
    cfg, data = h.datasets(pkg, seed=100 * day + 10 * p + 1, nb=NB)
    ds = pkg.Dataset(cfg)
    ds._blocks = [d.get_blocks()[0] for d in data]
    return cfg, ds


def make_engine(pkg):
    return pkg.Engine(pkg.Table(embedding_dim=MF, shard_num=4,
                                sgd=pkg.Sgd(mf_create_thresholds=0.0)),
                      seed=7, **pkg.kw)


def make_pair(pkg, path, params=None):
    eng = make_engine(pkg)
    cfg, _ = pass_data(pkg, 0, 0)
    if pkg is h.JAX:
        tr = pkg.Trainer(eng, JDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)),
                         cfg, batch_size=B, seed=3, sparse_path=path)
    else:
        tr = pkg.Trainer(eng, TDeepFM(S, 3 + MF, DENSE, hidden=(16, 16)),
                         cfg, batch_size=B, seed=3, sparse_path=path,
                         device="cpu")
        if params is not None:
            tr.model.load_jax_params(params)
    return eng, tr


def run_serial(pkg, eng, tr):
    """The serial day loop; per pass the train stats."""
    out = []
    for day in range(N_DAYS):
        eng.set_date(DAYS[day])
        for p in range(N_PASSES):
            _, ds = pass_data(pkg, day, p)
            eng.begin_feed_pass()
            for blk in ds.get_blocks():
                eng.add_keys(blk.all_keys())
            eng.end_feed_pass()
            eng.begin_pass()
            out.append(tr.train_pass(tr.build_pass_feed(ds)))
            eng.end_pass()
    return out


def run_prefetch(eng, tr):
    """The same loop through the PassPrefetcher (the port)."""
    out = []
    with PassPrefetcher(eng, tr) as pre:
        for day in range(N_DAYS):
            for p in range(N_PASSES):
                def load(day=day, p=p):
                    _, ds = pass_data(h.TORCH, day, p)
                    for blk in ds.get_blocks():
                        eng.add_keys(blk.all_keys())
                    return ds
                pre.submit(load, tag=f"d{day}p{p}", date=DAYS[day])
        for _ in range(N_DAYS * N_PASSES):
            feed = pre.next_pass()
            out.append(tr.train_pass(feed))
            pre.end_pass()
    return out


def table_state(table):
    keys = np.sort(table.export_keys())
    return keys, table.bulk_pull(keys)


@pytest.mark.parametrize("path", ["mxu", "fast"])
def test_day_loop_matches_jax(path):
    jeng, jtr = make_pair(h.JAX, path)
    teng, ttr = make_pair(h.TORCH, path,
                          jax.tree.map(np.asarray, jtr.params))
    jout, tout = run_serial(h.JAX, jeng, jtr), run_serial(h.TORCH, teng, ttr)
    np.testing.assert_allclose([m["loss"] for m in tout],
                               [m["loss"] for m in jout], **TOL)
    assert teng.day_id == jeng.day_id == DAYS[-1]
    assert teng.pass_id == jeng.pass_id == N_DAYS * N_PASSES
    jkeys, jrows = table_state(jeng.table)
    tkeys, trows = table_state(teng.table)
    np.testing.assert_array_equal(tkeys, jkeys)
    assert set(trows) == set(jrows)
    for f in jrows:
        want = np.asarray(jrows[f])
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(trows[f], want, err_msg=f)
        else:
            np.testing.assert_allclose(trows[f], want, err_msg=f, **TOL)


def assert_same_bits(a, b):
    (out_a, eng_a, tr_a), (out_b, eng_b, tr_b) = a, b
    assert [m["losses"] for m in out_a] == [m["losses"] for m in out_b]
    ka, sa = table_state(eng_a.table)
    kb, sb = table_state(eng_b.table)
    np.testing.assert_array_equal(ka, kb)
    for f in sa:
        np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
    for k, v in tr_a.model.state_dict().items():
        assert torch.equal(v, tr_b.model.state_dict()[k]), k
    st_a = tr_a.dense_opt.state_dict()["state"]
    st_b = tr_b.dense_opt.state_dict()["state"]
    for i in st_a:
        for k in st_a[i]:
            assert torch.equal(st_a[i][k], st_b[i][k]), (i, k)


@pytest.mark.parametrize("path", ["mxu", "fast", "ragged"])
def test_prefetched_loop_is_bit_identical(path):
    eng, tr = make_pair(h.TORCH, path)
    serial = (run_serial(h.TORCH, eng, tr), eng, tr)
    refresh0 = stat_get("ps.engine.stale_refresh_rows")
    eng2, tr2 = make_pair(h.TORCH, path)
    pref = (run_prefetch(eng2, tr2), eng2, tr2)
    # the refresh had rows to re-pull: consecutive passes share keys
    assert stat_get("ps.engine.stale_refresh_rows") > refresh0
    assert stat_get("data.prefetch.passes") >= N_DAYS * N_PASSES
    assert_same_bits(serial, pref)


def test_pipelined_pass_preload_refreshes_stale_rows():
    """An async next-pass build that pulled before the previous pass's
    write-back sees that write-back after adoption (JAX counterpart:
    test_fleet_api.py::test_pipelined_pass_preload_refreshes_stale_rows)."""
    eng = make_engine(h.TORCH)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, 11, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    eng.begin_feed_pass()
    eng.add_keys(np.arange(5, 16, dtype=np.uint64))
    eng.end_feed_pass(async_build=True)
    eng.wait_feed_pass_done()
    row5 = int(eng.mapper(np.array([5], np.uint64))[0])
    eng.ws["embed_w"][row5] = 3.25
    eng.end_pass()
    eng.begin_pass()
    row5b = int(eng.mapper(np.array([5], np.uint64))[0])
    assert float(eng.ws["embed_w"][row5b]) == 3.25
    eng.end_pass()


def test_peek_next_mapper_is_the_adopted_mapper():
    eng = make_engine(h.TORCH)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, 50, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    eng.begin_feed_pass()
    eng.add_keys(np.arange(30, 90, 3, dtype=np.uint64))
    eng.end_feed_pass(async_build=True)
    peeked = eng.peek_next_mapper()
    assert peeked is not eng.mapper
    eng.end_pass()
    eng.begin_pass()
    assert eng.mapper is peeked
    np.testing.assert_array_equal(eng.mapper.sorted_keys,
                                  np.arange(30, 90, 3, dtype=np.uint64))
    eng.end_pass()


def test_prefetch_failure_surfaces_at_next_pass():
    """A worker-side load failure fails that next_pass loudly (JAX
    counterpart: test_pass_pipeline.py::
    test_prefetch_failure_surfaces_at_next_pass)."""
    eng, tr = make_pair(h.TORCH, "fast")

    def boom():
        raise OSError("filesystem went away")

    with PassPrefetcher(eng, tr) as pre:
        pre.submit(boom, tag="doomed")
        with pytest.raises(RuntimeError, match="prefetch failed") as ei:
            pre.next_pass()
    assert isinstance(ei.value.__cause__, OSError)


def test_async_build_failure_raises_at_begin_pass():
    eng = make_engine(h.TORCH)

    def broken(keys):
        raise OSError("table shard unreadable")

    eng.table.bulk_pull = broken
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, 5, dtype=np.uint64))
    eng.end_feed_pass(async_build=True)
    with pytest.raises(RuntimeError, match="async working-set build"):
        eng.begin_pass()
    assert eng.ws is None


def test_quality_monitor_matches_jax():
    """The copied quality module: the same pass metrics give the same
    gauges in both packages."""
    rng = np.random.default_rng(5)
    got = []
    for mod in (jquality, tquality):
        mon = mod.QualityMonitor(window=3)
        res = []
        for p in range(4):
            pos = rng.integers(0, 20, 50).astype(float)
            neg = rng.integers(0, 20, 50).astype(float)
            res.append(mon.observe_pass(
                {"auc": 0.6 + 0.01 * p, "predicted_ctr": 0.3,
                 "actual_ctr": 0.25 + 0.01 * p,
                 "auc_buckets": {"pos": pos, "neg": neg}}))
            if p == 1:
                res.append(mon.end_day("d"))
        res.append(mon.end_day("e"))
        got.append(res)
        rng = np.random.default_rng(5)
    assert got[0] == got[1]
    assert "quality.psi.day" in got[1][-1]


def test_fault_plan_fires_alike_in_both_packages():
    """The copied faults module: one seeded plan fires at the same hits."""
    seqs = []
    for mod in (jfaults, tfaults):
        plan = (mod.FaultPlan(seed=13)
                .kill_at("end_pass", at=(1, 4))
                .drop("send", role="client", prob=0.3))
        seq = []
        for _ in range(12):
            for args in (("lifecycle", None, "end_pass"),
                         ("send", "client", None)):
                act = plan.fire(*args)
                seq.append(None if act is None else act.kind)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert any(s is not None for s in seqs[1])


def test_fault_install_needs_the_flag():
    with pytest.raises(RuntimeError):
        tfaults.install(tfaults.FaultPlan(seed=1))
    tflags.set_flags({"ps_fault_injection": True})
    try:
        tfaults.install(tfaults.FaultPlan(seed=1).kill_at("end_pass",
                                                          at=(0,)))
        eng = make_engine(h.TORCH)
        eng.begin_feed_pass()
        eng.add_keys(np.arange(1, 5, dtype=np.uint64))
        eng.end_feed_pass()
        eng.begin_pass()
        with pytest.raises(tfaults.InjectedFault):
            eng.end_pass()
        # the failed end_pass left the pass intact: a second one writes it
        assert eng.ws is not None and eng.mapper is not None
        eng.end_pass()
        assert eng.table.size() == 4
    finally:
        tfaults.uninstall()
        tflags.set_flags({"ps_fault_injection": False})


def test_feed_split_reset_metrics_and_pass_report():
    eng, tr = make_pair(h.TORCH, "mxu")
    eng.set_date(DAYS[0])
    _, ds = pass_data(h.TORCH, 0, 0)
    eng.begin_feed_pass()
    for blk in ds.get_blocks():
        eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    arrays = tr.pack_pass_host(ds)
    feed = tr.finish_pass_feed(arrays)
    ref = tr.build_pass_feed(ds)
    for k, v in ref.data.items():
        assert torch.equal(feed.data[k], v), k
    tr.train_pass(feed)
    assert float(tr.auc_state["pos"].sum() + tr.auc_state["neg"].sum()) \
        == NB * B
    tr.reset_metrics()
    assert float(tr.auc_state["pos"].sum()) == 0.0
    eng.end_pass()
    rep = eng.pass_report()
    assert rep.startswith(f"---- PrintSyncTimer pass 1 day {DAYS[0]}")
    assert "feed gap:" in rep and "dump_to_cpu" in rep
    eng.flip_phase()
    assert eng.phase == 0


def test_multitask_reset_metrics():
    from paddlebox_tpu_torch.models.mmoe import MMoE
    from paddlebox_tpu_torch.trainer.multitask import MultiTaskSparseTrainer
    cfg, data = h.datasets(h.TORCH, n_labels=2)
    eng = h.engine(h.TORCH, data)
    tr = MultiTaskSparseTrainer(eng, MMoE(S, 3 + MF, DENSE, num_experts=2,
                                          num_tasks=2),
                                cfg, batch_size=B,
                                label_slots=h.label_names(2), device="cpu")
    tr.train_pass(data[0])
    seen = tr.auc_state["pos"].sum(dim=1) + tr.auc_state["neg"].sum(dim=1)
    assert seen.tolist() == [float(B), float(B)]
    tr.reset_metrics()
    assert tr.auc_state["pos"].shape == (2, tr.auc_table_size)
    assert float(tr.auc_state["pos"].abs().sum()) == 0.0


def test_prefetch_bits_survive_thread_switch_stress():
    """The worker and the main thread share the engine (its pending pass,
    the agent sink, the pipeline counters): with the interpreter switching
    threads every few microseconds the prefetched loop still trains the
    serial loop's bits."""
    import sys
    eng, tr = make_pair(h.TORCH, "fast")
    serial = (run_serial(h.TORCH, eng, tr), eng, tr)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng2, tr2 = make_pair(h.TORCH, "fast")
        pref = (run_prefetch(eng2, tr2), eng2, tr2)
    finally:
        sys.setswitchinterval(old)
    assert_same_bits(serial, pref)
