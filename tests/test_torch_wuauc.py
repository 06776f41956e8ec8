"""The port's per-user AUC family and metric registry against the JAX
package's.

* ``WuAucCalculator`` (uauc / wuauc over pred ties, single-class users,
  non-finite and out-of-range preds) and ``MetricGroup`` (auc, wuauc,
  multi_task and cmatch_rank metrics, the phase flip, their errors, and
  ``merge_device_state`` of the port's torch bucket state): equal to the
  JAX package's within 1e-9 on the same numpy records (host float64 in
  both packages).
* ``uid_slot`` through ``SparseTrainer`` on the streaming and packed
  entry points (mxu) and through ``MultiTaskSparseTrainer``: uauc, wuauc
  and the user count against the JAX package's pass, the preds' f32
  rounding aside (rtol 1e-4).
* ``Fleet.metrics`` is a ``MetricGroup``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.metrics.auc import (MetricGroup as JGroup,
                                       WuAucCalculator as JWuAuc)
from paddlebox_tpu.models.ctr_dnn import CtrDnn as JCtrDnn
from paddlebox_tpu.models.mmoe import MMoE as JMMoE
from paddlebox_tpu.trainer.multitask import (
    MultiTaskSparseTrainer as JMultiTask)
from paddlebox_tpu_torch import fleet
from paddlebox_tpu_torch.metrics.auc import (MetricGroup as TGroup,
                                             WuAucCalculator as TWuAuc,
                                             accumulate_auc, make_auc_state)
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn as TCtrDnn
from paddlebox_tpu_torch.models.mmoe import MMoE as TMMoE
from paddlebox_tpu_torch.trainer.multitask import (
    MultiTaskSparseTrainer as TMultiTask)

import torch_parity_helpers as h

E = 3 + h.MF
EXACT = dict(rtol=1e-9, atol=1e-9)


def _assert_msg_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **EXACT)


def _records(seed, n=400):
    rng = np.random.default_rng(seed)
    uid = rng.integers(1, 25, n).astype(np.uint64)
    pred = np.round(rng.random(n), 1)       # quantized: pred-tie groups
    label = (rng.random(n) < pred).astype(np.int64)
    return uid, pred, label


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wuauc_matches_jax(seed):
    uid, pred, label = _records(seed)
    mask = np.random.default_rng(seed + 9).random(len(uid)) < 0.9
    calcs = (TWuAuc(), JWuAuc())
    for c in calcs:
        for lo in range(0, len(uid), 128):
            sl = slice(lo, lo + 128)
            c.add_data(pred[sl], label[sl], uid[sl], mask[sl])
    _assert_msg_equal(calcs[0].compute(), calcs[1].compute())


@pytest.mark.parametrize("case", ["single_class", "empty", "non_finite",
                                  "out_of_range"])
def test_wuauc_edge_cases_match_jax(case):
    feeds = {
        "single_class": [([0.9, 0.8, 0.3], [1, 1, 1], [5, 5, 5]),
                         ([0.7, 0.2], [1, 0], [6, 6])],
        "empty": [],
        "non_finite": [([0.5, np.nan, np.inf], [0, 1, 1], [7, 7, 7])],
        "out_of_range": [([1.7, 0.5, -0.2, 0.1], [1, 0, 0, 1],
                          [9, 9, 9, 9])],
    }[case]
    calcs = (TWuAuc(), JWuAuc())
    for c in calcs:
        for args in feeds:
            c.add_data(*args)
    _assert_msg_equal(calcs[0].compute(), calcs[1].compute())
    for c in calcs:
        c.reset()
    _assert_msg_equal(calcs[0].compute(), calcs[1].compute())


def _group_inputs(seed=7, b=300):
    rng = np.random.default_rng(seed)
    preds = rng.random((b, 2))
    cmatch = rng.choice([222, 223, 999], b)
    rank = rng.integers(0, 3, b)
    label = (rng.random(b) < preds[:, 0]).astype(np.int64)
    uid = rng.integers(1, 9, b).astype(np.uint64)
    mask = rng.random(b) < 0.95
    return preds, cmatch, rank, label, uid, mask


METRICS = {
    "auc_join": dict(phase=1),
    "auc_update": dict(phase=0, table_size=1000),
    "cr": dict(cmatch_rank_group="222:1,223:2"),
    "cm": dict(cmatch_rank_group="222,223"),
    "cm_ignore": dict(cmatch_rank_group="222:1,223:2", ignore_rank=True),
    "wu": dict(metric_type="wuauc", uid_var="uid"),
    "mt": dict(metric_type="multi_task", multitask_group="222_0,223_1"),
}


def test_metric_group_matches_jax():
    preds, cmatch, rank, label, uid, mask = _group_inputs()
    groups = (TGroup(), JGroup())
    for g in groups:
        for name, kw in METRICS.items():
            g.init_metric(name, **kw)
        assert g.phase == 1
        assert g.active() == [n for n in METRICS if n != "auc_update"]
        g.flip_phase()
        assert g.active() == [n for n in METRICS if n != "auc_join"]
        g.flip_phase()
        for name in METRICS:
            p = preds if name == "mt" else preds[:, 0]
            g.update(name, p, label, mask=mask, cmatch=cmatch, rank=rank,
                     uid=uid)
    for name in METRICS:
        _assert_msg_equal(groups[0].get_metric_msg(name),
                          groups[1].get_metric_msg(name))
        assert type(groups[0].calculator(name)).__name__ == \
            type(groups[1].calculator(name)).__name__
    for g in groups:
        g.reset("cr")
    _assert_msg_equal(groups[0].get_metric_msg("cr"),
                      groups[1].get_metric_msg("cr"))
    for g in groups:
        g.reset()
    _assert_msg_equal(groups[0].get_metric_msg("wu"),
                      groups[1].get_metric_msg("wu"))


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_metric_group_errors(pkg):
    g = TGroup() if pkg == "torch" else JGroup()
    g.init_metric("wu", metric_type="wuauc")
    g.init_metric("mt3", metric_type="multi_task",
                  multitask_group="222_0,223_0,224_0")
    with pytest.raises(ValueError, match="uid"):
        g.update("wu", [0.5], [1])
    with pytest.raises(ValueError, match="host-side"):
        g.merge_device_state("wu", {"pos": np.zeros(4)})
    with pytest.raises(ValueError, match="columns"):
        g.update("mt3", np.zeros((4, 2)), np.zeros(4),
                 cmatch=np.full(4, 222))
    with pytest.raises(ValueError, match="multi_task"):
        g.update("mt3", np.zeros(4), np.zeros(4), cmatch=np.full(4, 222))
    for kw, match in ((dict(metric_type="nope"), "metric_type"),
                      (dict(metric_type="multi_task"), "multitask_group"),
                      (dict(metric_type="multi_task",
                            multitask_group="222"), "cmatch_rank"),
                      (dict(multitask_group="222_0"), "multi_task")):
        with pytest.raises(ValueError, match=match):
            g.init_metric("bad", **kw)


def test_merge_device_state_takes_torch_state():
    """The port's device buckets (torch) merge into a group metric the way
    the JAX package merges its own numpy copy."""
    rng = np.random.default_rng(5)
    pred = rng.random(256).astype(np.float32)
    label = (rng.random(256) < pred).astype(np.float32)
    state = make_auc_state(1000, torch.device("cpu"))
    accumulate_auc(state, torch.as_tensor(pred), torch.as_tensor(label))
    tg, jg = TGroup(), JGroup()
    tg.init_metric("a", table_size=1000)
    jg.init_metric("a", table_size=1000)
    tg.merge_device_state("a", state)
    jg.merge_device_state("a", {k: v.numpy() for k, v in state.items()})
    _assert_msg_equal(tg.get_metric_msg("a"), jg.get_metric_msg("a"))
    assert 0.5 < tg.get_metric_msg("a")["auc"] < 1.0


def _uid_run(pkg, packed, params=None, multitask=False):
    """Per pass stats of a trainer with uid_slot: one pass of several
    pv-aligned batches, or (multitask) one pass per batch."""
    n_labels = 2 if multitask else 1
    if multitask:
        cfg, data = h.pv_datasets(pkg, uid=True)
    else:
        cfg, ds = h.pv_pass(pkg, uid=True)
        data = [ds]
    if multitask:
        # a second label column, the same records
        cfg = dataclasses.replace(cfg, slots=cfg.slots + (
            pkg.Slot("label1", dtype="float", is_dense=True, dim=1),))
        for k, ds in enumerate(data):
            ds.feed_config = cfg
            for blk in ds.get_blocks():
                lab = np.random.default_rng(k).integers(0, 2, blk.n)
                blk.float_slots["label1"] = (
                    lab.astype(np.float32),
                    np.arange(blk.n + 1, dtype=np.int64))
    eng = h.engine(pkg, data)
    if multitask:
        cls = JMMoE if pkg is h.JAX else TMMoE
        trc = JMultiTask if pkg is h.JAX else TMultiTask
        tr = trc(eng, cls(h.S + 1, E, h.DENSE, num_experts=2, num_tasks=2,
                          expert_hidden=(8,), tower_hidden=(8,)), cfg,
                 batch_size=h.B, label_slots=h.label_names(n_labels),
                 seed=3, **pkg.kw)
    else:
        cls = JCtrDnn if pkg is h.JAX else TCtrDnn
        tr = pkg.Trainer(eng, cls(h.S + 1, E, h.DENSE, hidden=(16,)), cfg,
                         batch_size=h.B, seed=3, auc_table_size=1000,
                         **pkg.kw)
    if params is not None:
        tr.model.load_jax_params(params)
    p0 = (jax.tree.map(np.asarray, tr.params) if pkg is h.JAX
          else tr.model.jax_params())
    stats = []
    for ds in data:
        stats.append(tr.train_pass(tr.build_pass_feed(ds) if packed
                                   else ds))
        if multitask and pkg is h.JAX:
            # the JAX multi-task trainer keeps the records but reports
            # none: read them per pass here
            w = tr.wuauc.compute()
            tr.wuauc.reset()
            stats[-1].update(uauc=w["uauc"], wuauc=w["wuauc"],
                             wuauc_users=w["user_cnt"])
    return stats, p0


@pytest.mark.parametrize("packed", [False, True], ids=["stream", "packed"])
def test_uid_slot_through_trainer_matches_jax(packed):
    js, params = _uid_run(h.JAX, packed)
    ts, _ = _uid_run(h.TORCH, packed, params)
    assert ts[0]["batches"] == js[0]["batches"] > 1
    for t, j in zip(ts, js):
        assert t["wuauc_users"] == j["wuauc_users"] > 0
        for k in ("uauc", "wuauc", "loss"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
        assert t["wuauc_s"] >= 0.0


def test_uid_slot_through_multitask_matches_jax():
    """MultiTaskSparseTrainer: the per-user AUC scores task 0, as the JAX
    package's streaming multi-task step records it."""
    js, params = _uid_run(h.JAX, False, multitask=True)
    ts, _ = _uid_run(h.TORCH, False, params, multitask=True)
    for t, j in zip(ts, js):
        assert t["wuauc_users"] == j["wuauc_users"] > 0
        for k in ("uauc", "wuauc", "task1_auc"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)


def test_fleet_metrics_registry():
    f = fleet.init()
    assert isinstance(f.metrics, TGroup)
    preds, cmatch, rank, label, uid, mask = _group_inputs(seed=11)
    f.metrics.init_metric("join_wuauc", metric_type="wuauc")
    f.metrics.update("join_wuauc", preds[:, 0], label, uid=uid)
    want = JWuAuc()
    want.add_data(preds[:, 0], label, uid)
    _assert_msg_equal(f.metrics.get_metric_msg("join_wuauc"), want.compute())
    assert fleet.init().metrics is not f.metrics     # one per Fleet
