"""Shared pieces of the PyTorch port's PS-tier tests
(``tests/test_torch_ps_*.py``, ``test_torch_crash_recovery.py``): the
port's counterparts of the JAX suites' helpers — a deterministic
engine / dataset / trainer trio over slot text files (4 slots, mf_dim 4,
DeepFM hidden (8,), batch 32, one reader thread, on the CPU), table and
fleet state readers, and a stub trainer for checkpoint mechanics.
Everything here imports the port only."""

import numpy as np
import torch

from paddlebox_tpu_torch import fleet
from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        SlotConfig, SparseSGDConfig)
from paddlebox_tpu_torch.launch import PSFleet
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.ps.service import PSClient, RemoteTableAdapter
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer

CAP = 3
KEYS = np.array([11, 23, 35], np.uint64)
DATES = ["20260801", "20260802"]


def table_cfg() -> EmbeddingTableConfig:
    return EmbeddingTableConfig(
        embedding_dim=4, shard_num=4,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0))


def simple_cfg() -> DataFeedConfig:
    return DataFeedConfig(slots=tuple(
        [SlotConfig("label", dtype="float", is_dense=True, dim=1),
         SlotConfig("dense0", dtype="float", is_dense=True, dim=3)]
        + [SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(4)]))


def write_slot_file(path, rng, n):
    """``n`` MultiSlot records: label, 3 dense floats, 4 sparse slots of
    1..CAP keys drawn from [1, 500)."""
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


def fresh(table=None, path="fast", params=None):
    """A deterministic engine/dataset/trainer trio (seeded init, one
    reader thread, no shuffle) so re-driven passes replay bit for bit;
    ``table`` replaces the engine's local table (a RemoteTableAdapter),
    ``params`` are JAX-package DeepFM params to load."""
    cfg = simple_cfg()
    eng = BoxPSEngine(table_cfg(), seed=0, device="cpu")
    if table is not None:
        eng.table = table
    ds = fleet.BoxPSDataset(cfg, engine=eng, read_threads=1)
    model = DeepFM(4, 3 + 4, 3, hidden=(8,))
    tr = SparseTrainer(eng, model, cfg, batch_size=32, seed=0,
                       sparse_path=path, device="cpu")
    if params is not None:
        tr.model.load_jax_params(params)
    return eng, ds, tr


def table_state(table):
    keys = np.sort(np.concatenate([s.keys for s in table._shards]))
    return keys, table.bulk_pull(keys)


def assert_same_table(table_a, table_b):
    ka, sa = table_state(table_a)
    kb, sb = table_state(table_b)
    np.testing.assert_array_equal(ka, kb)
    assert set(sa) == set(sb)
    for f in sa:
        np.testing.assert_array_equal(np.asarray(sa[f]), np.asarray(sb[f]),
                                      err_msg=f"table field {f!r}")


def assert_same_params(tr_a, tr_b):
    """Dense weights and the dense optimizer's moments, bit for bit."""
    sa, sb = tr_a.model.state_dict(), tr_b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa = tr_a.dense_opt.state_dict()["state"]
    ob = tr_b.dense_opt.state_dict()["state"]
    for i in oa:
        for k in oa[i]:
            assert torch.equal(torch.as_tensor(oa[i][k]),
                               torch.as_tensor(ob[i][k])), (i, k)


def fleet_state(tables):
    """Union-of-shards table state, sorted by key — comparable with the
    single-server ``table_state`` because each key lives on exactly one
    shard (asserted: the union has no duplicates)."""
    per = []
    for t in tables:
        k = np.sort(np.concatenate([s.keys for s in t._shards]))
        if len(k):
            per.append((k, t.bulk_pull(k)))
    allk = np.concatenate([k for k, _ in per])
    assert len(np.unique(allk)) == len(allk), "key owned by two shards"
    order = np.argsort(allk, kind="stable")
    fields = {f: np.concatenate(
        [np.asarray(rows[f]) for _, rows in per])[order]
        for f in per[0][1]}
    return allk[order], fields


def assert_fleet_matches_table(tables, table):
    ka, sa = fleet_state(tables)
    kb, sb = table_state(table)
    np.testing.assert_array_equal(ka, kb)
    assert set(sa) == set(sb)
    for f in sa:
        np.testing.assert_array_equal(
            np.asarray(sa[f]), np.asarray(sb[f]),
            err_msg=f"table field {f!r}")


def assert_fleet_matches_fleet(tables_a, tables_b):
    ka, sa = fleet_state(tables_a)
    kb, sb = fleet_state(tables_b)
    np.testing.assert_array_equal(ka, kb)
    for f in sa:
        np.testing.assert_array_equal(
            np.asarray(sa[f]), np.asarray(sb[f]),
            err_msg=f"table field {f!r}")


class StubTrainer:
    """What a TrainCheckpoint reads of a trainer: ``model`` and
    ``dense_opt`` (a tiny seeded MLP and its Adam)."""

    def __init__(self, seed=0):
        torch.manual_seed(seed)
        self.model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                         torch.nn.ReLU(),
                                         torch.nn.Linear(4, 1))
        self.dense_opt = torch.optim.Adam(self.model.parameters(), lr=1e-2)


def mini_pass(eng, p):
    """One pass over seeded keys that adds p + 1 to every show."""
    keys = np.unique(np.random.default_rng(p).integers(
        1, 300, size=80).astype(np.uint64))
    eng.begin_feed_pass()
    eng.add_keys(keys)
    eng.end_feed_pass()
    eng.begin_pass()
    eng.ws["show"] += float(p + 1)
    eng.end_pass()



def run_days(day_files, n_servers, prefetch, plan=None):
    """Train 2 days x 3 passes through a supervised PS fleet of
    ``n_servers`` shards (delta-mode remote table); → (tables, trainer,
    metrics)."""
    flt = PSFleet(n_servers, table_cfg(), seed=0, max_restarts=16)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                      backoff_cap=0.3, deadline=60)
    eng, ds, tr = fresh(table=RemoteTableAdapter(client, delta_mode=True))
    if plan is not None:
        faults.install(plan)
    metrics = []
    try:
        for d, date in enumerate(DATES):
            metrics.extend(fleet.train_passes(
                tr, ds, day_files[d], date=date, prefetch=prefetch))
    finally:
        faults.uninstall()
        client.close()
        flt.stop()
    return [s.table for s in flt.sups], tr, metrics
