"""Checkpoints of the PyTorch port: the generation chain, the dense half,
and sparse state that crosses between the two packages.

* Retain-K GC keeps the newest heads and every generation their chains
  reference (counterpart of the JAX package's
  test_crash_recovery.py::test_retain_k_gc_keeps_heads_and_chains).
* ``dense.pt`` is tensors only (``torch.load(weights_only=True)``), and
  ``resume`` restores Adam's moments and step counts into the trainer's
  own ``Parameter`` objects: the next step equals the step of a trainer
  that never stopped, bit for bit.
* A generation saved by the JAX package's ``TrainCheckpoint`` loads into
  the port's table through the port's ``load_table``, and the other way
  round, bit-equal on every key and field; so does
  ``ShardedHostTable.save(mode="all")`` / ``load``.
* The copied ``fs`` module gives the same results through both packages.
"""

import os
import types

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import EmbeddingTableConfig as JTable
from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.io import fs as jfs
from paddlebox_tpu.io.checkpoint import TrainCheckpoint as JCheckpoint
from paddlebox_tpu.ps.host_table import ShardedHostTable as JHostTable
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu_torch.config import EmbeddingTableConfig as TTable
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.io import fs as tfs
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint as TCheckpoint
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable as THostTable
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine as TEngine
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get


@pytest.fixture(autouse=True)
def _clean_stats():
    StatRegistry.instance().reset()


def jengine():
    return JEngine(JTable(embedding_dim=4, shard_num=4,
                          sgd=JSgd(mf_create_thresholds=0.0)), seed=0)


def tengine():
    return TEngine(TTable(embedding_dim=4, shard_num=4,
                          sgd=TSgd(mf_create_thresholds=0.0)), seed=0,
                   device="cpu")


def mini_pass(eng, p):
    """One pass over seeded keys that adds p + 1 to every show."""
    keys = np.unique(np.random.default_rng(p).integers(
        1, 300, size=80).astype(np.uint64))
    eng.begin_feed_pass()
    eng.add_keys(keys)
    eng.end_feed_pass()
    eng.begin_pass()
    if isinstance(eng, TEngine):
        eng.ws["show"] += float(p + 1)
    else:
        eng.ws["show"] = eng.ws["show"] + float(p + 1)
    eng.end_pass()


class StubTrainer:
    """What a TrainCheckpoint reads of a trainer: ``model`` and
    ``dense_opt``."""

    def __init__(self, seed=0):
        torch.manual_seed(seed)
        self.model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                         torch.nn.ReLU(),
                                         torch.nn.Linear(4, 1))
        self.dense_opt = torch.optim.Adam(self.model.parameters(), lr=1e-2)

    def step(self, seed):
        x = torch.as_tensor(np.random.default_rng(seed).normal(
            size=(8, 3)).astype(np.float32))
        self.dense_opt.zero_grad()
        self.model(x).square().mean().backward()
        self.dense_opt.step()


def jstub():
    return types.SimpleNamespace(params={"w": np.zeros(3, np.float32)},
                                 opt_state={"m": np.zeros((2, 2),
                                                          np.float32)})


def table_state(table):
    keys = np.sort(table.export_keys())
    return keys, table.bulk_pull(keys)


def assert_same_table(a, b):
    ka, sa = table_state(a)
    kb, sb = table_state(b)
    np.testing.assert_array_equal(ka, kb)
    assert set(sa) == set(sb)
    for f in sa:
        np.testing.assert_array_equal(np.asarray(sa[f]), np.asarray(sb[f]),
                                      err_msg=f)


def test_retain_k_gc_keeps_heads_and_chains(tmp_path):
    """keep=2, base_every=3 over base + 6 pass saves: gens 0(B) 1(D) 2(D)
    3(B) 4(D) 5(D) 6(B).  The two newest heads are 5 and 6; their chains
    reference {3,4,5} ∪ {6} — everything else is reclaimed."""
    eng = tengine()
    eng.set_date("20260801")
    tr = StubTrainer()
    ck = TCheckpoint(str(tmp_path / "ckpt"), keep=2, base_every=3)
    ck.save(eng, tr)
    for p in range(6):
        mini_pass(eng, p)
        tr.step(p)
        ck.save_pass(eng, tr)
    assert ck.head() == 6
    on_disk = sorted(int(n[4:]) for n in os.listdir(ck.root)
                     if n.startswith("gen-") and not n.endswith(".tmp"))
    assert on_disk == [3, 4, 5, 6]
    assert [ck.gen_state(n)["kind"] for n in on_disk] == \
        ["base", "delta", "delta", "base"]
    assert ck.gen_state(5)["chain"] == [3, 4, 5]
    assert stat_get("ckpt.gc_removed") >= 1
    assert flight.events(kind="ckpt_gc")

    eng2, tr2 = tengine(), StubTrainer(seed=1)
    state = ck.resume(eng2, tr2)
    assert state["generation"] == 6
    assert eng2.day_id == "20260801" and eng2.pass_id == eng.pass_id
    assert_same_table(eng.table, eng2.table)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(tr2.model.state_dict()[k], v), k


def test_resume_restores_adam_in_place(tmp_path):
    eng, tr = tengine(), StubTrainer()
    for i in range(3):
        tr.step(i)
    ck = TCheckpoint(str(tmp_path / "ckpt"))
    gen = ck.save(eng, tr)
    dense = torch.load(os.path.join(ck._gen_dir(gen), "dense.pt"),
                       weights_only=True)
    assert set(dense) == {"model", "opt"}

    want = StubTrainer()
    want.model.load_state_dict(tr.model.state_dict())
    want.dense_opt.load_state_dict(tr.dense_opt.state_dict())
    want.step(9)

    tr.step(7)                       # drift past the checkpoint
    tr.step(8)
    params = list(tr.model.parameters())
    ck.resume(eng, tr)
    assert list(tr.model.parameters()) == params
    assert tr.dense_opt.param_groups[0]["params"] == params
    for p in params:
        st = tr.dense_opt.state[p]
        assert float(st["step"]) == 3.0
        assert st["exp_avg"].device == p.device
    tr.step(9)
    for k, v in want.model.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k


def test_save_pass_writes_deltas_and_a_base_per_day(tmp_path):
    eng, tr = tengine(), StubTrainer()
    eng.set_date("20260801")
    ck = TCheckpoint(str(tmp_path / "ckpt"), keep=8, base_every=8)
    assert ck.save_pass(eng, tr) == 0          # nothing written yet: base
    mini_pass(eng, 0)
    ck.save_pass(eng, tr)
    eng.set_date("20260802")
    mini_pass(eng, 1)
    ck.save_pass(eng, tr)
    assert [ck.gen_state(n)["kind"] for n in range(3)] == \
        ["base", "delta", "base"]
    # the delta holds exactly the rows pass 0 wrote
    assert ck.gen_state(1)["rows"] == len(np.unique(
        np.random.default_rng(0).integers(1, 300, size=80)))
    eng2 = tengine()
    ck.load_table(eng2.table)
    assert_same_table(eng.table, eng2.table)


def test_jax_generation_loads_into_port_table(tmp_path):
    jeng = jengine()
    jeng.set_date("20260801")
    ck = JCheckpoint(str(tmp_path / "ckpt"), keep=4, base_every=4)
    ck.save(jeng, jstub())
    for p in range(3):
        mini_pass(jeng, p)
        ck.save_pass(jeng, jstub())
    assert ck.gen_state(ck.head())["chain"] == [0, 1, 2, 3]
    teng = tengine()
    assert TCheckpoint(ck.root).load_table(teng.table) == 3
    assert_same_table(jeng.table, teng.table)


def test_port_generation_loads_into_jax_table(tmp_path):
    teng = tengine()
    teng.set_date("20260801")
    ck = TCheckpoint(str(tmp_path / "ckpt"), keep=4, base_every=4)
    ck.save(teng, StubTrainer())
    for p in range(3):
        mini_pass(teng, p)
        ck.save_pass(teng, StubTrainer())
    jeng = jengine()
    assert JCheckpoint(ck.root).load_table(jeng.table) == 3
    assert_same_table(teng.table, jeng.table)
    assert JCheckpoint(ck.root).read_state()["day_id"] == "20260801"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_table_save_all_crosses_packages(tmp_path, direction):
    jcfg = JTable(embedding_dim=4, shard_num=3,
                  sgd=JSgd(mf_create_thresholds=0.0))
    tcfg = TTable(embedding_dim=4, shard_num=3,
                  sgd=TSgd(mf_create_thresholds=0.0))
    src, dst = ((JHostTable(jcfg, seed=2), THostTable(tcfg, seed=5))
                if direction == "jax_to_port"
                else (THostTable(tcfg, seed=2), JHostTable(jcfg, seed=5)))
    keys = np.arange(1, 200, 3, dtype=np.uint64)
    rows = src.bulk_pull(keys)
    rows["show"] = rows["show"] + 2.5
    rows["unseen_days"] = np.ones(len(keys), np.float32)
    src.bulk_write(keys, rows)
    path = str(tmp_path / "table")
    assert src.save(path, mode="all") == len(keys)
    assert sorted(os.listdir(path)) == [f"part-{i:05d}.shard.npz"
                                        for i in range(3)]
    assert dst.load(path) == len(keys)
    assert_same_table(src, dst)


def test_fs_matches_jax(tmp_path):
    out = []
    for mod, name in ((jfs, "j"), (tfs, "t")):
        root = str(tmp_path / name)
        fs = mod.get_fs(root)
        fs.mkdir(root + "/d")
        fs.write_bytes(root + "/d/a.bin", b"hello\x00world")
        fs.rename(root + "/d/a.bin", root + "/d/b.bin")
        res = [mod.split_scheme("hdfs://x/y"), mod.split_scheme(root),
               fs.exists(root + "/d/a.bin"), fs.exists(root + "/d/b.bin"),
               [os.path.basename(p) for p in fs.ls(root + "/d")],
               fs.read_bytes(root + "/d/b.bin")]
        fs.remove(root + "/d")
        res.append(fs.exists(root + "/d"))
        out.append(res)
    out[0][1] = out[1][1] = None     # the roots differ by name only
    assert out[0] == out[1]


def test_host_table_surface_matches_jax(tmp_path):
    """The table verbs this slice adds give the same answers in both
    packages: grow_stats, export/select/filter_keys, and the row counts
    of save in base, delta (which resets delta_score) and rows mode."""
    out = []
    for table_cls, table_cfg, sgd_cfg, name in (
            (JHostTable, JTable, JSgd, "j"), (THostTable, TTable, TSgd, "t")):
        table = table_cls(table_cfg(embedding_dim=4, shard_num=3,
                                    sgd=sgd_cfg(mf_create_thresholds=0.0)),
                          seed=1)
        res = []
        for p in range(3):
            keys = np.arange(1 + 40 * p, 120 + 40 * p, 2, dtype=np.uint64)
            rows = table.bulk_pull(keys)
            rows["show"] = rows["show"] + 4.0 * p
            rows["click"] = rows["click"] + p
            rows["delta_score"] = rows["delta_score"] + (p % 2)
            rows["unseen_days"] = np.zeros(len(keys), np.float32)
            table.bulk_write(keys, rows)
        res.append(table.grow_stats())
        res.append(np.sort(table.export_keys()).tolist())
        res.append(np.sort(table.select_keys(lambda k: k % 3 == 0)).tolist())
        root = str(tmp_path / name)
        res.append(table.save(root + "/base", mode="base"))
        res.append(table.save(root + "/delta", mode="delta"))
        res.append(table.save(root + "/delta2", mode="delta"))
        res.append(table.save(root + "/rows", mode="rows",
                              keys=np.array([3, 5, 7, 9999], np.uint64)))
        res.append(table.filter_keys(lambda k: k % 5 != 0))
        res.append(table.size())
        out.append(res)
    assert out[0] == out[1]
    assert out[1][5] == 0            # the first delta save reset the scores


def test_engine_persistence_verbs(tmp_path):
    eng = tengine()
    mini_pass(eng, 0)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, 30, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    eng.ws["show"] += 1.0
    eng.end_pass(need_save_delta=True, delta_path=str(tmp_path / "delta"))
    assert os.path.exists(tmp_path / "delta" / "part-00000.shard.npz")
    assert eng.save_checkpoint(str(tmp_path / "all")) == eng.table.size()
    assert eng.save_base(str(tmp_path / "base")) >= 0
    eng2 = tengine()
    assert eng2.load(str(tmp_path / "all")) == eng.table.size()
    assert_same_table(eng.table, eng2.table)
    assert eng2.shrink() >= 0


def test_gen_mtime_matches_jax(tmp_path):
    """gen_mtime(n) is generation n's commit time (its STATE.json mtime):
    the port's reads its own generations as the JAX package's reader does,
    and a later generation never reads earlier."""
    eng, tr = tengine(), StubTrainer()
    ck = TCheckpoint(str(tmp_path / "ckpt"))
    gens = [ck.save(eng, tr)]
    mini_pass(eng, 0)
    tr.step(0)
    gens.append(ck.save_pass(eng, tr))
    jck = JCheckpoint(str(tmp_path / "ckpt"))
    times = []
    for n in gens:
        t = ck.gen_mtime(n)
        assert t == jck.gen_mtime(n) == os.path.getmtime(
            os.path.join(ck._gen_dir(n), "STATE.json"))
        times.append(t)
    assert times[0] <= times[1]
    with pytest.raises(OSError):
        ck.gen_mtime(gens[-1] + 1)
