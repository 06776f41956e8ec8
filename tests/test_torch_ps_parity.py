"""The PS service tier of the PyTorch port against the JAX package's.

* (a) Wire bytes: the same seeded request dicts (pull_sparse responses
  and push_sparse / push_sparse_delta requests, with ctr_double's f64
  show/click and an expand table's ``mf_ex`` columns) encode to equal
  bytes in both packages' ``wire``, at every ``ps_wire_dtype``, and each
  package decodes the other's frames.
* (b) Cross-package serving: a port ``PSClient`` against a JAX
  ``PSServer`` and a JAX ``PSClient`` against a port ``PSServer`` run
  pull, push, push_sparse_delta and end_day (multi-chunk, pipelined) and
  leave rows bit-equal to the same-package pairs.
* (c) Training: 2 days x 3 passes of DeepFM (mxu lowering, dense init
  carried from JAX with ``load_jax_params``) through a ``PSFleet(1)`` of
  each package: losses, dense params and the fleet's table within rtol
  1e-4 / atol 1e-6 (f32 sums run in another order in XLA and in torch);
  the port's N = 1 and N = 4 bitwise.
* (d) The resume tier on a server's error reply: one injected error
  reply (the server's verb dispatch raises once) on a checkpointed 2-pass
  day — to ``push_sparse_delta`` in the serial loop, and to the prefetch
  worker's ``pull_sparse``, which reaches the tier at the end of a cause
  chain — is resumed by both packages' tiers to their fault-free bits,
  and the two agree within the same tolerance; a plain ``RuntimeError``
  raised by the trainer is still not re-driven by the port.
"""

import jax
import numpy as np
import pytest

from paddlebox_tpu import fleet as jfleet
from paddlebox_tpu import flags as jflags
from paddlebox_tpu.config import AccessorConfig as JAccessor
from paddlebox_tpu.config import DataFeedConfig as JFeed
from paddlebox_tpu.config import EmbeddingTableConfig as JTable
from paddlebox_tpu.config import SlotConfig as JSlot
from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.io.checkpoint import TrainCheckpoint as JCheckpoint
from paddlebox_tpu.launch import PSFleet as JPSFleet
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ps import faults as jfaults
from paddlebox_tpu.ps import wire as jwire
from paddlebox_tpu.ps.host_table import ShardedHostTable as JHostTable
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.ps.service import PSClient as JClient
from paddlebox_tpu.ps.service import PSServer as JServer
from paddlebox_tpu.ps.service import RemoteTableAdapter as JAdapter
from paddlebox_tpu.trainer.trainer import SparseTrainer as JTrainer
from paddlebox_tpu.utils.monitor import StatRegistry as JStats
from paddlebox_tpu.utils.monitor import stat_get as jstat_get
from paddlebox_tpu_torch import fleet, flags
from paddlebox_tpu_torch.config import AccessorConfig, EmbeddingTableConfig
from paddlebox_tpu_torch.config import SparseSGDConfig
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.launch import PSFleet
from paddlebox_tpu_torch.ps import faults, wire
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.service import (PSClient, PSServer,
                                            RemoteTableAdapter,
                                            ServerErrorReply)
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get
from torch_ps_helpers import (DATES, CAP, assert_fleet_matches_fleet,
                              assert_same_params, fleet_state, fresh,
                              write_slot_file)

TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean():
    StatRegistry.instance().reset()
    JStats.instance().reset()
    yield
    faults.uninstall()
    jfaults.uninstall()
    flags.set_flags({"ps_fault_injection": False})
    jflags.set_flags({"ps_fault_injection": False})


# ---------------------------------------------------------------------------
# (a) Wire bytes.
# ---------------------------------------------------------------------------

def _tables(double=True, expand=4):
    acc = "ctr_double" if double else "ctr"
    j = JHostTable(JTable(embedding_dim=4, shard_num=4, expand_dim=expand,
                          accessor=JAccessor(accessor_type=acc)), seed=5)
    t = ShardedHostTable(EmbeddingTableConfig(
        embedding_dim=4, shard_num=4, expand_dim=expand,
        accessor=AccessorConfig(accessor_type=acc)), seed=5)
    return j, t


def _seeded_rows(table, keys, rng):
    rows = table.bulk_pull(keys)
    for f, v in rows.items():
        if v.dtype.kind == "f":
            rows[f] = (rng.normal(size=v.shape) * 3).astype(v.dtype)
    return rows


@pytest.mark.parametrize("double,expand", [(True, 4), (False, 0)],
                         ids=["ctr_double-mf_ex", "ctr"])
@pytest.mark.parametrize("wd", ["f32", "f16", "i8"])
def test_wire_bytes_equal(wd, double, expand):
    jt, tt = _tables(double, expand)
    keys = np.random.default_rng(1).choice(
        2 ** 40, 300, replace=False).astype(np.uint64)
    jrows = _seeded_rows(jt, keys, np.random.default_rng(2))
    trows = _seeded_rows(tt, keys, np.random.default_rng(2))
    assert {f: (v.dtype, v.shape) for f, v in jrows.items()} == \
        {f: (v.dtype, v.shape) for f, v in trows.items()}
    abs_f = ("slot", "mf_size")

    def frames(w, rows):
        q = lambda r, verb: w.quantize_rows(r, wd, verb=verb)  # noqa: E731
        delta = {f: v for f, v in rows.items() if f not in abs_f}
        return [
            {"ok": True, "rows": q(rows, "pull_sparse"), "rid": "t:1",
             "wire_dtype": wd},
            {"cmd": "push_sparse", "keys": keys, "table": None,
             "rows": q(rows, "push_sparse"), "rid": "t:2", "ep": 3},
            {"cmd": "push_sparse_delta", "keys": keys, "table": "emb",
             "rows": q(delta, "push_sparse_delta"),
             "rows_abs": {f: rows[f] for f in abs_f}, "rid": "t:3.g0"},
            {"cmd": "end_day", "table": None, "rid": "t:4", "n": -7,
             "ratio": 0.25, "flag": True, "none": None},
        ]

    for jm, tm in zip(frames(jwire, jrows), frames(wire, trows)):
        jb, tb = jwire.encode(jm), wire.encode(tm)
        assert jb == tb, jm.get("cmd", "pull response")
        jd, td = wire.decode(jb), jwire.decode(tb)   # across packages
        assert set(jd) == set(td)


# ---------------------------------------------------------------------------
# (b) Cross-package serving.
# ---------------------------------------------------------------------------

def _drive(client, keys, rng):
    """pull(create) → push → push_sparse_delta ×2 → end_day → pull."""
    rows = client.pull_sparse(keys, create=True)
    rows = {f: np.array(v) for f, v in rows.items()}
    rows["show"] = (rng.random(len(keys)) * 5).astype(rows["show"].dtype)
    rows["embed_w"] = rng.normal(size=len(keys)).astype(np.float32)
    client.push_sparse(keys, rows)
    for _ in range(2):
        d = {f: np.zeros_like(v) for f, v in rows.items()
             if f not in ("slot", "mf_size")}
        d["click"] = np.ones(len(keys), d["click"].dtype)
        d["mf"] = rng.normal(size=d["mf"].shape).astype(np.float32)
        client.push_sparse_delta(keys, d)
    client.end_day()
    return client.pull_sparse(keys)


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("jax", "torch"), ("torch", "jax")])
def test_cross_package_serving_bit_equal(server_pkg, client_pkg):
    keys = np.random.default_rng(3).choice(
        2 ** 40, 2500, replace=False).astype(np.uint64)
    out = {}
    for srv_p, cli_p in ((server_pkg, client_pkg), (server_pkg, server_pkg)):
        jt, tt = _tables()
        srv = (JServer(jt) if srv_p == "jax" else PSServer(tt))
        Client = JClient if cli_p == "jax" else PSClient
        client = Client(srv.addr, max_frame=1 << 15, streams=4, window=8,
                        deadline=30)
        try:
            got = _drive(client, keys, np.random.default_rng(4))
            table = jt if srv_p == "jax" else tt
            out[(srv_p, cli_p)] = (got, table.bulk_pull(np.sort(keys)))
        finally:
            client.close()
            srv.shutdown()
    (g_x, t_x), (g_s, t_s) = out[(server_pkg, client_pkg)], \
        out[(server_pkg, server_pkg)]
    for f in g_s:
        np.testing.assert_array_equal(g_x[f], g_s[f], err_msg=f)
        np.testing.assert_array_equal(t_x[f], t_s[f], err_msg=f)


# ---------------------------------------------------------------------------
# (c) Training through a PSFleet(1) in each package.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def day_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity-passes")
    out = {}
    for day in range(2):
        out[day] = []
        for p in range(3):
            path = str(d / f"d{day}p{p}.txt")
            write_slot_file(path, np.random.default_rng(500 * day + p), 48)
            out[day].append([path])
    return out


def _jax_trio(table):
    cfg = JFeed(slots=tuple(
        [JSlot("label", dtype="float", is_dense=True, dim=1),
         JSlot("dense0", dtype="float", is_dense=True, dim=3)]
        + [JSlot(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(4)]))
    eng = JEngine(JTable(embedding_dim=4, shard_num=4,
                         sgd=JSgd(mf_create_thresholds=0.0)), seed=0)
    eng.table = table
    ds = jfleet.BoxPSDataset(cfg, engine=eng, read_threads=1)
    tr = JTrainer(eng, JDeepFM(4, 3 + 4, 3, hidden=(8,)), cfg,
                  batch_size=32, seed=0, sparse_path="mxu")
    return eng, ds, tr


def _jax_table_cfg():
    return JTable(embedding_dim=4, shard_num=4,
                  sgd=JSgd(mf_create_thresholds=0.0))


def _port_table_cfg():
    return EmbeddingTableConfig(embedding_dim=4, shard_num=4,
                                sgd=SparseSGDConfig(mf_create_thresholds=0.0))


def _train(pkg, n, day_files, params=None, days=(0, 1), prefetch=False,
           checkpoint=None, resume=None, before=None):
    """Train ``days`` through a PSFleet(n) of ``pkg`` → (tables, trainer,
    metrics)."""
    if pkg == "jax":
        flt = JPSFleet(n, _jax_table_cfg(), seed=0, max_restarts=4)
        client = JClient(flt.addrs, deadline=60)
        eng, ds, tr = _jax_trio(JAdapter(client, delta_mode=True))
        train = jfleet.train_passes
    else:
        flt = PSFleet(n, _port_table_cfg(), seed=0, max_restarts=4)
        client = PSClient(flt.addrs, deadline=60)
        eng, ds, tr = fresh(RemoteTableAdapter(client, delta_mode=True),
                            path="mxu", params=params)
        train = fleet.train_passes
    if before is not None:
        before(flt)
    metrics = []
    try:
        for d in days:
            metrics.extend(train(tr, ds, day_files[d], date=DATES[d],
                                 prefetch=prefetch, checkpoint=checkpoint,
                                 resume=resume))
    finally:
        client.close()
        flt.stop()
    return [s.table for s in flt.sups], tr, metrics


def _assert_close_to_jax(jrun, trun):
    (jtables, jtr, jm), (ttables, ttr, tm) = jrun, trun
    assert [m["batches"] for m in tm] == [m["batches"] for m in jm]
    np.testing.assert_allclose([m["loss"] for m in tm],
                               [m["loss"] for m in jm], **TOL)
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jtr.params))
    got = jax.tree_util.tree_leaves(ttr.model.jax_params())
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)
    jk, js = fleet_state(jtables)
    tk, ts = fleet_state(ttables)
    np.testing.assert_array_equal(tk, jk)
    assert set(ts) == set(js)
    for f in js:
        if js[f].dtype.kind in "iu":
            np.testing.assert_array_equal(ts[f], js[f], err_msg=f)
        else:
            np.testing.assert_allclose(ts[f], js[f], err_msg=f, **TOL)


@pytest.fixture(scope="module")
def jax_days(day_files):
    return _train("jax", 1, day_files)


def test_fleet_training_matches_jax_and_n1_equals_n4(day_files, jax_days):
    # a fresh JAX trio of the same seed holds the run's initial params
    init = jax.tree.map(np.asarray, _jax_trio(None)[2].params)
    t1 = _train("torch", 1, day_files, params=init)
    _assert_close_to_jax(jax_days, t1)
    t4 = _train("torch", 4, day_files, params=init, prefetch=True)
    assert [m["losses"] for m in t1[2]] == [m["losses"] for m in t4[2]]
    assert_same_params(t1[1], t4[1])
    assert_fleet_matches_fleet(t1[0], t4[0])


# ---------------------------------------------------------------------------
# (d) The resume tier on a server's error reply.
# ---------------------------------------------------------------------------

def _refuse_once(cmd, at):
    """A ``before`` hook: the first server's verb dispatch raises on the
    ``at``-th ``cmd`` (0-based), which the server answers with an error
    reply ``{"ok": False, "error": ...}`` — nothing applied."""
    def arm(flt):
        srv = flt.sups[0].server
        orig, seen = srv._dispatch, [0]

        def dispatch(req):
            if req.get("cmd") == cmd:
                seen[0] += 1
                if seen[0] == at + 1:
                    raise RuntimeError(f"injected: {cmd} refused")
            return orig(req)

        srv._dispatch = dispatch
    return arm


@pytest.mark.parametrize("cmd,prefetch", [("push_sparse_delta", False),
                                          ("pull_sparse", True)])
def test_server_error_reply_resumed_by_both_tiers(day_files, tmp_path, cmd,
                                                  prefetch):
    init = jax.tree.map(np.asarray, _jax_trio(None)[2].params)
    two = {0: day_files[0][:2]}                    # a 2-pass day
    runs = {}
    for pkg, Ckpt in (("jax", JCheckpoint), ("torch", TrainCheckpoint)):
        kw = dict(days=(0,), prefetch=prefetch,
                  params=init if pkg == "torch" else None)
        clean = _train(pkg, 1, two, **kw)
        ck = Ckpt(str(tmp_path / f"ckpt-{pkg}"))
        faulted = _train(pkg, 1, two, checkpoint=ck, resume=4,
                         before=_refuse_once(cmd, 1), **kw)
        runs[pkg] = (clean, faulted)
    # both tiers rolled back and re-drove the pass
    assert jstat_get("ps.fleet.auto_resume") == 1
    assert stat_get("ps.fleet.auto_resume") == 1
    # each package reaches its own fault-free bits
    (jc, jf), (tc, tf) = runs["jax"], runs["torch"]
    np.testing.assert_array_equal([m["loss"] for m in jf[2]],
                                  [m["loss"] for m in jc[2]])
    for a, b in zip(jax.tree_util.tree_leaves(jf[1].params),
                    jax.tree_util.tree_leaves(jc[1].params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert_fleet_matches_fleet(jf[0], jc[0])
    assert [m["losses"] for m in tf[2]] == [m["losses"] for m in tc[2]]
    assert_same_params(tf[1], tc[1])
    assert_fleet_matches_fleet(tf[0], tc[0])
    # and the two packages agree
    _assert_close_to_jax(jf, tf)


def test_trainer_runtime_error_not_redriven_over_remote_table(day_files,
                                                              tmp_path):
    """The repair takes only the server's replies: a plain RuntimeError
    of the trainer's own still propagates at once over a remote table."""
    calls = [0]

    def before_pass(_ds):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("a fault of the program")

    flt = PSFleet(1, _port_table_cfg(), seed=0)
    client = PSClient(flt.addrs, deadline=30)
    try:
        eng, ds, tr = fresh(RemoteTableAdapter(client, delta_mode=True),
                            path="mxu")
        with pytest.raises(RuntimeError) as info:
            fleet.train_passes(tr, ds, day_files[0], date=DATES[0],
                               before_pass=before_pass, prefetch=False,
                               checkpoint=TrainCheckpoint(
                                   str(tmp_path / "ckpt")), resume=4)
        assert type(info.value) is RuntimeError
        assert not isinstance(info.value, ServerErrorReply)
        assert stat_get("ps.fleet.auto_resume") == 0
    finally:
        client.close()
        flt.stop()
