"""The trainer fleet of the PyTorch port: N trainers x M PS shards with
the crash-anywhere exactly-once contract, on the CPU.

Ports ``tests/test_trainer_fleet.py`` case for case against
``paddlebox_tpu_torch.fleet.run_trainer_fleet`` (``device="cpu"``): N = 4
serial and prefetched and N = 1 prefetched bit-identical to N = 1 serial
(per-pass loss, AUC and batches, every rank's dense parameters and Adam
state, the union of the PS shards' tables); a seeded kill of rank 1 at
``fleet_shuffle`` and at ``fleet_allreduce`` recovered through
``TrainerSupervisor`` to the same bits; the leader killed at a write-back
turn, with ``end_day`` applied exactly once (a doubled decay would fork
the table); membership re-election and rejoin; the shuffle barrier's
deadline raising the typed ``ShufflePeerDead``; and the slow soak.

Beside the ports: the JAX package's ``run_trainer_fleet`` and the port's
on the same files from the same initial dense parameters (the JAX init
carried in through ``load_jax_params``) at N = 1 and N = 2 agree within
rtol 1e-4 / atol 1e-6 on histories, dense parameters with Adam's moments
and the tables (f32 sums run in another order in XLA and in torch); the
dense vector the fleet folds round-trips a fresh and a trained Adam; and
the fleet's entry points refuse a missing card.
"""

import socket
import time

import jax
import numpy as np
import pytest
import torch

from test_end_to_end import MF_DIM, N_SLOTS, gen_data
from test_end_to_end import feed_config as jax_feed_config

from paddlebox_tpu import flags as jflags
from paddlebox_tpu.config import EmbeddingTableConfig as JTable
from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.fleet import run_trainer_fleet as jax_run_trainer_fleet
from paddlebox_tpu.launch import PSFleet as JPSFleet
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ps.host_table import ShardedHostTable as JHostTable
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.ps.service import PSClient as JClient
# defines the JAX package's fleet flags, which the module fixture sets
from paddlebox_tpu.trainer import fleet_runner as _jfleet_runner  # noqa: F401
from paddlebox_tpu.trainer.trainer import SparseTrainer as JTrainer
from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        SlotConfig, SparseSGDConfig)
from paddlebox_tpu_torch.data.shuffle_transport import (ShufflePeerDead,
                                                        TcpShuffleTransport)
from paddlebox_tpu_torch.fleet import run_trainer_fleet
from paddlebox_tpu_torch.launch import PSFleet
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps import cluster as ps_cluster
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.ps.service import PSClient
from paddlebox_tpu_torch.trainer import fleet_runner
from paddlebox_tpu_torch.trainer.fleet_runner import _Membership
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import stat_snapshot

TOL = dict(rtol=1e-4, atol=1e-6)
_FLEET_FLAGS = {"shuffle_deadline_s": 20.0, "fleet_deadline_s": 45.0,
                "fleet_hb_ttl_s": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _fleet_flags():
    old = {k: flags.get_flags(k) for k in _FLEET_FLAGS}
    jold = {k: jflags.get_flags(k) for k in _FLEET_FLAGS}
    flags.set_flags(_FLEET_FLAGS)
    jflags.set_flags(_FLEET_FLAGS)
    yield
    flags.set_flags(old)
    jflags.set_flags(jold)


def _feed():
    """The port's copy of test_end_to_end's feed (3 slots, 2 dense)."""
    return DataFeedConfig(
        slots=(SlotConfig("label", dtype="float", is_dense=True, dim=1),
               SlotConfig("dense0", dtype="float", is_dense=True, dim=2),
               SlotConfig("slot_a", slot_id=101, capacity=2),
               SlotConfig("slot_b", slot_id=102, capacity=2),
               SlotConfig("slot_c", slot_id=103, capacity=1)),
        batch_size=128, rand_seed=42)


def _tcfg():
    return EmbeddingTableConfig(embedding_dim=MF_DIM, shard_num=4,
                                sgd=SparseSGDConfig(mf_create_thresholds=2.0))


def _jtcfg():
    return JTable(embedding_dim=MF_DIM, shard_num=4,
                  sgd=JSgd(mf_create_thresholds=2.0))


def _model_fn():
    return DeepFM(num_slots=N_SLOTS, emb_width=3 + MF_DIM, dense_dim=2,
                  hidden=(16, 8))


def _jmodel_fn():
    return JDeepFM(num_slots=N_SLOTS, emb_width=3 + MF_DIM, dense_dim=2,
                   hidden=(16, 8))


# fixed ports BELOW the ephemeral range (32768+): a restarted rank
# re-binds its OWN address, which must not be squattable as some
# concurrent outbound connection's local port.  This file's range keeps
# clear of the JAX suite's (24100+), which xdist may run beside it
_PORT_BASE = [25100]


def _free_ports(n):
    out = []
    while len(out) < n:
        _PORT_BASE[0] += 1
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", _PORT_BASE[0]))
            s.close()
            out.append(_PORT_BASE[0])
        except OSError:
            pass
    return out


@pytest.fixture(scope="module")
def fleet_data(tmp_path_factory):
    """2 days x 3 passes x 2 files (the acceptance schedule)."""
    root = tmp_path_factory.mktemp("torch-fleet-data")
    files = []
    for i in range(12):
        p = str(root / f"f{i}.txt")
        gen_data(p, n=150, seed=i)
        files.append(p)
    return [("20260701", [files[0:2], files[2:4], files[4:6]]),
            ("20260702", [files[6:8], files[8:10], files[10:12]])]


def _run_fleet(tmp_path, days, world, m_shards, tag, *, prefetch=False,
               fault_plans=None, model_fn=_model_fn):
    """One fleet run against a fresh M-shard PS cluster; returns the
    per-rank results plus a full-table dump directory."""
    flt = PSFleet(m_shards, _tcfg(), seed=1)
    try:
        addrs = ([("127.0.0.1", p) for p in _free_ports(world)]
                 if world > 1 else None)
        results = run_trainer_fleet(
            world, flt.addrs, str(tmp_path / f"wd-{tag}"), _tcfg(),
            model_fn, _feed(), days, batch_size=64, virtual_shards=4,
            table_seed=1, trainer_seed=2, prefetch=prefetch,
            trainer_addrs=addrs, fault_plans=fault_plans,
            client_deadline=30.0, device="cpu")
        dump = str(tmp_path / f"dump-{tag}")
        client = PSClient(flt.addrs, deadline=30.0)
        client.save(dump, mode="all")
        client.close()
        return results, dump
    finally:
        flt.stop()


def _load_dump(dump, table):
    w = ps_cluster.dump_width(dump)
    if w <= 1:
        table.load(dump, mode="upsert")
    else:
        for k in range(w):
            table.load(ps_cluster.shard_dir(dump, k), mode="upsert")
    return table


def _all_keys(t):
    parts = [np.asarray(s.keys, np.uint64) for s in t._shards
             if len(s.keys)]
    return np.sort(np.concatenate(parts)) if parts else \
        np.empty(0, np.uint64)


def _table_state(dump, table):
    t = _load_dump(dump, table)
    keys = _all_keys(t)
    return keys, t.bulk_pull(keys)


def _assert_bit_identical(base, other):
    """Histories, dense params and Adam state (every rank), and the full
    sparse table."""
    res_b, dump_b = base
    res_o, dump_o = other
    hb, ho = res_b[0]["history"], res_o[0]["history"]
    assert len(hb) == len(ho) and len(hb) > 0
    for a, b in zip(hb, ho):
        assert a["loss"] == b["loss"], (a, b)
        assert a["auc"] == b["auc"], (a, b)
        assert a["batches"] == b["batches"], (a, b)
    pb, ob = res_b[0]["params"], res_b[0]["opt_state"]
    for res in res_o:
        assert list(res["params"]) == list(pb)
        for n in pb:
            assert torch.equal(res["params"][n], pb[n]), \
                f"dense param {n} differs"
        assert set(res["opt_state"]) == set(ob)
        for i in ob:
            for k in ob[i]:
                assert torch.equal(torch.as_tensor(res["opt_state"][i][k]),
                                   torch.as_tensor(ob[i][k])), (i, k)
    kb, rb = _table_state(dump_b, ShardedHostTable(_tcfg(), seed=1))
    ko, ro = _table_state(dump_o, ShardedHostTable(_tcfg(), seed=1))
    assert np.array_equal(kb, ko), (len(kb), len(ko))
    assert len(kb) > 0
    for f in rb:
        assert np.array_equal(rb[f], ro[f]), f"table field {f} differs"


@pytest.fixture(scope="module")
def baseline(tmp_path_factory, fleet_data):
    """The N=1 serial run every width/chaos variant must match."""
    tmp = tmp_path_factory.mktemp("torch-fleet-base")
    return _run_fleet(tmp, fleet_data, 1, 1, "n1")


# -- bit-identity across fleet width -----------------------------------------

def test_n4_serial_bit_identical(tmp_path, fleet_data, baseline):
    out = _run_fleet(tmp_path, fleet_data, 4, 2, "n4")
    _assert_bit_identical(baseline, out)
    snap = stat_snapshot()
    for name in ("trainer.fleet.shuffle_tx_bytes",
                 "trainer.fleet.shuffle_rx_bytes",
                 "trainer.fleet.barrier_wait_s",
                 "trainer.fleet.allreduce_wait_s",
                 "trainer.fleet.straggler_gap_s"):
        assert any(k.startswith(name) for k in snap), name


def test_n4_prefetched_bit_identical(tmp_path, fleet_data, baseline):
    out = _run_fleet(tmp_path, fleet_data, 4, 2, "n4pf", prefetch=True)
    _assert_bit_identical(baseline, out)


def test_n1_prefetched_bit_identical(tmp_path, fleet_data, baseline):
    out = _run_fleet(tmp_path, fleet_data, 1, 1, "n1pf", prefetch=True)
    _assert_bit_identical(baseline, out)


# -- crash-anywhere: kill a trainer mid-pass ---------------------------------

@pytest.mark.parametrize("site", ["fleet_shuffle", "fleet_allreduce"])
def test_kill_trainer_mid_pass_recovers(tmp_path, fleet_data, baseline,
                                        site):
    """Seeded kill of rank 1 mid-shuffle / mid-allreduce: the
    TrainerSupervisor restarts it, the namespaced rid replay + shuffle
    resync recover the pass, and the result is bit-identical."""
    before = len(flight.events(kind="trainer_restart"))
    plan = faults.FaultPlan(seed=7).kill_at(site, at=(1,))
    out = _run_fleet(tmp_path, fleet_data, 2, 2, f"chaos-{site}",
                     fault_plans={1: plan})
    _assert_bit_identical(baseline, out)
    after = flight.events(kind="trainer_restart")   # newest-first
    restarts = [e for e in after[:len(after) - before]
                if e.get("rank") == 1]
    assert restarts, "supervisor restart never recorded"


def test_kill_leader_mid_pass_end_day_exactly_once(tmp_path, fleet_data,
                                                   baseline):
    """Kill rank 0 — the elected leader — during a write-back turn: the
    surviving rank's barrier pokes take over the lifecycle duties under
    the rank=None failover namespace, the restarted leader replays, and
    end_day lands exactly once (a doubled decay would fork the table
    and break bit-identity)."""
    plan = faults.FaultPlan(seed=11).kill_at("end_pass", at=(1,))
    out = _run_fleet(tmp_path, fleet_data, 2, 2, "chaos-leader",
                     fault_plans={0: plan})
    _assert_bit_identical(baseline, out)


# -- leader election ---------------------------------------------------------

def test_membership_reelection_and_rejoin(tmp_path):
    m0 = _Membership(str(tmp_path), 0, 2, ttl_s=0.3)
    m1 = _Membership(str(tmp_path), 1, 2, ttl_s=0.3)
    m0.heartbeat()
    m1.heartbeat()
    assert m1.leader() == 0
    before = len(flight.events(kind="leader_elect"))
    time.sleep(0.5)          # rank 0 stops beating -> TTL expiry
    m1.heartbeat()
    assert m1.leader() == 1
    elects = flight.events(kind="leader_elect")     # newest-first
    assert any(e.get("leader") == 1 and e.get("observer") == 1
               for e in elects[:len(elects) - before])
    m0.heartbeat()           # the restarted rank rejoins
    assert m1.leader() == 0


# -- transport deadline (typed peer-death) -----------------------------------

def test_shuffle_barrier_deadline_raises_typed(tmp_path):
    old = flags.get_flags("shuffle_deadline_s")
    flags.set_flags({"shuffle_deadline_s": 1.5})
    try:
        addrs = [("127.0.0.1", p) for p in _free_ports(2)]
        tr = TcpShuffleTransport(0, addrs)   # peer rank 1 never starts
        try:
            tr.set_epoch(0)
            with pytest.raises(ShufflePeerDead):
                tr.barrier()
        finally:
            tr.close()
    finally:
        flags.set_flags({"shuffle_deadline_s": old})


# -- slow soak: kill anywhere ------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("site", ["fleet_shuffle", "end_pass",
                                  "fleet_allreduce"])
@pytest.mark.parametrize("rank", [0, 1])
def test_soak_kill_anywhere_bit_identical(tmp_path, fleet_data, baseline,
                                          site, rank):
    """2-day soak sweep: any rank killed at any lifecycle site still
    converges to the N=1 bits through the supervisor restart."""
    plan = faults.FaultPlan(seed=13 + rank).kill_at(site, at=(1,))
    out = _run_fleet(tmp_path, fleet_data, 2, 2,
                     f"soak-{site}-r{rank}", fault_plans={rank: plan})
    _assert_bit_identical(baseline, out)


# -- across packages ---------------------------------------------------------

def _jax_init_params():
    """The dense init a JAX fleet trainer starts from (trainer_seed 2)."""
    eng = JEngine(_jtcfg(), seed=1)
    tr = JTrainer(eng, _jmodel_fn(), jax_feed_config(), 64, seed=2)
    return jax.tree.map(np.asarray, tr.params)


class _JaxInitDeepFM(DeepFM):
    """DeepFM whose (re)initialisation loads given JAX-package params —
    how the fleet's ``model_fn`` carries the JAX init into every rank."""

    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._jax_init = params
        self.reset_parameters(torch.Generator())

    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        if getattr(self, "_jax_init", None) is not None:
            self.load_jax_params(self._jax_init)


def _jax_fleet(tmp_path, days, world):
    flt = JPSFleet(2, _jtcfg(), seed=1)
    try:
        addrs = ([("127.0.0.1", p) for p in _free_ports(world)]
                 if world > 1 else None)
        results = jax_run_trainer_fleet(
            world, flt.addrs, str(tmp_path / f"jwd-{world}"), _jtcfg(),
            _jmodel_fn, jax_feed_config(), days, batch_size=64,
            virtual_shards=4, table_seed=1, trainer_seed=2,
            trainer_addrs=addrs, client_deadline=30.0)
        dump = str(tmp_path / f"jdump-{world}")
        client = JClient(flt.addrs, deadline=30.0)
        client.save(dump, mode="all")
        client.close()
        return results, dump
    finally:
        flt.stop()


def _port_moments_as_jax(params, opt_state, key):
    """The port's per-parameter Adam moment ``key`` in the JAX params
    layout (through a DeepFM whose parameters hold the moments)."""
    m = _model_fn()
    with torch.no_grad():
        for i, (_, p) in enumerate(m.named_parameters()):
            p.copy_(opt_state[i][key])
    return m.jax_params()


@pytest.mark.parametrize("world", [1, 2])
def test_fleet_matches_jax_package(tmp_path, fleet_data, world):
    init = _jax_init_params()
    jres, jdump = _jax_fleet(tmp_path, fleet_data, world)
    tres, tdump = _run_fleet(
        tmp_path, fleet_data, world, 2, f"x{world}",
        model_fn=lambda: _JaxInitDeepFM(init, num_slots=N_SLOTS,
                                        emb_width=3 + MF_DIM, dense_dim=2,
                                        hidden=(16, 8)))
    jh, th = jres[0]["history"], tres[0]["history"]
    assert [h["batches"] for h in th] == [h["batches"] for h in jh]
    for k in ("loss", "auc"):
        np.testing.assert_allclose([h[k] for h in th], [h[k] for h in jh],
                                   err_msg=k, **TOL)
    # dense parameters, then Adam's step and both moments
    m = _model_fn()
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(tres[0]["params"][n])
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray,
                                                  jres[0]["params"]))
    got = jax.tree_util.tree_leaves(m.jax_params())
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)
    adam = jres[0]["opt_state"][0]
    steps = {float(s["step"]) for s in tres[0]["opt_state"].values()}
    assert steps == {float(adam.count)}
    for key, jtree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = jax.tree_util.tree_leaves(
            _port_moments_as_jax(tres[0]["params"], tres[0]["opt_state"],
                                 key))
        want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jtree))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, err_msg=key, **TOL)
    # the union of the shard tables
    jk, js = _table_state(jdump, JHostTable(_jtcfg(), seed=1))
    tk, ts = _table_state(tdump, ShardedHostTable(_tcfg(), seed=1))
    np.testing.assert_array_equal(tk, jk)
    assert set(ts) == set(js)
    for f in js:
        if js[f].dtype.kind in "iu":
            np.testing.assert_array_equal(ts[f], js[f], err_msg=f)
        else:
            np.testing.assert_allclose(ts[f], js[f], err_msg=f, **TOL)


# -- the dense vector the fleet folds ----------------------------------------

def _trainer():
    eng = BoxPSEngine(_tcfg(), seed=1, device="cpu")
    return SparseTrainer(eng, _model_fn(), _feed(), 64, seed=2,
                         device="cpu")


def _adam_steps(tr, n, seed):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        tr.dense_opt.zero_grad()
        for p in tr.model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        tr.dense_opt.step()


def test_dense_flatten_round_trips_fresh_and_trained_adam():
    fresh, trained = _trainer(), _trainer()
    _adam_steps(trained, 3, seed=0)
    assert not fresh.dense_opt.state and trained.dense_opt.state
    v_fresh = fleet_runner._flatten_dense(fresh)
    v_trained = fleet_runner._flatten_dense(trained)
    # one layout before and after Adam's lazy state exists
    assert v_fresh.shape == v_trained.shape and v_fresh.dtype == np.float32
    n_par = sum(p.numel() for p in fresh.model.parameters())
    assert not v_fresh[n_par:].any()              # absent state = zeros
    # trained -> fresh: the fresh trainer now holds every state entry,
    # with Adam's own dtypes and devices, bound to its own Parameters
    params_before = [id(p) for p in fresh.model.parameters()]
    fleet_runner._unflatten_dense(fresh, v_trained)
    assert [id(p) for p in fresh.model.parameters()] == params_before
    np.testing.assert_array_equal(fleet_runner._flatten_dense(fresh),
                                  v_trained)
    for p in fresh.model.parameters():
        st = fresh.dense_opt.state[p]
        assert st["step"].dtype == torch.float32
        assert st["step"].device.type == "cpu" and st["step"].dim() == 0
        assert st["exp_avg"].shape == p.shape
    # the written state steps on exactly as the trained optimizer does
    twin = _trainer()
    _adam_steps(twin, 3, seed=0)
    _adam_steps(fresh, 2, seed=1)
    _adam_steps(twin, 2, seed=1)
    np.testing.assert_array_equal(fleet_runner._flatten_dense(fresh),
                                  fleet_runner._flatten_dense(twin))
    # fresh (all-zero state) -> trained: a pass-start rollback
    fleet_runner._unflatten_dense(trained, v_fresh)
    np.testing.assert_array_equal(fleet_runner._flatten_dense(trained),
                                  v_fresh)


def test_fleet_entry_points_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_trainer_fleet(1, [("127.0.0.1", 1)], str(tmp_path), _tcfg(),
                          _model_fn, _feed(), [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_runner.FleetRunner(0, 1, None, str(tmp_path), _tcfg(),
                                 _model_fn, _feed(), 64)
