"""The PyTorch port's sharded PS cluster (counterpart of
test_ps_cluster.py, run against ``paddlebox_tpu_torch`` on the CPU):
key-space partitioning across N parameter servers with bit-identical
training.

The contract under test: a `ServerMap` deterministically assigns every
key to exactly one of N servers, the sharded `PSClient` fans row verbs
out per shard and runs lifecycle verbs 2-phase over the per-shard dedup
windows, and the generation checkpoint commits ALL shards through ONE
cluster MANIFEST.  Consequences pinned here:

 * N=1 and N=4 training are BIT-IDENTICAL (losses, dense params, and
   the union-of-shards table), serial and prefetched — each key's row
   lives on one shard, fresh-row defaults are pure in (seed, key), and
   per-key RMW order within a shard is unchanged by the partition;
 * a mid-verb death of ONE shard + supervisor restart (dedup handoff)
   leaves training bit-identical to the fault-free run;
 * a caller-level retry of a partially-committed `end_day` replays the
   pinned rid group through the dedup windows — every shard decays
   exactly once;
 * a crash between the per-shard sparse dumps and the cluster MANIFEST
   swap rolls EVERY shard back to the previous generation together.
"""

import os

import numpy as np
import pytest

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.launch import PSFleet
from paddlebox_tpu_torch.ps import cluster as ps_cluster
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.cluster import ServerMap
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.service import (PSClient, PSServer,
                                            RemoteTableAdapter)
from paddlebox_tpu_torch.utils.monitor import (StatRegistry, stat_get,
                                               stat_snapshot)
from torch_ps_helpers import (DATES, StubTrainer,
                              assert_fleet_matches_fleet,
                              assert_fleet_matches_table, assert_same_params,
                              fleet_state, fresh, mini_pass, run_days,
                              table_cfg, write_slot_file)

N_WIDE = 4


@pytest.fixture(autouse=True)
def _clean():
    StatRegistry.instance().reset()
    flags.set_flags({"ps_fault_injection": True})
    yield
    faults.uninstall()
    flags.set_flags({"ps_fault_injection": False})


# ---------------------------------------------------------------------------
# ServerMap: deterministic, order-preserving, balanced; the env export.
# ---------------------------------------------------------------------------

def test_server_map_deterministic_and_balanced():
    addrs = [("127.0.0.1", 9000 + i) for i in range(N_WIDE)]
    keys = np.random.default_rng(3).choice(
        2 ** 40, 40_000, replace=False).astype(np.uint64)
    a = ServerMap(addrs).shard_of_keys(keys)
    b = ServerMap(list(addrs)).shard_of_keys(keys)
    np.testing.assert_array_equal(a, b)        # instance-independent
    counts = np.bincount(a, minlength=N_WIDE)
    assert counts.min() > 0.2 * len(keys)      # splitmix64 is uniform
    assert counts.max() < 0.3 * len(keys)
    # n == 1 routes everything to shard 0 (the pre-cluster client)
    assert not ServerMap(addrs[:1]).shard_of_keys(keys).any()


def test_server_map_partition_preserves_relative_order():
    keys = np.random.default_rng(7).integers(
        1, 2 ** 40, size=5_000).astype(np.uint64)
    smap = ServerMap([("h", 1), ("h", 2), ("h", 3)])
    pos = smap.partition(keys)
    assert sum(len(p) for p in pos) == len(keys)
    for s, p in enumerate(pos):
        assert np.all(np.diff(p) > 0)          # original order kept
        assert (smap.shard_of_keys(keys[p]) == s).all()


def test_addrs_env_roundtrip(monkeypatch):
    addrs = [("127.0.0.1", 9000), ("10.0.0.2", 9001)]
    spec = ps_cluster.format_addrs(addrs)
    assert ps_cluster.parse_addrs(spec) == addrs
    monkeypatch.setenv(ps_cluster.ADDRS_ENV, spec)
    assert ps_cluster.addrs_from_env() == addrs
    monkeypatch.delenv(ps_cluster.ADDRS_ENV)
    assert ps_cluster.addrs_from_env() is None


# ---------------------------------------------------------------------------
# Sharded data plane: fan-out pulls/pushes match the single server.
# ---------------------------------------------------------------------------

def test_sharded_client_matches_single_server():
    keys = np.random.default_rng(11).choice(
        2 ** 40, 3_000, replace=False).astype(np.uint64)
    srv = PSServer(ShardedHostTable(table_cfg(), seed=0))
    flt = PSFleet(N_WIDE, table_cfg(), seed=0)
    c1 = c4 = None
    try:
        c1 = PSClient(srv.addr, deadline=30)
        c4 = PSClient(flt.addrs, deadline=30)
        assert c4.n_shards == N_WIDE
        r1 = c1.pull_sparse(keys, create=True)
        r4 = c4.pull_sparse(keys, create=True)
        assert set(r1) == set(r4)
        for f in r1:                      # fresh-row purity in (seed, key)
            np.testing.assert_array_equal(np.asarray(r1[f]),
                                          np.asarray(r4[f]))
        d = {f: np.zeros_like(np.asarray(v)) for f, v in r1.items()}
        d["show"] = np.ones(len(keys), np.float32)
        c1.push_sparse_delta(keys, d)
        c4.push_sparse_delta(keys, d)
        np.testing.assert_array_equal(
            np.asarray(c1.pull_sparse(keys)["show"]),
            np.asarray(c4.pull_sparse(keys)["show"]))
        assert c1.size() == c4.size()     # union of shards, no double-home
        assert_fleet_matches_table([s.table for s in flt.sups], srv.table)
        snap = stat_snapshot("ps.cluster.")
        assert snap.get("ps.cluster.fan_out_width.count", 0) > 0
        assert any(k.startswith("ps.cluster.s") and k.endswith("pull_keys")
                   for k in snap)
    finally:
        if c1 is not None:
            c1.close()
        if c4 is not None:
            c4.close()
        flt.stop()
        srv.shutdown()


def test_fleet_one_shard_kill_midverb_restart():
    """One shard dies mid pull_sparse; its supervisor restarts it on the
    same port; the sharded client's retry lands — other shards never
    notice and the reassembled rows are exact."""
    keys = np.arange(1, 4001, dtype=np.uint64)
    flt = PSFleet(N_WIDE, table_cfg(), seed=0)
    client = None
    try:
        client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                          backoff_cap=0.2, deadline=30)
        rows = client.pull_sparse(keys, create=True)
        faults.install(faults.FaultPlan(seed=5)
                       .kill_server(cmd="pull_sparse", at=(0,)))
        got = client.pull_sparse(keys)
        faults.uninstall()
        for f in rows:
            np.testing.assert_array_equal(np.asarray(got[f]),
                                          np.asarray(rows[f]))
        assert sum(s.restarts for s in flt.sups) >= 1
        assert stat_get("ps.supervisor.restarts") >= 1
    finally:
        faults.uninstall()
        if client is not None:
            client.close()
        flt.stop()


def test_cluster_applied_unacked_delta_exactly_once():
    """One shard applies a delta chunk but its ack is dropped: the
    client's per-shard pipeline retries the SAME rid, the shard's dedup
    window returns the cached response, and every key lands the delta
    exactly once — no shard double-applies."""
    keys = np.arange(1, 2001, dtype=np.uint64)
    flt = PSFleet(N_WIDE, table_cfg(), seed=0)
    client = None
    try:
        client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                          backoff_cap=0.2, deadline=30)
        rows = client.pull_sparse(keys, create=True)
        base = np.asarray(rows["show"]).copy()
        d = {f: np.zeros_like(np.asarray(v)) for f, v in rows.items()}
        d["show"] = np.ones(len(keys), np.float32)
        faults.install(faults.FaultPlan(seed=3)
                       .drop("send", role="server", at=(0,)))
        client.push_sparse_delta(keys, d)    # first shard ack is dropped
        faults.uninstall()
        assert stat_get("ps.fault.send.drop") >= 1   # applied, ack lost
        got = np.asarray(client.pull_sparse(keys)["show"])
        np.testing.assert_array_equal(got, base + 1.0)   # exactly once
        assert stat_get("ps.server.dedup_hit") >= 1
    finally:
        faults.uninstall()
        if client is not None:
            client.close()
        flt.stop()


# ---------------------------------------------------------------------------
# 2-phase lifecycle: a partial commit retried decays exactly once.
# ---------------------------------------------------------------------------

def test_end_day_two_phase_retry_decays_once():
    keys = np.random.default_rng(19).choice(
        2 ** 40, 2_000, replace=False).astype(np.uint64)

    def seed_rows(client):
        rows = client.pull_sparse(keys, create=True)
        d = {f: np.zeros_like(np.asarray(v)) for f, v in rows.items()}
        d["show"] = np.full(len(keys), 3.0, np.float32)
        d["click"] = np.ones(len(keys), np.float32)
        client.push_sparse_delta(keys, d)

    # reference: one clean end_day on a single server, same seed/keys
    srv = PSServer(ShardedHostTable(table_cfg(), seed=0))
    try:
        c1 = PSClient(srv.addr, deadline=30)
        seed_rows(c1)
        c1.end_day()
        want = {f: np.asarray(v)
                for f, v in c1.pull_sparse(keys).items()}
        c1.close()
    finally:
        srv.shutdown()

    flt = PSFleet(N_WIDE, table_cfg(), seed=0)
    client = None
    try:
        client = PSClient(flt.addrs, deadline=30)
        seed_rows(client)
        orig = client._call
        state = {"armed": True}

        def flaky(req, **kw):
            resp = orig(req, **kw)
            if state["armed"] and req.get("cmd") == "lifecycle_commit" \
                    and kw.get("shard") == 2:
                # the commit APPLIED server-side; only the ack is lost —
                # the partial-failure window 2-phase must survive
                state["armed"] = False
                raise ConnectionError("injected: commit ack lost")
            return resp

        client._call = flaky
        with pytest.raises(ConnectionError):
            client.end_day()
        client._call = orig
        assert client._txn_groups            # group pinned for the retry
        client.end_day()                     # replays the SAME rids
        assert not client._txn_groups
        got = client.pull_sparse(keys)
        for f in want:
            np.testing.assert_array_equal(
                np.asarray(got[f]), want[f],
                err_msg=f"field {f!r} decayed !=1 times on some shard")
        assert stat_get("ps.cluster.lifecycle_commit") >= 1
        assert stat_get("ps.server.dedup_hit") >= 1   # the replayed rids
    finally:
        if client is not None:
            client.close()
        flt.stop()


# ---------------------------------------------------------------------------
# Cluster MANIFEST: a partial commit rolls ALL shards back together.
# ---------------------------------------------------------------------------

def test_partial_commit_rolls_all_shards_back(tmp_path):
    """Crash in the window where every shard's sparse dump landed (the
    gen dir is fully assembled) but the cluster MANIFEST still names the
    previous generation: recovery must load generation 0 on EVERY shard
    — no shard may serve the uncommitted pass-1 rows."""
    root = str(tmp_path / "ckpt")
    flt = PSFleet(N_WIDE, table_cfg(), seed=0)
    client = None
    try:
        client = PSClient(flt.addrs, deadline=30)
        eng, _, _ = fresh(table=RemoteTableAdapter(client,
                                                    delta_mode=True))
        eng.set_date(DATES[0])
        tr = StubTrainer()
        ck = TrainCheckpoint(root)
        mini_pass(eng, 0)
        ck.save(eng, tr)                               # gen 0 committed
        want_k, want_s = fleet_state([s.table for s in flt.sups])

        mini_pass(eng, 1)                             # uncommitted state
        faults.install(faults.FaultPlan(seed=13)
                       .kill_at("ckpt_commit", at=(0,)))
        with pytest.raises(faults.InjectedFault):
            ck.save_pass(eng, tr)
        faults.uninstall()
        # the dangerous shape: gen-1 fully assembled on disk, every
        # shard's subdir present — but the MANIFEST never advanced
        assert os.path.isdir(os.path.join(root, "gen-000001"))
        assert ck._manifest() == 0
    finally:
        faults.uninstall()
        if client is not None:
            client.close()
        flt.stop()

    flt2 = PSFleet(N_WIDE, table_cfg(), seed=0)
    client2 = None
    try:
        client2 = PSClient(flt2.addrs, deadline=30)
        eng2, _, _ = fresh(table=RemoteTableAdapter(client2,
                                                     delta_mode=True))
        tr2 = StubTrainer()
        state = TrainCheckpoint(root).resume(eng2, tr2)
        assert state["generation"] == 0
        got_k, got_s = fleet_state([s.table for s in flt2.sups])
        np.testing.assert_array_equal(got_k, want_k)
        for f in want_s:
            np.testing.assert_array_equal(
                np.asarray(got_s[f]), np.asarray(want_s[f]),
                err_msg=f"field {f!r}: a shard kept uncommitted rows")
    finally:
        if client2 is not None:
            client2.close()
        flt2.stop()


# ---------------------------------------------------------------------------
# The acceptance runs: 2 days x 3 passes of DeepFM, N=1 vs N=4.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def day_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cluster-passes")
    out = {}
    for day in range(2):
        out[day] = []
        for p in range(3):
            path = str(d / f"d{day}p{p}.txt")
            write_slot_file(path, np.random.default_rng(100 * day + p), 48)
            out[day].append([path])
    return out


@pytest.fixture(scope="module")
def n1_baseline(day_files):
    """The N=1 fault-free reference (remote adapter, so every N=4 run
    compares against the same arithmetic path)."""
    return run_days(day_files, 1, prefetch=False)


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["serial", "prefetched"])
def test_train_bit_identical_n1_vs_n4(day_files, n1_baseline, prefetch):
    tables_1, tr_1, m_1 = n1_baseline
    tables_4, tr_4, m_4 = run_days(day_files, N_WIDE, prefetch=prefetch)
    np.testing.assert_array_equal([m["loss"] for m in m_1],
                                  [m["loss"] for m in m_4])
    assert_same_params(tr_1, tr_4)
    assert_fleet_matches_fleet(tables_1, tables_4)


@pytest.mark.slow
def test_chaos_one_shard_kill_bit_identical(day_files, n1_baseline):
    """Seeded chaos on the N=4 fleet: one shard killed mid
    push_sparse_delta (supervisor restart + dedup handoff) plus an
    applied-unacked ack drop — final state bit-identical to the
    fault-free N=1 baseline."""
    tables_1, tr_1, m_1 = n1_baseline
    plan = (faults.FaultPlan(seed=17)
            .drop("send", role="server", at=(2,))
            .kill_server(cmd="push_sparse_delta", at=(5,)))
    tables_4, tr_4, m_4 = run_days(day_files, N_WIDE, prefetch=False,
                                    plan=plan)
    np.testing.assert_array_equal([m["loss"] for m in m_1],
                                  [m["loss"] for m in m_4])
    assert_same_params(tr_1, tr_4)
    assert_fleet_matches_fleet(tables_1, tables_4)
    assert stat_get("ps.supervisor.restarts") >= 1   # the shard died


def test_cached_prefetched_n4_under_lockdep(day_files, n1_baseline):
    """The N=4 day loop through the prefetcher with the device cache on,
    under the runtime lock-order witness: the pass worker pulls over the
    wire while the main thread trains and writes back, with the client's
    stream pool and the servers' handlers in between.  The witness sees
    lock edges and no cycle, and the run keeps the N=1 baseline's bits
    (the cache's write-back base and fold-back over a delta-mode remote
    table)."""
    from paddlebox_tpu_torch.utils import lockdep
    prev = {k: flags.get_flags(k) for k in
            ("lockdep", "ps_device_cache", "ps_device_cache_rows")}
    flags.set_flags({"lockdep": True, "ps_device_cache": True,
                     "ps_device_cache_rows": 4096})
    lockdep.reset()
    try:
        tables_4, tr_4, m_4 = run_days(day_files, N_WIDE, prefetch=True)
        assert lockdep.edges() and not lockdep.cycles(), lockdep.cycles()
    finally:
        flags.set_flags(prev)
        lockdep.reset()
    tables_1, tr_1, m_1 = n1_baseline
    np.testing.assert_array_equal([m["loss"] for m in m_1],
                                  [m["loss"] for m in m_4])
    assert_same_params(tr_1, tr_4)
    assert_fleet_matches_fleet(tables_1, tables_4)
    assert stat_get("ps.cache.hits") > 0
