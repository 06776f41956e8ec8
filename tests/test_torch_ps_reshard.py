"""The PyTorch port's elastic PS membership (counterpart of
test_ps_reshard.py, run against ``paddlebox_tpu_torch`` on the CPU): live
key-range handoff, epoch-fenced routing, crash-anywhere resharding.

The contract under test: every fenced sparse verb carries the client's
map epoch; a server answers typed ``wrong_epoch`` / ``not_owner`` /
``migrating`` redirects BEFORE any mutation (so a rejection proves
non-application) and AFTER the dedup echo (so an applied duplicate
still replays its cached ack); the client refreshes its ServerMap from
any live member's health surface — falling through dead entries, so a
dead shard-0 authority can never orphan the fleet — and re-drives only
the provably-unapplied chunks.  Consequences pinned here:

 * growing N=2 -> 4 (and shrinking 4 -> 3) under live traffic and
   between training days is BIT-IDENTICAL to a fixed-width fleet fed
   the same work — no row applied twice, none lost, losses and dense
   params equal;
 * a seeded kill at EVERY migration point (``reshard_snapshot``,
   ``reshard_catchup``, ``reshard_cutover``) is absorbed: either the
   admin client's retry resolves it through the dedup window, or the
   driver aborts, the OLD fleet keeps serving, and a re-run with a
   fresh workdir converges to the same final state;
 * a crash before the MANIFEST membership commit rolls back to the old
   epoch (``read_membership`` still names the old fleet), and a stale
   re-commit is refused;
 * an N=4 dump loads into an N=2 fleet (and back) bit-identically —
   the offline reshard-on-load fallback.
"""

import os
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu_torch import fleet, flags
from paddlebox_tpu_torch.io.checkpoint import (commit_membership,
                                               read_membership)
from paddlebox_tpu_torch.launch import PSElasticWatcher, PSFleet
from paddlebox_tpu_torch.ps import cluster as ps_cluster
from paddlebox_tpu_torch.ps import faults, wire
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.service import (EPOCH_FIELD, FenceError,
                                            PSClient, PSServer,
                                            RemoteTableAdapter)
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get
from torch_ps_helpers import (DATES, assert_fleet_matches_fleet,
                              assert_same_params, fleet_state, fresh,
                              run_days, table_cfg, write_slot_file)

KILL_POINTS = ("reshard_snapshot", "reshard_catchup", "reshard_cutover")


@pytest.fixture(autouse=True)
def _clean():
    StatRegistry.instance().reset()
    flags.set_flags({"ps_fault_injection": True})
    yield
    faults.uninstall()
    flags.set_flags({"ps_fault_injection": False})


def _keys(seed, n=64):
    return np.random.default_rng(seed).choice(
        2 ** 40, n, replace=False).astype(np.uint64)


def _ops(seed, n_batches=5, batch=48):
    """A deterministic write workload: (keys, show-delta) batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        keys = rng.choice(2 ** 40, batch, replace=False).astype(np.uint64)
        out.append((keys, rng.random(batch).astype(np.float32)))
    return out


def _drive(client, ops):
    """Apply one op list: pull-create then delta-push each batch."""
    for keys, show in ops:
        rows = client.pull_sparse(keys, create=True)
        d = {f: np.zeros_like(np.asarray(v)) for f, v in rows.items()}
        d["show"] = show
        client.push_sparse_delta(keys, d)


def _native_state(n, op_lists):
    """Final fleet state of a FIXED width-``n`` fleet fed ``op_lists``
    serially — the reference every elastic run must bit-match."""
    flt = PSFleet(n, table_cfg(), seed=0, max_restarts=4)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                      backoff_cap=0.3, deadline=60)
    try:
        for ops in op_lists:
            _drive(client, ops)
        return fleet_state([s.table for s in flt.sups])
    finally:
        client.close()
        flt.stop()


def _assert_state_equal(a, b):
    ka, sa = a
    kb, sb = b
    np.testing.assert_array_equal(ka, kb)
    assert set(sa) == set(sb)
    for f in sa:
        np.testing.assert_array_equal(
            np.asarray(sa[f]), np.asarray(sb[f]), err_msg=f"field {f!r}")


# ---------------------------------------------------------------------------
# The server-side fence: typed rejections, ordered after the dedup echo.
# ---------------------------------------------------------------------------

def _fenced_server(epoch=1, n=2):
    """One PSServer believing in an ``n``-member map at ``epoch`` (the
    other members are fictional — the fence never dials them)."""
    srv = PSServer(ShardedHostTable(table_cfg(), seed=0))
    addrs = [srv.addr] + [("127.0.0.1", 1 + i) for i in range(n - 1)]
    srv.membership = ps_cluster.make_server_map(addrs, epoch=epoch)
    srv.shard = 0
    return srv


def _owned(srv, seed=0, n=32, shard=None):
    m = srv.membership
    k = _keys(seed, 4096)
    want = srv.shard if shard is None else shard
    k = k[m.shard_of_keys(k) == want][:n]
    assert len(k)
    return k


def test_fence_wrong_epoch_both_directions():
    srv = _fenced_server(epoch=3)
    try:
        k = _owned(srv)
        for stale in (2, 4):   # behind AND ahead both redirect, typed
            with pytest.raises(FenceError) as ei:
                srv._dispatch({"cmd": "pull_sparse", "keys": k,
                               EPOCH_FIELD: stale})
            resp = ei.value.resp()
            assert resp["wrong_epoch"] is True and not resp["ok"]
            assert resp["epoch"] == 3
            assert resp["membership"]["epoch"] == 3   # refresh hint rides
        r = srv._dispatch({"cmd": "pull_sparse", "keys": k,
                           EPOCH_FIELD: 3, "create": True})
        assert r["ok"]
        assert stat_get("ps.server.fence_wrong_epoch") == 2
    finally:
        srv.shutdown()


def test_fence_unstamped_frames_served_only_before_first_reshard():
    # epoch 0 = no reshard ever happened: legacy unfenced frames serve
    srv = _fenced_server(epoch=0)
    try:
        k = _owned(srv)
        assert srv._dispatch({"cmd": "pull_sparse", "keys": k,
                              "create": True})["ok"]
    finally:
        srv.shutdown()
    # epoch > 0: an unstamped frame could address a moved range — reject
    srv = _fenced_server(epoch=1)
    try:
        with pytest.raises(FenceError) as ei:
            srv._dispatch({"cmd": "pull_sparse", "keys": _owned(srv)})
        assert ei.value.kind == "wrong_epoch"
    finally:
        srv.shutdown()


def test_fence_not_owner_wrong_range_and_departed_member():
    srv = _fenced_server(epoch=1, n=2)
    try:
        stray = _owned(srv, shard=1)       # keys the map sends elsewhere
        with pytest.raises(FenceError) as ei:
            srv._dispatch({"cmd": "pull_sparse", "keys": stray,
                           EPOCH_FIELD: 1})
        assert ei.value.kind == "not_owner"
        srv.shard = -1                     # departed: owns NOTHING now
        with pytest.raises(FenceError) as ei:
            srv._dispatch({"cmd": "pull_sparse", "keys": _owned(srv,
                                                               shard=0),
                           EPOCH_FIELD: 1})
        assert ei.value.kind == "not_owner"
    finally:
        srv.shutdown()


def test_fence_freeze_blocks_only_moving_range_writes():
    srv = _fenced_server(epoch=1, n=1)
    try:
        k = _keys(5, 512)
        rows = srv._dispatch({"cmd": "pull_sparse", "keys": k,
                              EPOCH_FIELD: 1, "create": True})["rows"]
        d = {f: np.zeros_like(np.asarray(v)) for f, v in rows.items()}
        # stage a frozen migration to a fictional 2-wide map; this
        # server keeps new-index 0
        new = ps_cluster.make_server_map(
            [srv.addr, ("127.0.0.1", 1)], epoch=2)
        with srv._reshard_lock:
            srv._reshard = {"map": new, "self_new": 0, "dirty": {},
                            "frozen": True}
        moving = k[new.shard_of_keys(k) != 0]
        staying = k[new.shard_of_keys(k) == 0]

        def _sub(keys):
            return {f: np.asarray(v)[np.isin(k, keys)]
                    for f, v in d.items()}

        with pytest.raises(FenceError) as ei:   # moving write: blocked
            srv._dispatch({"cmd": "push_sparse", "keys": moving,
                           "rows": _sub(moving), EPOCH_FIELD: 1})
        assert ei.value.kind == "migrating"
        # non-moving write AND moving READ both serve at full rate
        assert srv._dispatch({"cmd": "push_sparse", "keys": staying,
                              "rows": _sub(staying),
                              EPOCH_FIELD: 1})["ok"]
        assert srv._dispatch({"cmd": "pull_sparse", "keys": moving,
                              EPOCH_FIELD: 1})["ok"]
    finally:
        srv.shutdown()


def test_fence_runs_after_dedup_echo():
    """An applied-but-unacked mutation must replay its cached ack even
    when the resend arrives with a now-stale epoch — the fence rejecting
    it would turn exactly-once into exactly-zero."""
    srv = _fenced_server(epoch=1)
    try:
        k = _owned(srv)
        rows = srv._dispatch({"cmd": "pull_sparse", "keys": k,
                              EPOCH_FIELD: 1, "create": True})["rows"]
        d = {f: np.zeros_like(np.asarray(v)) for f, v in rows.items()}
        d["show"] = np.ones(len(k), np.float32)
        req = {"cmd": "push_sparse_delta", "keys": k, "rows": d,
               EPOCH_FIELD: 1, wire.RID_FIELD: "fence-test:1"}
        assert srv._dispatch(dict(req))["ok"]
        srv.membership = ps_cluster.make_server_map(
            list(srv.membership.addrs), epoch=2)
        assert srv._dispatch(dict(req))["ok"]        # cached ack replays
        got = srv._dispatch({"cmd": "pull_sparse", "keys": k,
                             EPOCH_FIELD: 2})["rows"]
        np.testing.assert_array_equal(np.asarray(got["show"]),
                                      rows["show"] + 1.0)   # ONCE
        # same staleness on a FRESH rid is a real fence rejection
        req2 = dict(req)
        req2[wire.RID_FIELD] = "fence-test:2"
        with pytest.raises(FenceError):
            srv._dispatch(req2)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# Client map refresh: dead authority fall-through + typed-redirect recovery.
# ---------------------------------------------------------------------------

def _member_fleet(n, epoch):
    tables = [ShardedHostTable(table_cfg(), seed=0) for _ in range(n)]
    srvs = [PSServer(t) for t in tables]
    m = ps_cluster.make_server_map([s.addr for s in srvs], epoch=epoch)
    for i, s in enumerate(srvs):
        s.membership = m
        s.shard = i
    return srvs


def test_refresh_falls_through_dead_shard0():
    srvs = _member_fleet(3, epoch=4)
    client = PSClient([s.addr for s in srvs], retries=None,
                      retry_sleep=0.05, backoff_cap=0.2, deadline=20)
    try:
        srvs[0].kill()          # the preferred membership authority dies
        assert client.refresh_server_map(timeout=1.0)
        assert client.server_map.epoch == 4
        assert stat_get("ps.client.map_probe_miss") >= 1
    finally:
        client.close()
        for s in srvs:
            s.shutdown()


def test_wrong_epoch_redirect_recovers_without_caller_error():
    """A client whose map is a whole epoch behind the fleet: the first
    fenced verb draws a typed redirect, refreshes off the carried hint,
    and re-drives — the caller sees rows, never an exception."""
    srvs = _member_fleet(3, epoch=2)
    client = PSClient([s.addr for s in srvs], retries=None,
                      retry_sleep=0.05, backoff_cap=0.2, deadline=20)
    try:
        k = _keys(9, 128)
        rows = client.pull_sparse(k, create=True)
        assert len(np.asarray(rows["show"])) == len(k)
        assert client.server_map.epoch == 2          # adopted en route
        assert stat_get("ps.client.fence_redirect") >= 1
        assert stat_get("ps.server.fence_wrong_epoch") >= 1
        d = {f: np.zeros_like(np.asarray(v)) for f, v in rows.items()}
        d["show"] = np.ones(len(k), np.float32)
        client.push_sparse_delta(k, d)               # fenced write path
        got = client.pull_sparse(k)
        np.testing.assert_array_equal(np.asarray(got["show"]),
                                      np.asarray(rows["show"]) + 1.0)
    finally:
        client.close()
        for s in srvs:
            s.shutdown()


# ---------------------------------------------------------------------------
# Live migration: grow/shrink equivalence, traffic during the handoff.
# ---------------------------------------------------------------------------

def test_live_grow_matches_native_fleet(tmp_path):
    flt = PSFleet(2, table_cfg(), seed=0, max_restarts=4)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                      backoff_cap=0.3, deadline=60)
    try:
        _drive(client, _ops(1))
        flt.resize(4, str(tmp_path / "grow"))
        assert flt.n == 4 and flt.epoch == 1
        _drive(client, _ops(2))      # outer client learns via redirect
        assert client.server_map.epoch == 1
        state = fleet_state([s.table for s in flt.sups])
    finally:
        client.close()
        flt.stop()
    _assert_state_equal(state, _native_state(4, [_ops(1), _ops(2)]))
    assert stat_get("ps.reshard.completed") >= 1
    assert stat_get("ps.server.reshard_rows_dropped") >= 1


def test_live_shrink_matches_native_fleet(tmp_path):
    flt = PSFleet(4, table_cfg(), seed=0, max_restarts=4)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                      backoff_cap=0.3, deadline=60)
    try:
        _drive(client, _ops(1))
        flt.resize(2, str(tmp_path / "shrink"), retire_grace=60.0)
        assert flt.n == 2 and flt.epoch == 1
        _drive(client, _ops(2))
        # retirees (still up, in grace) dropped every row at cutover
        assert all(s.table.size() == 0 for _, s in flt._retired)
        state = fleet_state([s.table for s in flt.sups])
    finally:
        client.close()
        flt.stop()
    _assert_state_equal(state, _native_state(2, [_ops(1), _ops(2)]))


@pytest.mark.parametrize("dedup_window", [None, 64],
                         ids=["default", "tight-dedup"])
def test_grow_under_live_traffic_exactly_once(tmp_path, dedup_window):
    """A writer hammers one key set straight through the migration: the
    sum it observes afterwards equals exactly the number of pushes that
    returned — nothing doubled by the handoff, nothing lost to the
    freeze.  The tight-dedup variant shrinks the per-server rid window
    to prove convergence rests on the typed-fence protocol (provable
    chunk fates), not on an unbounded dedup history."""
    old = flags.get_flags("ps_dedup_window")
    if dedup_window is not None:
        flags.set_flags({"ps_dedup_window": dedup_window})
    flt = PSFleet(2, table_cfg(), seed=0, max_restarts=4)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.02,
                      backoff_cap=0.2, deadline=60)
    try:
        k = _keys(21, 96)
        base = np.asarray(client.pull_sparse(k, create=True)["show"]).copy()
        rows = client.pull_sparse(k)
        d = {f: np.zeros_like(np.asarray(v)) for f, v in rows.items()}
        d["show"] = np.ones(len(k), np.float32)
        applied = [0]
        stop = threading.Event()
        errs = []

        def writer():
            try:
                while not stop.is_set():
                    client.push_sparse_delta(k, d)
                    applied[0] += 1
            except Exception as e:      # noqa: BLE001 - surfaced below
                errs.append(e)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            flt.resize(4, str(tmp_path / "grow"))
        finally:
            stop.set()
            t.join(timeout=60)
        assert not errs, errs            # migration is never a user error
        client.push_sparse_delta(k, d)   # post-cutover write lands too
        applied[0] += 1
        got = np.asarray(client.pull_sparse(k)["show"])
        np.testing.assert_array_equal(got, base + float(applied[0]))
        fleet_state([s.table for s in flt.sups])   # no duplicate owners
        assert flt.n == 4 and client.server_map.epoch == 1
    finally:
        flags.set_flags({"ps_dedup_window": old})
        client.close()
        flt.stop()


# ---------------------------------------------------------------------------
# Crash-anywhere: a seeded kill at every migration point.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", KILL_POINTS)
def test_kill_at_migration_point_absorbed(tmp_path, point):
    """One injected death at each window: the admin client's pinned-rid
    retry (or the driver's cutover re-drive) resolves it — the resize
    completes and the state still bit-matches the native fleet."""
    plan = faults.install(faults.FaultPlan(seed=11).kill_at(point,
                                                            at=(0,)))
    flt = PSFleet(2, table_cfg(), seed=0, max_restarts=4)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                      backoff_cap=0.3, deadline=60)
    try:
        _drive(client, _ops(1))
        flt.resize(4, str(tmp_path / "grow"), timeout=60)
        assert plan.killed.is_set()      # the point actually fired
        faults.uninstall()
        _drive(client, _ops(2))
        state = fleet_state([s.table for s in flt.sups])
    finally:
        faults.uninstall()
        client.close()
        flt.stop()
    _assert_state_equal(state, _native_state(4, [_ops(1), _ops(2)]))


@pytest.mark.parametrize("point", KILL_POINTS)
def test_persistent_failure_rolls_back_then_rerun_converges(tmp_path,
                                                            point):
    """EVERY attempt at one point dies until the driver gives up: a
    pre-cutover failure aborts (old fleet immediately serviceable at the
    old epoch); a cutover failure leaves the target retryable.  Either
    way a re-run with a FRESH workdir converges bit-identically."""
    plan = faults.install(
        faults.FaultPlan(seed=7).kill_at(point, at=tuple(range(256)),
                                         limit=None))
    flt = PSFleet(2, table_cfg(), seed=0, max_restarts=4)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                      backoff_cap=0.3, deadline=60)
    try:
        _drive(client, _ops(1))
        with pytest.raises(Exception):
            flt.resize(4, str(tmp_path / "m1"), timeout=3)
        assert plan.killed.is_set()
        assert flt.n == 2 and flt.epoch == 0        # nothing adopted
        faults.uninstall()
        if point != "reshard_cutover":
            # pre-cutover abort: the old fleet serves writes right away
            assert stat_get("ps.reshard.abort") >= 1
            _drive(client, _ops(2))
        flt.resize(4, str(tmp_path / "m2"), timeout=60)
        assert flt.n == 4 and flt.epoch >= 1
        if point == "reshard_cutover":
            _drive(client, _ops(2))
        _drive(client, _ops(3))
        state = fleet_state([s.table for s in flt.sups])
    finally:
        faults.uninstall()
        client.close()
        flt.stop()
    _assert_state_equal(state,
                        _native_state(4, [_ops(1), _ops(2), _ops(3)]))


def test_manifest_membership_commit_and_rollback(tmp_path):
    root = str(tmp_path / "ckpt")
    os.makedirs(root)
    flt = PSFleet(2, table_cfg(), seed=0, ckpt_root=root, max_restarts=4)
    client = PSClient(flt.addrs, retries=None, deadline=60)
    try:
        _drive(client, _ops(1))
        # a failed migration never touches the manifest: rollback to the
        # old membership is "the pointer never moved"
        faults.install(faults.FaultPlan(seed=3).kill_at(
            "reshard_catchup", at=tuple(range(256)), limit=None))
        with pytest.raises(Exception):
            flt.resize(3, str(tmp_path / "m1"), timeout=3)
        faults.uninstall()
        assert read_membership(root) is None
        flt.resize(3, str(tmp_path / "m2"))
        m = read_membership(root)
        assert m is not None and m.epoch == flt.epoch == 1
        assert [tuple(a) for a in m.addrs] == \
            [tuple(a) for a in flt.addrs]
        # a stale epoch can never un-commit the pointer
        stale = ps_cluster.make_server_map(list(m.addrs)[:2], epoch=0)
        assert commit_membership(root, stale) is False
        assert read_membership(root).epoch == 1
    finally:
        faults.uninstall()
        client.close()
        flt.stop()


# ---------------------------------------------------------------------------
# Training through resizes: the end-to-end bit-identity acceptance.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def day_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("reshard-passes")
    out = {}
    for day in range(2):
        out[day] = []
        for p in range(3):
            path = str(d / f"d{day}p{p}.txt")
            write_slot_file(path, np.random.default_rng(300 * day + p), 48)
            out[day].append([path])
    return out


@pytest.fixture(scope="module")
def n2_baseline(day_files):
    """The fixed-N=2 fault-free reference run."""
    return run_days(day_files, 2, prefetch=False)


def _run_days_elastic(day_files, workroot, prefetch, plan=None,
                      shrink_to=3):
    """Train day 0 on N=2, grow to 4 (optionally under an armed fault
    plan), train day 1 on N=4, then shrink to ``shrink_to`` — the
    2 -> 4 -> 3 elastic schedule; → (tables, trainer, metrics)."""
    flt = PSFleet(2, table_cfg(), seed=0, max_restarts=16)
    client = PSClient(flt.addrs, retries=None, retry_sleep=0.05,
                      backoff_cap=0.3, deadline=60)
    eng, ds, tr = fresh(table=RemoteTableAdapter(client, delta_mode=True))
    metrics = []
    try:
        metrics.extend(fleet.train_passes(
            tr, ds, day_files[0], date=DATES[0], prefetch=prefetch))
        if plan is not None:
            faults.install(plan)
        try:
            flt.resize(4, os.path.join(workroot, "grow"), timeout=60)
        finally:
            faults.uninstall()
        metrics.extend(fleet.train_passes(
            tr, ds, day_files[1], date=DATES[1], prefetch=prefetch))
        flt.resize(shrink_to, os.path.join(workroot, "shrink"),
                   timeout=60)
    finally:
        faults.uninstall()
        client.close()
        flt.stop()
    return [s.table for s in flt.sups], tr, metrics


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["serial", "prefetched"])
def test_train_elastic_grow_shrink_bit_identical(tmp_path, day_files,
                                                 n2_baseline, prefetch):
    tables_b, tr_b, m_b = n2_baseline
    tables_e, tr_e, m_e = _run_days_elastic(
        day_files, str(tmp_path), prefetch=prefetch)
    np.testing.assert_array_equal([m["loss"] for m in m_b],
                                  [m["loss"] for m in m_e])
    assert_same_params(tr_b, tr_e)
    assert_fleet_matches_fleet(tables_b, tables_e)
    assert stat_get("ps.reshard.completed") >= 2     # grow AND shrink


@pytest.mark.slow
@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["serial", "prefetched"])
@pytest.mark.parametrize("point", KILL_POINTS)
def test_train_elastic_kill_at_point_bit_identical(tmp_path, day_files,
                                                   n2_baseline, point,
                                                   prefetch):
    """The grow migration dies once at each window while a training run
    straddles it: training must finish bit-identical to the fixed-N
    fault-free baseline — losses, dense params, full table state."""
    tables_b, tr_b, m_b = n2_baseline
    plan = faults.FaultPlan(seed=13).kill_at(point, at=(0,))
    tables_e, tr_e, m_e = _run_days_elastic(
        day_files, str(tmp_path), prefetch=prefetch, plan=plan)
    assert plan.killed.is_set()
    np.testing.assert_array_equal([m["loss"] for m in m_b],
                                  [m["loss"] for m in m_e])
    assert_same_params(tr_b, tr_e)
    assert_fleet_matches_fleet(tables_b, tables_e)


# ---------------------------------------------------------------------------
# Offline fallback: reshard-on-load round trip.
# ---------------------------------------------------------------------------

def test_reshard_on_load_roundtrip(tmp_path):
    """save N=4 -> load N=2 -> save -> load N=4: bit-identical, each
    cross-width load routed through the owner filter."""
    flt4 = PSFleet(4, table_cfg(), seed=0, max_restarts=4)
    c4 = PSClient(flt4.addrs, retries=None, deadline=60)
    try:
        _drive(c4, _ops(1))
        state0 = fleet_state([s.table for s in flt4.sups])
        ps_cluster.cluster_save(c4, str(tmp_path / "w4"), mode="all")
    finally:
        c4.close()
        flt4.stop()

    flt2 = PSFleet(2, table_cfg(), seed=0, max_restarts=4)
    c2 = PSClient(flt2.addrs, retries=None, deadline=60)
    try:
        n = ps_cluster.cluster_load(c2, str(tmp_path / "w4"),
                                    mode="replace")
        assert n == len(state0[0])
        _assert_state_equal(fleet_state([s.table for s in flt2.sups]),
                            state0)
        ps_cluster.cluster_save(c2, str(tmp_path / "w2"), mode="all")
    finally:
        c2.close()
        flt2.stop()

    flt4b = PSFleet(4, table_cfg(), seed=0, max_restarts=4)
    c4b = PSClient(flt4b.addrs, retries=None, deadline=60)
    try:
        ps_cluster.cluster_load(c4b, str(tmp_path / "w2"),
                                mode="replace")
        _assert_state_equal(fleet_state([s.table for s in flt4b.sups]),
                            state0)
    finally:
        c4b.close()
        flt4b.stop()
    assert stat_get("ps.cluster.reshard_on_load") >= 2


# ---------------------------------------------------------------------------
# The launcher surface: the elastic file watcher.
# ---------------------------------------------------------------------------

def test_elastic_watcher_grow_shrink_and_env_export(tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv(ps_cluster.ADDRS_ENV, "sentinel:0")
    flt = PSFleet(2, table_cfg(), seed=0, max_restarts=4)
    client = PSClient(flt.addrs, retries=None, deadline=60)
    watcher = PSElasticWatcher(flt, str(tmp_path / "elastic"),
                               str(tmp_path / "work"), poll_s=0.05,
                               retire_grace=0.0, timeout=60)
    try:
        _drive(client, _ops(1))
        # malformed request: eaten, not retried, fleet untouched
        bad = tmp_path / "elastic" / "ps_grow"
        bad.write_text("banana\n")
        deadline = time.monotonic() + 10
        while bad.exists() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not bad.exists() and flt.n == 2

        (tmp_path / "elastic" / "ps_grow").write_text("2\n")
        deadline = time.monotonic() + 60
        while flt.n != 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert flt.n == 4 and flt.epoch == 1
        assert os.environ[ps_cluster.ADDRS_ENV] == flt.env_value()

        (tmp_path / "elastic" / "ps_shrink").write_text("1\n")
        deadline = time.monotonic() + 60
        while flt.n != 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert flt.n == 3 and flt.epoch == 2
        assert os.environ[ps_cluster.ADDRS_ENV] == flt.env_value()
        _drive(client, _ops(2))
        state = fleet_state([s.table for s in flt.sups])
    finally:
        watcher.stop()
        client.close()
        flt.stop()
    _assert_state_equal(state, _native_state(3, [_ops(1), _ops(2)]))
