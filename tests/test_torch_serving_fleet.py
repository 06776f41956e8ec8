"""The PyTorch port's sharded delta-fresh serving fleet (counterpart of
test_serving_fleet.py, run against ``paddlebox_tpu_torch``; the
checkpoint chain comes from a CPU engine): N-shard reads bit-identical
to one full-table replica — across a streamed save_pass delta flip (zero
failed requests, compaction-cadence boundary included) and a replica
kill (router failover) — plus heat-replicated hot-key p2c routing and
the torn-manifest retry discipline."""

import json
import os
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.ps.serving import ServingReplica, ServingRouter
from paddlebox_tpu_torch.ps.service import DEFAULT_TABLE
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import (StatRegistry, stat_get,
                                         stat_snapshot)
from tests.torch_ps_helpers import StubTrainer as _StubTrainer
from tests.torch_ps_helpers import mini_pass as _mini_pass
from tests.torch_ps_helpers import table_cfg as _table_cfg

N_SHARDS = 4


@pytest.fixture(autouse=True)
def _clean_stats():
    StatRegistry.instance().reset()
    yield


def _grow_chain(ck, eng, tr, n, start=0):
    for p in range(start, start + n):
        _mini_pass(eng, p)
        ck.save_pass(eng, tr)


def _build_chain(root, passes=3, base_every=8):
    """A base + ``passes`` save_pass generations (deltas, re-basing at
    the compaction cadence) from a deterministic engine."""
    eng = BoxPSEngine(_table_cfg(), seed=0, device="cpu")
    eng.set_date("20260807")
    tr = _StubTrainer()
    ck = TrainCheckpoint(root, keep=4, base_every=base_every)
    ck.save(eng, tr)
    _grow_chain(ck, eng, tr, passes)
    return eng, tr, ck


def _query_keys(eng, n_miss=30):
    """Every resident key plus misses, shuffled — the parity probe must
    cover the default-row path on every shard too."""
    keys = np.sort(np.concatenate([s.keys for s in eng.table._shards]))
    rng = np.random.default_rng(7)
    misses = rng.choice(2 ** 50, n_miss, replace=False).astype(np.uint64)
    q = np.concatenate([keys, misses])
    rng.shuffle(q)
    return q


def _spawn_fleet(cfg, root, n_shards=N_SHARDS, hot_keys=None,
                 members=1):
    """``n_shards`` groups of ``members`` identical replicas each, plus
    the shard_groups list for the router."""
    reps, groups = [], []
    for s in range(n_shards):
        grp = []
        for _ in range(members):
            r = ServingReplica(config=cfg, ckpt_root=root, shard=s,
                               n_shards=n_shards, hot_keys=hot_keys)
            reps.append(r)
            grp.append(r.addr)
        groups.append(grp)
    return reps, groups


def _assert_rows_equal(a, b):
    assert set(a) == set(b)
    for f in a:
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]),
                                      err_msg=f)


def _shutdown(reps, routers):
    for r in routers:
        r.close()
    for rep in reps:
        rep.shutdown(drain_timeout=2.0)


# -- N=4 fleet vs N=1 full table: bit-identity --------------------------------

def test_sharded_fleet_bit_identical_to_single_replica(tmp_path):
    """pull_sparse AND forward through a 4-shard fleet (ServerMap fan +
    position merge + client-side pooling) answer byte-equal to one
    full-table replica built from the same generation chain — resident
    rows and miss defaults both."""
    cfg = _table_cfg()
    root = str(tmp_path / "ckpt")
    eng, tr, ck = _build_chain(root, passes=3)
    q = _query_keys(eng)

    solo = ServingReplica(config=cfg, ckpt_root=root)
    fleet, groups = _spawn_fleet(cfg, root)
    r1 = ServingRouter([solo.addr])
    r4 = ServingRouter(shard_groups=groups)
    try:
        _assert_rows_equal(r1.pull_sparse(q), r4.pull_sparse(q))
        lod = np.array([0, 3, 3, 17, len(q)], np.int64)
        np.testing.assert_array_equal(r1.forward(q, lod),
                                      r4.forward(q, lod))
        # every shard holds ONLY its range (no hot set here): fleet
        # memory is partitioned, not mirrored
        healths = r4.health()
        assert [h["shard"] for h in healths] == list(range(N_SHARDS))
        assert all(h["n_shards"] == N_SHARDS for h in healths)
        per_shard = [rep._gen.tables[DEFAULT_TABLE].size() for rep in fleet]
        assert sum(per_shard) == solo._gen.tables[DEFAULT_TABLE].size()
        assert max(per_shard) < solo._gen.tables[DEFAULT_TABLE].size()
    finally:
        _shutdown([solo] + fleet, [r1, r4])


# -- streamed delta flips under load ------------------------------------------

def test_streamed_delta_flip_under_load_zero_failures(tmp_path):
    """watch_ckpt streams new save_pass generations into a 4-shard fleet
    while router traffic runs: ZERO failed requests across every flip
    (including a compaction-cadence re-base), and the converged fleet
    reads bit-identical to a from-scratch load of the same chain."""
    cfg = _table_cfg()
    root = str(tmp_path / "ckpt")
    # base_every=2 → growing the chain below crosses the compaction
    # boundary (delta, rebase-to-base, delta...), exercising BOTH the
    # incremental patch path and the full-rebuild fallback
    eng, tr, ck = _build_chain(root, passes=1, base_every=2)
    q0 = _query_keys(eng, n_miss=10)

    fleet, groups = _spawn_fleet(cfg, root)
    for rep in fleet:
        rep.watch_ckpt(poll_s=0.05)
    router = ServingRouter(shard_groups=groups)
    errors, stop = [], threading.Event()

    def traffic():
        while not stop.is_set():
            try:
                rows = router.pull_sparse(q0)
                assert len(rows["embed_w"]) == len(q0)
            except Exception as e:  # noqa: BLE001 — the assertion IS the test
                errors.append(repr(e))

    threads = [threading.Thread(target=traffic) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for p in range(1, 5):           # gens 2..5, rebases inside
            _grow_chain(ck, eng, tr, 1, start=p)
            time.sleep(0.3)             # let every watcher catch THIS head
                                        # (so delta-extends flow incremental)
        head = ck.head()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if all(rep._gen.generation == head for rep in fleet):
                break
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert errors == [], errors[:3]
        assert all(rep._gen.generation == head for rep in fleet)
        assert stat_get("serving.delta_flip") >= N_SHARDS
        snap = stat_snapshot("serving.staleness_s")
        assert snap.get("serving.staleness_s.count", 0) >= 1
        assert snap.get("serving.staleness_s.p99", -1) >= 0
        flips = flight.events(kind="serving_delta_flip")
        assert any(e.get("incremental") for e in flips)
        assert any(not e.get("incremental") for e in flips), \
            "compaction re-base never exercised the full-rebuild path"

        # parity vs a from-scratch chain load at the same head
        q = _query_keys(eng)
        fresh = ServingReplica(config=cfg, ckpt_root=root)
        rf = ServingRouter([fresh.addr])
        try:
            _assert_rows_equal(rf.pull_sparse(q), router.pull_sparse(q))
        finally:
            rf.close()
            fresh.shutdown(drain_timeout=2.0)
    finally:
        stop.set()
        _shutdown(fleet, [router])


# -- router failover inside a shard group -------------------------------------

def test_group_failover_bit_identity(tmp_path):
    """Kill the primary of a 2-member shard group mid-stream: the router
    rotates to the probed-live member and the retried reads stay
    bit-identical (replicas of one chain answer identically)."""
    cfg = _table_cfg()
    root = str(tmp_path / "ckpt")
    eng, tr, ck = _build_chain(root, passes=2)
    q = _query_keys(eng)

    fleet, groups = _spawn_fleet(cfg, root, n_shards=2, members=2)
    router = ServingRouter(shard_groups=groups)
    try:
        before = router.pull_sparse(q)
        fleet[0].kill()                 # group 0's primary
        after = router.pull_sparse(q)   # ConnectionError → rotate → retry
        _assert_rows_equal(before, after)
        assert stat_get("serving.router.failover") >= 1
        assert any(e.get("group") == 0
                   for e in flight.events(kind="serving_failover"))
        lod = np.array([0, 5, len(q)], np.int64)
        np.testing.assert_array_equal(router.forward(q, lod).shape,
                                      (2, 1 + cfg.embedding_dim))
    finally:
        _shutdown(fleet[1:], [router])


# -- heat-driven hot-key replication + p2c routing ----------------------------

def test_hot_key_replication_p2c_routing(tmp_path):
    """An explicit hot set is replicated into EVERY shard group's planes
    (health round-trips it; the router adopts the intersection) and hot
    keys route p2c off the owner shard — answers stay bit-identical to a
    full-table replica."""
    cfg = _table_cfg()
    root = str(tmp_path / "ckpt")
    eng, tr, ck = _build_chain(root, passes=2)
    keys = np.sort(np.concatenate([s.keys for s in eng.table._shards]))
    hot = keys[:: max(1, len(keys) // 8)][:8]

    solo = ServingReplica(config=cfg, ckpt_root=root)
    fleet, groups = _spawn_fleet(cfg, root, hot_keys=hot)
    r1 = ServingRouter([solo.addr])
    r4 = ServingRouter(shard_groups=groups, seed=3)
    try:
        # the fleet advertises the replicated set; the router adopts the
        # groups' intersection
        assert r4.refresh_hot_keys() == len(hot)
        np.testing.assert_array_equal(r4._hot, np.sort(hot))
        # every group serves a hot key it does NOT own
        for rep in fleet:
            assert rep._gen.tables[DEFAULT_TABLE].resident_mask(hot).all()
        q = _query_keys(eng)
        for _ in range(6):              # several p2c draws
            _assert_rows_equal(r1.pull_sparse(q), r4.pull_sparse(q))
        assert stat_get("serving.router.hot_routed") >= 6
        lod = np.array([0, len(hot)], np.int64)
        np.testing.assert_array_equal(r1.forward(hot, lod),
                                      r4.forward(hot, lod))
    finally:
        _shutdown([solo] + fleet, [r1, r4])


# -- torn-manifest retry discipline -------------------------------------------

def test_manifest_retry_bounded_backoff(tmp_path):
    """A mid-rename MANIFEST (invalid JSON) retries with bounded backoff
    and a manifest_retry flight event; the poll — never the watcher — is
    abandoned when the budget runs out, and a later good manifest still
    flips."""
    cfg = _table_cfg()
    root = str(tmp_path / "ckpt")
    eng, tr, ck = _build_chain(root, passes=1)
    rep = ServingReplica(config=cfg, ckpt_root=root)
    man = os.path.join(root, "MANIFEST.json")
    good = open(man).read()
    try:
        flags.set_flags({"serving_manifest_retries": 2})
        with open(man, "w") as f:
            f.write('{"generation": 1')        # torn write
        assert rep._manifest_poll(ck.head, "ckpt_manifest") is None
        assert stat_get("serving.manifest_retry") == 2
        assert stat_get("serving.manifest_giveup") == 1
        assert len(flight.events(kind="manifest_retry")) == 2
        assert flight.events(kind="manifest_giveup")

        # watcher survives the torn window and applies the next commit
        rep.watch_ckpt(poll_s=0.05)
        with open(man, "w") as f:
            f.write(good)
        _grow_chain(ck, eng, tr, 1, start=1)
        head = ck.head()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and rep._gen.generation != head:
            time.sleep(0.05)
        assert rep._gen.generation == head
        assert json.loads(open(man).read())["generation"] == head
    finally:
        flags.set_flags({"serving_manifest_retries": 4})
        rep.shutdown(drain_timeout=2.0)
