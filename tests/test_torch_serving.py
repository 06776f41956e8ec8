"""The PyTorch port's serving tier (counterpart of test_serving.py, run
against ``paddlebox_tpu_torch``): frozen-table parity, the two-day
hot-swap loop with zero failed requests, per-tenant admission + metrics,
router failover bit-identity, the xbox swap manifest, the hot-swap
coherence invalidations (load_xbox must invalidate the DeviceRowCache
and the client row-width estimates) and the supervisor's restart in
place."""

import json
import os
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu_torch.config import EmbeddingTableConfig
from paddlebox_tpu_torch.io import checkpoint
from paddlebox_tpu_torch.io.checkpoint import (publish_xbox_manifest,
                                         read_xbox_manifest, save_xbox)
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.serving import (FrozenHostTable, ServingOverload,
                                      ServingReplica, ServingRouter)
from paddlebox_tpu_torch.ps.service import PSClient, RemoteTableAdapter
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_snapshot

MF = 4


@pytest.fixture(autouse=True)
def _clean_stats():
    StatRegistry.instance().reset()
    yield


def make_table(n_keys=200, seed=0, day_salt=0.0):
    """A trained-shaped table whose rows CLEAR the xbox base threshold
    (score = 0.1*(show-click) + click must be >= 1.5 or save_xbox
    filters them and the dump comes out empty)."""
    cfg = EmbeddingTableConfig(embedding_dim=MF)
    tab = ShardedHostTable(cfg, seed=0)
    rng = np.random.default_rng(seed)
    keys = rng.choice(2 ** 40, n_keys, replace=False).astype(np.uint64)
    rows = tab.bulk_pull(keys)
    rows["show"] = rows["show"] + 20.0 + day_salt
    rows["click"] = rows["click"] + 5.0
    rows["mf_size"][:] = MF
    rows["mf"][:] = rng.standard_normal(rows["mf"].shape) \
        .astype(np.float32) + day_salt
    tab.bulk_write(keys, rows)
    return cfg, tab, keys


def g6(a):
    """save_xbox's TSV precision (%.6g) round-trip: the values a replica
    serving the DUMP can reproduce of the trainer's float32 rows.
    Replica↔replica stays bit-identical (same dump); replica↔live-table
    comparisons must pass the expectation through this."""
    a = np.asarray(a)
    flat = [np.float32(float(f"{x:.6g}"))
            for x in a.astype(np.float64).ravel()]
    return np.asarray(flat, np.float32).reshape(a.shape)


def dump_xbox(tab, cfg, path):
    class Eng:
        pass
    eng = Eng()
    eng.table, eng.config = tab, cfg
    save_xbox(eng, path, base=True)
    return path


# -- FrozenHostTable ---------------------------------------------------------

def test_frozen_parity_bit_identical():
    """Frozen lookups == live bulk_pull for resident AND miss keys: the
    property that makes replica responses interchangeable with the
    engine (and with each other)."""
    cfg, tab, keys = make_table(300)
    frozen = FrozenHostTable.freeze(tab)
    rng = np.random.default_rng(1)
    misses = rng.choice(2 ** 39, 40, replace=False).astype(np.uint64)
    q = np.concatenate([keys[:50], misses, keys[200:260]])
    rng.shuffle(q)
    live = tab.bulk_pull(q)
    froz = frozen.lookup_rows(q)
    for f in live:
        assert np.array_equal(live[f], froz[f]), f
    assert frozen.size() == 300


def test_frozen_is_lock_free_snapshot():
    """Mutating the source table after freeze must not leak into the
    frozen generation (snapshot semantics, not a view)."""
    cfg, tab, keys = make_table(50)
    frozen = FrozenHostTable.freeze(tab)
    before = frozen.lookup_rows(keys[:5])["embed_w"].copy()
    rows = tab.bulk_pull(keys[:5])
    rows["embed_w"] += 99.0
    tab.bulk_write(keys[:5], rows)
    assert np.array_equal(frozen.lookup_rows(keys[:5])["embed_w"], before)


# -- e2e: two-day loop, hot swap under load ---------------------------------

def test_two_day_hot_swap_zero_failed_requests(tmp_path):
    """The acceptance loop: train day-1 and day-2 tables, save_xbox
    each, serve day-1, hot-swap to day-2 while a query stream runs —
    ZERO failed requests, every response from exactly one whole
    generation, per-tenant qps/latency gauges populated."""
    cfg, tab1, keys = make_table(200, seed=0, day_salt=0.0)
    _, tab2, _ = make_table(200, seed=0, day_salt=1.0)
    d1 = dump_xbox(tab1, cfg, str(tmp_path / "xbox_d1"))
    d2 = dump_xbox(tab2, cfg, str(tmp_path / "xbox_d2"))

    rep = ServingReplica(config=cfg, xbox_path=d1, day="d1")
    router = ServingRouter([rep.addr])
    exp1 = g6(tab1.bulk_pull(keys)["embed_w"])
    exp2 = g6(tab2.bulk_pull(keys)["embed_w"])
    errors, done = [], threading.Event()
    n_ok = [0]

    def stream():
        rng = np.random.default_rng(3)
        try:
            while not done.is_set():
                idx = rng.integers(0, len(keys), 32)
                got = router.pull_sparse(keys[idx])
                # a response must be ONE generation whole — day-1 or
                # day-2 rows, never a mix
                if np.array_equal(got["embed_w"], exp1[idx]):
                    pass
                elif np.array_equal(got["embed_w"], exp2[idx]):
                    pass
                else:
                    raise AssertionError("torn generation read")
                n_ok[0] += 1
        except Exception as e:  # noqa: BLE001 — recorded for the assert
            errors.append(e)

    t = threading.Thread(target=stream)
    t.start()
    try:
        time.sleep(0.2)
        gen = rep.hot_swap(d2, day="d2")
        assert gen == 2
        time.sleep(0.2)
    finally:
        done.set()
        t.join(timeout=30)
        router.close()
        rep.shutdown()
    assert not errors, errors
    assert n_ok[0] > 0
    # post-swap reads are day-2
    snap = stat_snapshot("serving.")
    assert snap.get("serving.default.qps", 0) >= n_ok[0]
    assert "serving.default.latency_s.p99" in snap
    assert snap.get("serving.swap", 0) == 1


def test_post_swap_reads_new_day(tmp_path):
    cfg, tab1, keys = make_table(60, day_salt=0.0)
    _, tab2, _ = make_table(60, seed=0, day_salt=2.0)
    d1 = dump_xbox(tab1, cfg, str(tmp_path / "d1"))
    d2 = dump_xbox(tab2, cfg, str(tmp_path / "d2"))
    rep = ServingReplica(config=cfg, xbox_path=d1, day="d1")
    router = ServingRouter([rep.addr])
    try:
        rep.hot_swap(d2, day="d2")
        got = router.pull_sparse(keys[:10])
        exp = tab2.bulk_pull(keys[:10])
        for f in ("show", "click", "embed_w", "mf"):
            assert np.array_equal(got[f], g6(exp[f])), f
        h = router.health()[0]
        assert h["day"] == "d2" and h["generation"] == 2
    finally:
        router.close()
        rep.shutdown()


def test_hot_swap_invalidates_registered_cache(tmp_path):
    """The swap IS a coherence point: a registered device row cache must
    be invalidated at the flip."""
    cfg, tab, keys = make_table(40)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))

    class SpyCache:
        def __init__(self):
            self.calls = []

        def invalidate(self, reason=""):
            self.calls.append(reason)

    rep = ServingReplica(config=cfg, xbox_path=d1)
    rep.cache = SpyCache()
    try:
        rep.hot_swap(d1, day="again")
        assert rep.cache.calls == ["serving_swap"]
    finally:
        rep.shutdown()


# -- multi-tenancy: namespacing, admission, shed ----------------------------

def test_tenant_namespacing_and_unknown_tenant(tmp_path):
    cfg, tab, keys = make_table(50)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))
    rep = ServingReplica(config=cfg, xbox_path=d1,
                         tenants=["ads", "feed"])
    try:
        ads = ServingRouter([rep.addr], tenant="ads")
        feed = ServingRouter([rep.addr], tenant="feed")
        exp = g6(tab.bulk_pull(keys[:8])["embed_w"])
        for r in (ads, feed):
            got = r.pull_sparse(keys[:8])
            assert np.array_equal(got["embed_w"], exp)
            r.close()
        bad = ServingRouter([rep.addr], tenant="nosuch")
        with pytest.raises(RuntimeError, match="unknown tenant"):
            bad.pull_sparse(keys[:8])
        bad.close()
    finally:
        rep.shutdown()


def test_admission_shed_is_typed_not_failover(tmp_path):
    """At the per-tenant cap the replica sheds with the OVERLOADED
    marker and the router raises the typed ServingOverload — it must NOT
    mark the replica dead or fail over (the fleet is alive)."""
    cfg, tab, keys = make_table(30)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))
    rep = ServingReplica(config=cfg, xbox_path=d1, max_inflight=1)
    router = ServingRouter([rep.addr])
    try:
        # deterministic overload: occupy the tenant's whole budget
        with rep._adm_lock:
            rep._tenant_inflight["default"] = 1
        with pytest.raises(ServingOverload):
            router.pull_sparse(keys[:4])
        assert stat_snapshot("serving.").get("serving.default.shed") == 1
        with rep._adm_lock:
            rep._tenant_inflight["default"] = 0
        got = router.pull_sparse(keys[:4])   # same router, same replica
        assert np.array_equal(got["embed_w"],
                              g6(tab.bulk_pull(keys[:4])["embed_w"]))
        assert router._dead == [False]
    finally:
        router.close()
        rep.shutdown()


# -- read-only surface -------------------------------------------------------

def test_mutating_verbs_rejected(tmp_path):
    cfg, tab, keys = make_table(20)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))
    rep = ServingReplica(config=cfg, xbox_path=d1)
    c = PSClient(rep.addr)
    try:
        rows = tab.bulk_pull(keys[:2])
        with pytest.raises(RuntimeError, match="read-only"):
            c.push_sparse(keys[:2], rows)
        # reads still fine on the same connection
        assert c.size() == 20
    finally:
        c.close()
        rep.shutdown()


def test_health_reports_serving_surface(tmp_path):
    cfg, tab, _ = make_table(25)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))
    rep = ServingReplica(config=cfg, xbox_path=d1, day="20260101",
                         tenants=["ads", "feed"])
    c = PSClient(rep.addr)
    try:
        h = c.health()
        assert h["mode"] == "serving"
        assert h["generation"] == 1 and h["day"] == "20260101"
        assert h["tenants"] == "ads,feed"
        assert h["tenant_inflight"] == {"ads": 0, "feed": 0}
        assert "ads/embedding" in h["tables"]
        # train-mode servers advertise mode too (router can tell tiers)
        tab2 = ShardedHostTable(EmbeddingTableConfig(embedding_dim=MF))
        from paddlebox_tpu_torch.ps.service import PSServer
        srv = PSServer(tab2)
        c2 = PSClient(srv.addr)
        try:
            assert c2.health()["mode"] == "train"
        finally:
            c2.close()
            srv.shutdown()
    finally:
        c.close()
        rep.shutdown()


# -- forward verb ------------------------------------------------------------

def test_forward_pooling_matches_numpy(tmp_path):
    """Ragged sum-pool over [embed_w | mf], empty segments included."""
    cfg, tab, keys = make_table(80)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))
    rep = ServingReplica(config=cfg, xbox_path=d1)
    router = ServingRouter([rep.addr])
    try:
        q = keys[:7]
        lod = np.array([0, 3, 3, 5, 7], np.int64)   # sample 1 is EMPTY
        pooled = router.forward(q, lod)
        rows = tab.bulk_pull(q)
        emb = np.concatenate([g6(rows["embed_w"])[:, None],
                              g6(rows["mf"])], 1)
        want = np.stack([emb[a:b].sum(0) for a, b in zip(lod, lod[1:])])
        assert pooled.shape == (4, 1 + MF)
        assert np.array_equal(pooled[1], np.zeros(1 + MF, np.float32))
        np.testing.assert_allclose(pooled, want.astype(np.float32),
                                   rtol=1e-6)
    finally:
        router.close()
        rep.shutdown()


# -- router failover ---------------------------------------------------------

def test_failover_bit_identical_zero_lost(tmp_path):
    """Kill the primary mid-stream: the router retries on the survivor
    and the full answer stream is BYTE-equal to a single-replica
    baseline — exactly one response per query, none lost, none
    duplicated, no torn reads."""
    cfg, tab, keys = make_table(150)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))
    baseline_rep = ServingReplica(config=cfg, xbox_path=d1)
    rep_a = ServingReplica(config=cfg, xbox_path=d1)
    rep_b = ServingReplica(config=cfg, xbox_path=d1)

    rng = np.random.default_rng(7)
    batches = [keys[rng.integers(0, len(keys), 64)] for _ in range(30)]

    base_router = ServingRouter([baseline_rep.addr])
    baseline = [base_router.pull_sparse(b) for b in batches]
    base_router.close()
    baseline_rep.shutdown()

    router = ServingRouter([rep_a.addr, rep_b.addr])
    killer = threading.Timer(0.0, rep_a.kill)
    got = []
    try:
        for i, b in enumerate(batches):
            if i == 10:          # chaos: primary dies mid-query-stream
                killer = threading.Timer(0.001, rep_a.kill)
                killer.start()
            got.append(router.pull_sparse(b))
        assert len(got) == len(baseline)          # zero lost/duplicated
        for g, w in zip(got, baseline):
            for f in w:
                assert np.array_equal(g[f], w[f]), f
        assert True in [router._dead[0]] or rep_a._dead
    finally:
        killer.cancel()
        router.close()
        rep_b.shutdown()
        rep_a.kill()


def test_router_resurrects_restarted_replica(tmp_path):
    """Restart-in-place (launch.ServingReplicaSupervisor): after every
    replica is marked dead, the router probes the old addresses and
    rejoins a replica that came back on the same port."""
    cfg, tab, keys = make_table(40)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))
    rep = ServingReplica(config=cfg, xbox_path=d1)
    host, port = rep.addr
    router = ServingRouter([rep.addr])
    try:
        exp = g6(tab.bulk_pull(keys[:6])["embed_w"])
        assert np.array_equal(router.pull_sparse(keys[:6])["embed_w"],
                              exp)
        rep.kill()
        with pytest.raises(ConnectionError):
            router.pull_sparse(keys[:6])
        # supervisor brings it back on the SAME port
        rep = ServingReplica(config=cfg, xbox_path=d1, host=host,
                             port=port)
        got = router.pull_sparse(keys[:6])       # resurrection pass
        assert np.array_equal(got["embed_w"], exp)
        assert stat_snapshot("serving.").get(
            "serving.router.resurrect", 0) >= 1
    finally:
        router.close()
        rep.shutdown()


# -- xbox swap manifest ------------------------------------------------------

def test_manifest_publish_read_roundtrip(tmp_path):
    root = str(tmp_path)
    assert read_xbox_manifest(root) is None
    publish_xbox_manifest(root, "/d/xbox_d1", generation=3, day="20260102")
    man = read_xbox_manifest(root)
    assert man["path"] == "/d/xbox_d1"
    assert man["generation"] == 3 and man["day"] == "20260102"
    # atomic publish: no tmp litter next to the manifest
    litter = [f for f in os.listdir(root) if f != checkpoint.XBOX_MANIFEST]
    assert litter == []
    with open(os.path.join(root, checkpoint.XBOX_MANIFEST), "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError):
        read_xbox_manifest(root)


def test_watch_manifest_swaps_on_generation_advance(tmp_path):
    cfg, tab1, keys = make_table(50, day_salt=0.0)
    _, tab2, _ = make_table(50, seed=0, day_salt=3.0)
    root = str(tmp_path)
    d1 = dump_xbox(tab1, cfg, os.path.join(root, "xd1"))
    d2 = dump_xbox(tab2, cfg, os.path.join(root, "xd2"))
    publish_xbox_manifest(root, d1, generation=1, day="d1")
    rep = ServingReplica(config=cfg, xbox_path=d1, day="d1")
    rep.watch_manifest(root, poll_s=0.05)
    router = ServingRouter([rep.addr])
    try:
        publish_xbox_manifest(root, d2, generation=2, day="d2")
        deadline = time.time() + 10
        while rep._gen.generation < 2:
            assert time.time() < deadline, "watcher never swapped"
            time.sleep(0.02)
        got = router.pull_sparse(keys[:5])
        assert np.array_equal(got["embed_w"],
                              g6(tab2.bulk_pull(keys[:5])["embed_w"]))
    finally:
        router.close()
        rep.shutdown()


# -- satellite: load_xbox hot-swap coherence ---------------------------------

@pytest.mark.filterwarnings(
    "ignore:load_xbox on a training-mode engine")
def test_load_xbox_invalidates_device_cache_and_row_width(tmp_path):
    """The PR-fix regression: an engine that load_xbox's a new day over
    a live table MUST invalidate its DeviceRowCache (device rows mirror
    the pre-load table) and drop learned row-width estimates (the new
    day's rows may chunk differently)."""
    cfg, tab, keys = make_table(30)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))

    calls = []

    class SpyCache:
        def invalidate(self, reason=""):
            calls.append(("cache", reason))

    class SpyTable(ShardedHostTable):
        def invalidate_row_width(self):
            calls.append(("row_width", None))

    class Eng:
        pass
    eng = Eng()
    eng.mode = "train"
    eng.config = cfg
    eng.table = SpyTable(cfg)
    eng.cache = SpyCache()
    got = checkpoint.load_xbox(eng, d1)
    assert len(got) == 30
    assert ("cache", "load_xbox") in calls
    assert ("row_width", None) in calls


def test_router_observe_generation_clears_row_width(tmp_path):
    """Client side of the same coherence point: a fleet generation
    advance drops every router client's learned row-width estimates."""
    cfg, tab, keys = make_table(40)
    d1 = dump_xbox(tab, cfg, str(tmp_path / "d1"))
    rep = ServingReplica(config=cfg, xbox_path=d1)
    router = ServingRouter([rep.addr])
    try:
        assert router.observe_generation() is False   # nothing seen yet
        router.pull_sparse(keys)
        c = router._clients[0]
        with c._lock:
            assert c._row_bytes_est                   # learned something
        rep.hot_swap(d1, day="d2")
        assert router.observe_generation() is True
        with c._lock:
            assert not c._row_bytes_est               # and forgot it
        assert router.observe_generation() is False   # no advance now
    finally:
        router.close()
        rep.shutdown()


def test_remote_table_adapter_invalidate_row_width(tmp_path):
    cfg, tab, keys = make_table(20)
    from paddlebox_tpu_torch.ps.service import PSServer
    srv = PSServer(tab)
    c = PSClient(srv.addr)
    try:
        ad = RemoteTableAdapter(c)
        ad.bulk_pull(keys[:5])
        with c._lock:
            assert c._row_bytes_est
        ad.invalidate_row_width()
        with c._lock:
            assert not c._row_bytes_est
    finally:
        c.close()
        srv.shutdown()


# -- supervisor --------------------------------------------------------------

def test_supervisor_restart_in_place_re_resolves_manifest(tmp_path):
    """launch.ServingReplicaSupervisor: a dead replica is rebuilt on the
    SAME port from the CURRENT manifest — a replica that died on day 1
    after day 2 was published comes back serving day 2."""
    from paddlebox_tpu_torch.launch import ServingReplicaSupervisor
    cfg, tab1, keys = make_table(40, day_salt=0.0)
    _, tab2, _ = make_table(40, seed=0, day_salt=4.0)
    root = str(tmp_path)
    d1 = dump_xbox(tab1, cfg, os.path.join(root, "xd1"))
    d2 = dump_xbox(tab2, cfg, os.path.join(root, "xd2"))
    publish_xbox_manifest(root, d1, generation=1, day="d1")
    sup = ServingReplicaSupervisor(config=cfg, manifest_root=root,
                                   poll_s=0.01)
    router = ServingRouter([sup.addr])
    try:
        assert np.array_equal(router.pull_sparse(keys[:5])["embed_w"],
                              g6(tab1.bulk_pull(keys[:5])["embed_w"]))
        publish_xbox_manifest(root, d2, generation=2, day="d2")
        sup.replica.kill()
        deadline = time.time() + 15
        while sup.replica._dead:
            assert time.time() < deadline, "supervisor never restarted"
            time.sleep(0.02)
        assert sup.replica.addr[1] == sup.port
        got = router.pull_sparse(keys[:5])
        assert np.array_equal(got["embed_w"],
                              g6(tab2.bulk_pull(keys[:5])["embed_w"]))
        assert sup.restarts == 1
    finally:
        router.close()
        sup.stop()
