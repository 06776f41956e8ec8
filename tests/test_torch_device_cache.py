"""The device row cache of the PyTorch port (ps/device_cache.py), on the
CPU: counterparts of the JAX package's tests/test_device_cache.py.

The contract: ``FLAGS_ps_device_cache`` changes which rows the table
serves, never what trains.  A small DeepFM (4 slots, mf_dim 4, hidden
(16, 16), batch 64, 2 batches a pass) trains 2 days × 3 passes:

* cache on = cache off bitwise (per-batch losses, every table key × every
  field, dense weights and Adam state) on mxu, fast and ragged, serially,
  through ``PassPrefetcher``, and pipelined by hand (pass N+1's snapshot
  and pull before pass N's write-back and fold-back, in one thread, so
  the overlap is certain);
* the same at a capacity that evicts every pass: hits evicted since the
  snapshot take the fallback pull, and keys the fold-back admitted after
  the snapshot are still refreshed;
* under ctr_double, whose f64 show/click reach the cache as host casts;
* across a kill at ``end_pass`` resumed by ``fleet.train_passes``,
  serial and prefetched, and a failed write-back that leaves the cache
  untouched;
* the Zipf hit-rate floor, and the policy units (eviction, determinism,
  snapshot and invalidation, working sets that do not alias);
* the JAX ``DeviceRowCache`` and the port's, fed the same
  ``update_after_pass`` sequence, keep the same keys, slots, scores,
  mirror and store.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.ps.device_cache import DeviceRowCache as JCache
from paddlebox_tpu_torch import flags, fleet
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps import embedding, faults
from paddlebox_tpu_torch.ps.device_cache import DeviceRowCache
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get

import torch_parity_helpers as h
from torch_day_loop import (B, N_DAYS, N_PASSES, SMALL, S, assert_same_bits,
                            cache_off, cache_on, feed_sync, make_pair,
                            pass_data, run)

PATHS = ("mxu", "fast", "ragged")


@pytest.fixture(autouse=True)
def _clean_flags():
    prev = {k: flags.get_flags(k)
            for k in ("ps_device_cache", "ps_device_cache_rows")}
    StatRegistry.instance().reset()
    yield
    faults.uninstall()
    flags.set_flags({**prev, "ps_fault_injection": False})


_BASE = {}


def cache_off_run(path, double=False):
    """The serial cache-off run every cache-on run must equal (made
    once per path and accessor in a worker process)."""
    key = (path, double)
    if key not in _BASE:
        cache_off()
        _BASE[key] = run(path, "serial", double)[0]
    return _BASE[key]


# ---------------------------------------------------------------------------
# Bit-identity: cache on == cache off.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["serial", "prefetch", "pipelined"])
@pytest.mark.parametrize("path", PATHS)
def test_cache_on_is_bit_identical(path, mode):
    want = cache_off_run(path)
    cache_on()
    pulled0 = stat_get("ps.engine.build_pull_rows")
    got, rec = run(path, mode)
    assert_same_bits(want, got)
    hits = stat_get("ps.cache.hits")
    assert hits > 0
    # the miss-only pull: fewer table rows than the passes trained
    assert stat_get("ps.engine.build_pull_rows") - pulled0 \
        < hits + stat_get("ps.cache.misses")
    # passes 1 and 4 are cold (set_date drops the cache).  Overlapped,
    # pass N+1's snapshot predates pass N's fold-back, so passes 2 and 5
    # see only what an earlier pass folded back (under the prefetcher,
    # nothing or pass 1's, as the worker thread races the fold-back)
    warm = [r["ps.cache.hits"] > 0 for r in rec.passes]
    if mode == "serial":
        assert warm == [False, True, True] * N_DAYS
    else:
        assert warm[0::3] == [False] * N_DAYS
        assert warm[2::3] == [True] * N_DAYS
        if mode == "pipelined":
            assert warm[1::3] == [False] * N_DAYS
    assert got[0][-1]["cache_hit_rate"] > 0.5
    assert got[1].cache.resident_rows > 0


@pytest.mark.parametrize("mode", ["prefetch", "pipelined"])
@pytest.mark.parametrize("path", PATHS)
def test_evicting_capacity_is_bit_identical(path, mode):
    """A capacity far below a pass's keys: every fold-back evicts, hits
    evicted since the snapshot fall back to a table pull, and keys the
    fold-back admitted after the snapshot are refreshed."""
    want = cache_off_run(path)
    cache_on(SMALL)
    got, rec = run(path, mode)
    assert_same_bits(want, got)
    for day in range(N_DAYS):
        day_passes = rec.passes[day * N_PASSES:(day + 1) * N_PASSES]
        # every fold-back after the day's first evicts, and the day's
        # last pass finds pass 1's rows resident
        assert all(r["ps.cache.evictions"] > 0 for r in day_passes[1:])
        assert day_passes[-1]["ps.cache.hits"] > 0
    assert got[1].cache.resident_rows == SMALL
    if mode == "pipelined":
        assert stat_get("ps.cache.gather_fallback_rows") > 0
        assert stat_get("ps.engine.stale_refresh_rows") > 0


def test_ctr_double_is_bit_identical():
    """f64 show/click on the host: hit rows take their f64 base from the
    mirror and their device values from end_pass's host-side casts."""
    want = cache_off_run("mxu", double=True)
    cache_on(SMALL)
    got, rec = run("mxu", "pipelined", double=True)
    assert_same_bits(want, got)
    assert stat_get("ps.cache.hits") > 0
    assert got[1].cache.read_mirror(np.arange(2), ("show",))[
        "show"].dtype == np.float64


# ---------------------------------------------------------------------------
# Faults: kill at end_pass resumed; a failed write-back.
# ---------------------------------------------------------------------------

def write_slot_file(path, rng, n):
    with open(path, "w") as f:
        for _ in range(n):
            parts = [f"1 {rng.integers(0, 2)}",
                     "3 " + " ".join(f"{rng.normal():.4f}"
                                     for _ in range(3))]
            for _s in range(4):
                k = rng.integers(1, 4)
                parts.append(f"{k} " + " ".join(
                    str(rng.integers(1, 500)) for _ in range(k)))
            f.write(" ".join(parts) + "\n")


def fleet_trio():
    t = h.TORCH
    cfg = t.Feed(slots=tuple(
        [t.Slot("label", dtype="float", is_dense=True, dim=1),
         t.Slot("dense0", dtype="float", is_dense=True, dim=3)]
        + [t.Slot(f"s{i}", slot_id=100 + i, capacity=3) for i in range(4)]))
    eng = t.Engine(t.Table(embedding_dim=4, shard_num=4,
                           sgd=t.Sgd(mf_create_thresholds=0.0)),
                   seed=0, device="cpu")
    ds = fleet.BoxPSDataset(cfg, engine=eng, read_threads=1)
    tr = t.Trainer(eng, DeepFM(4, 3 + 4, 3, hidden=(8,)), cfg,
                   batch_size=32, seed=0, sparse_path="fast", device="cpu")
    return eng, ds, tr


@pytest.mark.parametrize("prefetch,hit", [(False, 1), (True, 1), (True, 2)])
def test_crash_resume_bit_identical(tmp_path, prefetch, hit):
    """A seeded kill at a pass's write-back (the second's, or under the
    prefetcher the third's, the first there to find rows resident) with
    the cache on: the resume tier invalidates at both teardown points
    (reset_feed_state and the checkpoint resume), and the re-driven
    passes land on the cache-off fault-free state."""
    files = []
    for p in range(3):
        path = str(tmp_path / f"p{p}.txt")
        write_slot_file(path, np.random.default_rng(p), 48)
        files.append([path])
    cache_off()
    eng1, ds1, tr1 = fleet_trio()
    base = fleet.train_passes(tr1, ds1, files, date="20260801",
                              prefetch=False)
    cache_on()
    flags.set_flags({"ps_fault_injection": True})
    eng2, ds2, tr2 = fleet_trio()
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    faults.install(faults.FaultPlan(seed=13).kill_at("end_pass", at=(hit,)))
    metrics = fleet.train_passes(tr2, ds2, files, date="20260801",
                                 prefetch=prefetch, checkpoint=ck, resume=4)
    faults.uninstall()
    assert_same_bits((base, eng1, tr1), (metrics, eng2, tr2))
    reasons = {e["reason"] for e in flight.events(kind="cache_invalidate")}
    assert {"reset", "resume"} <= reasons
    assert stat_get("ps.fault.lifecycle.kill") >= 1
    if not prefetch or hit == 2:
        # prefetched, a pass snapshots the index before the previous
        # pass folds back: passes 2 and 3 after a kill at pass 2 see
        # only cold snapshots
        assert stat_get("ps.cache.hits") > 0


def test_failed_write_back_leaves_the_cache_untouched():
    """end_pass's fold-back runs only after the table write succeeded,
    so a replayed end_pass folds back exactly once."""
    cache_on()
    eng, tr = make_pair("fast")
    _, ds = pass_data(0, 0)
    feed_sync(eng, ds)
    tr.train_pass(tr.build_pass_feed(ds))
    real = eng.table.bulk_write

    def broken(keys, soa):
        raise ConnectionError("table unreachable")

    eng.table.bulk_write = broken
    with pytest.raises(ConnectionError):
        eng.end_pass()
    assert eng.cache.resident_rows == 0 and eng.ws is not None
    eng.table.bulk_write = real
    eng.end_pass()
    assert eng.cache.resident_rows == eng.num_keys
    keys = eng.mapper.sorted_keys
    valid, slots = eng.cache.resolve(keys, eng.cache.snapshot())
    assert valid.all()
    want = eng.table.bulk_pull(keys)
    np.testing.assert_array_equal(
        eng.cache.read_mirror(slots, ("show",))["show"], want["show"])
    for f, v in eng.cache._store.items():
        np.testing.assert_array_equal(
            v[torch.as_tensor(slots.astype(np.int64))].numpy(),
            want[f].astype(v.numpy().dtype), err_msg=f)


# ---------------------------------------------------------------------------
# Hit-rate floor on a synthetic Zipf day.
# ---------------------------------------------------------------------------

def zipf_dataset(rng, n, n_keys=2000, a=1.3):
    cfg, data = h.datasets(h.TORCH, seed=0, b=n, nb=1)
    blk = data[0].get_blocks()[0]
    for i in range(S):
        vals, off = blk.uint64_slots[f"s{i}"]
        draws = np.minimum(rng.zipf(a, size=len(vals)), n_keys)
        blk.uint64_slots[f"s{i}"] = (draws.astype(np.uint64), off)
    return data[0]


def test_zipf_hit_rate_floor():
    """On a Zipf day the steady pass hit rate clears 0.5, and the
    miss-only pull cuts the table rows by at least 2× against the
    every-key pulls of a cache-off run."""
    cache_on(8192)
    eng, tr = make_pair("fast")
    eng.set_date("20260801")
    warm = {}
    for p in range(6):
        if p == 1:
            warm = {k: stat_get(k) for k in
                    ("ps.cache.hits", "ps.cache.misses",
                     "ps.engine.build_pull_rows")}
        ds = zipf_dataset(np.random.default_rng(p), B)
        feed_sync(eng, ds)
        tr.train_pass(tr.build_pass_feed(ds))
        eng.end_pass()
    hits = stat_get("ps.cache.hits") - warm["ps.cache.hits"]
    misses = stat_get("ps.cache.misses") - warm["ps.cache.misses"]
    assert hits / (hits + misses) >= 0.5
    pulled = stat_get("ps.engine.build_pull_rows") \
        - warm["ps.engine.build_pull_rows"]
    assert (hits + misses) / max(pulled, 1.0) >= 2.0
    assert stat_get("ps.cache.bytes_saved") > 0


# ---------------------------------------------------------------------------
# Policy units.
# ---------------------------------------------------------------------------

def mk_pass(keys, shows, clicks, lib=torch):
    """A (keys, soa, ws) trio shaped like a real pass: ws rows 1..n carry
    build_working_set's casts of the host rows (torch, or jax.numpy)."""
    keys = np.asarray(keys, np.uint64)
    order = np.argsort(keys)
    keys = keys[order]
    n = len(keys)
    soa = {
        "show": np.asarray(shows, np.float32)[order],
        "click": np.asarray(clicks, np.float32)[order],
        "embed_w": np.linspace(0, 1, n, dtype=np.float32),
        "slot": np.arange(n, dtype=np.int32) + 100,
        "unseen_days": np.zeros((n,), np.float32),
    }
    ws = {}
    for f in ("show", "click", "embed_w", "slot"):
        col = np.concatenate([[0], soa[f], [0]]).astype(soa[f].dtype)
        ws[f] = (torch.from_numpy(col) if lib is torch
                 else jnp.asarray(col))
    return keys, soa, ws


def resident(cache):
    return set(cache.snapshot().keys.tolist())


def test_eviction_under_capacity_pressure():
    cache = DeviceRowCache(capacity=4, device="cpu")
    cache.update_after_pass(*mk_pass([10, 11, 12, 13], [50, 40, 30, 20],
                                     [0, 0, 0, 0]), pass_id=0)
    assert cache.resident_rows == 4
    # a hotter newcomer evicts exactly the coldest incumbent; a colder
    # one is refused — capacity never overshoots
    cache.update_after_pass(*mk_pass([20, 21], [100, 1], [0, 0]), pass_id=1)
    assert cache.resident_rows == 4
    assert resident(cache) == {10, 11, 12, 20}
    # rows touched by the CURRENT pass are never its eviction victims
    cache2 = DeviceRowCache(capacity=2, device="cpu")
    cache2.update_after_pass(*mk_pass([1, 2], [5, 3], [0, 0]), pass_id=0)
    cache2.update_after_pass(*mk_pass([2, 3], [3, 1000], [0, 0]), pass_id=1)
    assert resident(cache2) == {2, 3}
    assert stat_get("ps.cache.evictions") >= 2
    assert flight.events(kind="cache_evict")


def test_eviction_is_deterministic():
    def once():
        c = DeviceRowCache(capacity=3, device="cpu")
        c.update_after_pass(*mk_pass([5, 6, 7, 8], [2, 2, 2, 2],
                                     [0, 0, 0, 0]), pass_id=0)
        c.update_after_pass(*mk_pass([9, 10], [3, 3], [1, 1]), pass_id=1)
        return c.snapshot().keys, c._slots
    (k1, s1), (k2, s2) = once(), once()
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(s1, s2)


def test_snapshot_and_invalidation_semantics():
    cache = DeviceRowCache(capacity=8, device="cpu")
    keys, soa, ws = mk_pass([3, 1, 2], [1, 1, 1], [0, 0, 0])
    cache.update_after_pass(keys, soa, ws, pass_id=0)
    snap = cache.snapshot()
    probe = np.asarray([1, 2, 4], np.uint64)
    np.testing.assert_array_equal(snap.lookup(probe), [True, True, False])
    valid, slots = cache.resolve(probe[:2], snap)
    assert valid.all()
    # the mirror rows behind those slots are the exact written soa bits,
    # and the store gathers the working set's rows into a fresh ws
    np.testing.assert_array_equal(
        cache.read_mirror(slots, fields=("show",))["show"], [1.0, 1.0])
    target = {f: torch.zeros_like(v) for f, v in ws.items()}
    cache.scatter_into(target, np.array([1, 2]), slots)
    for f in ws:
        assert torch.equal(target[f][1:3], ws[f][1:3]), f
    v0 = cache.version
    cache.invalidate("test")
    assert cache.version == v0 + 1 and cache.resident_rows == 0
    # a stale snapshot resolves as all-miss, never a wrong slot
    valid, _ = cache.resolve(probe[:2], snap)
    assert not valid.any()
    assert len(cache.snapshot().keys) == 0
    assert flight.events(kind="cache_invalidate")
    # planes survive the invalidation and the next fold-back repopulates
    cache.update_after_pass(keys, soa, ws, pass_id=1)
    assert cache.resident_rows == 3
    # f32 + int32 fields: 4 × 4 bytes a row
    assert cache.row_bytes == 16 and cache.store_bytes == 16 * 8


def test_build_working_set_no_aliasing():
    """Working sets built back to back own their rows: the next pass's
    build leaves a live working set's bits alone, and the reserved row 0
    and the padding past the pass are zero."""
    n = 10
    soa = {"show": np.arange(n, dtype=np.float32) + 1,
           "click": np.ones(n, np.float32),
           "slot": np.arange(n, dtype=np.int32) + 1}
    dev = torch.device("cpu")
    ws1 = embedding.build_working_set(soa, dev)
    soa2 = {f: v + 1 for f, v in soa.items()}
    ws2 = embedding.build_working_set(soa2, dev)
    for f in soa:
        np.testing.assert_array_equal(ws1[f][1:n + 1].numpy(), soa[f])
        np.testing.assert_array_equal(ws2[f][1:n + 1].numpy(), soa2[f])
        assert ws2[f].data_ptr() != ws1[f].data_ptr()
        for ws in (ws1, ws2):
            assert ws[f][0] == 0 and (ws[f][n + 1:] == 0).all(), f
    assert ws1["slot"].dtype == torch.int32
    assert len(ws1["show"]) == embedding.size_bucket(n + 1)


def test_matches_the_jax_cache_on_the_same_fold_backs():
    """The JAX DeviceRowCache and the port's, fed the same update_after_pass
    sequence (admissions, evictions of the coldest, residents touched
    again, an invalidation), keep the same resident keys and slots,
    scores, pass stamps, mirror and store."""
    rng = np.random.default_rng(5)
    jc, tc = JCache(capacity=48), DeviceRowCache(capacity=48, device="cpu")
    for pass_id in range(7):
        if pass_id == 4:
            jc.invalidate("test")
            tc.invalidate("test")
        keys = rng.choice(np.arange(1, 120), size=40, replace=False)
        shows = rng.integers(1, 50, 40)
        clicks = rng.integers(0, 2, 40)
        tc.update_after_pass(*mk_pass(keys, shows, clicks), pass_id=pass_id)
        jc.update_after_pass(*mk_pass(keys, shows, clicks, lib=jnp),
                             pass_id=pass_id)
        np.testing.assert_array_equal(tc.snapshot().keys,
                                      jc.snapshot().keys)
        np.testing.assert_array_equal(tc._slots, jc._slots)
        np.testing.assert_array_equal(tc._slot_score, jc._slot_score)
        np.testing.assert_array_equal(tc._slot_pass, jc._slot_pass)
        assert set(tc._mirror) == set(jc._mirror)
        for f in tc._mirror:
            np.testing.assert_array_equal(tc._mirror[f], jc._mirror[f])
        for f in jc._store:
            np.testing.assert_array_equal(tc._store[f].numpy(),
                                          np.asarray(jc._store[f]))
    assert stat_get("ps.cache.evictions") > 0


def test_cluster_half_matches_the_jax_cache():
    """The cache's cluster half against the JAX cache's: with a 4-shard
    ServerMap attached at rank 1 of a world of 2, only the owned slice is
    admitted; a reshard to 3 shards drops exactly the keys whose owner
    moved (and restamps the epoch); a restart of shard 2 drops its rows
    only.  Both caches keep the same keys, slots and mirror throughout."""
    from paddlebox_tpu.ps import cluster as jcluster
    from paddlebox_tpu_torch.ps import cluster
    addrs = [("127.0.0.1", 7000 + i) for i in range(4)]
    rng = np.random.default_rng(9)
    jc, tc = JCache(capacity=64), DeviceRowCache(capacity=64, device="cpu")
    jc.attach_server_map(jcluster.make_server_map(addrs, epoch=1), 1, 2)
    tc.attach_server_map(cluster.make_server_map(addrs, epoch=1), 1, 2)

    def same():
        np.testing.assert_array_equal(tc.snapshot().keys, jc.snapshot().keys)
        np.testing.assert_array_equal(tc._slots, jc._slots)
        for f in jc._mirror:
            np.testing.assert_array_equal(tc._mirror[f], jc._mirror[f])
        assert tc.map_epoch == jc.map_epoch and tc.version == jc.version

    smap = cluster.make_server_map(addrs, epoch=1)
    for pass_id in range(3):
        keys = rng.choice(np.arange(1, 400), size=60, replace=False)
        shows, clicks = rng.integers(1, 50, 60), rng.integers(0, 2, 60)
        tc.update_after_pass(*mk_pass(keys, shows, clicks), pass_id=pass_id)
        jc.update_after_pass(*mk_pass(keys, shows, clicks, lib=jnp),
                             pass_id=pass_id)
        same()
    res = tc.snapshot().keys
    assert len(res) and (smap.shard_of_keys(res) % 2 == 1).all()
    new = cluster.make_server_map(addrs[:3], epoch=2)
    moved = smap.shard_of_keys(res) != new.shard_of_keys(res)
    assert moved.any() and (~moved).any()
    tc.update_server_map(new, reason="test")
    jc.update_server_map(jcluster.make_server_map(addrs[:3], epoch=2),
                         reason="test")
    same()
    np.testing.assert_array_equal(tc.snapshot().keys, res[~moved])
    assert tc.map_epoch == 2
    kept = tc.snapshot().keys
    tc.invalidate_shard(2, reason="restart")
    jc.invalidate_shard(2, reason="restart")
    same()
    np.testing.assert_array_equal(tc.snapshot().keys,
                                  kept[new.shard_of_keys(kept) != 2])


def test_cache_chaos_delta_mode_bit_identical():
    """Cache + prefetch + delta-mode remote PS under seeded connection
    chaos (counterpart of the JAX test of the same name): the miss-only
    pull snapshots only misses, so the engine seeds the full-key
    write-back base itself from the cache mirror, and the fold-back
    keeps the server's bits — the day must equal the fault-free
    cache-off serial run over the same remote table bit for bit."""
    from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
    from paddlebox_tpu_torch.ps.service import (PSClient, PSServer,
                                                RemoteTableAdapter)
    from torch_day_loop import RUNS, Recorder

    def remote_run(mode):
        eng, tr = make_pair("mxu")
        table = ShardedHostTable(eng.config, seed=7)
        srv = PSServer(table)
        client = PSClient(srv.addr, retries=None, retry_sleep=0.01,
                          backoff_cap=0.1, deadline=60)
        eng.table = RemoteTableAdapter(client, delta_mode=True)
        try:
            out = RUNS[mode](eng, tr, Recorder())
        finally:
            faults.uninstall()
            client.close()
            srv.shutdown()
        return out, table, tr

    flags.set_flags({"ps_fault_injection": True})
    cache_off()
    want, t_want, tr_want = remote_run("serial")
    cache_on()
    faults.install(
        faults.FaultPlan(seed=17)
        .drop("send", role="client", prob=0.04)
        .drop("recv", role="client", prob=0.03)
        .delay("send", 0.002, role="client", prob=0.1))
    got, t_got, tr_got = remote_run("prefetch")
    assert [m["losses"] for m in want] == [m["losses"] for m in got]
    keys = np.sort(t_want.export_keys())
    np.testing.assert_array_equal(keys, np.sort(t_got.export_keys()))
    s1, s2 = t_want.bulk_pull(keys), t_got.bulk_pull(keys)
    for f in s1:
        np.testing.assert_array_equal(s1[f], s2[f],
                                      err_msg=f"table field {f!r}")
    for k, v in tr_want.model.state_dict().items():
        assert torch.equal(v, tr_got.model.state_dict()[k]), k
    assert stat_get("ps.cache.hits") > 0
    assert stat_get("ps.fault.send.drop") + stat_get("ps.fault.recv.drop") > 0
