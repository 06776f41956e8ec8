"""The PyTorch port's PS fault-injection harness and exactly-once retry
protocol (counterpart of test_ps_faults.py, run against
``paddlebox_tpu_torch``): backoff math, FaultPlan determinism,
rid/dedup-window semantics, drain/kill lifecycle, the chaos proxy, the
connect timeout, the snapshot-eviction warning and the oversized-response
error, and the engine's end_pass re-drive over a remote table on the
CPU."""

import logging
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import EmbeddingTableConfig
from paddlebox_tpu_torch.ps import faults, wire
from paddlebox_tpu_torch.ps import service
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.service import (PSClient, PSServer,
                                      RemoteTableAdapter, _DedupWindow)
from paddlebox_tpu_torch.utils.backoff import Backoff
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get


@pytest.fixture(autouse=True)
def _clean_faults():
    StatRegistry.instance().reset()
    flags.set_flags({"ps_fault_injection": True})
    yield
    faults.uninstall()
    flags.set_flags({"ps_fault_injection": False})


@pytest.fixture()
def server():
    table = ShardedHostTable(EmbeddingTableConfig(embedding_dim=3,
                                                  shard_num=4))
    srv = PSServer(table)
    yield srv
    srv.shutdown()


# -- backoff / deadline math -------------------------------------------------

def test_backoff_delay_grows_and_caps():
    bo = Backoff(base=0.1, cap=0.8, seed=0)
    delays = [bo.delay(a) for a in range(1, 8)]
    nominals = [min(0.8, 0.1 * 2 ** (a - 1)) for a in range(1, 8)]
    for d, n in zip(delays, nominals):
        assert 0.5 * n <= d < n          # jitter in [0.5, 1.0) * nominal
    assert nominals[-1] == 0.8           # capped


def test_backoff_deterministic_under_seed():
    a = Backoff(base=0.1, cap=2.0, seed=42)
    b = Backoff(base=0.1, cap=2.0, seed=42)
    assert [a.delay(i) for i in range(1, 6)] == \
        [b.delay(i) for i in range(1, 6)]


def test_backoff_deadline_budget():
    bo = Backoff(base=0.01, cap=0.02, deadline=0.05)
    assert bo.remaining() <= 0.05
    t0 = time.monotonic()
    attempts = 0
    while bo.sleep(attempts + 1):
        attempts += 1
        assert attempts < 100            # must terminate via the budget
    assert time.monotonic() - t0 <= 0.5  # never sleeps past the deadline
    assert bo.remaining() <= 0
    assert bo.sleep(1) is False          # spent budget refuses immediately


# -- FaultPlan ---------------------------------------------------------------

def test_fault_plan_deterministic_and_scheduled():
    def decisions(seed):
        plan = (faults.FaultPlan(seed)
                .drop("send", role="client", at=(1, 3))
                .drop("recv", role="client", prob=0.3))
        return [(plan.fire("send", "client") is not None,
                 plan.fire("recv", "client") is not None)
                for _ in range(20)]

    assert decisions(7) == decisions(7)          # same seed → same firing
    plan = faults.FaultPlan(0).drop("send", role="client", at=(1, 3))
    fired = [plan.fire("send", "client") is not None for _ in range(6)]
    assert fired == [False, True, False, True, False, False]
    assert plan.fire("send", "server") is None   # role filter
    assert plan.hits("send", "client") == 6


def test_fault_plan_cmd_filter_and_limit():
    plan = faults.FaultPlan(0).drop("dispatch", role="server",
                                    cmd="push_sparse_delta", at=(0,))
    assert plan.fire("dispatch", "server", "pull_sparse") is None
    act = plan.fire("dispatch", "server", "push_sparse_delta")
    assert act is not None and act.kind == "drop"
    assert plan.fire("dispatch", "server", "push_sparse_delta") is None


def test_install_requires_flag():
    flags.set_flags({"ps_fault_injection": False})
    with pytest.raises(RuntimeError, match="fault injection is disabled"):
        faults.install(faults.FaultPlan())
    flags.set_flags({"ps_fault_injection": True})
    faults.install(faults.FaultPlan())
    assert faults.ACTIVE is not None
    faults.uninstall()
    assert faults.ACTIVE is None


# -- dedup window ------------------------------------------------------------

def test_dedup_window_replay_and_eviction():
    win = _DedupWindow(cap=3)
    for i in range(5):
        assert win.begin(f"tok:{i}") is None
        win.commit(f"tok:{i}", {"ok": True, "i": i})
    # newest 3 replay from cache; the 2 oldest were evicted → re-execute
    assert win.begin("tok:4") == {"ok": True, "i": 4}
    assert win.begin("tok:2") == {"ok": True, "i": 2}
    assert win.begin("tok:0") is None            # evicted → admitted anew
    assert stat_get("ps.server.dedup_evict") == 2
    assert stat_get("ps.server.dedup_hit") == 2


def test_dedup_window_inflight_never_evicted_and_waits():
    win = _DedupWindow(cap=1, wait_timeout=5)
    assert win.begin("tok:0") is None            # in-flight, never evicted
    for i in range(1, 4):
        assert win.begin(f"tok:{i}") is None
        win.commit(f"tok:{i}", {"ok": True})
    got = []

    def dup():
        got.append(win.begin("tok:0"))           # blocks on the in-flight

    t = threading.Thread(target=dup, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not got                               # still waiting
    win.commit("tok:0", {"ok": True, "v": 7})
    t.join(timeout=5)
    assert got == [{"ok": True, "v": 7}]


def test_dedup_window_drop_allows_reexecution():
    win = _DedupWindow(cap=4)
    assert win.begin("tok:1") is None
    win.drop("tok:1")                            # verb raised / rolled back
    assert win.begin("tok:1") is None            # re-admitted, not replayed


def test_duplicate_rid_suppressed_end_to_end(server):
    client = PSClient(server.addr)
    keys = np.array([5, 6], np.uint64)
    client.pull_sparse(keys, create=True)
    req = {"cmd": "push_sparse_delta", "keys": keys,
           "rows": {"show": np.ones(2, np.float32)}, "rows_abs": {},
           "table": None, wire.RID_FIELD: "dup-tok:1"}
    r1 = server._dispatch(dict(req))
    r2 = server._dispatch(dict(req))             # resend of the same rid
    assert r1["ok"] and r2 == r1
    assert r2[wire.RID_FIELD] == "dup-tok:1"     # response echoes the rid
    np.testing.assert_allclose(client.pull_sparse(keys)["show"], [1.0, 1.0])
    assert stat_get("ps.server.dedup_hit") == 1


# -- retry protocol over injected faults ------------------------------------

def test_client_retries_through_send_drops(server):
    faults.install(faults.FaultPlan(0).drop("send", role="client",
                                            at=(0, 1)))
    client = PSClient(server.addr, retries=5, retry_sleep=0.01)
    assert client.size() == 0                    # survives 2 dropped sends
    assert stat_get("ps.client.retry") == 2
    assert stat_get("ps.fault.send.drop") == 2


def test_delta_exactly_once_when_response_lost(server):
    """The ambiguous failure: the delta APPLIES but the response frame is
    dropped — the resend must dedup, not double-apply."""
    client = PSClient(server.addr, retries=5, retry_sleep=0.01)
    keys = np.array([1, 2, 3], np.uint64)
    rows = client.pull_sparse(keys, create=True)
    d = {f: np.zeros_like(v) for f, v in rows.items()}
    d["show"] = np.ones(3, np.float32)
    faults.install(faults.FaultPlan(0).drop(
        "send", role="server", at=(0,), cmd=None))
    client.push_sparse_delta(keys, d)
    faults.uninstall()
    np.testing.assert_allclose(client.pull_sparse(keys)["show"],
                               [1.0, 1.0, 1.0])  # once, not twice
    assert stat_get("ps.server.dedup_hit") >= 1


def test_barrier_retries_through_drops(server):
    faults.install(faults.FaultPlan(0).drop("send", role="client", at=(1,)))
    clients = [PSClient(server.addr, retries=5, retry_sleep=0.01)
               for _ in range(3)]
    done = []

    def worker(c):
        c.barrier(3, timeout=30)
        done.append(1)

    threads = [threading.Thread(target=worker, args=(c,), daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(done) == 3                        # no double-registration


def test_deadline_budget_bounds_total_retry_time():
    client = PSClient(("127.0.0.1", 9), retries=None, retry_sleep=0.01,
                      backoff_cap=0.05, deadline=0.3)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        client.size()
    assert time.monotonic() - t0 < 5.0


# -- connect timeout, snapshot eviction, oversized responses -------------

def test_connect_honors_per_call_timeout(monkeypatch):
    """_call used to hardcode create_connection(timeout=60),
    ignoring the per-call timeout — a short-deadline call could block a
    minute on connect."""
    seen = []

    def fake_connect(addr, timeout=None):
        seen.append(timeout)
        raise ConnectionRefusedError("nope")

    monkeypatch.setattr(service.socket, "create_connection", fake_connect)
    client = PSClient(("127.0.0.1", 9), retries=1, deadline=500.0)
    with pytest.raises(ConnectionError):
        client._call({"cmd": "size", "table": None}, timeout=0.5)
    assert seen and seen[0] <= 0.5               # not 60


def test_snapshot_eviction_warns_and_counts(server, caplog):
    """The adapter used to evict the oldest pull snapshot
    silently; the failure then surfaced as a confusing RuntimeError at
    write-back time."""
    adapter = RemoteTableAdapter(PSClient(server.addr), delta_mode=True)
    with caplog.at_level(logging.WARNING, logger="paddlebox_tpu_torch.ps.service"):
        for i in range(adapter._snap_cap + 1):
            adapter.bulk_pull(np.arange(10 * i + 1, 10 * i + 4,
                                        dtype=np.uint64))
    assert any("evicting the oldest snapshot" in r.getMessage()
               for r in caplog.records)
    assert stat_get("ps.adapter.snap_evict") == 1


def test_oversized_response_reports_real_reason(server, monkeypatch):
    """An oversized RESPONSE used to kill the handler thread —
    the client saw a bare ConnectionError and re-pulled the same chunk.
    Now the server replies with the actual reason."""
    monkeypatch.setattr(wire, "MAX_FRAME", 1 << 14)
    client = PSClient(server.addr, retries=2, retry_sleep=0.01)
    with pytest.raises(RuntimeError, match="response exceeds wire cap"):
        # huge client-side frame budget → one request whose response
        # overshoots the (patched) hard wire cap
        client._call({"cmd": "pull_sparse",
                      "keys": np.arange(1, 2000, dtype=np.uint64),
                      "table": None, "create": True})


# -- lifecycle: drain / kill / health ---------------------------------------

def test_health_verb(server):
    client = PSClient(server.addr)
    h = client.health()
    assert h["ok"] and h["draining"] is False
    assert "embedding" in h["tables"]


def test_graceful_drain_finishes_inflight_verb(server):
    faults.install(faults.FaultPlan(0).delay("dispatch", 0.4, at=(0,),
                                             cmd="push_dense"))
    client = PSClient(server.addr)
    errs = []

    def slow_push():
        try:
            client.push_dense("w", np.ones(4))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=slow_push, daemon=True)
    t.start()
    time.sleep(0.1)                              # verb is now in flight
    server.shutdown(drain_timeout=5)             # drains, doesn't cut it
    t.join(timeout=5)
    assert not errs
    # drained server refuses new work
    c2 = PSClient(server.addr, retries=2, retry_sleep=0.01, deadline=1)
    with pytest.raises(ConnectionError):
        c2.size()


def test_kill_and_restart_same_port(server):
    client = PSClient(server.addr, retries=None, retry_sleep=0.02,
                      deadline=20)
    keys = np.array([9, 10], np.uint64)
    client.pull_sparse(keys, create=True)
    port = server.addr[1]
    server.kill()
    srv2 = PSServer(server.table, port=port)     # same table, same port
    try:
        assert client.size() == 2                # client reconnects+retries
    finally:
        srv2.shutdown()


# -- pass-level recovery -----------------------------------------------------

def test_end_pass_redrive_after_partial_write(server):
    """A mid-sequence write-back failure leaves some chunks applied.  The
    adapter restores the snapshot and pins the rid group, so re-driving
    end_pass resends identical rids: applied chunks dedup, the rest land
    — exactly once overall."""
    from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
    engine = BoxPSEngine(EmbeddingTableConfig(embedding_dim=3, shard_num=4),
                         device="cpu")
    # small frame budget → several delta chunks per write-back
    client = PSClient(server.addr, retries=1, retry_sleep=0.01,
                      max_frame=1 << 12)
    engine.table = RemoteTableAdapter(client, delta_mode=True)
    engine.begin_feed_pass()
    keys = np.arange(1, 101, dtype=np.uint64)
    engine.add_keys(keys)
    engine.end_feed_pass()
    engine.begin_pass()
    engine.ws["show"] = engine.ws["show"] + 1.0
    n_chunks = len(client._chunk_counts(
        100, client._rows_bytes(engine.table._snaps[
            np.sort(keys).tobytes()])))
    assert n_chunks >= 3
    # chunk 1's dispatch drops (not applied) → chunk 0 stays applied
    faults.install(faults.FaultPlan(0).drop(
        "dispatch", role="server", cmd="push_sparse_delta", at=(1,)))
    with pytest.raises(ConnectionError):
        engine.end_pass()
    faults.uninstall()
    assert engine.ws is not None                 # engine state preserved
    engine.end_pass()                            # re-drive: exactly-once
    np.testing.assert_allclose(
        PSClient(server.addr).pull_sparse(keys)["show"], np.ones(100))
    assert stat_get("ps.server.dedup_hit") >= 1  # replayed applied chunk
    assert stat_get("ps.engine.end_pass_write_failure") == 1


# -- chaos proxy -------------------------------------------------------------

def test_chaos_proxy_faults_are_survivable(server):
    plan = (faults.FaultPlan(seed=3)
            .drop("connect", role="proxy", at=(1,))
            .drop("send", role="proxy", at=(2,))
            .truncate("recv", role="proxy", at=(4,))
            .delay("send", 0.002, role="proxy", prob=0.1))
    proxy = faults.ChaosProxy(server.addr, plan)
    try:
        client = PSClient(proxy.addr, retries=None, retry_sleep=0.01,
                          backoff_cap=0.1, deadline=30)
        keys = np.arange(1, 40, dtype=np.uint64)
        rows = client.pull_sparse(keys, create=True)
        d = {f: np.zeros_like(v) for f, v in rows.items()}
        d["show"] = np.ones(39, np.float32)
        for _ in range(4):
            client.push_sparse_delta(keys, d)
        np.testing.assert_allclose(client.pull_sparse(keys)["show"],
                                   np.full(39, 4.0))
        assert plan.hits("send", "proxy") > 0    # frames really flowed
    finally:
        proxy.shutdown()
