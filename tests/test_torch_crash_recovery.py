"""The PyTorch port's crash recovery (counterpart of test_crash_recovery.py,
run against ``paddlebox_tpu_torch`` on the CPU).

Crash-safe training acceptance: generation-chained
checkpoints, restart-durable exactly-once, and auto-resume proven by
kill-anywhere chaos.

The contract under test: with a ``TrainCheckpoint`` + an auto-resume
budget, a seeded kill at ANY lifecycle point — end-of-pass write-back,
mid-checkpoint sparse dump, the MANIFEST crash window, a mid-verb server
death — rolls the world back to the last committed generation and the
re-driven run converges to a final table + dense-params state
BIT-IDENTICAL to the fault-free baseline.  Exactly-once survives server
restarts two ways, both pinned here: the in-process dedup-window handoff
(launch.PSServerSupervisor) and the checkpoint's DEDUP.bin.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import fleet, flags
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.launch import PSServerSupervisor
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.ps.service import (PSClient, PSServer,
                                            RemoteTableAdapter)
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get
from torch_ps_helpers import (KEYS, StubTrainer, assert_same_params,
                              assert_same_table, fresh, mini_pass, table_cfg,
                              table_state, write_slot_file)

N_PASSES = 3


@pytest.fixture(autouse=True)
def _clean():
    StatRegistry.instance().reset()
    flags.set_flags({"ps_fault_injection": True})
    yield
    faults.uninstall()
    flags.set_flags({"ps_fault_injection": False})


@pytest.fixture(scope="module")
def pass_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("crash-passes")
    files = []
    for p in range(N_PASSES):
        path = str(d / f"p{p}.txt")
        write_slot_file(path, np.random.default_rng(p), 48)
        files.append([path])
    return files


@pytest.fixture(scope="module")
def baseline(pass_files):
    """Fault-free reference run — the state every chaos run must hit."""
    eng, ds, tr = fresh()
    metrics = fleet.train_passes(tr, ds, pass_files, date="20260801",
                                 prefetch=False)
    return eng, tr, metrics


# ---------------------------------------------------------------------------
# Kill-at-lifecycle-point resume: bit-identity through the outer tier.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point,hit,prefetch", [
    ("end_pass", 1, False),      # pass-1 write-back dies, serial loop
    ("end_pass", 1, True),       # same death through the prefetcher
    ("ckpt_sparse", 1, False),   # mid-checkpoint: shards down, gen not
                                 # assembled — previous gen must load
    ("ckpt_commit", 1, False),   # the MANIFEST crash window: gen dir
                                 # complete, pointer not yet swapped
])
def test_kill_point_resume_bit_identical(pass_files, baseline, tmp_path,
                                         point, hit, prefetch):
    base_eng, base_tr, base_metrics = baseline
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    eng, ds, tr = fresh()
    faults.install(faults.FaultPlan(seed=13).kill_at(point, at=(hit,)))
    metrics = fleet.train_passes(tr, ds, pass_files, date="20260801",
                                 prefetch=prefetch, checkpoint=ck,
                                 resume=4)
    faults.uninstall()

    assert len(metrics) == N_PASSES
    assert all(m is not None for m in metrics)
    np.testing.assert_array_equal(
        [m["loss"] for m in metrics],
        [m["loss"] for m in base_metrics])
    assert_same_table(base_eng.table, eng.table)
    assert_same_params(base_tr, tr)
    assert stat_get("ps.fleet.auto_resume") >= 1
    assert stat_get("ps.fault.lifecycle.kill") >= 1
    assert flight.events(kind="resume_ok")
    # crashed assembly dirs never survive the recovery cycle
    assert not [n for n in os.listdir(ck.root) if n.endswith(".tmp")]


def test_completed_day_rerun_is_noop(pass_files, tmp_path):
    """A fresh incarnation resuming a COMPLETED day skips every pass via
    the checkpointed cursor (None placeholders keep indices aligned) and
    leaves the restored table byte-identical."""
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    eng, ds, tr = fresh()
    m1 = fleet.train_passes(tr, ds, pass_files, date="20260801",
                            prefetch=False, checkpoint=ck, resume=2)
    assert all(m is not None for m in m1)

    eng2, ds2, tr2 = fresh()
    m2 = fleet.train_passes(tr2, ds2, pass_files, date="20260801",
                            prefetch=False, checkpoint=ck, resume=2)
    assert m2 == [None] * N_PASSES
    assert_same_table(eng.table, eng2.table)
    assert_same_params(tr, tr2)


# ---------------------------------------------------------------------------
# Restart-durable exactly-once: the dedup window outlives the server.
# ---------------------------------------------------------------------------

def _applied_unacked_push(table, dedup_handoff):
    """Push one delta whose ack the schedule drops (applied server-side,
    client left retrying), kill the server in that window, restart it on
    the same port — with or without the dedup-window handoff — and let
    the retry land.  Returns (value before, value after)."""
    srv = PSServer(table)
    port = srv.addr[1]
    restarted = []
    try:
        client = PSClient(srv.addr, retries=None, retry_sleep=0.4,
                          backoff_cap=0.8, deadline=30)
        rows = client.pull_sparse(KEYS, create=True)
        base = np.asarray(rows["show"]).copy()
        faults.install(faults.FaultPlan(seed=3)
                       .drop("send", role="server", at=(0,)))
        d = {f: np.zeros_like(v) for f, v in rows.items()}
        d["show"] = np.ones(len(KEYS), np.float32)
        done = threading.Event()

        def push():
            client.push_sparse_delta(KEYS, d)
            done.set()

        t = threading.Thread(target=push, daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while stat_get("ps.fault.send.drop") < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        assert stat_get("ps.fault.send.drop") >= 1   # applied, ack lost
        state = srv.dedup_state() if dedup_handoff else None
        srv.kill()               # dies with the retry still in flight
        faults.uninstall()
        restarted.append(PSServer(table, port=port, dedup_state=state))
        assert done.wait(timeout=30)
        t.join(timeout=5)
        got = np.asarray(client.pull_sparse(KEYS)["show"])
        return base, got
    finally:
        faults.uninstall()
        for s in restarted:
            s.shutdown()
        srv.shutdown()


def test_dedup_handoff_restart_applies_exactly_once():
    table = ShardedHostTable(table_cfg(), seed=0)
    base, got = _applied_unacked_push(table, dedup_handoff=True)
    np.testing.assert_array_equal(got, base + 1.0)   # exactly once
    assert stat_get("ps.server.dedup_hit") >= 1
    assert stat_get("ps.server.dedup_restore_entries") >= 1
    assert any(e.get("source") == "handoff"
               for e in flight.events(kind="dedup_restore"))


def test_dedup_restart_without_handoff_double_applies():
    """Sensitivity control: the SAME schedule with the window dropped on
    restart double-applies — restart-durable exactly-once rests on the
    persisted window, not on timing."""
    table = ShardedHostTable(table_cfg(), seed=0)
    base, got = _applied_unacked_push(table, dedup_handoff=False)
    np.testing.assert_array_equal(got, base + 2.0)   # the double apply


def test_dedup_window_persists_through_checkpoint_save_load(tmp_path):
    """DEDUP.bin rides the sparse dump: a save verb persists the DONE
    entries next to the rows they describe; a load restores both from
    the SAME dump."""
    table = ShardedHostTable(table_cfg(), seed=0)
    srv = PSServer(table)
    path = str(tmp_path / "sparse")
    try:
        client = PSClient(srv.addr, deadline=30)
        rows = client.pull_sparse(KEYS, create=True)
        d = {f: np.zeros_like(v) for f, v in rows.items()}
        d["show"] = np.ones(len(KEYS), np.float32)
        client.push_sparse_delta(KEYS, d)    # leaves a DONE dedup entry
        client.save(path, mode="all")
        assert os.path.exists(os.path.join(path, "DEDUP.bin"))
    finally:
        srv.shutdown()

    table2 = ShardedHostTable(table_cfg(), seed=0)
    srv2 = PSServer(table2)
    try:
        client2 = PSClient(srv2.addr, deadline=30)
        client2.load(path)
        assert stat_get("ps.server.dedup_restore_entries") >= 1
        assert any(e.get("source") == "checkpoint"
                   for e in flight.events(kind="dedup_restore"))
        got = np.asarray(client2.pull_sparse(KEYS)["show"])
        np.testing.assert_array_equal(
            got, np.asarray(rows["show"]) + 1.0)
    finally:
        srv2.shutdown()


# ---------------------------------------------------------------------------
# Generation chain mechanics: retain-K GC and the resume roundtrip.
# ---------------------------------------------------------------------------

def test_retain_k_gc_keeps_heads_and_chains(tmp_path):
    """keep=2, base_every=3 over base + 6 pass saves: gens 0(B) 1(D) 2(D)
    3(B) 4(D) 5(D) 6(B).  The two newest heads are 5 and 6; their chains
    reference {3,4,5} ∪ {6} — everything else must be reclaimed."""
    eng = BoxPSEngine(table_cfg(), seed=0, device="cpu")
    eng.set_date("20260801")
    tr = StubTrainer()
    ck = TrainCheckpoint(str(tmp_path / "ckpt"), keep=2, base_every=3)
    ck.save(eng, tr)                          # gen 0, base
    for p in range(6):
        mini_pass(eng, p)
        ck.save_pass(eng, tr)                 # gens 1..6
    assert ck._manifest() == 6
    on_disk = sorted(int(n[4:]) for n in os.listdir(ck.root)
                     if n.startswith("gen-") and not n.endswith(".tmp"))
    assert on_disk == [3, 4, 5, 6]
    assert stat_get("ckpt.gc_removed") >= 1
    assert flight.events(kind="ckpt_gc")

    # roundtrip: a fresh world restored from the head chain matches
    eng2 = BoxPSEngine(table_cfg(), seed=0, device="cpu")
    tr2 = StubTrainer()
    with torch.no_grad():
        for p in tr2.model.parameters():      # must be overwritten
            p += 7.0
    state = ck.resume(eng2, tr2)
    assert state["generation"] == 6
    assert eng2.day_id == "20260801"
    assert_same_table(eng.table, eng2.table)
    assert_same_params(tr, tr2)


# ---------------------------------------------------------------------------
# Supervisor auto-restart: same port, dedup handoff / checkpoint reload.
# ---------------------------------------------------------------------------

def test_supervisor_restarts_dead_server_same_port():
    table = ShardedHostTable(table_cfg(), seed=0)
    sup = PSServerSupervisor(table, poll_s=0.01)
    try:
        client = PSClient(sup.addr, retries=None, retry_sleep=0.05,
                          backoff_cap=0.2, deadline=30)
        rows = client.pull_sparse(KEYS, create=True)
        faults.install(faults.FaultPlan(seed=5)
                       .kill_server(cmd="pull_sparse", at=(0,)))
        got = client.pull_sparse(KEYS)     # dies mid-verb; the retry
        faults.uninstall()                 # lands on the restart
        np.testing.assert_array_equal(np.asarray(got["show"]),
                                      np.asarray(rows["show"]))
        assert sup.restarts >= 1
        assert stat_get("ps.supervisor.restarts") >= 1
        assert sup.server.addr[1] == sup.port          # same port
        assert any(e.get("role") == "ps_server"
                   for e in flight.events(kind="resume_ok"))
    finally:
        faults.uninstall()
        sup.stop()


def test_supervisor_ckpt_reload_restart(tmp_path):
    """reload_from_ckpt: the restarted instance distrusts the in-process
    table and reloads rows (+ dedup window) from the last committed
    generation — the cross-process restart semantics."""
    eng = BoxPSEngine(table_cfg(), seed=0, device="cpu")
    eng.set_date("20260801")
    mini_pass(eng, 0)
    ck = TrainCheckpoint(str(tmp_path / "ckpt"))
    ck.save(eng, StubTrainer())

    table2 = ShardedHostTable(table_cfg(), seed=0)
    sup = PSServerSupervisor(table2, poll_s=0.01,
                             ckpt_root=str(tmp_path / "ckpt"),
                             reload_from_ckpt=True)
    try:
        client = PSClient(sup.addr, retries=None, retry_sleep=0.05,
                          backoff_cap=0.2, deadline=30)
        faults.install(faults.FaultPlan(seed=5)
                       .kill_server(cmd="pull_sparse", at=(0,)))
        keys, _ = table_state(eng.table)
        client.pull_sparse(keys)           # death → reload → retry served
        faults.uninstall()
        assert sup.restarts >= 1
        assert_same_table(eng.table, table2)
    finally:
        faults.uninstall()
        sup.stop()


# ---------------------------------------------------------------------------
# The acceptance soak: kill-anywhere across 2 days x 3 passes.
# ---------------------------------------------------------------------------

def _soak_files(tmp_path):
    out = {}
    for d in range(2):
        out[d] = []
        for p in range(3):
            path = str(tmp_path / f"d{d}p{p}.txt")
            write_slot_file(path, np.random.default_rng(100 * d + p), 48)
            out[d].append([path])
    return out


@pytest.mark.slow
def test_kill_anywhere_soak_bit_identical(tmp_path):
    """2 days x 3 passes of real training driven through a supervised PS
    server, with seeded kills spread across BOTH tiers and BOTH days:
    trainer deaths at end-of-pass write-back, mid-checkpoint and in the
    MANIFEST window, a server death mid push_sparse_delta (supervisor
    restart + dedup handoff), and one applied-unacked ack drop.  Final
    table AND dense params must be bit-identical to the fault-free run,
    including the day-boundary decay between the days."""
    day_files = _soak_files(tmp_path)
    dates = ["20260801", "20260802"]

    def run(chaos):
        # BOTH runs train through a PS server + delta-mode adapter so the
        # comparison isolates the chaos machinery, not the (float-exact
        # but differently-ordered) local-vs-remote arithmetic paths
        table = ShardedHostTable(table_cfg(), seed=0)
        sup = PSServerSupervisor(table, poll_s=0.01, max_restarts=16)
        client = PSClient(sup.addr, retries=None, retry_sleep=0.05,
                          backoff_cap=0.3, deadline=60)
        eng, ds, tr = fresh(
            table=RemoteTableAdapter(client, delta_mode=True))
        ck = None
        if chaos:
            ck = TrainCheckpoint(str(tmp_path / "ckpt"))
            faults.install(
                faults.FaultPlan(seed=17)
                .drop("send", role="server", at=(2,))   # forces a dedup hit
                .kill_server(cmd="push_sparse_delta", at=(5,))
                .kill_at("end_pass", at=(1,))           # day-0 write-back
                .kill_at("ckpt_commit", at=(3,))
                .kill_at("ckpt_sparse", at=(6,)))       # lands in day 1
        metrics = []
        try:
            for d, date in enumerate(dates):
                metrics.extend(fleet.train_passes(
                    tr, ds, day_files[d], date=date, prefetch=(d == 1),
                    checkpoint=ck, resume=8 if chaos else None))
        finally:
            faults.uninstall()
            sup.stop()
        return table, tr, metrics

    table_want, tr_want, m_want = run(chaos=False)
    table_got, tr_got, m_got = run(chaos=True)

    assert_same_table(table_want, table_got)
    assert_same_params(tr_want, tr_got)
    np.testing.assert_array_equal(
        [m["loss"] for m in m_want],
        [m["loss"] for m in m_got if m is not None][:len(m_want)])
    assert stat_get("ps.fleet.auto_resume") >= 1     # trainer tier fired
    assert stat_get("ps.fault.lifecycle.kill") >= 1
    assert stat_get("ps.supervisor.restarts") >= 1   # server tier fired
    assert stat_get("ps.server.dedup_hit") >= 1      # zero double apply
