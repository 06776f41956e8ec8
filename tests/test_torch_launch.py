"""The launcher half of the PyTorch port: elastic membership, the worker
launcher and its elastic relaunch, the TCP global shuffle, the
``init_distributed`` gloo rendezvous and two training workers.

Ports ``tests/test_launch_elastic.py`` (over the port's
``elastic``, ``launch.launch`` / ``launch_elastic`` and
``tests/torch_elastic_worker.py``, which imports neither torch nor JAX)
and ``tests/test_two_process.py`` (``tests/torch_dist_worker.py``, spawned
through ``python -m paddlebox_tpu_torch.launch``).  Beside them: two
processes join ``init_distributed``'s gloo group and ``all_reduce``; an
at-cap grow request survives ranks that finish a second apart (the JAX
launcher burns it, ROADMAP Queue 3); the fleet's record routing
(``slice_of`` of ``route_keys``) and the shuffle's block frames
(``block_to_wire``) equal the JAX package's, and each package decodes the
other's frames.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu.data import pass_feed as jpass_feed
from paddlebox_tpu.data import shuffle_transport as jst
from paddlebox_tpu.data.slot_record import SlotRecordBlock as JBlock
from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        SlotConfig, SparseSGDConfig)
from paddlebox_tpu_torch.data import pass_feed
from paddlebox_tpu_torch.data import shuffle_transport as st
from paddlebox_tpu_torch.data.data_feed import SlotParser
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.shuffle_transport import TcpShuffleTransport
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.elastic import ElasticManager, FileStore
from paddlebox_tpu_torch.launch import launch, launch_elastic
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.service import PSServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")
_DIST_WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _read_json(path):
    with open(path) as f:
        return json.load(f)


# -- elastic membership ------------------------------------------------------

def test_filestore_ttl(tmp_path):
    store = FileStore(str(tmp_path), ttl=0.3)
    store.put("rank-0", {"rank": 0})
    assert store.get("rank-0") == {"rank": 0}
    assert store.alive_keys() == ["rank-0"]
    time.sleep(0.4)
    assert store.get("rank-0") is None
    assert store.alive_keys() == []


def test_elastic_detects_member_loss(tmp_path):
    store = FileStore(str(tmp_path), ttl=1.0)
    m0 = ElasticManager(store, rank=0, world_size=2,
                        heartbeat_interval=0.2)
    m1 = ElasticManager(store, rank=1, world_size=2,
                        heartbeat_interval=0.2)
    changes = []
    m0.on_membership_change(lambda members: changes.append(list(members)))
    m0.start()
    m1.start()
    time.sleep(0.5)
    assert m0.healthy()
    m1.stop()  # rank 1 leaves
    time.sleep(1.5)
    assert not m0.healthy()
    assert changes and all("rank-00001" not in c for c in changes[-1:])
    m0.stop()


# -- the worker launcher -----------------------------------------------------

def test_launcher_spawns_and_collects(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        import os, sys
        rank = os.environ["PBOX_RANK"]
        world = os.environ["PBOX_WORLD_SIZE"]
        print(f"worker {rank}/{world}")
        sys.exit(0)
    """))
    code = launch(str(script), [], nproc=3, log_dir=str(tmp_path / "logs"))
    assert code == 0
    logs = sorted(os.listdir(tmp_path / "logs"))
    assert logs == ["worker-0.log", "worker-1.log", "worker-2.log"]


def test_launcher_propagates_failure(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys; sys.exit(3)\n")
    assert launch(str(script), [], nproc=2) == 3


def test_tcp_shuffle_transport():
    cfg = DataFeedConfig(slots=(SlotConfig("s", capacity=2),))
    parser = SlotParser(cfg)
    addrs = [("127.0.0.1", _free_port()) for _ in range(2)]
    transports = [TcpShuffleTransport(r, addrs) for r in range(2)]
    datasets = []
    for r in range(2):
        ds = SlotDataset(cfg, transport=transports[r])
        ds._blocks = [parser.parse_block(
            [f"1 {100 * r + i}" for i in range(8)])]
        datasets.append(ds)
    threads = [threading.Thread(target=ds.global_shuffle) for ds in datasets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    keys = []
    for ds in datasets:
        for b in ds.get_blocks():
            keys.extend(b.uint64_slots["s"][0].tolist())
    assert sorted(keys) == sorted(100 * r + i for r in range(2)
                                  for i in range(8))
    for tr in transports:
        tr.close()


# -- elastic relaunch orchestration ------------------------------------------

def test_elastic_relaunch_shrinks_world_after_repeat_node_loss(tmp_path):
    """Rank 1 SIGKILLs itself mid-pass in generation 0 AND again in
    generation 1: the first kill respawns it (transient-OOM policy), the
    repeat kill is the real node-loss verdict — the launcher scales in to
    a 2-worker generation 2, the job resumes from the shared checkpoint
    and finishes — exit 0, no lost progress."""
    edir = str(tmp_path / "elastic")
    rc = launch_elastic(_WORKER, ["kill_repeat"], nproc=3,
                        elastic_dir=edir, min_workers=2, max_relaunches=2,
                        heartbeat_ttl=4.0)
    assert rc == 0
    done = sorted(os.listdir(edir))
    assert "done-g2-r0" in done and "done-g2-r1" in done
    assert not any(d.startswith(("done-g0", "done-g1")) for d in done)
    final = _read_json(os.path.join(edir, "job_ckpt.json"))
    assert final == {"step": 40, "gen": 2, "world": 2}


def test_elastic_single_sigkill_respawns_full_world(tmp_path):
    """A LONE SIGKILL exit (indistinguishable from a transient OOM kill)
    respawns the rank like a crash, not a permanent shrink: with
    min_workers == nproc the job finishes at full strength."""
    edir = str(tmp_path / "elastic")
    rc = launch_elastic(_WORKER, ["kill"], nproc=3, elastic_dir=edir,
                        min_workers=3, max_relaunches=2,
                        heartbeat_ttl=4.0)
    assert rc == 0
    done = sorted(os.listdir(edir))
    assert {"done-g1-r0", "done-g1-r1", "done-g1-r2"} <= set(done)
    final = _read_json(os.path.join(edir, "job_ckpt.json"))
    assert final == {"step": 40, "gen": 1, "world": 3}


def test_elastic_relaunch_detects_heartbeat_partition(tmp_path):
    """Rank 1 stops heartbeating but stays alive (partition): the launcher
    must SIGTERM it, scale in, and still finish the job."""
    edir = str(tmp_path / "elastic")
    rc = launch_elastic(_WORKER, ["partition"], nproc=3, elastic_dir=edir,
                        min_workers=2, max_relaunches=2,
                        heartbeat_ttl=3.0)
    assert rc == 0
    final = _read_json(os.path.join(edir, "job_ckpt.json"))
    assert final["gen"] == 1 and final["world"] == 2


def test_elastic_grow_request_scales_out(tmp_path):
    """A pending grow request is honored at the re-rendezvous after a
    real node loss (the partition verdict): the lost rank's capacity is
    replaced and the job finishes at full strength again."""
    edir = str(tmp_path / "elastic")
    os.makedirs(edir, exist_ok=True)
    with open(os.path.join(edir, "grow"), "w") as f:
        f.write("1")
    rc = launch_elastic(_WORKER, ["partition"], nproc=3, elastic_dir=edir,
                        min_workers=2, max_relaunches=2,
                        heartbeat_ttl=3.0)
    assert rc == 0
    final = _read_json(os.path.join(edir, "job_ckpt.json"))
    assert final["gen"] == 1 and final["world"] == 3


def test_elastic_aborts_below_quorum(tmp_path):
    """REALLY losing a rank (repeat SIGKILL) with min_workers == nproc
    must abort, not limp on."""
    edir = str(tmp_path / "elastic")
    rc = launch_elastic(_WORKER, ["kill_repeat"], nproc=3,
                        elastic_dir=edir, min_workers=3, max_relaunches=2,
                        heartbeat_ttl=4.0)
    assert rc == 76


@pytest.mark.parametrize("mode", ["none", "skew"])
def test_elastic_grow_after_spent_budget_keeps_job_alive(tmp_path, mode):
    """A grow request on a HEALTHY job with exhausted failure budget must
    not kill it: voluntary scale-out is free, and a no-op grow (already at
    the nproc cap) stays pending instead of being silently burned — also
    when one rank finishes a second before the other (``skew``: the
    first exit frees no capacity; the JAX launcher read it as room)."""
    edir = str(tmp_path / "elastic")
    os.makedirs(edir, exist_ok=True)
    with open(os.path.join(edir, "grow"), "w") as f:
        f.write("2")
    rc = launch_elastic(_WORKER, [mode], nproc=2, elastic_dir=edir,
                        min_workers=1, max_relaunches=0,
                        heartbeat_ttl=10.0)
    assert rc == 0
    final = _read_json(os.path.join(edir, "job_ckpt.json"))
    assert final["gen"] == 0 and final["world"] == 2
    assert sorted(d for d in os.listdir(edir) if d.startswith("done")) == \
        ["done-g0-r0", "done-g0-r1"]
    assert os.path.exists(os.path.join(edir, "grow"))


# -- python -m paddlebox_tpu_torch.launch: rendezvous and two workers --------

def _launch_workers(world, out, env_extra=None, timeout=420):
    """``python -m paddlebox_tpu_torch.launch`` over the dist worker;
    returns each rank's JSON."""
    env = dict(os.environ)
    env["DW_OUT"] = out
    env.update(env_extra or {})
    proc = subprocess.run(
        [sys.executable, "-m", "paddlebox_tpu_torch.launch",
         "--nproc_per_node", str(world),
         "--coordinator", f"127.0.0.1:{_free_port()}", _DIST_WORKER],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [_read_json(out + f".rank{r}") for r in range(world)]


def test_init_distributed_gloo_all_reduce(tmp_path):
    outs = _launch_workers(2, str(tmp_path / "ar"))
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["world"] == 2 and o["backend"] == "gloo"
        assert o["all_reduce"] == 3.0            # (0 + 1) + (1 + 1)


def _run_world(world, data, out, batch, passes=3):
    table = ShardedHostTable(EmbeddingTableConfig(
        embedding_dim=4, shard_num=4,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)))
    srv = PSServer(table)
    try:
        outs = _launch_workers(world, out, {
            "DW_PS_ADDR": f"{srv.addr[0]}:{srv.addr[1]}",
            "DW_SHUFFLE_PORTS": ",".join(
                str(_free_port()) for _ in range(world)),
            "DW_DATA": data, "DW_BATCH": str(batch),
            "DW_PASSES": str(passes)})
    finally:
        srv.shutdown()
    return [o["passes"] for o in outs], table


def test_two_workers_match_single_worker(tmp_path):
    from test_end_to_end import gen_data
    data = str(tmp_path / "pass.txt")
    gen_data(data, n=1500, seed=0)

    # single worker, effective batch 128
    solo, _ = _run_world(1, data, str(tmp_path / "solo"), batch=128)
    # two workers, batch 64 each == same effective batch
    duo, table = _run_world(2, data, str(tmp_path / "duo"), batch=64)

    solo_traj = [r["loss"] for r in solo[0]]
    duo_traj = [np.mean([duo[0][p]["loss"], duo[1][p]["loss"]])
                for p in range(len(duo[0]))]

    # both decrease over passes and track each other
    assert solo_traj[-1] < solo_traj[0]
    assert duo_traj[-1] < duo_traj[0]
    for s, d in zip(solo_traj, duo_traj):
        assert abs(s - d) < 0.06, (solo_traj, duo_traj)

    # final AUC of the 2-worker run shows the same learnable signal
    duo_auc = np.mean([duo[0][-1]["auc"], duo[1][-1]["auc"]])
    solo_auc = solo[0][-1]["auc"]
    assert duo_auc > 0.55 and abs(duo_auc - solo_auc) < 0.08

    # EXACT global metrics (allreduced bucket tables through the PS):
    # both ranks report the IDENTICAL value every pass
    for p in range(len(duo[0])):
        assert duo[0][p]["gauc"] == duo[1][p]["gauc"], p
    assert duo[0][-1]["gauc"] > 0.55

    # the PS table holds the merged state from both workers
    assert table.size() > 0


# -- across packages: record routing and shuffle frames ---------------------

def _blocks(seed=0, n=37):
    """The same records as a JAX-package block and a port block: two
    uint64 slots (some records empty in the first), a float slot, an aux
    slot, ins_ids, the page-view fields and a shuffle tag."""
    out = []
    for Block in (JBlock, SlotRecordBlock):
        r = np.random.default_rng(seed)
        blk = Block(n=n)
        for name in ("b", "a"):
            lens = r.integers(0 if name == "a" else 1, 4, size=n)
            off = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            blk.uint64_slots[name] = (r.integers(
                1, 2 ** 63, size=int(off[-1]), dtype=np.uint64), off)
        blk.float_slots["dense"] = (r.normal(size=2 * n).astype(np.float32),
                                    np.arange(n + 1, dtype=np.int64) * 2)
        blk.aux_slots["t"] = (r.integers(0, 9, size=n).astype(np.uint64),
                              np.arange(n + 1, dtype=np.int64))
        blk.ins_ids = [f"ins-{i}" for i in range(n - 1)] + [""]
        blk.search_ids = r.integers(0, 2 ** 40, size=n, dtype=np.uint64)
        blk.cmatch = r.integers(0, 300, size=n).astype(np.int32)
        blk.rank = r.integers(0, 4, size=n).astype(np.int32)
        blk.shuffle_tag = (3, 1, 7)
        out.append(blk)
    return out


@pytest.mark.parametrize("n_slices", [1, 4, 8, 13])
def test_record_routing_equals_jax(n_slices):
    jb, tb = _blocks(seed=n_slices)
    jk, tk = jpass_feed.route_keys(jb), pass_feed.route_keys(tb)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(st.slice_of(tk, n_slices),
                                  jst.slice_of(jk, n_slices))
    assert st.SHUFFLE_SALT == jst.SHUFFLE_SALT


def _same_block(a, b):
    assert a.n == b.n
    for kind in ("uint64_slots", "float_slots", "aux_slots"):
        ga, gb = getattr(a, kind), getattr(b, kind)
        assert set(ga) == set(gb), kind
        for name in ga:
            for x, y in zip(ga[name], gb[name]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert a.ins_ids == b.ins_ids
    for f in ("search_ids", "cmatch", "rank"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.shuffle_tag == b.shuffle_tag


def test_block_frames_equal_jax_both_ways():
    jb, tb = _blocks()
    jbytes, tbytes = jst.block_to_wire(jb), st.block_to_wire(tb)
    assert tbytes == jbytes
    # each package decodes the other's frame into the same records
    _same_block(st.block_from_wire(jbytes), tb)
    _same_block(jst.block_from_wire(tbytes), jb)
    # and the port's own round trip
    _same_block(st.block_from_wire(tbytes), tb)
