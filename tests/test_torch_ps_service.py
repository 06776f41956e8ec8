"""The PyTorch port's PS service (counterpart of test_ps_service.py, run
against ``paddlebox_tpu_torch``): sparse and dense verbs, the barrier,
the engine over a remote table on the CPU, the typed wire codec (no
pickle; a torch tensor is refused, not converted), multi-table routing,
the keyed allreduce and ``allreduce_auc_state`` over the port's torch
bucket state, transparent chunking, the per-table row-width estimate and
the ``dump_xbox`` verb (a server-side xbox dump; an unknown table is
refused by name)."""

import os
import threading

import numpy as np
import pytest

from paddlebox_tpu_torch.config import EmbeddingTableConfig
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.ps.service import PSClient, PSServer, RemoteTableAdapter


@pytest.fixture()
def server():
    table = ShardedHostTable(EmbeddingTableConfig(embedding_dim=3,
                                                  shard_num=4))
    srv = PSServer(table)
    yield srv
    srv.shutdown()


def test_sparse_roundtrip(server):
    client = PSClient(server.addr)
    keys = np.array([1, 2, 3], np.uint64)
    rows = client.pull_sparse(keys)
    rows["show"][:] = [5, 6, 7]
    client.push_sparse(keys, rows)
    assert client.size() == 3
    back = client.pull_sparse(np.array([3, 1], np.uint64))
    np.testing.assert_allclose(back["show"], [7, 5])


def test_dense_and_lifecycle(server, tmp_path):
    client = PSClient(server.addr)
    client.push_dense("w", np.ones(4))
    client.push_dense("w", np.ones(4) * 2, add=True)
    np.testing.assert_allclose(client.pull_dense("w"), [3, 3, 3, 3])
    assert client.pull_dense("missing") is None

    keys = np.array([10], np.uint64)
    rows = client.pull_sparse(keys)
    rows["show"][:] = 100.0
    client.push_sparse(keys, rows)
    client.end_day()
    np.testing.assert_allclose(
        client.pull_sparse(keys)["show"], [98.0])
    assert client.save(str(tmp_path / "m")) == 1


def test_barrier(server):
    clients = [PSClient(server.addr) for _ in range(3)]
    done = []

    def worker(c):
        c.barrier(3)
        done.append(1)

    threads = [threading.Thread(target=worker, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(done) == 3


def test_engine_over_remote_table(server):
    """BoxPSEngine running its pass lifecycle against the remote PS
    (the multi-host BuildPull path)."""
    engine = BoxPSEngine(EmbeddingTableConfig(embedding_dim=3, shard_num=4),
                         device="cpu")
    engine.table = RemoteTableAdapter(PSClient(server.addr))
    engine.begin_feed_pass()
    engine.add_keys(np.array([11, 22, 33], np.uint64))
    engine.end_feed_pass()
    engine.begin_pass()
    engine.ws["show"][1:4] += 2.0
    engine.end_pass()
    client = PSClient(server.addr)
    np.testing.assert_allclose(
        client.pull_sparse(np.array([11, 22, 33], np.uint64))["show"],
        [2.0, 2.0, 2.0])


def test_client_retries_unreachable():
    client = PSClient(("127.0.0.1", 9), retries=2, retry_sleep=0.05)
    with pytest.raises(ConnectionError):
        client.size()


# -- typed binary wire (no pickle on network bytes) -------------------------

def test_wire_roundtrip_all_types():
    from paddlebox_tpu_torch.ps import wire
    msg = {
        "cmd": "x", "flag": True, "count": -7, "ratio": 2.5, "none": None,
        "arr_u64": np.arange(5, dtype=np.uint64),
        "arr_f32": np.ones((3, 4), np.float32),
        "arr_0d": np.float32(3.0) * np.ones((), np.float32),
        "rows": {"show": np.zeros((2,), np.float32),
                 "mf": np.ones((2, 3), np.float32)},
    }
    out = wire.decode(wire.encode(msg))
    assert out["cmd"] == "x" and out["flag"] is True and out["count"] == -7
    assert out["ratio"] == 2.5 and out["none"] is None
    np.testing.assert_array_equal(out["arr_u64"], msg["arr_u64"])
    np.testing.assert_array_equal(out["arr_f32"], msg["arr_f32"])
    np.testing.assert_array_equal(out["rows"]["mf"], msg["rows"]["mf"])


def test_wire_refuses_torch_tensors():
    """Every payload reaching the wire is numpy: a torch tensor in a
    frame is an error, never a silent ``.numpy()``."""
    import torch
    from paddlebox_tpu_torch.ps import wire
    with pytest.raises(TypeError, match="Tensor"):
        wire.encode({"cmd": "x", "arr": torch.ones(3)})
    with pytest.raises(TypeError, match="Tensor"):
        wire.encode({"cmd": "x", "rows": {"show": torch.zeros(2)}})


def test_wire_rejects_malformed():
    from paddlebox_tpu_torch.ps import wire
    with pytest.raises(wire.DecodeError):
        wire.decode(b"\xff\xff\xff\xff")           # absurd field count
    with pytest.raises(wire.DecodeError):
        wire.decode(wire.encode({"a": 1}) + b"xx")  # trailing bytes
    import pickle
    with pytest.raises(wire.DecodeError):          # a pickle is not a frame
        wire.decode(pickle.dumps({"cmd": "pull_sparse"}))


def test_no_pickle_in_service_module():
    """The wire contract: nothing in the service path may unpickle network
    bytes."""
    import inspect
    from paddlebox_tpu_torch.ps import service, wire
    for mod in (service, wire):
        assert "pickle.loads" not in inspect.getsource(mod)


def test_multi_table_routing(tmp_path):
    from paddlebox_tpu_torch.ps.service import DEFAULT_TABLE
    t1 = ShardedHostTable(EmbeddingTableConfig(embedding_dim=3, shard_num=2))
    t2 = ShardedHostTable(EmbeddingTableConfig(embedding_dim=3, shard_num=2))
    srv = PSServer({DEFAULT_TABLE: t1, "user_profile": t2})
    try:
        client = PSClient(srv.addr)
        k1 = np.array([1, 2], np.uint64)
        k2 = np.array([7, 8, 9], np.uint64)
        client.push_sparse(k1, client.pull_sparse(k1))
        client.push_sparse(k2, client.pull_sparse(k2, table="user_profile"),
                           table="user_profile")
        assert client.size() == 2
        assert client.size(table="user_profile") == 3
        assert client.list_tables() == {DEFAULT_TABLE: 2, "user_profile": 3}
        with pytest.raises(RuntimeError, match="unknown table"):
            client.size(table="nope")
    finally:
        srv.shutdown()


def test_loopback_bulk_roundtrip():
    """Bulk dense arrays round-trip the loopback wire bit for bit (16 MB
    of f64, three times).  The JAX suite's >=100 MB/s floor is a CPU
    timing floor; the port measures loopback MB/s on the card machine
    (chip_smoke's cluster phase) instead of asserting it here."""
    table = ShardedHostTable(EmbeddingTableConfig(embedding_dim=3,
                                                  shard_num=2))
    srv = PSServer(table)
    try:
        client = PSClient(srv.addr)
        blob = np.random.default_rng(0).random(16 << 20 >> 3)  # 16 MB f64
        for i in range(3):
            client.push_dense("blob", blob * (i + 1))
            np.testing.assert_array_equal(client.pull_dense("blob"),
                                          blob * (i + 1))
    finally:
        srv.shutdown()


def test_allreduce_sums_across_world(server):
    """Keyed array allreduce: every participant receives the identical sum
    (the exact-global-metrics primitive, ≙ fleet.metrics gloo all_reduce);
    keys drain after all readers and are reusable."""
    world = 3
    results = [None] * world
    errors = []

    def worker(r):
        try:
            c = PSClient(server.addr)
            arrs = {"pos": np.full((8,), float(r + 1), np.float64),
                    "scalars": np.arange(5, dtype=np.float64) * (r + 1)}
            results[r] = c.allreduce(arrs, world, key="m-0")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errors, errors
    for r in range(world):
        np.testing.assert_allclose(results[r]["pos"], np.full((8,), 6.0))
        np.testing.assert_allclose(results[r]["scalars"],
                                   np.arange(5, dtype=np.float64) * 6)

    # key fully drained -> immediately reusable
    c = PSClient(server.addr)
    out = c.allreduce({"x": np.ones(2)}, 1, key="m-0")
    np.testing.assert_allclose(out["x"], [1, 1])


def test_allreduce_matches_global_auc(server):
    """allreduce_auc_state: two workers' summed buckets give exactly the
    AUC of the union of their data."""
    import torch
    from paddlebox_tpu_torch.metrics.auc import (AucCalculator,
                                                 accumulate_auc,
                                                 allreduce_auc_state,
                                                 make_auc_state)

    rng = np.random.default_rng(0)
    preds = rng.random((2, 64)).astype(np.float32)
    labels = (rng.random((2, 64)) < preds).astype(np.float32)  # learnable

    states = [accumulate_auc(make_auc_state(1000),
                             torch.as_tensor(preds[r]),
                             torch.as_tensor(labels[r])) for r in range(2)]
    got = [None, None]

    def worker(r):
        c = PSClient(server.addr)
        g = allreduce_auc_state(states[r], c, 2, key="auc-t")
        calc = AucCalculator(1000)
        calc.merge_device_state(g)
        got[r] = calc.compute()["auc"]

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)

    ref = AucCalculator(1000)
    ref.add_data(preds.ravel(), labels.ravel())
    want = ref.compute()["auc"]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, atol=1e-9)


def test_transparent_chunking_moves_oversized_pulls_and_pushes():
    """A pull/push larger than the wire frame budget chunks transparently
    in the client (≙ brpc_ps_client sharding bulk requests) — the caller
    never splits.  Exercised by shrinking the client's frame budget so the
    traffic is ~2x the budget per verb."""
    table = ShardedHostTable(EmbeddingTableConfig(embedding_dim=8,
                                                  shard_num=4))
    srv = PSServer(table)
    try:
        client = PSClient(srv.addr, max_frame=1 << 16)    # 64 KiB budget
        n = 4000                    # ~a few MB of row traffic >> budget
        keys = np.arange(1, n + 1, dtype=np.uint64)
        rows = client.pull_sparse(keys, create=True)
        assert len(rows["show"]) == n
        rows["show"] = np.arange(n, dtype=np.float32)
        rows["mf"] = np.tile(np.arange(8, dtype=np.float32), (n, 1)) + \
            np.arange(n, dtype=np.float32)[:, None]
        client.push_sparse(keys, rows)
        assert client.size() == n

        # read back through a fresh client (fresh row-size estimate) in a
        # single logical pull; verify chunk boundaries didn't scramble rows
        c2 = PSClient(srv.addr, max_frame=1 << 16)
        back = c2.pull_sparse(keys[::-1].copy())          # reversed order
        np.testing.assert_allclose(back["show"],
                                   np.arange(n, dtype=np.float32)[::-1])
        np.testing.assert_allclose(back["mf"][:, 0],
                                   np.arange(n, dtype=np.float32)[::-1])

        # delta pushes chunk too and still sum server-side
        d = {f: np.zeros_like(v) for f, v in rows.items()}
        d["show"] = np.ones((n,), np.float32)
        client.push_sparse_delta(keys, d)
        client.push_sparse_delta(keys, d)
        final = c2.pull_sparse(keys)
        np.testing.assert_allclose(
            final["show"], np.arange(n, dtype=np.float32) + 2.0)
    finally:
        srv.shutdown()


def test_row_size_estimate_is_per_table_and_locked():
    """The pull_sparse learned row-size estimate was once a
    single per-client scalar mutated outside self._lock — after learning
    a narrow table, a pull from a much wider table sized its first chunk
    from the stale estimate and could overshoot the hard wire cap.  The
    estimate is now a per-table dict updated under the lock: each table
    learns its own width, and an unlearned table always re-probes."""
    from paddlebox_tpu_torch.ps.service import DEFAULT_TABLE
    narrow = ShardedHostTable(EmbeddingTableConfig(embedding_dim=1,
                                                   shard_num=2))
    wide = ShardedHostTable(EmbeddingTableConfig(embedding_dim=256,
                                                 shard_num=2))
    srv = PSServer({DEFAULT_TABLE: narrow, "wide": wide})
    try:
        client = PSClient(srv.addr, max_frame=1 << 16)
        keys = np.arange(1, 2001, dtype=np.uint64)
        client.pull_sparse(keys, create=True)                 # narrow
        assert set(client._row_bytes_est) == {DEFAULT_TABLE}
        n_est = client._row_bytes_est[DEFAULT_TABLE]
        # first pull of the wide table must NOT reuse the narrow width:
        # it re-probes (unlearned branch) and learns its own entry
        rows = client.pull_sparse(keys, table="wide", create=True)
        assert rows["mf"].shape == (2000, 256)
        w_est = client._row_bytes_est["wide"]
        assert client._row_bytes_est[DEFAULT_TABLE] == n_est
        assert w_est > 4 * n_est        # widths learned independently
        # and the narrow table's chunks stay sized by its own width
        assert client._per_chunk(n_est) > client._per_chunk(w_est)
    finally:
        srv.shutdown()


def test_dump_xbox_verb_refuses_by_name(server, tmp_path):
    """The server's xbox dump: the verb writes the server's rows through
    ``io.checkpoint.dump_table_xbox`` (the same bytes as a local dump of
    the same table), and a dump of a table the server does not hold is
    refused by name with an error reply (the client's ServerErrorReply,
    a RuntimeError) while the server keeps serving."""
    from paddlebox_tpu_torch.io.checkpoint import dump_table_xbox
    from paddlebox_tpu_torch.ps.service import ServerErrorReply
    client = PSClient(server.addr)
    keys = np.array([1, 2], np.uint64)
    rows = client.pull_sparse(keys, create=True)
    rows["show"][:] = [10.0, 20.0]
    client.push_sparse(keys, rows)
    path = str(tmp_path / "remote.xbox")
    resp = client._call({"cmd": "dump_xbox", "table": None, "path": path})
    assert resp["dumped"] == 2
    local = str(tmp_path / "local.xbox")
    assert dump_table_xbox(server.tables["embedding"], local) == 2
    with open(path, "rb") as a, open(local, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ServerErrorReply, match="unknown table 'nope'"):
        client._call({"cmd": "dump_xbox", "table": "nope",
                      "path": str(tmp_path / "x")})
    assert not os.path.exists(tmp_path / "x")
    assert client.size() == 2               # the server keeps serving


def test_geo_sparse_table_protocol():
    """Geo-async table (counterpart of test_aux.py's test of the same
    name): per-trainer pending-key sets drain independently."""
    from paddlebox_tpu_torch.ps.geo_table import GeoSparseTable
    t = GeoSparseTable(dim=3, num_trainers=2, learning_rate=0.5)
    keys = np.array([7, 9], np.uint64)
    t.push_sparse_param(keys, np.ones((2, 3), np.float32))
    # trainer 0 pushes an update on key 7
    t.push_sparse(np.array([7], np.uint64),
                  np.array([[2.0, 0.0, 0.0]], np.float32))
    np.testing.assert_allclose(t.pull_sparse(np.array([7], np.uint64))[0],
                               [0.0, 1.0, 1.0])
    # both trainers see key 7 pending; pulls clear independently
    ids0, vals0 = t.pull_geo_param(0)
    assert ids0.tolist() == [7]
    np.testing.assert_allclose(vals0[0], [0.0, 1.0, 1.0])
    ids0b, _ = t.pull_geo_param(0)
    assert ids0b.size == 0
    ids1, _ = t.pull_geo_param(1)
    assert ids1.tolist() == [7]
    # unknown keys pull zeros
    assert t.pull_sparse(np.array([42], np.uint64))[0].tolist() == [0, 0, 0]
