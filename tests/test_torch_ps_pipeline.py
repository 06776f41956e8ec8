"""The PyTorch port's pipelined multi-stream PS wire path and quantized
payloads (counterpart of test_ps_pipeline.py, run against
``paddlebox_tpu_torch``).

Covers: sliding-window chunk pipelining over the connection pool
(ordering, out-of-order completion, and the functional half of the JAX
suite's loopback speedup microbenchmark — its >=2x floor is a CPU timing
floor, measured on the card machine by chip_smoke instead), failure of one stream mid-window
converging bit-identically through the exactly-once dedup window, the
f32/f16/i8 wire encodings (tag 7 round-trip, delta-consistency via the
dequantized snapshot, bounded error), the learn-once row-width estimate,
the FLAGS_ps_snap_cap flag, and the observability counters.
"""

import threading

import numpy as np
import pytest

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import EmbeddingTableConfig
from paddlebox_tpu_torch.ps import faults, wire
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.service import (DEFAULT_TABLE, PSClient, PSServer,
                                      RemoteTableAdapter)
from paddlebox_tpu_torch.utils.backoff import Backoff
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get, stat_max

CFG = dict(embedding_dim=4, shard_num=4)


@pytest.fixture(autouse=True)
def _clean():
    StatRegistry.instance().reset()
    yield
    faults.uninstall()
    flags.set_flags({"ps_fault_injection": False})


def _server(seed=0):
    return PSServer(ShardedHostTable(EmbeddingTableConfig(**CFG), seed=seed))


def _delta_for(rows, value=1.0):
    d = {f: np.zeros_like(v) for f, v in rows.items()}
    d["show"] = np.full_like(rows["show"], value)
    return d


# -- pipelined chunk engine --------------------------------------------------

def test_pipelined_multichunk_roundtrip_and_ordering():
    """Many chunks over 4 streams: rows come back in key order, deltas sum
    exactly once, and the in-flight high-water mark proves real overlap."""
    srv = _server()
    try:
        client = PSClient(srv.addr, max_frame=1 << 14, streams=4, window=8)
        n = 3000
        keys = np.arange(1, n + 1, dtype=np.uint64)
        rows = client.pull_sparse(keys, create=True)
        assert len(rows["show"]) == n
        rows["show"] = np.arange(n, dtype=np.float32)
        client.push_sparse(keys, rows)

        c2 = PSClient(srv.addr, max_frame=1 << 14, streams=4, window=8)
        back = c2.pull_sparse(keys[::-1].copy())       # reversed order
        np.testing.assert_allclose(back["show"],
                                   np.arange(n, dtype=np.float32)[::-1])

        d = _delta_for(rows)
        client.push_sparse_delta(keys, d)
        client.push_sparse_delta(keys, d)
        final = c2.pull_sparse(keys)
        np.testing.assert_allclose(final["show"],
                                   np.arange(n, dtype=np.float32) + 2.0)
        assert stat_get("ps.client.inflight_hwm") > 1     # really pipelined
        assert stat_get("ps.wire.push_sparse_delta.tx_bytes") > 0
    finally:
        srv.shutdown()


def test_pull_rids_never_enter_dedup_window():
    """Pipelined pulls match responses by the rid echo, but the server must
    NOT cache bulk pull responses in its dedup window (bounded memory)."""
    srv = _server()
    try:
        client = PSClient(srv.addr, max_frame=1 << 14, streams=4)
        client.pull_sparse(np.arange(1, 1001, dtype=np.uint64), create=True)
        assert not srv._dedup._by_token       # pulls left no window entries
    finally:
        srv.shutdown()


def test_pipeline_streams_one_vs_four_same_chunks_and_rows():
    """The JAX suite's pipelining microbenchmark, without its wall-clock
    floor: the same multi-chunk pull + push_sparse_delta round trip
    through 1 stream / window 1 and through 4 streams / window 8 cuts
    the same chunks (>= 8), returns the same rows and lands each delta
    exactly once; only the 4-stream client has more than one chunk in
    flight.  A seeded per-dispatch delay stands in for wire latency, so
    the window really fills."""
    srv = _server()
    flags.set_flags({"ps_fault_injection": True})
    try:
        seq = PSClient(srv.addr, max_frame=1 << 14, streams=1, window=1)
        pipe = PSClient(srv.addr, max_frame=1 << 14, streams=4, window=8)
        n = 2500
        keys = np.arange(1, n + 1, dtype=np.uint64)
        rows = seq.pull_sparse(keys, create=True)
        pipe.pull_sparse(keys)
        per_row = seq._rows_bytes(rows)
        n_chunks = len(seq._chunk_counts(n, per_row))
        assert n_chunks >= 8, f"geometry too small ({n_chunks} chunks)"
        assert seq._chunk_counts(n, per_row) == \
            pipe._chunk_counts(n, per_row)

        faults.install(faults.FaultPlan(0).delay(
            "dispatch", 0.002, role="server", prob=1.0))
        hwm = {}
        got = {}
        for name, client in (("seq", seq), ("pipe", pipe)):
            StatRegistry.instance().reset()
            got[name] = client.pull_sparse(keys)
            client.push_sparse_delta(keys, _delta_for(got[name], 1.0))
            hwm[name] = stat_get("ps.client.inflight_hwm")
        faults.uninstall()
        assert hwm["seq"] <= 1 < hwm["pipe"], hwm
        for f in got["seq"]:
            if f == "show":
                np.testing.assert_array_equal(got["pipe"][f],
                                              got["seq"][f] + 1.0)
            else:
                np.testing.assert_array_equal(got["pipe"][f],
                                              got["seq"][f], err_msg=f)
        np.testing.assert_array_equal(seq.pull_sparse(keys)["show"],
                                      rows["show"] + 2.0)
    finally:
        faults.uninstall()
        srv.shutdown()


def test_stream_kill_mid_window_bit_identical():
    """One stream severed mid-window (its ack dropped server-side, the
    connection dies with chunks in flight): the requeued chunks resend
    through the dedup window and the final table state is BIT-IDENTICAL
    to a fault-free single-stream run."""
    # fault-free single-stream baseline
    srv_a = _server(seed=0)
    try:
        base = PSClient(srv_a.addr, max_frame=1 << 13, streams=1, window=1)
        n = 600
        keys = np.arange(1, n + 1, dtype=np.uint64)
        rows = base.pull_sparse(keys, create=True)
        base.push_sparse_delta(keys, _delta_for(rows))
        want = srv_a.table.bulk_pull(keys)
    finally:
        srv_a.shutdown()

    srv_b = _server(seed=0)
    flags.set_flags({"ps_fault_injection": True})
    try:
        client = PSClient(srv_b.addr, max_frame=1 << 13, streams=4,
                          window=8, retries=5, retry_sleep=0.01)
        rows = client.pull_sparse(keys, create=True)
        assert len(client._chunk_counts(
            n, client._rows_bytes(rows) * 2)) >= 4
        # 2nd server ack after install vanishes -> that stream dies with
        # its window in flight; the acked-but-applied chunk must dedup
        faults.install(faults.FaultPlan(0).drop("send", role="server",
                                                at=(1,)))
        client.push_sparse_delta(keys, _delta_for(rows))
        faults.uninstall()
        got = srv_b.table.bulk_pull(keys)
    finally:
        faults.uninstall()
        srv_b.shutdown()

    assert set(want) == set(got)
    for f in want:
        np.testing.assert_array_equal(want[f], got[f], err_msg=f"field {f}")
    assert stat_get("ps.client.stream_reconnect") >= 1
    assert stat_get("ps.server.dedup_hit") >= 1


# -- quantized payloads ------------------------------------------------------

def test_wire_quant_roundtrip_tag():
    """Tag-7 frames: f16 and i8 encodings round-trip through the codec to
    the original dtype with the documented error bound; empty and 2-D
    arrays included; f64/int fields pass through exact."""
    rows = {"mf": np.linspace(-3, 3, 24, dtype=np.float32).reshape(8, 3),
            "show": np.array([0.0, 1.5, -2.25], np.float32),
            "empty": np.empty((0, 4), np.float32),
            "f64": np.array([2**40 + 0.5], np.float64),
            "ints": np.arange(5, dtype=np.int32)}
    for wd, atol in (("f16", 2e-3), ("i8", 0.03)):
        msg = {"cmd": "x", "rows": wire.quantize_rows(dict(rows), wd)}
        out = wire.decode(wire.encode(msg))
        for f in ("mf", "show", "empty"):
            assert out["rows"][f].dtype == np.float32
            assert out["rows"][f].shape == rows[f].shape
            np.testing.assert_allclose(out["rows"][f], rows[f], atol=atol)
        np.testing.assert_array_equal(out["rows"]["f64"], rows["f64"])
        np.testing.assert_array_equal(out["rows"]["ints"], rows["ints"])
    # f32 is an exact, counted passthrough
    msg = {"rows": wire.quantize_rows(dict(rows), "f32")}
    out = wire.decode(wire.encode(msg))
    np.testing.assert_array_equal(out["rows"]["mf"], rows["mf"])
    with pytest.raises(ValueError, match="wire dtype"):
        wire.quantize_rows(rows, "f8")


def _train_roundtrip(wire_dtype, seed=0):
    """pull(create) -> add a per-key delta -> push_delta -> final state."""
    srv = _server(seed=seed)
    try:
        client = PSClient(srv.addr, max_frame=1 << 13, streams=4,
                          window=8, wire_dtype=wire_dtype)
        keys = np.arange(1, 401, dtype=np.uint64)
        rows = client.pull_sparse(keys, create=True)
        d = {f: np.zeros_like(v) for f, v in rows.items()}
        d["show"] = (0.1 * np.arange(len(keys))).astype(np.float32)
        d["mf"] = np.tile(np.linspace(-1, 1, 4, dtype=np.float32),
                          (len(keys), 1)) * 0.1
        client.push_sparse_delta(keys, d)
        return srv.table.bulk_pull(keys)
    finally:
        srv.shutdown()


def test_quantization_f32_is_bit_deterministic():
    a = _train_roundtrip("f32")
    b = _train_roundtrip("f32")
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.parametrize("wd,tol", [("f16", 2e-3), ("i8", 1 / 120)])
def test_quantization_bounded_error(wd, tol):
    """Error is bounded RELATIVE to each field's magnitude: f16 by its
    2^-11 mantissa step, i8 by half the per-chunk-per-field scale
    (max|x|/127) — the delta is the only quantized contribution to the
    final state (the pulled base round-trips through the snapshot)."""
    want = _train_roundtrip("f32")
    got = _train_roundtrip(wd)
    assert set(want) == set(got)
    for f in want:
        atol = tol * (1.0 + float(np.max(np.abs(want[f]))))
        np.testing.assert_allclose(got[f], want[f], atol=atol,
                                   err_msg=f"field {f}")
    # the wire really narrowed: encoded bytes < raw bytes for the pushes
    assert 0 < stat_get("ps.wire.push_sparse_delta.quant_bytes") \
        < stat_get("ps.wire.push_sparse_delta.raw_bytes")


def test_quantized_pull_zero_delta_leaves_table_bits_unchanged():
    """The dequantized-snapshot contract: in delta mode the snapshot holds
    exactly what pull_sparse returned (already dequantized), so writing
    back UNCHANGED rows pushes a zero delta and the server's fp32 state
    stays bit-identical — a raw-vs-dequantized snapshot mismatch would
    drift it by the quantization error every pass."""
    srv = _server()
    try:
        exact = PSClient(srv.addr)
        keys = np.arange(1, 301, dtype=np.uint64)
        exact.pull_sparse(keys, create=True)      # persist the base
        before = srv.table.bulk_pull(keys)
        adapter = RemoteTableAdapter(
            PSClient(srv.addr, max_frame=1 << 13, streams=4,
                     wire_dtype="f16"),
            delta_mode=True)
        rows = adapter.bulk_pull(keys)
        adapter.bulk_write(keys, rows)            # zero training delta
        after = srv.table.bulk_pull(keys)
        for f in before:
            np.testing.assert_array_equal(before[f], after[f],
                                          err_msg=f"field {f}")
    finally:
        srv.shutdown()


# -- row-width estimate, snapshot cap, pool shape, counters --------------

class _CountingDict(dict):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.sets = 0

    def __setitem__(self, k, v):
        self.sets += 1
        super().__setitem__(k, v)


def test_pull_sparse_learns_row_width_once_per_call():
    """The estimate used to be re-read and re-written on EVERY
    chunk; now one read + one write per call and the chunk width is
    frozen after the first response (deterministic chunking)."""
    srv = _server()
    try:
        client = PSClient(srv.addr, max_frame=1 << 14, streams=1)
        client._row_bytes_est = _CountingDict()
        n = 2500
        keys = np.arange(1, n + 1, dtype=np.uint64)
        pulls = [0]
        real_pull = srv.table.bulk_pull

        def counting_pull(k):
            pulls[0] += 1
            return real_pull(k)

        srv.table.bulk_pull = counting_pull
        try:
            client.pull_sparse(keys, create=True)
        finally:
            srv.table.bulk_pull = real_pull
        assert client._row_bytes_est.sets == 1    # learned exactly once
        learned = client._row_bytes_est[DEFAULT_TABLE]
        per = client._per_chunk(learned)
        probe = min(client._per_chunk(512), 65536, n)
        want = 1 + len(client._chunk_spans(n - probe, per))
        assert pulls[0] == want                   # frozen width chunking
    finally:
        srv.shutdown()


def test_snap_cap_flag_and_override():
    srv = _server()
    try:
        client = PSClient(srv.addr)
        assert RemoteTableAdapter(client, delta_mode=True)._snap_cap == 4
        flags.set_flags({"ps_snap_cap": 9})
        try:
            assert RemoteTableAdapter(client,
                                      delta_mode=True)._snap_cap == 9
        finally:
            flags.set_flags({"ps_snap_cap": 4})
        assert RemoteTableAdapter(client, delta_mode=True,
                                  snap_cap=2)._snap_cap == 2
    finally:
        srv.shutdown()


def test_client_flags_default_pool_shape():
    flags.set_flags({"ps_streams": 2, "ps_window": 5,
                     "ps_wire_dtype": "f16"})
    try:
        c = PSClient(("127.0.0.1", 9))
        assert (c.streams, c.window, c.wire_dtype) == (2, 5, "f16")
    finally:
        flags.set_flags({"ps_streams": 4, "ps_window": 8,
                         "ps_wire_dtype": "f32"})
    with pytest.raises(ValueError, match="ps_wire_dtype"):
        PSClient(("127.0.0.1", 9), wire_dtype="f8")


def test_health_reports_pool():
    srv = _server()
    try:
        client = PSClient(srv.addr, streams=3, window=6)
        h = client.health()
        assert h["ok"] and h["pool_streams"] == 3
        assert h["pool_window"] == 6 and h["wire_dtype"] == "f32"
        assert 0 <= h["pool_connected"] <= 3
    finally:
        srv.shutdown()


def test_stat_max_tracks_high_water_mark():
    stat_max("hwm.test", 3.0)
    stat_max("hwm.test", 2.0)
    assert stat_get("hwm.test") == 3.0
    stat_max("hwm.test", 5.0)
    assert stat_get("hwm.test") == 5.0


def test_backoff_reset_restores_budget():
    bo = Backoff(base=0.01, cap=0.02, deadline=0.05)
    while bo.sleep(1):
        pass
    assert bo.remaining() <= 0
    bo.reset()
    assert bo.remaining() > 0.04                  # fresh episode budget


def test_pipeline_respects_window_under_concurrent_callers():
    """Two threads pipelining against one client: the pool arbitrates and
    both calls complete correctly (no deadlock, no cross-talk)."""
    srv = _server()
    try:
        client = PSClient(srv.addr, max_frame=1 << 14, streams=4, window=8)
        k1 = np.arange(1, 1501, dtype=np.uint64)
        k2 = np.arange(5001, 6501, dtype=np.uint64)
        client.pull_sparse(k1[:10], create=True)      # learn width
        out = {}

        def puller(name, keys):
            out[name] = client.pull_sparse(keys, create=True)

        ts = [threading.Thread(target=puller, args=("a", k1)),
              threading.Thread(target=puller, args=("b", k2))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert len(out["a"]["show"]) == len(k1)
        assert len(out["b"]["show"]) == len(k2)
    finally:
        srv.shutdown()
