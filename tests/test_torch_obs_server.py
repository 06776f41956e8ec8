"""The PyTorch port's in-process exporter and wedge doctor (the doctor
and exporter tests of test_flight_doctor.py, test_observability.py and
test_heat.py, run against ``paddlebox_tpu_torch``): postmortem bundles
(dump_state, SIGUSR1 round trip), the /metrics + /statz + /tracez +
/flightz + /debugz + /statz?raw=1 endpoints, bucket-wise percentile
merging across workers, non-finite sanitization, a concurrent
multi-client scrape stress, and /heatz over the port's heat sketches."""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.ps import heat
from paddlebox_tpu_torch.utils import doctor, flight, intervals, obs_server
from paddlebox_tpu_torch.utils import trace
from paddlebox_tpu_torch.utils.monitor import (Histogram, StatRegistry,
                                               stat_add, stat_get,
                                               stat_observe, stat_set,
                                               stat_snapshot)

MB4 = 4 * 1024 * 1024


@pytest.fixture(autouse=True)
def _clean():
    prev = {k: flags.get_flags(k)
            for k in ("obs_heat", "obs_heat_topk", "obs_heat_width",
                      "obs_heat_depth", "obs_heat_decay")}
    StatRegistry.instance().reset()
    flags.set_flags({"obs_flight_ring": 2048, "obs_postmortem_dir": ""})
    flight.reconfigure()
    intervals.clear()
    heat.disable()
    yield
    heat.disable()
    StatRegistry.instance().reset()
    flags.set_flags({"obs_flight_ring": 2048, "obs_postmortem_dir": ""})
    flags.set_flags(prev)
    flight.reconfigure()
    intervals.clear()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read().decode("utf-8")


def test_dump_state_names_threads_and_carries_flight_tail():
    park = threading.Event()
    t = threading.Thread(target=park.wait, name="park-me", daemon=True)
    t.start()
    try:
        flight.record("fault_injected", site="pull_sparse", action="drop")
        stat_add("ps.client.retry", 3.0)
        bundle = doctor.dump_state(reason="unit")
        assert bundle["reason"] == "unit"
        assert bundle["pid"] == os.getpid()
        names = [th["name"] for th in bundle["threads"]]
        assert names[0] == "MainThread"          # sorted first
        assert "park-me" in names
        parked = next(th for th in bundle["threads"]
                      if th["name"] == "park-me")
        assert any("wait" in fr for fr in parked["stack"])
        assert any(e["kind"] == "fault_injected" for e in bundle["flight"])
        assert bundle["stats"]["ps.client.retry"] == 3.0
        assert "workpool" in bundle
        json.dumps(bundle, default=str)          # JSON-able end to end
    finally:
        park.set()
        t.join(timeout=5)


def test_sigusr1_postmortem_round_trip(tmp_path):
    flags.set_flags({"obs_postmortem_dir": str(tmp_path)})
    assert doctor.install() is True
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)                         # handler runs on main
        files = [f for f in os.listdir(tmp_path)
                 if f.startswith("postmortem-")]
        assert len(files) == 1
        bundle = json.load(open(tmp_path / files[0]))
        assert bundle["reason"] == "sigusr1"
        assert any(th["name"] == "MainThread" for th in bundle["threads"])
        # the write itself is a flight event (self-describing ring)
        evs = flight.events(kind="postmortem_written")
        assert evs and evs[0]["path"].endswith(files[0])
    finally:
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)


def test_flightz_debugz_statz_raw_endpoints():
    flight.record("stream_reconnect", error="ConnectionError", requeued=2)
    flight.record("verb_retry", cmd="pull_sparse", attempt=1)
    for v in (0.01, 0.02):
        stat_observe("rt.lat_s", v)
    srv = obs_server.ObsServer(port=0)
    try:
        port = srv.addr[1]
        fl = json.loads(_get(port, "/flightz"))
        assert fl["enabled"] and fl["capacity"] == 2048
        assert fl["counts"]["verb_retry"] == 1
        assert fl["events"][0]["kind"] == "verb_retry"   # newest first
        only = json.loads(_get(port, "/flightz?kind=stream_reconnect&n=1"))
        assert [e["kind"] for e in only["events"]] == ["stream_reconnect"]
        dbg = json.loads(_get(port, "/debugz"))
        assert any(th["name"] == "MainThread" for th in dbg["threads"])
        assert dbg["stats"]["rt.lat_s.count"] == 2.0
        plain = json.loads(_get(port, "/statz"))
        assert obs_server.HIST_RAW_KEY not in plain
        raw = json.loads(_get(port, "/statz?raw=1"))
        hr = raw[obs_server.HIST_RAW_KEY]
        assert hr["rt.lat_s"]["count"] == 2
        assert sum(hr["rt.lat_s"]["b"].values()) == 2
        # 404 still names every path
        try:
            _get(port, "/nope")
            assert False, "404 expected"
        except urllib.error.HTTPError as e:
            body = e.read().decode()
            for p in ("/flightz", "/debugz", "/statz"):
                assert p in body
    finally:
        srv.shutdown()


def test_concurrent_multi_client_scrape_stress():
    """8 clients hammer all four endpoints while live traffic mutates
    the registry and the flight ring: every response must be complete
    and parseable (ThreadingHTTPServer + short-critical-section locks)."""
    srv = obs_server.ObsServer(port=0)
    stop = threading.Event()
    errors = []

    def produce():
        i = 0
        while not stop.is_set():
            i += 1
            stat_add("stress.counter")
            stat_observe("stress.lat_s", 0.001 * (i % 7 + 1))
            flight.record("verb_retry", cmd="pull_sparse", attempt=i % 5)
            intervals.record("pack", i * 0.01, i * 0.01 + 0.005)

    def scrape(cid):
        try:
            port = srv.addr[1]
            for _ in range(6):
                assert "pbox_stress_counter" in _get(port, "/metrics")
                s = json.loads(_get(port, "/statz?raw=1"))
                assert s["stress.counter"] >= 1
                f = json.loads(_get(port, "/flightz?n=64"))
                assert f["enabled"]
                d = json.loads(_get(port, "/debugz"))
                assert d["threads"]
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append((cid, repr(e)))

    producers = [threading.Thread(target=produce, daemon=True)
                 for _ in range(2)]
    clients = [threading.Thread(target=scrape, args=(i,), daemon=True)
               for i in range(8)]
    try:
        for t in producers + clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
    finally:
        stop.set()
        for t in producers:
            t.join(timeout=5)
        srv.shutdown()
    assert not errors, errors


def test_merge_snapshots_bucketwise_is_exact():
    rng = np.random.default_rng(7)
    va = rng.lognormal(mean=-6.0, sigma=1.2, size=4000)
    vb = rng.lognormal(mean=-4.0, sigma=0.8, size=1000)  # skewed worker
    for v in va:
        stat_observe("m.lat_s", v)
    snap_a = json.loads(obs_server.render_statz(raw=True))
    StatRegistry.instance().reset()
    for v in vb:
        stat_observe("m.lat_s", v)
    snap_b = json.loads(obs_server.render_statz(raw=True))

    merged = obs_server.merge_snapshots([snap_a, snap_b])
    ref = Histogram()
    for v in np.concatenate([va, vb]):
        ref.observe(v)
    for q in (50, 95, 99):
        assert merged[f"m.lat_s.p{q}"] == pytest.approx(ref.percentile(q))
    assert merged["m.lat_s.count"] == 5000.0
    assert merged["m.lat_s.max"] == pytest.approx(max(va.max(), vb.max()))
    assert obs_server.HIST_RAW_KEY not in merged
    # max-of-medians would have been wrong: worker B's median dominates
    naive = max(snap_a["m.lat_s.p50"], snap_b["m.lat_s.p50"])
    assert merged["m.lat_s.p50"] < naive


def test_merge_snapshots_raw_less_worker_falls_back_to_max():
    for v in (0.01, 0.02, 0.03):
        stat_observe("m.lat_s", v)
    snap_a = json.loads(obs_server.render_statz(raw=True))
    legacy = {"m.lat_s.p99": 9.0, "m.lat_s.count": 3.0,
              "m.lat_s.max": 9.0}                 # predates raw export
    merged = obs_server.merge_snapshots([snap_a, legacy])
    assert merged["m.lat_s.p99"] == 9.0           # never understate tails
    assert merged["m.lat_s.count"] == 6.0


def test_non_finite_values_sanitized():
    h = Histogram()
    h.observe(float("nan"))
    h.observe(float("inf"))
    assert h.count == 0                           # dropped at observe()
    stat_observe("x.lat_s", float("nan"))
    assert stat_get("obs.non_finite_dropped") == 1.0
    assert "x.lat_s.count" not in stat_snapshot("x.")
    stat_set("g.bad", float("inf"))
    stat_set("g.good", 1.5)
    statz = json.loads(obs_server.render_statz())
    assert "g.bad" not in statz                   # invalid JSON otherwise
    assert statz["g.good"] == 1.5
    prom = obs_server.render_prometheus()
    assert "pbox_g_bad +Inf" in prom              # exposition spelling
    json.loads(obs_server.render_statz(raw=True))  # stays strict JSON


def test_metrics_statz_tracez_roundtrip():
    stat_add("rt.counter", 3.0)
    for v in (0.01, 0.02, 0.03, 0.04):
        stat_observe("rt.lat_s", v)
    tr = trace.enable()
    with trace.span("rt.span"):
        pass
    srv = obs_server.ObsServer(port=0)
    try:
        port = srv.addr[1]
        metrics = _get(port, "/metrics")
        assert "# TYPE pbox_rt_counter gauge" in metrics
        assert "pbox_rt_counter 3.0" in metrics
        assert "# TYPE pbox_rt_lat_s summary" in metrics
        assert 'pbox_rt_lat_s{quantile="0.99"}' in metrics
        assert "pbox_rt_lat_s_count 4" in metrics
        statz = json.loads(_get(port, "/statz"))
        assert statz["rt.counter"] == 3.0
        assert statz["rt.lat_s.count"] == 4.0
        assert statz["rt.lat_s.max"] == 0.04
        tracez = json.loads(_get(port, "/tracez"))
        assert tracez["enabled"]
        assert any(s["name"] == "rt.span" for s in tracez["spans"])
        # unknown path → 404, server survives
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nope")
        assert json.loads(_get(port, "/statz"))["rt.counter"] == 3.0
    finally:
        srv.shutdown()
        assert tr is trace.ACTIVE or trace.ACTIVE is None


def test_merge_snapshots_sums_counters_maxes_quantiles():
    a = {"ps.client.retry": 2.0, "ps.x.latency_s.p99": 0.5,
         "ps.client.inflight_hwm": 3.0}
    b = {"ps.client.retry": 1.0, "ps.x.latency_s.p99": 0.9,
         "ps.client.inflight_hwm": 8.0}
    m = obs_server.merge_snapshots([a, b])
    assert m["ps.client.retry"] == 3.0              # summed
    assert m["ps.x.latency_s.p99"] == 0.9           # worst worker
    assert m["ps.client.inflight_hwm"] == 8.0       # hwm


def _zipf_stream(n=200_000, a=1.3, cap=100_000, seed=7):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(a, size=n), cap).astype(np.uint64)


def _exact_counts(stream):
    uniq, counts = np.unique(stream, return_counts=True)
    return dict(zip(uniq.tolist(), counts.astype(float).tolist()))


def _exact_topn(stream, n=100):
    exact = _exact_counts(stream)
    return {k for k, _ in sorted(exact.items(),
                                 key=lambda kv: -kv[1])[:n]}


def test_heatz_round_trip_zipf_recall_and_budget():
    """The acceptance bar verbatim: on a zipf-1.3 run /heatz reports
    top-100 recall >= 0.9 vs exact with <= 4 MB sketch memory."""
    flags.set_flags({"obs_heat": True})
    hm = heat.enable()
    stream = _zipf_stream()
    for chunk in np.array_split(stream, 20):
        hm.observe("pull", chunk)
    srv = obs_server.ObsServer(port=0)
    try:
        body = json.loads(_get(srv.addr[1], "/heatz"))
        assert body["enabled"] is True
        pull = body["sites"]["pull"]
        got = {int(e["key"]) for e in pull["top"]}
        assert len(got & _exact_topn(stream, 100)) / 100 >= 0.9
        assert body["sketch_bytes"] <= MB4
        assert pull["zipf_exponent"] == pytest.approx(1.3, abs=0.2)
        assert pull["share_curve"][-1]["share"] <= 1.0
        assert all(e["est_rate_hz"] > 0 for e in pull["top"])
        small = json.loads(_get(srv.addr[1], "/heatz?topn=5"))
        assert len(small["sites"]["pull"]["top"]) == 5
        # raw statz carries the mergeable export for the supervisor
        snap = json.loads(_get(srv.addr[1], "/statz?raw=1"))
        assert "pull" in snap[obs_server.HEAT_RAW_KEY]["sites"]
    finally:
        srv.shutdown()


def test_heatz_disabled_when_heat_off():
    srv = obs_server.ObsServer(port=0)
    try:
        assert json.loads(_get(srv.addr[1], "/heatz")) == \
            {"enabled": False}
    finally:
        srv.shutdown()
