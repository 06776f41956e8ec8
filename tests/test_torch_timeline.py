"""The PyTorch port's telemetry timeline + SLO watchdog (counterpart of
test_timeline.py, run against ``paddlebox_tpu_torch``): ring wrap and
rate derivation vs hand-computed deltas (counter reset included), breach
→ ``slo_breach`` flight-event round-trip with per-rule latching, the
serving rule set, the /timelinez + /clusterz endpoints and ?prefix=
scrape filters, quality monitor gauges and postmortem timeline tails,
and the launcher's ClusterScraper behind /clusterz (its merged fold and
a worker killed mid-scrape).  The pboxlint rule is not part of the
port."""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.launch import ClusterScraper
from paddlebox_tpu_torch.metrics import quality
from paddlebox_tpu_torch.utils import flight, obs_server, timeline
from paddlebox_tpu_torch.utils.monitor import (StatRegistry, stat_add,
                                               stat_get, stat_observe,
                                               stat_set, stat_snapshot)


@pytest.fixture(autouse=True)
def _clean():
    StatRegistry.instance().reset()
    quality.reset()
    fr = flight.ring()
    if fr is not None:
        fr.clear()
    yield
    timeline.stop()
    obs_server.set_clusterz_provider(None)
    quality.reset()
    fr = flight.ring()
    if fr is not None:
        fr.clear()
    flags.set_flags({"obs_timeline_interval_s": 0.0,
                     "obs_timeline_ring": 512,
                     "obs_slo_watchdog": True,
                     "obs_slo_auc_drop": 0.05})


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read().decode("utf-8")


def test_ring_rates_match_hand_computed_deltas_across_reset():
    ring = timeline.TimelineRing(16)
    # (mono, counter value): steady growth, then a worker restart drops
    # the counter to 4 — the interval's growth is the NEW value, never a
    # negative rate
    ring.append({"c.ops": 100.0}, mono=10.0, t=1000.0)
    ring.append({"c.ops": 110.0}, mono=12.0, t=1002.0)   # d=10 dt=2 → 5.0
    ring.append({"c.ops": 111.0}, mono=13.0, t=1003.0)   # d=1  dt=1 → 1.0
    ring.append({"c.ops": 4.0}, mono=15.0, t=1005.0)     # reset: 4/2 → 2.0
    s = ring.series("c.ops")
    assert s["points"] == [[1000.0, 100.0], [1002.0, 110.0],
                           [1003.0, 111.0], [1005.0, 4.0]]
    assert s["rates"] == [[1002.0, 5.0], [1003.0, 1.0], [1005.0, 2.0]]
    # first sample has no predecessor → no rate entry
    assert len(s["rates"]) == len(s["points"]) - 1


def test_ring_gauge_keys_carry_values_but_never_rates():
    ring = timeline.TimelineRing(8)
    snap = {"ps.client.inflight_hwm": 3.0, "x.lat_s.p99": 0.5,
            "ps.cache.hit_rate": 0.9, "quality.auc": 0.7, "c.n": 1.0}
    ring.append(dict(snap), mono=1.0)
    ring.append(dict(snap), mono=2.0)
    last = ring.samples()[-1]
    assert set(last["rates"]) == {"c.n"}       # counters only
    assert ring.series("quality.auc")["points"][-1][1] == 0.7
    assert ring.series("quality.auc")["rates"] == []


def test_ring_wrap_keeps_newest_and_rates_stay_correct():
    ring = timeline.TimelineRing(4)
    for i in range(10):
        ring.append({"c.n": float(10 * i)}, mono=float(i), t=float(i))
    assert len(ring) == 4
    s = ring.samples()
    assert [x["seq"] for x in s] == [7, 8, 9, 10]       # newest-4 kept
    assert [p[1] for p in ring.series("c.n")["points"]] == \
        [60.0, 70.0, 80.0, 90.0]
    # rate derivation uses _prev, not the ring, so wrap never skews it
    assert all(r[1] == 10.0 for r in ring.series("c.n")["rates"])
    assert ring.names() == ["c.n"]
    ring.clear()
    assert len(ring) == 0


def test_tail_is_compact_top_movers():
    ring = timeline.TimelineRing(8)
    many = {f"k.{i:02d}": float(i) for i in range(40)}
    ring.append(dict(many), mono=1.0)
    many2 = {k: v + i for i, (k, v) in enumerate(sorted(many.items()))}
    ring.append(many2, mono=2.0)
    tail = ring.tail(n=5, rate_top=3, stat_top=3)
    assert len(tail) == 2
    assert len(tail[-1]["stats"]) == 3          # top movers only
    assert len(tail[-1]["rates"]) == 3
    # the largest stats won
    assert "k.39" in tail[-1]["stats"]


def _hit_rule(min_samples=3):
    return timeline.SloRule(
        "cache_hit_collapse", "ps.cache.hit_rate", kind="gauge", op="lt",
        threshold=0.10, window_s=30.0, min_samples=min_samples,
        reason="hit rate collapsed")


def test_breach_emits_exactly_one_latched_flight_event_then_clears():
    ring = timeline.TimelineRing(64)
    wd = timeline.SloWatchdog([_hit_rule()])
    for i in range(3):                                  # healthy
        ring.append({"ps.cache.hit_rate": 0.9}, mono=100.0 + i)
    assert wd.evaluate(ring, now_mono=102.0) == []
    # collapse, far enough that healthy samples aged out of the window
    for i in range(3):
        ring.append({"ps.cache.hit_rate": 0.02}, mono=200.0 + i)
    trans = wd.evaluate(ring, now_mono=202.0)
    assert [t["rule"] for t in trans] == ["cache_hit_collapse"]
    assert trans[0]["breached"] is True
    # still breached on the next samples: LATCHED — no event storm
    for i in range(3, 8):
        ring.append({"ps.cache.hit_rate": 0.02}, mono=200.0 + i)
        assert wd.evaluate(ring, now_mono=200.0 + i) == []
    breaches = flight.events(kind="slo_breach")
    assert len(breaches) == 1
    assert breaches[0]["rule"] == "cache_hit_collapse"
    assert breaches[0]["metric"] == "ps.cache.hit_rate"
    assert stat_get("obs.slo.breach") == 1.0
    assert wd.states() == {"cache_hit_collapse": True}
    # recovery → one slo_clear, counter stays at one breach
    for i in range(3):
        ring.append({"ps.cache.hit_rate": 0.95}, mono=300.0 + i)
    trans = wd.evaluate(ring, now_mono=302.0)
    assert trans and trans[0]["breached"] is False
    assert len(flight.events(kind="slo_clear")) == 1
    assert len(flight.events(kind="slo_breach")) == 1
    assert stat_get("obs.slo.active") == 0.0


def test_one_bad_scrape_never_pages():
    """min_samples + the sustained-all-window predicate: a single bad
    sample (or a window with a healthy one mixed in) is not a breach."""
    ring = timeline.TimelineRing(64)
    wd = timeline.SloWatchdog([_hit_rule(min_samples=3)])
    ring.append({"ps.cache.hit_rate": 0.01}, mono=100.0)
    assert wd.evaluate(ring, now_mono=100.0) == []      # 1 < min_samples
    ring.append({"ps.cache.hit_rate": 0.01}, mono=101.0)
    ring.append({"ps.cache.hit_rate": 0.90}, mono=102.0)  # one healthy
    assert wd.evaluate(ring, now_mono=102.0) == []      # not sustained
    assert flight.events(kind="slo_breach") == []


def test_auc_drop_rule_via_quality_gauges():
    ring = timeline.TimelineRing(64)
    rule = timeline.SloRule("auc_drop", "quality.auc", kind="drop",
                            threshold=0.05, window_s=600.0, min_samples=2)
    wd = timeline.SloWatchdog([rule])
    ring.append({"quality.auc": 0.75}, mono=10.0)
    ring.append({"quality.auc": 0.74}, mono=20.0)
    assert wd.evaluate(ring, now_mono=20.0) == []       # within epsilon
    ring.append({"quality.auc": 0.62}, mono=30.0)       # 0.13 drop
    trans = wd.evaluate(ring, now_mono=30.0)
    assert trans and trans[0]["rule"] == "auc_drop"


def test_throughput_stall_rate_rule():
    ring = timeline.TimelineRing(64)
    rule = timeline.SloRule("stall", "trainer.step_dispatch_s.count",
                            kind="rate", op="lt", threshold=1e-9,
                            window_s=60.0, min_samples=3)
    wd = timeline.SloWatchdog([rule])
    for i in range(5):                                   # flat counter
        ring.append({"trainer.step_dispatch_s.count": 40.0},
                    mono=100.0 + i)
    trans = wd.evaluate(ring, now_mono=104.0)
    assert trans and trans[0]["rule"] == "stall"


def test_default_rules_reference_only_emitted_metrics():
    """The shipped rule set parses, and PB207 (which cross-checks every
    literal against real emission sites) holds the invariant statically;
    here just pin the metric names we promise to watch."""
    rules = {r.name: r.metric for r in timeline.default_rules()}
    assert rules == {
        "cache_hit_collapse": "ps.cache.hit_rate",
        "queue_saturation": "ps.pool.table.queue_depth_hwm",
        "throughput_stall": "trainer.step_dispatch_s.count",
        "auc_drop": "quality.auc",
        "heat_shard_imbalance": "heat.shard_imbalance",
    }


def test_sampler_thread_samples_and_stops():
    import time as _time
    s = timeline.start(interval_s=0.01, cap=32)
    deadline = _time.monotonic() + 5.0
    while len(s.ring) < 3 and _time.monotonic() < deadline:
        _time.sleep(0.01)
    assert len(s.ring) >= 3
    assert s.running
    timeline.stop()
    assert timeline.sampler() is None
    assert not s.running
    assert stat_get("obs.timeline.samples") >= 3.0


def test_maybe_start_from_flags_off_by_default():
    assert timeline.maybe_start_from_flags() is None
    flags.set_flags({"obs_timeline_interval_s": 60.0})
    s = timeline.maybe_start_from_flags()
    assert s is not None and s.interval_s == 60.0
    timeline.stop()


def test_timelinez_endpoint_roundtrip():
    srv = obs_server.ObsServer(port=0)
    try:
        port = srv.addr[1]
        # sampler off → disabled index, empty series
        idx = json.loads(_get(port, "/timelinez"))
        assert idx["enabled"] is False and idx["len"] == 0
        s = timeline.start(interval_s=600.0, cap=32)    # driven by hand
        stat_add("tz.counter", 7.0)
        s.sample_once()
        stat_add("tz.counter", 3.0)
        s.sample_once()
        idx = json.loads(_get(port, "/timelinez"))
        assert idx["enabled"] is True and idx["len"] == 2
        assert "tz.counter" in idx["names"]
        assert "slo" in idx
        ser = json.loads(_get(port, "/timelinez?name=tz.counter&n=8"))
        assert [p[1] for p in ser["points"]] == [7.0, 10.0]
        assert len(ser["rates"]) == 1
    finally:
        srv.shutdown()


def test_statz_and_metrics_prefix_filter():
    stat_add("pa.x", 1.0)
    stat_add("pb.y", 2.0)
    stat_observe("pa.lat_s", 0.01)
    srv = obs_server.ObsServer(port=0)
    try:
        port = srv.addr[1]
        z = json.loads(_get(port, "/statz?prefix=pa"))
        assert z["pa.x"] == 1.0 and z["pa.lat_s.count"] == 1.0
        assert not [k for k in z if k.startswith("pb.")]
        raw = json.loads(_get(port, "/statz?raw=1&prefix=pa"))
        assert "pa.lat_s" in raw[obs_server.HIST_RAW_KEY]
        m = _get(port, "/metrics?prefix=pa")
        assert "pbox_pa_x 1.0" in m and "pbox_pb_y" not in m
        # unfiltered still serves everything
        assert json.loads(_get(port, "/statz"))["pb.y"] == 2.0
    finally:
        srv.shutdown()


def test_postmortem_bundle_embeds_timeline_tail():
    from paddlebox_tpu_torch.utils import doctor
    s = timeline.start(interval_s=600.0, cap=32)
    stat_add("pm.ops", 5.0)
    s.sample_once()
    stat_add("pm.ops", 5.0)
    s.sample_once()
    bundle = doctor.dump_state(reason="test")
    tl = bundle["timeline"]
    assert tl["interval_s"] == 600.0
    assert isinstance(tl["slo"], dict)
    assert len(tl["tail"]) == 2
    assert tl["tail"][-1]["stats"].get("pm.ops") == 10.0


def _pass_metrics(auc, pos_shift=0):
    pos = np.zeros(50)
    neg = np.zeros(50)
    pos[30 + pos_shift: 40 + pos_shift] = 10.0
    neg[10: 20] = 10.0
    return {"auc": auc, "size": 200.0, "predicted_ctr": 0.11,
            "actual_ctr": 0.10,
            "auc_buckets": {"pos": pos.tolist(), "neg": neg.tolist()}}


def test_quality_monitor_gauges_and_day_psi():
    qm = quality.QualityMonitor(window=4)
    out = qm.observe_pass(_pass_metrics(0.70))
    assert out["quality.auc"] == 0.70
    assert out["quality.auc_drop"] == 0.0
    assert out["quality.auc_window"] == pytest.approx(1.0)  # separable
    assert out["quality.calibration_drift"] == pytest.approx(0.1)
    assert "quality.psi.prediction" not in out          # needs 2 passes
    out2 = qm.observe_pass(_pass_metrics(0.60))
    assert out2["quality.auc_drop"] == pytest.approx(0.10)
    assert out2["quality.psi.prediction"] == 0.0        # same distribution
    out3 = qm.observe_pass(_pass_metrics(0.60, pos_shift=8))
    assert out3["quality.psi.prediction"] > 0.2         # shifted
    # gauges landed in the registry for the timeline/watchdog to read
    snap = stat_snapshot("quality.")
    assert snap["quality.auc"] == 0.60
    assert snap["quality.passes"] == 3.0
    # day rollover: first day has no predecessor, second day does
    assert qm.end_day("d1") == {}
    qm.observe_pass(_pass_metrics(0.61))
    out_day = qm.end_day("d2")
    assert out_day["quality.psi.day"] >= 0.0
    # None / auc-less metrics are ignored (resume-cursor skipped passes)
    assert qm.observe_pass(None) == {}
    assert qm.observe_pass({"loss": 1.0}) == {}


def test_windowed_auc_union_not_mean():
    """A tiny pass with a terrible AUC must not drag the window the way
    a mean of per-pass AUCs would — the union statistic weights by
    instances."""
    big_sep = _pass_metrics(0.9)                        # 200 instances
    pos = np.zeros(50)
    neg = np.zeros(50)
    pos[10:12] = 1.0                                    # 4 instances,
    neg[30:32] = 1.0                                    # inverted ranks
    tiny_bad = {"pos": pos.tolist(), "neg": neg.tolist()}
    w = quality.windowed_auc([big_sep["auc_buckets"], tiny_bad])
    assert w > 0.9
    assert quality.windowed_auc([]) == -0.5             # sentinel
    # single-class union → sentinel too
    only_pos = {"pos": pos.tolist(), "neg": (pos * 0).tolist()}
    assert quality.windowed_auc([only_pos]) == -0.5


def test_psi_properties():
    assert quality.psi([1, 2, 3], [1, 2, 3]) == 0.0
    assert quality.psi([10, 0, 0], [0, 0, 10]) > 1.0    # gross shift
    assert quality.psi([], []) == 0.0                   # degenerate
    assert quality.calibration_drift(0.2, 0.0) == 0.0   # no positives


def test_serving_rules_page_on_tenant_p99_and_sustained_shed():
    """The serving entry point's rule set (one p99 and one shed-rate
    rule a tenant): a tenant whose p99 stays over
    ``FLAGS_obs_slo_serving_p99_ms`` breaches, its neighbour does not,
    and sustained shedding breaches the shed rule."""
    flags.set_flags({"obs_slo_serving_p99_ms": 100.0})
    rules = timeline.serving_rules(["ads", "feed"])
    assert [r.name for r in rules] == ["serving_ads_p99", "serving_ads_shed",
                                       "serving_feed_p99",
                                       "serving_feed_shed"]
    ring = timeline.TimelineRing(64)
    wd = timeline.SloWatchdog(rules)
    for i in range(4):
        ring.append({"serving.ads.latency_s.p99": 0.25,
                     "serving.feed.latency_s.p99": 0.01,
                     "serving.feed.shed": 10.0 * i}, mono=100.0 + i)
    trans = wd.evaluate(ring, now_mono=103.0)
    assert {t["rule"] for t in trans} == {"serving_ads_p99",
                                          "serving_feed_shed"}
    assert all(t["breached"] for t in trans)
    assert wd.states()["serving_feed_p99"] is False


def test_cluster_scraper_merged_equals_per_worker_sums():
    """Stubbed per-worker snapshots with DISTINCT values: the merged
    timeline must carry their sum (counters) and worst (quantiles)."""
    scraper = ClusterScraper([7001, 7002, 7003], interval_s=600.0)
    snaps = {7001: {"w.ops": 10.0, "w.lat_s.p99": 0.2},
             7002: {"w.ops": 4.0, "w.lat_s.p99": 0.9},
             7003: {"w.ops": 1.0, "w.lat_s.p99": 0.1}}
    real = scraper._obs
    scraper._obs = types.SimpleNamespace(
        scrape=lambda port, **kw: dict(snaps[port]),
        merge_snapshots=real.merge_snapshots,
        set_clusterz_provider=real.set_clusterz_provider)
    assert scraper.scrape_once() == 3
    latest = scraper.ring.samples()[-1]["stats"]
    assert latest["w.ops"] == 15.0                      # summed
    assert latest["w.lat_s.p99"] == 0.9                 # worst worker
    idx = scraper.render()
    assert idx["workers"] == {"7001": True, "7002": True, "7003": True}
    assert idx["latest"]["w.ops"] == 15.0


def test_cluster_scraper_survives_mid_scrape_worker_kill():
    """Chaos: worker 2's obs server is shut down while the scrape round
    is in flight — the round folds whoever answered, marks the corpse
    dead, and the merged series carries on (with a counter 'reset'
    handled as restart-from-zero when it comes back smaller)."""
    stat_add("cl.ops", 6.0)
    srv1, srv2 = obs_server.ObsServer(port=0), obs_server.ObsServer(port=0)
    p1, p2 = srv1.addr[1], srv2.addr[1]
    try:
        scraper = ClusterScraper([p1, p2], interval_s=600.0)
        assert scraper.scrape_once() == 2
        # both workers serve the same process registry → merged = 2x
        assert scraper.ring.samples()[-1]["stats"]["cl.ops"] == 12.0
        # kill worker 2 in the MIDDLE of the next round: after worker 1
        # answered, before worker 2 is polled
        real = scraper._obs

        def killing_scrape(port, **kw):
            if port == p2:
                srv2.shutdown()
            return real.scrape(port, **kw)

        scraper._obs = types.SimpleNamespace(
            scrape=killing_scrape,
            merge_snapshots=real.merge_snapshots,
            set_clusterz_provider=real.set_clusterz_provider)
        assert scraper.scrape_once() == 1               # survived
        assert scraper.ring.samples()[-1]["stats"]["cl.ops"] == 6.0
        idx = scraper.render()
        assert idx["workers"] == {str(p1): True, str(p2): False}
        # the fold dropping a worker halves the counter: rate derivation
        # treats it as a reset, never a negative rate
        rates = scraper.ring.samples()[-1]["rates"]
        assert rates["cl.ops"] >= 0.0
    finally:
        srv1.shutdown()
        srv2.shutdown()


def test_clusterz_endpoint_provider_registration():
    """/clusterz serves the registered provider — the launcher's
    ClusterScraper over this process's own exporter here — and falls
    back to disabled when it is unregistered."""
    stat_add("cz.n", 2.0)
    srv = obs_server.ObsServer(port=0)
    try:
        port = srv.addr[1]
        assert json.loads(_get(port, "/clusterz")) == {"enabled": False}
        scraper = ClusterScraper([srv.addr[1]], interval_s=600.0)
        obs_server.set_clusterz_provider(scraper.render)
        scraper.scrape_once()
        idx = json.loads(_get(port, "/clusterz"))
        assert idx["enabled"] is True and "cz.n" in idx["names"]
        assert idx["workers"] == {str(port): True}
        ser = json.loads(_get(port, "/clusterz?name=cz.n&n=4"))
        assert ser["points"][-1][1] == 2.0
        obs_server.set_clusterz_provider(None)
        assert json.loads(_get(port, "/clusterz")) == {"enabled": False}
    finally:
        srv.shutdown()
