"""Key-space heat of the PyTorch port (utils/sketch.py, ps/heat.py) against
the JAX package's copies, and heat on = heat off on the port's day loop.

Counterparts of the sketch and HeatMap units of tests/test_heat.py: each
runs the port's module and the JAX package's on the same seeded Zipf-1.3
stream and must give equal results (count-min tables, heavy hitters, HLL
registers, shard loads, gauges, summaries, renders), besides the JAX
tests' own accuracy bounds.  Then heat on = heat off bitwise on the
port's 2-day × 3-pass loop (losses, every table key × every field, dense
weights), serial and prefetched, with the device cache off and on, while
the taps really fed the sketches.  The /heatz, cluster-scraper,
PS-health and serving-health tests wait for the ported HTTP views, PS
service and serving tiers.
"""

import numpy as np
import pytest

from paddlebox_tpu.ps import heat as jheat
from paddlebox_tpu.utils import sketch as jsketch
from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.ps import heat
from paddlebox_tpu_torch.utils import flight, sketch
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get

import torch_day_loop as dc

MB4 = 4 * 1024 * 1024
SIZES = dict(width=2048, depth=4, topk=512)


@pytest.fixture(autouse=True)
def _clean():
    prev = {k: flags.get_flags(k)
            for k in ("obs_heat", "ps_device_cache", "ps_device_cache_rows")}
    StatRegistry.instance().reset()
    heat.disable()
    fr = flight.ring()
    if fr is not None:
        fr.clear()
    yield
    heat.disable()
    flags.set_flags(prev)


def zipf_stream(n=200_000, a=1.3, cap=100_000, seed=7):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(a, size=n), cap).astype(np.uint64)


def exact_counts(stream):
    uniq, counts = np.unique(stream, return_counts=True)
    return dict(zip(uniq.tolist(), counts.astype(float).tolist()))


def exact_topn(stream, n=100):
    exact = exact_counts(stream)
    return {k for k, _ in sorted(exact.items(), key=lambda kv: -kv[1])[:n]}


def same_raw(a, b):
    """Two raw() exports (nested dicts / lists / arrays) hold the same
    values."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same_raw(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not (
            a and isinstance(a[0], (int, float))):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_raw(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# Sketches: the port's equal the JAX package's, within the JAX bounds.
# ---------------------------------------------------------------------------

def test_countmin_matches_jax_and_honors_bound():
    stream = zipf_stream()
    cms = sketch.CountMinSketch(), jsketch.CountMinSketch()
    for chunk in np.array_split(stream, 16):
        for cm, sk in zip(cms, (sketch, jsketch)):
            cm.update(*sk.unique_with_counts(chunk))
    same_raw(cms[0].raw(), cms[1].raw())
    exact = exact_counts(stream)
    keys = np.fromiter(exact, np.uint64)
    est = cms[0].estimate(keys)
    np.testing.assert_array_equal(est, cms[1].estimate(keys))
    over = est - np.array([exact[int(k)] for k in keys])
    assert (over >= -1e-9).all(), "count-min undercounted"
    assert over.max() <= cms[0].epsilon() * len(stream)
    assert cms[0].total == pytest.approx(len(stream))


def test_spacesaving_matches_jax_recall_and_error_bound():
    stream = zipf_stream()
    sss = sketch.SpaceSaving(k=512), jsketch.SpaceSaving(k=512)
    for chunk in np.array_split(stream, 16):
        for ss, sk in zip(sss, (sketch, jsketch)):
            ss.update(*sk.unique_with_counts(chunk))
    top = sss[0].top(100)
    assert top == sss[1].top(100)
    same_raw(sss[0].raw(), sss[1].raw())
    got = {k for k, _, _ in top}
    assert len(got & exact_topn(stream, 100)) / 100 >= 0.9
    exact = exact_counts(stream)
    for key, est, err in top:
        assert est + 1e-9 >= exact.get(key, 0.0) >= est - err - 1e-9
        assert err <= len(stream) / 512 + 1e-9
    assert sss[0].topk_share(100) == sss[1].topk_share(100)


def test_hll_matches_jax_within_error_band():
    stream = zipf_stream()
    hlls = sketch.HyperLogLog(), jsketch.HyperLogLog()
    for chunk in np.array_split(stream, 16):
        for hll in hlls:
            hll.update(np.unique(chunk))
    assert hlls[0].raw() == hlls[1].raw()
    exact = len(exact_counts(stream))
    assert hlls[0].estimate() == hlls[1].estimate()
    assert abs(hlls[0].estimate() - exact) / exact <= 0.05


def test_zipf_fit_and_shardload_match_jax():
    stream = zipf_stream()
    counts = sorted(exact_counts(stream).values(), reverse=True)[:200]
    fit = sketch.fit_zipf_exponent(counts)
    assert fit == jsketch.fit_zipf_exponent(counts)
    assert fit == pytest.approx(1.3, abs=0.2)
    loads = sketch.ShardLoad(), jsketch.ShardLoad()
    for sl in loads:
        for s in range(4):
            sl.add(s, 100.0)
        assert sl.imbalance() == pytest.approx(1.0)
        sl.add(0, 300.0)
    assert loads[0].imbalance() == loads[1].imbalance() \
        == pytest.approx(400.0 / 175.0)
    assert loads[0].shares() == loads[1].shares()
    assert sketch.ShardLoad().imbalance() == 0.0


def test_merge_matches_jax_and_is_associative():
    stream = zipf_stream()
    parts = np.array_split(stream, 3)
    keys = np.fromiter(exact_counts(stream), np.uint64)
    for sk in (sketch, jsketch):
        def cm_of(part, sk=sk):
            c = sk.CountMinSketch()
            c.update(*sk.unique_with_counts(part))
            return c
        full = cm_of(stream)
        ab_c = cm_of(parts[0])
        ab_c.merge(cm_of(parts[1]))
        ab_c.merge(cm_of(parts[2]))
        np.testing.assert_allclose(ab_c.estimate(keys), full.estimate(keys))
    merged = []
    for sk in (sketch, jsketch):
        sss = []
        for p in parts:
            s = sk.SpaceSaving(k=512)
            s.update(*sk.unique_with_counts(p))
            sss.append(s)
        merged.append(sk.SpaceSaving.from_raw([s.raw() for s in sss]))
    assert merged[0].top(100) == merged[1].top(100)
    got = {k for k, _, _ in merged[0].top(100)}
    assert len(got & exact_topn(stream, 100)) / 100 >= 0.9


def test_merge_heat_raw_gauges_match_jax():
    gauges = []
    for hm_cls, sk in ((heat.HeatMap, sketch), (jheat.HeatMap, jsketch)):
        hm1, hm2 = hm_cls(**SIZES), hm_cls(**SIZES)
        hm1.observe("pull", np.arange(0, 3000, dtype=np.uint64))
        hm2.observe("pull", np.arange(50_000, 53_000, dtype=np.uint64))
        hm1.observe_shard(0, 100)
        hm1.observe_shard(1, 100)
        hm2.observe_shard(0, 700)
        hm2.observe_shard(1, 100)
        raw1, raw2 = hm1.raw(), hm2.raw()
        g = sk.heat_gauges_from_raw(sk.merge_heat_raw([raw1, raw2]))
        solo = max(sk.heat_gauges_from_raw(raw1)["heat.working_set_rows"],
                   sk.heat_gauges_from_raw(raw2)["heat.working_set_rows"])
        assert g["heat.working_set_rows"] > 1.5 * solo
        assert g["heat.shard_imbalance"] == pytest.approx(1.6)
        gauges.append(g)
    assert gauges[0] == gauges[1]


# ---------------------------------------------------------------------------
# HeatMap: gauges, budget, decay, latch, hot keys — equal to the JAX one.
# ---------------------------------------------------------------------------

def feed_both(stream, n_chunks=8):
    hms = heat.HeatMap(**SIZES), jheat.HeatMap(**SIZES)
    for hm in hms:
        for chunk in np.array_split(stream, n_chunks):
            hm.observe("pull", chunk)
            hm.observe("serve.ads", chunk[: len(chunk) // 2])
        hm.observe_shard(0, 3000)
        hm.observe_shard(1, 1000)
        hm.observe_cache(70, 30)
    return hms


def strip_clock(render):
    """A render without its wall-clock fields (rates, ages)."""
    out = dict(render)
    out.pop("day_age_s")
    out["sites"] = {
        name: {**site, "top": [{k: v for k, v in t.items()
                                if k != "est_rate_hz"} for t in site["top"]]}
        for name, site in render["sites"].items()}
    return out


def test_heatmap_gauges_summary_and_render_match_jax():
    stream = zipf_stream(n=50_000)
    hm, jhm = feed_both(stream)
    assert hm.summary() == jhm.summary()
    assert strip_clock(hm.render()) == strip_clock(jhm.render())
    assert hm.nbytes() == jhm.nbytes() <= MB4
    # the gauges the port published
    assert 0.0 < stat_get("heat.topk_share") <= 1.0
    assert stat_get("heat.working_set_rows") == \
        pytest.approx(len(exact_counts(stream)), rel=0.05)
    assert stat_get("heat.shard_imbalance") == pytest.approx(1.5)
    assert stat_get("heat.cache_hot_coverage") == pytest.approx(0.7)
    np.testing.assert_array_equal(hm.hot_keys(20), jhm.hot_keys(20))
    assert len(hm.hot_keys(20)) == 20


def test_site_cap_and_serving_hot_keys():
    hm = heat.HeatMap(**SIZES)
    for i in range(heat._MAX_SITES * 2):
        hm.observe(f"serve.t{i}", np.arange(5, dtype=np.uint64))
    assert len(hm.raw()["sites"]) == heat._MAX_SITES
    assert len(heat.serving_hot_keys(10)) == 0      # heat off
    heat.enable().observe("serve.ads", zipf_stream(n=5000))
    assert len(heat.serving_hot_keys(10)) == 10
    assert heat.summary() == heat.ACTIVE.summary()


def test_decay_day_matches_jax():
    stream = zipf_stream(n=20_000)
    hms = heat.HeatMap(**SIZES), jheat.HeatMap(**SIZES)
    for hm in hms:
        hm.observe("pull", stream)
    total0 = hms[0].summary()["total_keys"]
    assert total0 > 0 and hms[0].summary()["working_set_rows"] > 0
    for hm in hms:
        hm.decay_day(factor=0.5)
    s = hms[0].summary()
    assert s == hms[1].summary()
    assert s["total_keys"] == pytest.approx(total0 * 0.5, rel=1e-6)
    assert s["working_set_rows"] == 0.0
    assert len(flight.events(kind="heat_snapshot")) == 1
    hms[0].decay_day(factor=0.0)
    assert hms[0].summary()["total_keys"] == 0.0


def test_imbalance_latch_matches_jax():
    counts = []
    for hm in (heat.enable(), jheat.HeatMap(**SIZES)):
        for s in range(8):
            hm.observe_shard(s, 100)
        for _ in range(10):
            hm.observe_shard(0, 10_000)
        for s in range(1, 8):
            hm.observe_shard(s, 20_000)
        hm.observe_shard(0, 1_000_000)
        counts.append(hm.summary())
    assert counts[0] == counts[1]
    evs = flight.events(kind="heat_imbalance")
    assert len(evs) == 2 and evs[0]["imbalance"] >= 4.0


# ---------------------------------------------------------------------------
# Heat on == heat off on the port's day loop.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("mode", ["serial", "prefetch"])
def test_heat_on_is_bit_identical(mode, cache):
    """Heat on == heat off (and cache on == cache off), losses, table and
    dense state, while the sketches observed the run; the engine turns
    heat on from the flag and fades it at the change of date."""
    flags.set_flags({"obs_heat": False, "ps_device_cache": False})
    want = dc.run("mxu", "serial")[0]
    flags.set_flags({"obs_heat": True, "ps_device_cache": cache,
                     "ps_device_cache_rows": dc.SMALL})
    got = dc.run("mxu", mode)[0]
    dc.assert_same_bits(want, got)
    assert heat.ACTIVE is not None
    sites = set(heat.ACTIVE.raw()["sites"])
    assert {"pull", "push"} <= sites
    if cache:
        assert {"cache_admit", "cache_evict"} <= sites
        assert 0.0 < stat_get("heat.cache_hot_coverage") < 1.0
    assert stat_get("heat.working_set_rows") > 0
    assert len(flight.events(kind="heat_snapshot")) == dc.N_DAYS - 1
