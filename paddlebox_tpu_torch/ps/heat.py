"""Key-space heat telemetry: the per-process HeatMap registry.

The obs stack observes verbs and time; this observes the *key space* —
which keys are hot, how hot, how the heat lands across PS shards, and
how big the live working set is.  It is the measured substrate for the
skew-routing roadmap items (hot-key replication, density-driven
placement): everything here is a bounded-memory streaming sketch
(:mod:`paddlebox_tpu_torch.utils.sketch`), never a per-key dict (lint rule
PB208 enforces that package-wide).

Copy of ``paddlebox_tpu/ps/heat.py`` with the import paths rewritten;
numpy only, so no tap ever makes a device call.

Cost discipline is the trace.py one-check pattern: module-level
``ACTIVE`` starts ``None``; every tap site in the hot paths is a single
``if heat.ACTIVE is not None:`` — heat-off runs execute zero extra
instructions beyond that check.  Heat never touches training state, so
heat-on runs are bit-identical to heat-off (pinned by
tests/test_torch_heat.py on the serial and prefetched day loops).

Sites (one sketch bundle per literal site name, tenant-bounded):

* ``pull`` / ``push`` — ShardedHostTable.bulk_pull / bulk_write key
  batches (the training fan).
* ``cache_admit`` / ``cache_evict`` — DeviceRowCache admissions and
  evictions at the end_pass fold-back.
* ``serve.<tenant>`` — serving row lookups per tenant, and
  ``observe_shard``'s per-PS-shard load: their callers (the serving
  tier and the PS service tier) are not ported yet.

Derived gauges (published at LITERAL stat_set sites so the PB207
SloRule gate can see them; the "heat." prefix makes them timeline
gauges, not rates):

* ``heat.topk_share`` — fraction of pull traffic on the top-100 keys.
* ``heat.shard_imbalance`` — max/mean PS-shard key load (1.0 = even).
* ``heat.working_set_rows`` — HLL distinct pulled keys since day start.
* ``heat.cache_hot_coverage`` — share of pulled rows served resident
  by the device row cache.

Day boundaries decay the frequency sketches like every other day-scale
score (``decay_day`` — deliberately NOT named end_day: that name is a
table mutator and the PB701 serving-path gate bans reachable calls to
it).  Distinct counts cannot decay, so the HLLs reset: working-set
reads are per-day by contract.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils import sketch
from paddlebox_tpu_torch.utils.monitor import stat_set

flags.define_flag(
    "obs_heat", False,
    "enable key-space heat sketches (ps/heat.py) at the engine / PS "
    "server / serving replica / PS client entry points; off = every tap "
    "site is a single is-None check and training carries zero heat cost")
flags.define_flag(
    "obs_heat_topk", 512,
    "SpaceSaving heavy-hitter capacity per site; guarantees every key "
    "with frequency > N/k is tracked, over-count ≤ N/k")
flags.define_flag(
    "obs_heat_width", 2048,
    "count-min sketch width per site (over-count ≤ (e/width)·N "
    "w.p. ≥ 1 − e^−depth; 2048×4 float64 = 64 KB/site)")
flags.define_flag(
    "obs_heat_depth", 4,
    "count-min sketch depth (rows) per site")
flags.define_flag(
    "obs_heat_decay", 0.5,
    "day-boundary multiplier applied to heat frequency sketches "
    "(count-min cells, top-K counts, shard loads) — same day-scale "
    "fade discipline as show_click_decay; HLL working sets reset "
    "instead (distinct counts cannot decay)")

# cap on distinct site bundles (site names are literal or tenant-bounded,
# but a misbehaving tenant list must not grow memory without bound)
_MAX_SITES = 64
# top-N used for the topk_share headline gauge (matches the /heatz
# "top-100 recall" acceptance bar)
TOPN = 100
# shard-imbalance level that latches a heat_imbalance flight event
# (aligned with the timeline SloRule threshold)
IMBALANCE_EVENT_THRESHOLD = 4.0


class _Site:
    """One site's sketch bundle: frequencies + heavy hitters + distinct."""

    __slots__ = ("cm", "tk", "hll", "t0")

    def __init__(self, width: int, depth: int, topk: int, t0: float):
        self.cm = sketch.CountMinSketch(width=width, depth=depth)
        self.tk = sketch.SpaceSaving(k=topk)
        self.hll = sketch.HyperLogLog()
        self.t0 = t0


class HeatMap:
    """Per-process registry of heat sketches; all methods are cheap
    relative to the bulk ops they ride on (one np.unique of an
    already-materialized key batch plus O(u) sketch updates)."""

    def __init__(self, width: Optional[int] = None,
                 depth: Optional[int] = None,
                 topk: Optional[int] = None):
        self._width = int(width if width is not None
                          else flags.get_flags("obs_heat_width"))
        self._depth = int(depth if depth is not None
                          else flags.get_flags("obs_heat_depth"))
        self._topk = int(topk if topk is not None
                         else flags.get_flags("obs_heat_topk"))
        self._sites: Dict[str, _Site] = {}
        self._loads = sketch.ShardLoad()
        self._cache_hits = 0.0
        self._cache_misses = 0.0
        self._imbalance_latched = False
        self._day_t0 = time.time()
        from paddlebox_tpu_torch.utils import lockdep
        self._lock = lockdep.lock("ps.heat.HeatMap._lock")

    # -- taps ---------------------------------------------------------------
    def _site(self, name: str) -> Optional[_Site]:
        s = self._sites.get(name)
        if s is None:
            if len(self._sites) >= _MAX_SITES:
                return None          # bounded: drop novel sites past the cap
            s = _Site(self._width, self._depth, self._topk, time.time())
            self._sites[name] = s
        return s

    def observe(self, site: str, keys: np.ndarray) -> None:
        """Fold one key batch into ``site``'s sketches.  ``site`` must be
        a bounded literal (or tenant-derived) name — never key-derived."""
        uniq, counts = sketch.unique_with_counts(keys)
        if not len(uniq):
            return
        with self._lock:
            s = self._site(site)
            if s is None:
                return
            s.cm.update(uniq, counts)
            s.tk.update(uniq, counts)
            s.hll.update(uniq)
            if site == "pull":
                stat_set("heat.topk_share", s.tk.topk_share(TOPN))
                stat_set("heat.working_set_rows", s.hll.estimate())

    def observe_shard(self, shard: int, n_keys: int) -> None:
        """Account ``n_keys`` of fan traffic to PS shard ``shard`` and
        publish the imbalance gauge; crossing the event threshold latches
        one heat_imbalance flight event (cleared on recovery)."""
        if n_keys <= 0:
            return
        with self._lock:
            self._loads.add(shard, float(n_keys))
            imb = self._loads.imbalance()
            stat_set("heat.shard_imbalance", imb)
            if len(self._loads.loads) < 2:
                return
            if imb >= IMBALANCE_EVENT_THRESHOLD and not \
                    self._imbalance_latched:
                self._imbalance_latched = True
                flight.record("heat_imbalance", imbalance=round(imb, 3),
                              shards=len(self._loads.loads))
            elif imb < IMBALANCE_EVENT_THRESHOLD and \
                    self._imbalance_latched:
                self._imbalance_latched = False

    def hot_keys(self, k: int, site_prefix: str = "serve.") -> np.ndarray:
        """Top-``k`` hot keys merged across the ``site_prefix`` sketches
        (the serving tenants by default) — the measured replication set
        for the serving tier's hot-key planes (ps/serving.py).  Counts of
        the same key across tenants sum; ties break toward the smaller
        key so the set is deterministic for a given sketch state.
        Returns a SORTED uint64 array (at most ``k`` keys; empty when no
        matching site has traffic yet).  Pure-array aggregation — the
        candidate pool is bounded by k × matching sites, never the key
        space."""
        if k <= 0:
            return np.zeros(0, np.uint64)
        cand_keys: List[int] = []
        cand_counts: List[float] = []
        with self._lock:
            for name, s in self._sites.items():
                if not name.startswith(site_prefix):
                    continue
                for key, count, _err in s.tk.top(k):
                    cand_keys.append(int(key))
                    cand_counts.append(float(count))
        if not cand_keys:
            return np.zeros(0, np.uint64)
        keys = np.asarray(cand_keys, np.uint64)
        counts = np.asarray(cand_counts, np.float64)
        uniq, inv = np.unique(keys, return_inverse=True)
        sums = np.zeros(len(uniq), np.float64)
        np.add.at(sums, inv, counts)
        # stable sort on -count ties toward ascending key (uniq is sorted)
        order = np.argsort(-sums, kind="stable")[:k]
        return np.sort(uniq[order])

    def observe_cache(self, hits: int, misses: int) -> None:
        """Device row cache admission outcome for one pass build:
        hot-coverage = share of pulled rows served resident."""
        with self._lock:
            self._cache_hits += float(max(0, hits))
            self._cache_misses += float(max(0, misses))
            denom = self._cache_hits + self._cache_misses
            if denom > 0:
                stat_set("heat.cache_hot_coverage",
                         self._cache_hits / denom)

    # -- day boundary -------------------------------------------------------
    def decay_day(self, factor: Optional[float] = None) -> None:
        """Day-boundary fade (NOT named end_day — see module docstring):
        frequency sketches and shard loads scale by ``factor``; the HLL
        working sets reset (per-day by contract)."""
        f = float(factor if factor is not None
                  else flags.get_flags("obs_heat_decay"))
        with self._lock:
            for s in self._sites.values():
                s.cm.decay(f)
                s.tk.decay(f)
                s.hll.reset()
            self._loads.decay(f)
            self._cache_hits *= f
            self._cache_misses *= f
            self._day_t0 = time.time()
            summ = self._summary_locked()
        flight.record("heat_snapshot", topk_share=summ["topk_share"],
                      shard_imbalance=summ["shard_imbalance"],
                      working_set_rows=summ["working_set_rows"])

    # -- exports ------------------------------------------------------------
    def _summary_locked(self) -> Dict[str, float]:
        pull = self._sites.get("pull")
        return {
            "topk_share": round(pull.tk.topk_share(TOPN), 4)
            if pull else 0.0,
            "shard_imbalance": round(self._loads.imbalance(), 4),
            "working_set_rows": round(pull.hll.estimate(), 1)
            if pull else 0.0,
            # decayed pull traffic weight — the cluster health fold
            # measures cross-member imbalance from these
            "total_keys": round(pull.cm.total, 1) if pull else 0.0,
        }

    def summary(self) -> Dict[str, float]:
        """Compact heat sub-dict for the health verbs."""
        with self._lock:
            return self._summary_locked()

    def raw(self) -> Dict:
        """Mergeable wire export (the sketch.merge_heat_raw schema) —
        what /statz?raw=1 ships and the supervisor folds."""
        with self._lock:
            return {
                "sites": {name: {"cm": s.cm.raw(), "tk": s.tk.raw(),
                                 "hll": s.hll.raw()}
                          for name, s in self._sites.items()},
                "loads": self._loads.raw(),
                "cache": [self._cache_hits, self._cache_misses],
            }

    def nbytes(self) -> int:
        """Resident sketch memory (the ≤ 4 MB/process budget check)."""
        with self._lock:
            return sum(s.cm.nbytes() + s.hll.nbytes() +
                       len(s.tk) * 48 for s in self._sites.values()) \
                + int(self._loads.loads.nbytes)

    def render(self, topn: int = TOPN) -> Dict:
        """The /heatz payload: top-K keys with estimated rates, per-shard
        load shares, skew exponent fit, and the working-set curve."""
        now = time.time()
        with self._lock:
            sites_out = {}
            for name, s in self._sites.items():
                elapsed = max(1e-6, now - s.t0)
                top = s.tk.top(topn)
                counts = [c for _, c, _ in top]
                sites_out[name] = {
                    "total_keys": round(s.cm.total, 1),
                    "working_set_rows": round(s.hll.estimate(), 1),
                    "zipf_exponent": sketch.fit_zipf_exponent(counts),
                    "topk_share": round(s.tk.topk_share(topn), 6),
                    # cumulative share of traffic at increasing rank
                    # depths — the working-set curve ("how many rows
                    # cover how much traffic")
                    "share_curve": self._share_curve(counts, s.tk.total),
                    "top": [{"key": str(key),
                             "est_count": round(c, 1),
                             "err": round(e, 1),
                             "est_rate_hz": round(c / elapsed, 3)}
                            for key, c, e in top],
                }
            denom = self._cache_hits + self._cache_misses
            return {
                "sites": sites_out,
                "shards": {
                    "n": len(self._loads.loads),
                    "imbalance": round(self._loads.imbalance(), 4),
                    "shares": self._loads.shares(),
                },
                "cache_hot_coverage":
                    round(self._cache_hits / denom, 6) if denom else 0.0,
                "sketch_bytes": sum(
                    s.cm.nbytes() + s.hll.nbytes() + len(s.tk) * 48
                    for s in self._sites.values()),
                "day_age_s": round(now - self._day_t0, 1),
            }

    @staticmethod
    def _share_curve(counts: List[float], total: float) -> List[Dict]:
        if total <= 0 or not counts:
            return []
        out, acc = [], 0.0
        marks = {1, 10, 50, 100, len(counts)}
        for rank, c in enumerate(sorted(counts, reverse=True), start=1):
            acc += c
            if rank in marks:
                out.append({"rank": rank,
                            "share": round(min(1.0, acc / total), 4)})
        return out


# module-level handle — the one hot-path check (≙ trace.ACTIVE)
ACTIVE: Optional[HeatMap] = None


def enable() -> HeatMap:
    global ACTIVE
    if ACTIVE is None:
        ACTIVE = HeatMap()
    return ACTIVE


def disable() -> None:
    global ACTIVE
    ACTIVE = None


def maybe_enable_from_flags() -> Optional[HeatMap]:
    if flags.get_flags("obs_heat"):
        return enable()
    return ACTIVE


def summary() -> Optional[Dict[str, float]]:
    """Health-verb helper: compact heat dict, or None when heat is off."""
    return ACTIVE.summary() if ACTIVE is not None else None


def serving_hot_keys(k: int) -> np.ndarray:
    """The serving tier's measured hot-key set: top-``k`` keys across the
    ``serve.*`` sketch sites, or empty when heat is off / cold.  Sorted
    uint64 — directly usable as a replication set (ps/serving.py)."""
    if ACTIVE is None or k <= 0:
        return np.zeros(0, np.uint64)
    return ACTIVE.hot_keys(k)
