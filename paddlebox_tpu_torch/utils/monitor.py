"""Process-wide stat gauges + bounded-memory latency histograms
(≙ platform/monitor.h:80 StatRegistry and the STAT_INT_ADD macros at
monitor.h:137, grown a histogram surface for verb-latency percentiles).

Two kinds of stats live in the one registry:

* **counters/gauges** — ``stat_add``/``stat_set``/``stat_max``: a flat
  name → float map, exactly the reference's StatValue registry.
* **histograms** — ``stat_observe(name, value)``: bounded-memory
  log-bucketed distributions (quarter-octave buckets over
  ~1e-9 .. ~1e9, 242 fixed buckets, exact count/sum/min/max).
  ``snapshot()`` folds each histogram into derived keys
  ``<name>.count/.sum/.p50/.p95/.p99/.max`` so every existing consumer
  of the flat snapshot (health verb, bench result line, /statz) sees
  percentiles with zero schema change; the Prometheus exporter
  (utils/obs_server.py) reads ``hist_snapshot()`` for summary
  exposition.

``snapshot(prefix)`` matches on DOTTED-SEGMENT boundaries: ``"ps.s"``
matches ``ps.s`` and ``ps.s.*`` but never ``ps.streams.*`` (the naive
startswith used to leak sibling namespaces into prefix scrapes).

Metric names are lowercase dotted literals; dynamic parts must be
bounded fields (verb/cmd/site/... — lint rule PB204 enforces this), or
an unbounded key set grows this process-wide registry forever.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Tuple

# histogram bucket geometry: quarter-octave log buckets from 2^-30
# (~0.93ns — below any latency we time) up to 2^30 (~1.07e9 — above any
# byte count per observation we expect); values outside clamp into the
# under/overflow buckets but min/max stay exact
_HIST_LO = 2.0 ** -30
_HIST_BPB = 4                       # buckets per octave (2^(1/4) growth)
_HIST_NB = 60 * _HIST_BPB           # spans 2^-30 .. 2^30


def _bucket_index(v: float) -> int:
    if v <= _HIST_LO:
        return 0
    idx = int(math.log2(v / _HIST_LO) * _HIST_BPB) + 1
    return min(idx, _HIST_NB + 1)


def _bucket_bounds(idx: int) -> Tuple[float, float]:
    """(lower, upper) value bounds of bucket ``idx`` (1..NB)."""
    return (_HIST_LO * 2.0 ** ((idx - 1) / _HIST_BPB),
            _HIST_LO * 2.0 ** (idx / _HIST_BPB))


class Histogram:
    """Bounded-memory log-bucketed histogram: a fixed int array plus
    exact count/sum/min/max.  Percentiles interpolate at the geometric
    midpoint of the landing bucket (≤ ~9% relative bucket-width error at
    quarter-octave resolution), clamped to the observed [min, max]."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.counts = [0] * (_HIST_NB + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            # a single nan would poison `total` (and every later .sum /
            # mean) while leaving vmin/vmax untouched — drop it here and
            # let the registry count the drop
            return
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self.counts[_bucket_index(v)] += 1

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100])."""
        if self.count == 0:
            return 0.0
        target = max(1.0, q / 100.0 * self.count)
        cum = 0
        for idx, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                if idx == 0:
                    return min(self.vmin, _HIST_LO)
                if idx == _HIST_NB + 1:
                    return self.vmax
                lo, hi = _bucket_bounds(idx)
                est = math.sqrt(lo * hi)
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "sum": self.total,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "max": self.vmax if self.count else 0.0,
        }

    def raw(self) -> Dict:
        """Mergeable wire form: sparse bucket counts + exact
        count/sum/min/max.  ``/statz?raw=1`` ships this so the
        supervisor can merge histograms BUCKET-WISE across workers and
        recompute job-wide percentiles (max-of-per-worker-percentiles is
        statistically wrong — see obs_server.merge_snapshots)."""
        return {
            "b": {str(i): c for i, c in enumerate(self.counts) if c},
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
        }

    @classmethod
    def from_raw(cls, raws: List[Dict]) -> "Histogram":
        """Rebuild one histogram from the bucket-wise sum of many
        ``raw()`` dicts (identical fixed bucket geometry on every
        worker makes this exact up to bucket resolution)."""
        h = cls()
        nb = len(h.counts)
        for r in raws:
            for i, c in (r.get("b") or {}).items():
                idx = int(i)
                if 0 <= idx < nb:
                    h.counts[idx] += int(c)
            n = int(r.get("count", 0))
            h.count += n
            h.total += float(r.get("sum", 0.0))
            if n > 0:
                h.vmin = min(h.vmin, float(r.get("min", math.inf)))
                h.vmax = max(h.vmax, float(r.get("max", -math.inf)))
        return h


def _prefix_match(key: str, prefix: str) -> bool:
    """Dotted-segment prefix: ``ps.s`` matches ``ps.s``/``ps.s.x`` but
    never ``ps.streams.x``; a trailing-dot prefix matches its subtree."""
    if not prefix or key == prefix:
        return True
    if prefix.endswith("."):
        return key.startswith(prefix)
    return key.startswith(prefix) and key[len(prefix)] == "."


class StatRegistry:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._stats: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "StatRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self._stats[name] = self._stats.get(name, 0.0) + value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._stats[name] = value

    def max(self, name: str, value: float) -> None:
        """Keep the high-water mark of a gauge (e.g. frames in flight)."""
        with self._lock:
            cur = self._stats.get(name)
            if cur is None or value > cur:
                self._stats[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the named histogram (created on first
        observe; bounded memory per name — see lint rule PB204 for why
        the NAME set must be bounded too).  Non-finite samples are
        dropped (they would poison ``sum``) and counted under
        ``obs.non_finite_dropped``."""
        with self._lock:
            if not math.isfinite(float(value)):
                self._stats["obs.non_finite_dropped"] = \
                    self._stats.get("obs.non_finite_dropped", 0.0) + 1.0
                return
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def get(self, name: str) -> float:
        with self._lock:
            return self._stats.get(name, 0.0)

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        """All stats — counters plus each histogram's derived
        ``.count/.sum/.p50/.p95/.p99/.max`` keys — or just those under a
        dotted prefix, matched on segment boundaries (``"ps.s"`` never
        matches ``ps.streams.*``)."""
        with self._lock:
            out = dict(self._stats)
            hists = {n: h.summary() for n, h in self._hists.items()}
        for name, summ in hists.items():
            for k, v in summ.items():
                out[f"{name}.{k}"] = v
        if not prefix:
            return out
        return {k: v for k, v in out.items() if _prefix_match(k, prefix)}

    def hist_snapshot(self, prefix: str = "") -> Dict[str, Dict[str, float]]:
        """Histogram summaries keyed by histogram name (the Prometheus
        summary exposition source, utils/obs_server.py)."""
        with self._lock:
            names = [n for n in self._hists if _prefix_match(n, prefix)]
            return {n: self._hists[n].summary() for n in names}

    def hist_raw(self, prefix: str = "") -> Dict[str, Dict]:
        """Raw (mergeable) histogram exports keyed by name — the
        ``/statz?raw=1`` payload."""
        with self._lock:
            names = [n for n in self._hists if _prefix_match(n, prefix)]
            return {n: self._hists[n].raw() for n in names}

    def counter_snapshot(self, prefix: str = "") -> Dict[str, float]:
        """Plain counters/gauges only (no histogram-derived keys)."""
        with self._lock:
            return {k: v for k, v in self._stats.items()
                    if _prefix_match(k, prefix)}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._hists.clear()

    def remove_prefix(self, prefix: str) -> int:
        """Drop every stat and histogram under a dotted prefix; returns
        how many were removed.  For subsystem resets (quality.reset):
        a gauge left behind by a discarded model would keep feeding the
        timeline sampler and SLO watchdog as if it were current."""
        with self._lock:
            ks = [k for k in self._stats if _prefix_match(k, prefix)]
            hs = [k for k in self._hists if _prefix_match(k, prefix)]
            for k in ks:
                del self._stats[k]
            for k in hs:
                del self._hists[k]
            return len(ks) + len(hs)


def stat_add(name: str, value: float = 1.0) -> None:
    StatRegistry.instance().add(name, value)


def stat_set(name: str, value: float) -> None:
    """Overwrite a gauge (mirrors StatRegistry.set, like stat_add/
    stat_max mirror add/max)."""
    StatRegistry.instance().set(name, value)


def stat_get(name: str) -> float:
    return StatRegistry.instance().get(name)


def stat_max(name: str, value: float) -> None:
    StatRegistry.instance().max(name, value)


def stat_observe(name: str, value: float) -> None:
    """Record one sample into a bounded-memory log-bucketed histogram;
    percentiles surface as ``<name>.p50/.p95/.p99/.max`` in snapshots."""
    StatRegistry.instance().observe(name, value)


def stat_snapshot(prefix: str = "") -> Dict[str, float]:
    return StatRegistry.instance().snapshot(prefix)
