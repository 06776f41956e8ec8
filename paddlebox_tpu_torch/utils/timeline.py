"""Continuous telemetry timeline + SLO watchdog — the TIME dimension of
the obs stack.

Copy of ``paddlebox_tpu/utils/timeline.py`` with the import paths rewritten;
host code (stdlib and numpy), so none of its threads makes a device
call.

/statz and the per-pass PrintSyncTimer report (ps/pass_manager.py) answer
"what is the state now" and "what did this pass cost"; neither answers
"what happened over the last five minutes" — the exact view the r04/r05
wedges needed and only got post hoc.  This module runs a background
sampler (≙ the reference's platform/monitor.h periodic stat collection)
that snapshots the StatRegistry on a monotonic cadence into a bounded
ring, deriving per-interval counter deltas → rates (ex/s, tx_bytes/s,
dedup-hit/s) while retaining gauge/percentile series as-is.

Consumers:

  ``/timelinez``          utils/obs_server.py — JSON series by name
  postmortem bundles      utils/doctor.py embeds ``tail()`` so every
                          bundle shows the minutes LEADING UP TO the
                          wedge, not just the instant of it
  SLO watchdog            evaluated on each sample against a small
                          declarative rule set; a sustained breach emits
                          ONE ``slo_breach`` flight event (latched per
                          rule — no event storm while breached) plus
                          ``obs.slo.*`` counters
  launch.py /clusterz     the supervisor folds per-worker scrapes into a
                          job-level :class:`TimelineRing`

Design constraints (same discipline as trace/flight):

* **Off by default** — ``FLAGS_obs_timeline_interval_s`` = 0 starts
  nothing; no instrumentation site pays anything (the sampler PULLS from
  the registry, producers are untouched).
* **Bounded memory** — newest-N samples (``FLAGS_obs_timeline_ring``).
* **Counter-reset tolerant** — a negative delta (registry reset, worker
  restart behind the same scrape port) is treated as a restart from
  zero, never a negative rate.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils import flight, lockdep
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_add, stat_set

flags.define_flag(
    "obs_timeline_interval_s", 0.0,
    "sample the stat registry into the telemetry timeline every N "
    "seconds (served at /timelinez, embedded in postmortems, input to "
    "the SLO watchdog); 0 = off, like obs_port")
flags.define_flag(
    "obs_timeline_ring", 512,
    "timeline ring capacity (newest-N samples); at the 1 s cadence the "
    "default retains ~8.5 minutes of history")
flags.define_flag(
    "obs_slo_watchdog", True,
    "evaluate the declarative SLO rule set on every timeline sample "
    "(cache hit-rate collapse, throughput stall, queue saturation, AUC "
    "drop); breaches emit one latched slo_breach flight event each and "
    "count under obs.slo.*.  Only active while the timeline sampler "
    "runs")
flags.define_flag(
    "obs_slo_auc_drop", 0.05,
    "SLO watchdog epsilon for the AUC-drop rule: breach when quality.auc "
    "falls more than this below its recent-window maximum")
flags.define_flag(
    "obs_slo_serving_p99_ms", 250.0,
    "serving-tier SLO: per-tenant pull p99 latency budget in ms "
    "(serving_rules breaches when serving.<tenant>.latency_s.p99 stays "
    "over this for the rule window)")
flags.define_flag(
    "obs_slo_heat_imbalance", 4.0,
    "SLO watchdog threshold for PS shard skew: breach when "
    "heat.shard_imbalance (max/mean shard key load, ps/heat.py) stays "
    "over this for the rule window — read /heatz before resize(new_n)")

# Keys carrying level/percentile semantics: retained as value series but
# excluded from rate derivation (a gauge moving down is not a counter
# reset).  Everything else in the registry is add()-style cumulative.
_GAUGE_SUFFIXES = (".p50", ".p95", ".p99", ".max", "hwm", "_frac",
                   "_ratio", "_rate", "_gen", "generation", ".threads",
                   "resident_rows")
_GAUGE_PREFIXES = ("quality.", "heat.")


def is_gauge_key(key: str) -> bool:
    """True for keys the rate derivation must skip (levels, marks,
    percentiles, training-quality gauges)."""
    return key.endswith(_GAUGE_SUFFIXES) or key.startswith(_GAUGE_PREFIXES)


class TimelineRing:
    """Bounded ring of registry snapshots with per-interval rate
    derivation.  Also the fold target for the supervisor's cluster
    aggregation (launch.py appends MERGED snapshots here)."""

    def __init__(self, cap: int):
        self._ring: "deque[Dict]" = deque(maxlen=max(2, int(cap)))
        self._lock = lockdep.lock("utils.timeline.TimelineRing._lock")
        self._prev: Optional[Tuple[float, Dict[str, float]]] = None
        self._seq = 0

    def append(self, stats: Dict[str, float],
               mono: Optional[float] = None,
               t: Optional[float] = None) -> Dict:
        """Fold one snapshot in; returns the stored sample (with its
        derived ``rates``)."""
        if mono is None:
            mono = time.monotonic()
        if t is None:
            t = time.time()
        rates: Dict[str, float] = {}
        with self._lock:
            if self._prev is not None:
                pmono, pstats = self._prev
                dt = mono - pmono
                if dt > 0:
                    for k, v in stats.items():
                        if is_gauge_key(k) or not isinstance(v, (int, float)):
                            continue
                        d = v - pstats.get(k, 0.0)
                        if d < 0:
                            # counter reset (registry.reset / worker
                            # restart): the counter restarted from zero,
                            # so the interval's growth is the new value
                            d = v
                        rates[k] = d / dt
            lockdep.guards(self, "_seq")
            self._seq += 1
            sample = {"seq": self._seq, "t": t, "mono": mono,
                      "stats": dict(stats), "rates": rates}
            self._ring.append(sample)
            self._prev = (mono, dict(stats))
        return sample

    def samples(self, n: Optional[int] = None) -> List[Dict]:
        """Oldest-first retained samples (last ``n`` when given)."""
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-max(0, int(n)):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def names(self) -> List[str]:
        """Sorted union of stat names across retained samples."""
        seen = set()
        for s in self.samples():
            seen.update(s["stats"].keys())
        return sorted(seen)

    def series(self, name: str, n: Optional[int] = None) -> Dict:
        """One metric's trajectory: ``points`` = [t, value] pairs,
        ``rates`` = [t, per-second rate] pairs (counters only)."""
        points: List[List[float]] = []
        rate_points: List[List[float]] = []
        for s in self.samples(n):
            v = s["stats"].get(name)
            if v is not None:
                points.append([s["t"], float(v)])
            r = s["rates"].get(name)
            if r is not None:
                rate_points.append([s["t"], float(r)])
        return {"name": name, "points": points, "rates": rate_points}

    def tail(self, n: int = 20,
             rate_top: int = 12, stat_top: int = 12) -> List[Dict]:
        """Compact newest-``n`` view for postmortem bundles: per sample,
        the ``rate_top`` largest rates and ``stat_top`` largest stats —
        what was moving in the minutes before the wedge, without the
        full snapshot weight."""
        out = []
        for s in self.samples(n):
            rates = sorted(s["rates"].items(), key=lambda kv: -abs(kv[1]))
            stats = sorted(s["stats"].items(), key=lambda kv: -abs(kv[1]))
            out.append({
                "seq": s["seq"], "t": s["t"], "mono": s["mono"],
                "rates": {k: round(v, 6) for k, v in rates[:rate_top]},
                "stats": {k: round(v, 6) for k, v in stats[:stat_top]},
            })
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._prev = None


class SloRule:
    """One declarative SLO rule: breach when ``metric``'s series over the
    trailing ``window_s`` seconds SUSTAINS the predicate (every sample
    violates, with at least ``min_samples`` samples — one bad scrape
    never pages).

    kind: ``gauge`` evaluates the raw value series, ``rate`` the derived
    per-second rate series, ``drop`` compares the latest value against
    the window maximum (breach when it fell more than ``threshold``).
    op: ``lt`` | ``gt`` (ignored for ``drop``)."""

    KINDS = ("gauge", "rate", "drop")
    OPS = ("lt", "gt")

    def __init__(self, name: str, metric: str, *, kind: str = "gauge",
                 op: str = "lt", threshold: float = 0.0,
                 window_s: float = 30.0, min_samples: int = 3,
                 reason: str = ""):
        if kind not in self.KINDS:
            raise ValueError(f"unknown SLO rule kind {kind!r}")
        if op not in self.OPS:
            raise ValueError(f"unknown SLO rule op {op!r}")
        self.name = name
        self.metric = metric
        self.kind = kind
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.min_samples = int(min_samples)
        self.reason = reason

    def _values(self, ring: TimelineRing, now_mono: float) -> List[float]:
        key = "rates" if self.kind == "rate" else "stats"
        vals: List[float] = []
        for s in ring.samples():
            if s["mono"] < now_mono - self.window_s:
                continue
            v = s[key].get(self.metric)
            if v is not None:
                vals.append(float(v))
        return vals

    def evaluate(self, ring: TimelineRing, now_mono: float) -> bool:
        """True = currently breached."""
        vals = self._values(ring, now_mono)
        if len(vals) < self.min_samples:
            return False
        if self.kind == "drop":
            return max(vals) - vals[-1] > self.threshold
        if self.op == "lt":
            return all(v < self.threshold for v in vals)
        return all(v > self.threshold for v in vals)

    def describe(self) -> Dict:
        return {"name": self.name, "metric": self.metric,
                "kind": self.kind, "op": self.op,
                "threshold": self.threshold, "window_s": self.window_s,
                "min_samples": self.min_samples, "reason": self.reason}


class SloWatchdog:
    """Evaluates a rule set against the ring on every sample, LATCHING
    breach state per rule: the ok→breach transition emits one
    ``slo_breach`` flight event + ``obs.slo.breach`` count, the
    breach→ok transition one ``slo_clear`` — a sustained breach never
    storms the flight ring."""

    def __init__(self, rules: Sequence[SloRule]):
        self.rules = list(rules)
        self._breached: Dict[str, bool] = {r.name: False for r in self.rules}
        self._lock = lockdep.lock("utils.timeline.SloWatchdog._lock")

    def evaluate(self, ring: TimelineRing,
                 now_mono: Optional[float] = None) -> List[Dict]:
        """Run every rule; returns the transitions that fired."""
        if now_mono is None:
            now_mono = time.monotonic()
        transitions: List[Dict] = []
        with self._lock:
            for rule in self.rules:
                breached = rule.evaluate(ring, now_mono)
                was = self._breached.get(rule.name, False)
                if breached == was:
                    continue
                self._breached[rule.name] = breached
                ev = {"rule": rule.name, "metric": rule.metric,
                      "breached": breached, "threshold": rule.threshold,
                      "reason": rule.reason}
                transitions.append(ev)
                if breached:
                    stat_add("obs.slo.breach")
                    flight.record("slo_breach", rule=rule.name,
                                  metric=rule.metric,
                                  threshold=rule.threshold,
                                  reason=rule.reason)
                else:
                    stat_add("obs.slo.clear")
                    flight.record("slo_clear", rule=rule.name,
                                  metric=rule.metric)
            stat_set("obs.slo.active",
                     float(sum(1 for b in self._breached.values() if b)))
        return transitions

    def states(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._breached)


def default_rules() -> List[SloRule]:
    """The shipped rule set — conservative sustained-window predicates
    over metrics the package actually emits (lint rule PB207 cross-
    checks every metric literal here against emission sites)."""
    auc_eps = float(flags.get_flags("obs_slo_auc_drop"))
    return [
        SloRule("cache_hit_collapse", "ps.cache.hit_rate",
                kind="gauge", op="lt", threshold=0.10,
                window_s=30.0, min_samples=3,
                reason="device embedding-cache hit rate collapsed"),
        SloRule("queue_saturation", "ps.pool.table.queue_depth_hwm",
                kind="gauge", op="gt", threshold=10_000.0,
                window_s=30.0, min_samples=3,
                reason="host-table work queue saturated"),
        SloRule("throughput_stall", "trainer.step_dispatch_s.count",
                kind="rate", op="lt", threshold=1e-9,
                window_s=60.0, min_samples=5,
                reason="no device steps dispatched for a minute"),
        SloRule("auc_drop", "quality.auc",
                kind="drop", threshold=auc_eps,
                window_s=600.0, min_samples=2,
                reason="pass AUC fell below its recent-window maximum"),
        SloRule("heat_shard_imbalance", "heat.shard_imbalance",
                kind="gauge", op="gt",
                threshold=float(flags.get_flags("obs_slo_heat_imbalance")),
                window_s=30.0, min_samples=3,
                reason="PS shard key load skewed far off the mean — "
                       "a hot shard is serializing the pull fan"),
    ]


def serving_rules(tenants: Sequence[str] = ("default",)) -> List[SloRule]:
    """Per-tenant serving-tier SLO rules (ps/serving.py's metric surface)
    — appended to ``default_rules()`` by the serving entrypoints, one
    p99-latency and one shed-rate rule per configured tenant.  Tenants
    are a closed configured set, so the rule count stays bounded."""
    p99_s = float(flags.get_flags("obs_slo_serving_p99_ms")) / 1000.0
    out: List[SloRule] = []
    for t in tenants:
        out.append(SloRule(
            f"serving_{t}_p99", f"serving.{t}.latency_s.p99",
            kind="gauge", op="gt", threshold=p99_s,
            window_s=30.0, min_samples=3,
            reason=f"serving pull p99 over budget for tenant {t}"))
        out.append(SloRule(
            f"serving_{t}_shed", f"serving.{t}.shed",
            kind="rate", op="gt", threshold=1.0,
            window_s=30.0, min_samples=3,
            reason=f"admission control sustained-shedding tenant {t}"))
    return out


class TimelineSampler:
    """Background daemon sampling the process StatRegistry into a
    :class:`TimelineRing` on a monotonic cadence, running the watchdog
    on each sample.  ``stop()`` joins the thread (PB405 lifecycle)."""

    def __init__(self, interval_s: float, cap: int,
                 rules: Optional[Sequence[SloRule]] = None):
        self.interval_s = float(interval_s)
        self.ring = TimelineRing(cap)
        self.watchdog = SloWatchdog(
            default_rules() if rules is None else rules)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TimelineSampler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pbox-timeline", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — sampling must never die
                stat_add("obs.timeline.sample_errors")

    def sample_once(self) -> Dict:
        """One sample + watchdog evaluation (also the test surface — no
        thread needed to drive the timeline deterministically)."""
        stats = StatRegistry.instance().snapshot()
        sample = self.ring.append(stats)
        stat_add("obs.timeline.samples")
        if bool(flags.get_flags("obs_slo_watchdog")):
            self.watchdog.evaluate(self.ring, now_mono=sample["mono"])
        return sample

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()


# -- module-level handle ----------------------------------------------------
ACTIVE: Optional[TimelineSampler] = None
_LOCK = threading.Lock()


def start(interval_s: Optional[float] = None,
          cap: Optional[int] = None,
          rules: Optional[Sequence[SloRule]] = None) -> TimelineSampler:
    """Start (or return) the process-wide sampler.  Flag defaults apply
    when arguments are omitted."""
    global ACTIVE
    with _LOCK:
        if ACTIVE is None:
            if interval_s is None:
                interval_s = float(flags.get_flags("obs_timeline_interval_s"))
            if cap is None:
                cap = int(flags.get_flags("obs_timeline_ring"))
            ACTIVE = TimelineSampler(max(interval_s, 0.01), cap,
                                     rules=rules).start()
        return ACTIVE


def stop() -> None:
    global ACTIVE
    with _LOCK:
        if ACTIVE is not None:
            ACTIVE.stop()
            ACTIVE = None


def sampler() -> Optional[TimelineSampler]:
    return ACTIVE


def maybe_start_from_flags() -> Optional[TimelineSampler]:
    """Worker entry hook (called when the obs exporter starts): run the
    sampler iff ``FLAGS_obs_timeline_interval_s`` > 0."""
    interval = float(flags.get_flags("obs_timeline_interval_s"))
    if interval <= 0:
        return None
    return start(interval_s=interval)


def series(name: str, n: Optional[int] = None) -> Dict:
    """The active sampler's series for ``name`` (empty when off)."""
    s = ACTIVE
    if s is None:
        return {"name": name, "points": [], "rates": []}
    return s.ring.series(name, n=n)


def tail(n: int = 20) -> List[Dict]:
    """Compact newest-``n`` samples for postmortems ([] when off)."""
    s = ACTIVE
    return s.ring.tail(n) if s is not None else []
