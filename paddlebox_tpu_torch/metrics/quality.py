"""Training-quality monitors — the model-health series feeding the
telemetry timeline (utils/timeline.py) and the per-pass report
(ps/pass_manager.pass_report).

The reference prints one AUC line per pass and forgets it; ROADMAP item
4's streaming mode needs AUC *over time* and concept-drift detection.
This module keeps a bounded window of per-pass results and derives:

* **windowed AUC** — an exact AUC over the union of the last W passes,
  recomputed from each pass's folded pos/neg bucket tables via
  :class:`~paddlebox_tpu_torch.metrics.auc.AucCalculator` (not a mean of
  per-pass AUCs, which over-weights small passes);
* **calibration drift** — ``predicted_ctr / actual_ctr`` divergence
  (the COPC view of the reference's bucket_error);
* **PSI drift** — population-stability index of the prediction
  distribution between consecutive passes and between consecutive days
  (> 0.2 is the classic "distribution shifted" alarm level).

Everything lands as ``quality.*`` gauges in the StatRegistry, so the
timeline sampler picks the series up for free and the SLO watchdog's
``auc_drop`` rule reads ``quality.auc`` like any other metric.  Cost is
a few hundred floats per PASS — never per batch.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.metrics.auc import AucCalculator
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_add, stat_set

PSI_BINS = 10           # coarse decile bins, the classic PSI setup
_PSI_EPS = 1e-6         # zero-cell smoothing so ln() stays finite


def psi(expected: Sequence[float], actual: Sequence[float]) -> float:
    """Population-stability index between two distributions (counts or
    proportions; normalized internally).  0 = identical; > 0.2 is the
    conventional "significant shift" threshold."""
    e = np.asarray(expected, np.float64)
    a = np.asarray(actual, np.float64)
    if e.shape != a.shape or e.sum() <= 0 or a.sum() <= 0:
        return 0.0
    e = np.maximum(e / e.sum(), _PSI_EPS)
    a = np.maximum(a / a.sum(), _PSI_EPS)
    return float(np.sum((a - e) * np.log(a / e)))


def windowed_auc(window: Sequence[Dict[str, Sequence[float]]]) -> float:
    """Exact AUC over the union of several passes, from their folded
    pos/neg bucket exports (``AucCalculator.folded_buckets``).  Returns
    -0.5 (the reference's sentinel) when the union is single-class."""
    if not window:
        return -0.5
    bins = len(window[0]["pos"])
    calc = AucCalculator(table_size=bins)
    for b in window:
        calc._pos += np.asarray(b["pos"], np.float64)
        calc._neg += np.asarray(b["neg"], np.float64)
    return float(calc.compute()["auc"])


def calibration_drift(predicted_ctr: float, actual_ctr: float) -> float:
    """|COPC - 1|: how far predicted clicks diverge from observed ones
    (0 = perfectly calibrated).  0 when the pass saw no positives (the
    ratio is undefined, not infinitely wrong)."""
    if actual_ctr <= 0.0:
        return 0.0
    return abs(predicted_ctr / actual_ctr - 1.0)


def _pred_dist(buckets: Dict[str, Sequence[float]]) -> np.ndarray:
    """Prediction-score distribution (pos+neg mass per bucket) folded to
    PSI_BINS."""
    pos = np.asarray(buckets["pos"], np.float64)
    neg = np.asarray(buckets["neg"], np.float64)
    total = pos + neg
    n = len(total)
    idx = (np.arange(n) * PSI_BINS) // max(n, 1)
    out = np.zeros((PSI_BINS,), np.float64)
    np.add.at(out, idx, total)
    return out


class QualityMonitor:
    """Bounded-window per-pass quality tracker.  ``observe_pass``
    consumes one trainer metrics dict (``trainer.train_pass`` output:
    auc/predicted_ctr/actual_ctr/size plus the optional ``auc_buckets``
    export) and publishes the derived ``quality.*`` gauges."""

    def __init__(self, window: int = 8):
        self.window = max(2, int(window))
        self._lock = threading.Lock()
        self._aucs: "deque[float]" = deque(maxlen=self.window)
        self._buckets: "deque[Dict]" = deque(maxlen=self.window)
        self._prev_dist: Optional[np.ndarray] = None
        self._day_dist: Optional[np.ndarray] = None
        self._prev_day_dist: Optional[np.ndarray] = None

    def observe_pass(self, metrics: Optional[Dict],
                     pass_id: Optional[int] = None,
                     day: Optional[str] = None) -> Dict[str, float]:
        """Fold one pass result in; returns the derived quality gauges
        (also written to the StatRegistry).  ``None`` metrics (a pass
        skipped by the resume cursor) are ignored."""
        if not metrics or "auc" not in metrics:
            return {}
        # every gauge lands through a LITERAL stat_set site (not a k,v
        # loop): pboxlint PB207 statically cross-checks the watchdog's
        # rule metrics against these names, and one dynamic emission
        # site anywhere would disarm that check package-wide
        out: Dict[str, float] = {}
        with self._lock:
            auc = float(metrics["auc"])
            self._aucs.append(auc)
            out["quality.auc"] = auc
            stat_set("quality.auc", auc)
            drop = max(self._aucs) - auc
            out["quality.auc_drop"] = drop
            stat_set("quality.auc_drop", drop)
            buckets = metrics.get("auc_buckets")
            if buckets:
                self._buckets.append(buckets)
                wauc = windowed_auc(list(self._buckets))
                dist = _pred_dist(buckets)
                if self._prev_dist is not None:
                    p = psi(self._prev_dist, dist)
                    out["quality.psi.prediction"] = p
                    stat_set("quality.psi.prediction", p)
                self._prev_dist = dist
                self._day_dist = dist if self._day_dist is None \
                    else self._day_dist + dist
            else:
                # no bucket export (older trainer / hand-built metrics):
                # fall back to the plain windowed mean so the series
                # still exists
                wauc = float(sum(self._aucs) / len(self._aucs))
            out["quality.auc_window"] = wauc
            stat_set("quality.auc_window", wauc)
            cal = calibration_drift(
                float(metrics.get("predicted_ctr", 0.0)),
                float(metrics.get("actual_ctr", 0.0)))
            out["quality.calibration_drift"] = cal
            stat_set("quality.calibration_drift", cal)
        stat_add("quality.passes")
        return out

    def end_day(self, day: Optional[str] = None) -> Dict[str, float]:
        """Day rollover: PSI of the prediction distribution between the
        finished day and the previous one — the day-scale concept-drift
        series (ROADMAP item 4)."""
        out: Dict[str, float] = {}
        with self._lock:
            if self._day_dist is not None \
                    and self._prev_day_dist is not None:
                p = psi(self._prev_day_dist, self._day_dist)
                out["quality.psi.day"] = p
                stat_set("quality.psi.day", p)
            if self._day_dist is not None:
                self._prev_day_dist = self._day_dist
            self._day_dist = None
        return out

    def aucs(self) -> List[float]:
        with self._lock:
            return list(self._aucs)

    def reset(self) -> None:
        with self._lock:
            self._aucs.clear()
            self._buckets.clear()
            self._prev_dist = None
            self._day_dist = None
            self._prev_day_dist = None
        # a reset means "new model / new trajectory": the old model's
        # quality.* gauges must leave the registry too, or the timeline
        # sampler keeps feeding them to the SLO watchdog and the next
        # model's first pass reads as an AUC drop from the dead one
        StatRegistry.instance().remove_prefix("quality.")


# Process-wide monitor — always on (a few gauge writes per PASS); the
# flag-gated timeline sampler decides whether anything consumes the
# series continuously.
ACTIVE = QualityMonitor()


def observe_pass(metrics: Optional[Dict], pass_id: Optional[int] = None,
                 day: Optional[str] = None) -> Dict[str, float]:
    return ACTIVE.observe_pass(metrics, pass_id=pass_id, day=day)


def end_day(day: Optional[str] = None) -> Dict[str, float]:
    return ACTIVE.end_day(day)


def aucs() -> List[float]:
    """The retained per-pass AUC trajectory (bench.py's timeline
    summary)."""
    return ACTIVE.aucs()


def reset() -> None:
    ACTIVE.reset()
