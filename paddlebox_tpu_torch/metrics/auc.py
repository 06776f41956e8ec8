"""Streaming AUC / calibration metrics.

Port of ``paddlebox_tpu/metrics/auc.py`` (≙ BasicAucCalculator,
fleet/metrics.h:46, metrics.cc:284-410): bucket accumulation runs on the
device inside the train step (``accumulate_auc``, ≙ mode_collect_in_gpu,
box_wrapper.h:787) into tensors that live beside the working set; the
final ``AucCalculator.compute()`` is the host-side numpy reduction over
the bucket tables, copied from the JAX package.  The per-user WuAUC
family and the metric registry are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

TABLE_SIZE = 1_000_000  # ≙ box_wrapper.h:786
N_SCALARS = 6   # abserr, sqrerr, pred_sum, label_sum, total, nan_inf
K_RELATIVE_ERROR_BOUND = 0.05  # ≙ metrics.h:193
K_MAX_SPAN = 0.01              # ≙ metrics.h:194


def make_auc_state(table_size: int = TABLE_SIZE,
                   device: torch.device = None) -> Dict[str, torch.Tensor]:
    """Device-side accumulator: pos/neg bucket tables + scalar sums
    [abserr, sqrerr, pred_sum, label_sum, total, nan_inf]."""
    return {
        "pos": torch.zeros((table_size,), dtype=torch.float32, device=device),
        "neg": torch.zeros((table_size,), dtype=torch.float32, device=device),
        "scalars": torch.zeros((N_SCALARS,), dtype=torch.float32,
                               device=device),
    }


@torch.no_grad()
def accumulate_auc(state: Dict[str, torch.Tensor], pred: torch.Tensor,
                   label: torch.Tensor, mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Bucket accumulation IN PLACE into ``state`` (≙ add_unlock_data
    metrics.cc:84-105 vectorized); returns ``state``.  pred/label: [B];
    mask False drops padded records (≙ add_mask_data metrics.cc:164).
    Bucket weights are 0/1, so the scatter sums are exact in any order."""
    table_size = state["pos"].shape[0]
    pred = pred.to(torch.float32)
    # non-finite preds must not poison the buckets: count them separately
    # (≙ add_nan_inf_data metrics.cc:452) and drop them everywhere else
    finite = torch.isfinite(pred)
    pred = torch.clamp(torch.where(finite, pred, torch.zeros_like(pred)),
                       0.0, 1.0)
    label = label.to(torch.float32)
    w = torch.ones_like(pred) if mask is None else mask.to(torch.float32)
    fin = finite.to(torch.float32)
    nan_inf = torch.sum(w * (1.0 - fin))
    w = w * fin
    bucket = torch.clamp((pred * table_size).to(torch.int64), 0,
                         table_size - 1)
    state["pos"].scatter_add_(0, bucket, w * label)
    state["neg"].scatter_add_(0, bucket, w * (1.0 - label))
    err = pred - label
    state["scalars"] += torch.stack([
        torch.sum(w * torch.abs(err)),
        torch.sum(w * err * err),
        torch.sum(w * pred),
        torch.sum(w * label),
        torch.sum(w),
        nan_inf,
    ])
    return state


class AucCalculator:
    """Host wrapper with the reference's result surface
    (auc/bucket_error/mae/rmse/actual_ctr/predicted_ctr, metrics.h:108-121)."""

    def __init__(self, table_size: int = TABLE_SIZE):
        self.table_size = table_size
        self.reset()

    def reset(self) -> None:
        self._pos = np.zeros((self.table_size,), np.float64)
        self._neg = np.zeros((self.table_size,), np.float64)
        self._scalars = np.zeros((N_SCALARS,), np.float64)

    # -- host-side add (small batches / tests) ------------------------------
    def add_data(self, pred, label, mask=None) -> None:
        pred = np.asarray(pred, np.float64)
        label = np.asarray(label, np.float64)
        w = np.ones_like(pred) if mask is None else \
            np.asarray(mask, np.float64)
        # finite check BEFORE the clip (clip would turn +inf into 1.0)
        finite = np.isfinite(pred)
        pred = np.clip(np.where(finite, pred, 0.0), 0.0, 1.0)
        nan_inf = np.sum(w * (1.0 - finite))
        w = w * finite
        bucket = np.clip((pred * self.table_size).astype(np.int64), 0,
                         self.table_size - 1)
        np.add.at(self._pos, bucket, w * label)
        np.add.at(self._neg, bucket, w * (1.0 - label))
        err = pred - label
        self._scalars += [np.sum(w * np.abs(err)), np.sum(w * err * err),
                          np.sum(w * pred), np.sum(w * label), np.sum(w),
                          nan_inf]

    # -- merge device accumulator state -------------------------------------
    def merge_device_state(self, state) -> None:
        self._pos += np.asarray(state["pos"], np.float64)
        self._neg += np.asarray(state["neg"], np.float64)
        self._scalars += np.asarray(state["scalars"], np.float64)

    # -- final reduction (≙ compute() metrics.cc:284) -----------------------
    def compute(self) -> Dict[str, float]:
        pos, neg = self._pos, self._neg
        # trapezoid sweep from the top bucket down (metrics.cc:314-320)
        tp_cum = np.cumsum(pos[::-1])
        fp_cum = np.cumsum(neg[::-1])
        tp_prev = np.concatenate([[0.0], tp_cum[:-1]])
        fp_prev = np.concatenate([[0.0], fp_cum[:-1]])
        area = np.sum((fp_cum - fp_prev) * (tp_prev + tp_cum) / 2.0)
        fp, tp = fp_cum[-1], tp_cum[-1]
        if fp < 1e-3 or tp < 1e-3:
            auc = -0.5  # all-positive or all-negative (metrics.cc:321)
        else:
            auc = area / (fp * tp)
        size = fp + tp
        abserr, sqrerr, pred_sum, label_sum, total, nan_inf = self._scalars
        out = {
            "auc": float(auc),
            "size": float(size),
            "mae": float(abserr / size) if size else 0.0,
            "rmse": float(math.sqrt(sqrerr / size)) if size else 0.0,
            "actual_ctr": float(tp / size) if size else 0.0,
            "predicted_ctr": float(pred_sum / size) if size else 0.0,
            "bucket_error": self._bucket_error(),
            # ≙ nan_inf_rate (metrics.h:116): non-finite preds are counted
            # out of the other statistics, never bucketed
            "nan_inf_rate": float(nan_inf / (size + nan_inf))
            if (size + nan_inf) else 0.0,
        }
        return out

    def folded_buckets(self, bins: int = 50) -> "tuple[np.ndarray, np.ndarray]":
        """Fold the pos/neg bucket tables down to ``bins`` coarse buckets
        (exact counts, reduced resolution) — the compact per-pass export
        the windowed-AUC / drift monitors (metrics/quality.py) retain
        across passes without holding the 1M-bucket tables."""
        bins = max(1, int(bins))
        idx = (np.arange(self.table_size) * bins) // self.table_size
        pos = np.zeros((bins,), np.float64)
        neg = np.zeros((bins,), np.float64)
        np.add.at(pos, idx, self._pos)
        np.add.at(neg, idx, self._neg)
        return pos, neg

    def _bucket_error(self) -> float:
        """≙ calculate_bucket_error (metrics.cc:373-410): merge adjacent
        buckets until the adjusted-ctr estimate is statistically tight, then
        accumulate the relative error of actual vs adjusted ctr."""
        last_ctr = -1.0
        impression_sum = ctr_sum = click_sum = 0.0
        error_sum = error_count = 0.0
        nz = np.nonzero(self._pos + self._neg)[0]
        for i in nz:
            click = self._pos[i]
            show = self._pos[i] + self._neg[i]
            ctr = i / self.table_size
            if abs(ctr - last_ctr) > K_MAX_SPAN:
                last_ctr = ctr
                impression_sum = ctr_sum = click_sum = 0.0
            impression_sum += show
            ctr_sum += ctr * show
            click_sum += click
            adjust_ctr = ctr_sum / impression_sum
            if adjust_ctr <= 0 or adjust_ctr >= 1:
                continue
            relative_error = math.sqrt(
                (1 - adjust_ctr) / (adjust_ctr * impression_sum))
            if relative_error < K_RELATIVE_ERROR_BOUND:
                actual = click_sum / impression_sum
                error_sum += abs(actual / adjust_ctr - 1) * impression_sum
                error_count += impression_sum
                last_ctr = -1.0
        return error_sum / error_count if error_count > 0 else 0.0
