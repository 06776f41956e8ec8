"""Streaming AUC / calibration metrics.

Port of ``paddlebox_tpu/metrics/auc.py`` (≙ BasicAucCalculator,
fleet/metrics.h:46, metrics.cc:284-410): bucket accumulation runs on the
device inside the train step (``accumulate_auc``, ≙ mode_collect_in_gpu,
box_wrapper.h:787) into tensors that live beside the working set; the
final ``AucCalculator.compute()`` is the host-side numpy reduction over
the bucket tables, copied from the JAX package.  The per-user AUC family
(``WuAucCalculator``) and the metric registry (``MetricGroup``) are host
numpy, copied too; ``MetricGroup.merge_device_state`` takes the port's
torch bucket state.  Not ported: ``allreduce_auc_state`` (it needs the PS
service's client).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

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


class WuAucCalculator:
    """Per-user AUC family — uauc (mean of per-user AUCs) and wuauc
    (instance-weighted mean), ≙ WuAucMetricMsg + computeWuAuc /
    computeSingelUserAuc (metrics.h:287, metrics.cc:501-587).

    The reference sorts a record vector and walks each user's ROC with a
    tie-merging loop; here per-user AUC is the Mann-Whitney statistic
    with average ranks for pred ties (identical to the tie-merged
    trapezoid — tests diff against a transliteration of the reference
    loop), computed with vectorized lexsort + segment cumsums over ALL
    users at once.  Single-class users are skipped
    exactly like the reference's auc == -1 branch."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._uid: List[np.ndarray] = []
        self._pred: List[np.ndarray] = []
        self._label: List[np.ndarray] = []
        self._nan_inf = 0.0
        self._out_of_range = 0.0

    def add_data(self, pred, label, uid, mask=None) -> None:
        pred = np.asarray(pred, np.float64)
        label = np.asarray(label, np.int64)
        uid = np.asarray(uid, np.uint64)
        if mask is not None:
            keep = np.asarray(mask, bool)
            pred, label, uid = pred[keep], label[keep], uid[keep]
        # same invariant as AucCalculator: non-finite preds are counted,
        # never ranked (a NaN would lexsort to the top rank and inflate
        # the diverging model's per-user AUC)
        finite = np.isfinite(pred)
        if not finite.all():
            self._nan_inf += float((~finite).sum())
            pred, label, uid = pred[finite], label[finite], uid[finite]
        # keep preds UNCLIPPED for ranking: the Mann-Whitney statistic only
        # needs order, and clipping would collapse out-of-range preds into
        # artificial ties at 0/1 and shift per-user AUC.  NOTE the
        # reference does NOT rank raw out-of-range preds — its
        # add_uid_unlock_data PADDLE_ENFORCEs pred in [0,1] and rejects
        # the record outright; a non-sigmoid head violates that
        # precondition silently here, so count the violations (surfaced as
        # out_of_range_rate) the way _nan_inf tracks non-finite preds.
        self._out_of_range += float(((pred < 0.0) | (pred > 1.0)).sum())
        self._pred.append(pred)
        self._label.append(label)
        self._uid.append(uid)

    def compute(self) -> Dict[str, float]:
        if not self._pred or not sum(len(p) for p in self._pred):
            return {"uauc": 0.0, "wuauc": 0.0, "user_cnt": 0.0,
                    "size": 0.0, "nan_inf_rate": 1.0 if self._nan_inf
                    else 0.0, "out_of_range_rate": 1.0
                    if self._out_of_range else 0.0}
        pred = np.concatenate(self._pred)
        label = np.concatenate(self._label)
        uid = np.concatenate(self._uid)
        order = np.lexsort((pred, uid))
        u, p, l = uid[order], pred[order], label[order]
        n = len(u)
        new_user = np.empty(n, bool)
        new_user[0] = True
        np.not_equal(u[1:], u[:-1], out=new_user[1:])
        user_id = np.cumsum(new_user) - 1
        n_users = int(user_id[-1]) + 1
        first = np.nonzero(new_user)[0]
        pos_in_user = np.arange(n) - first[user_id] + 1    # 1-based rank
        # pred-tie groups within a user share the AVERAGE rank
        new_grp = new_user | np.concatenate([[True], p[1:] != p[:-1]])
        gid = np.cumsum(new_grp) - 1
        cnt_g = np.bincount(gid)
        avg_rank = np.bincount(gid, weights=pos_in_user) / cnt_g
        rank = avg_rank[gid]

        cnt_u = np.bincount(user_id, minlength=n_users).astype(np.float64)
        npos = np.bincount(user_id, weights=l, minlength=n_users)
        nneg = cnt_u - npos
        pos_rank_sum = np.bincount(user_id, weights=rank * l,
                                   minlength=n_users)
        ok = (npos > 0) & (nneg > 0)
        auc_u = np.zeros(n_users)
        auc_u[ok] = (pos_rank_sum[ok] - npos[ok] * (npos[ok] + 1) / 2.0) \
            / (npos[ok] * nneg[ok])
        user_cnt = float(ok.sum())
        size = float(cnt_u[ok].sum())
        return {
            "uauc": float(auc_u[ok].sum() / max(user_cnt, 1.0)),
            "wuauc": float((auc_u[ok] * cnt_u[ok]).sum() / max(size, 1.0)),
            "user_cnt": user_cnt, "size": size,
            "nan_inf_rate": float(
                self._nan_inf / (n + self._nan_inf)) if self._nan_inf
            else 0.0,
            # ranked records whose pred violates the reference's [0,1]
            # precondition (they ARE still ranked — see add_data)
            "out_of_range_rate": float(self._out_of_range / n)
            if self._out_of_range else 0.0,
        }


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


class MetricGroup:
    """Named metric registry with phase filtering (≙ BoxWrapper metric maps,
    box_wrapper.h:769-792: InitMetric/UpdateMetric/GetMetricMsg; phases are
    the join/update pass flip, ≙ FlipPhase box_wrapper.h:805)."""

    def __init__(self):
        self._metrics: Dict[str, Dict] = {}
        self.phase = 1  # 1 = join, 0 = update (reference convention)

    def init_metric(self, name: str, label_var: str = "label",
                    pred_var: str = "prob", phase: int = -1,
                    cmatch_rank_group: str = "", ignore_rank: bool = False,
                    table_size: int = TABLE_SIZE,
                    metric_type: str = "auc",
                    uid_var: str = "",
                    multitask_group: str = "") -> None:
        """cmatch_rank_group: "222:1,223:2" keeps records whose
        (cmatch, rank) is listed; "222,223" (or ignore_rank) filters on
        cmatch only (≙ CmatchRankAucCalculator / MetricMsg variants,
        metrics.h:204+).  metric_type "wuauc" registers the per-user AUC
        family instead (≙ WuAucMetricMsg, metrics.h:287) — update() then
        requires uid.  metric_type "multi_task" (≙ MultiTaskMetricMsg,
        metrics.h:327): multitask_group maps (cmatch, rank) pairs
        ("222_0,223_0") to pred COLUMNS — each instance scores with the
        task column its cmatch selects, into one shared calculator."""
        if metric_type not in ("auc", "wuauc", "multi_task"):
            raise ValueError(f"unknown metric_type {metric_type!r}")
        task_pairs = []
        if metric_type == "multi_task":
            for tok in multitask_group.split(","):
                tok = tok.strip()
                if not tok:
                    continue
                parts = tok.split("_")
                if len(parts) != 2:
                    raise ValueError(
                        f"multitask_group token {tok!r}: expected "
                        "'cmatch_rank' (e.g. '222_0')")
                task_pairs.append((int(parts[0]), int(parts[1])))
            if not task_pairs:
                raise ValueError(
                    "metric_type='multi_task' needs multitask_group "
                    "(e.g. '222_0,223_0' — one cmatch_rank per pred "
                    "column)")
        elif multitask_group:
            raise ValueError(
                "multitask_group is only meaningful with "
                "metric_type='multi_task'")
        pairs = []
        for tok in cmatch_rank_group.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if ":" in tok and not ignore_rank:
                c, r = tok.split(":")
                pairs.append((int(c), int(r)))
            else:
                pairs.append((int(tok.split(":")[0]), None))
        self._metrics[name] = {
            "calc": (WuAucCalculator() if metric_type == "wuauc"
                     else AucCalculator(table_size)),
            "type": metric_type, "uid_var": uid_var,
            "label_var": label_var, "pred_var": pred_var, "phase": phase,
            "cmatch_rank": pairs, "task_pairs": task_pairs,
        }

    def flip_phase(self) -> None:
        self.phase = 1 - self.phase

    def active(self) -> List[str]:
        return [n for n, m in self._metrics.items()
                if m["phase"] in (-1, self.phase)]

    def update(self, name: str, pred, label, mask=None,
               cmatch=None, rank=None, uid=None) -> None:
        """mask/cmatch/rank filtering (≙ add_mask_data metrics.cc:164 and
        the cmatch_rank MetricMsg update loop)."""
        m = self._metrics[name]
        pred = np.asarray(pred)
        keep = np.ones(len(pred), bool) if mask is None else \
            np.asarray(mask, bool).copy()
        if m["cmatch_rank"]:
            cm = np.asarray(cmatch) if cmatch is not None else \
                np.zeros(len(pred), np.int64)
            rk = np.asarray(rank) if rank is not None else \
                np.zeros(len(pred), np.int64)
            sel = np.zeros(len(pred), bool)
            for c, r in m["cmatch_rank"]:
                sel |= (cm == c) if r is None else ((cm == c) & (rk == r))
            keep &= sel
        if m.get("type") == "wuauc":
            if uid is None:
                raise ValueError(
                    f"metric {name!r} is wuauc — update() requires uid")
            m["calc"].add_data(pred, label, uid, keep)
        elif m.get("type") == "multi_task":
            # each instance scores with the pred COLUMN its (cmatch, rank)
            # selects (first match, ≙ the std::find loop metrics.h:394);
            # unmatched instances are skipped
            if pred.ndim != 2 or cmatch is None:
                raise ValueError(
                    f"metric {name!r} is multi_task — update() needs "
                    "pred [B, T] and cmatch")
            if len(m["task_pairs"]) > pred.shape[1]:
                raise ValueError(
                    f"metric {name!r}: {len(m['task_pairs'])} multitask "
                    f"pairs but pred has only {pred.shape[1]} columns")
            cm = np.asarray(cmatch)
            rk = (np.asarray(rank) if rank is not None
                  else np.zeros(len(cm), np.int64))
            sel = np.full(pred.shape[0], -1, np.int64)
            for t, (c, r) in enumerate(m["task_pairs"]):
                hit = (cm == c) & (rk == r) & (sel < 0)
                sel[hit] = t
            pick = (sel >= 0) & keep
            m["calc"].add_data(pred[np.nonzero(pick)[0], sel[pick]],
                               np.asarray(label)[pick])
        else:
            m["calc"].add_data(pred, label, keep)

    def merge_device_state(self, name: str, state) -> None:
        """``state``: the port's device bucket state (torch tensors on
        any device) or its numpy copy."""
        m = self._metrics[name]
        if m.get("type") == "wuauc":
            raise ValueError(
                f"metric {name!r} is wuauc — it accumulates host-side "
                "(uid, label, pred) records, not device bucket tables; "
                "feed it via update(..., uid=...).  Cross-worker "
                "aggregation needs the records gathered (variable "
                "length), which the fixed-shape PS allreduce does not "
                "carry — compute wuauc per worker or gather records "
                "upstream")
        m["calc"].merge_device_state(
            {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else v) for k, v in state.items()})

    def calculator(self, name: str) -> "AucCalculator | WuAucCalculator":
        return self._metrics[name]["calc"]

    def get_metric_msg(self, name: str) -> Dict[str, float]:
        return self._metrics[name]["calc"].compute()

    def reset(self, name: Optional[str] = None) -> None:
        for n, m in self._metrics.items():
            if name is None or n == name:
                m["calc"].reset()
