"""The numbers that decide a training cell's ``correct``.

Two trajectories over the same first steps (the program's, or the
control's, against the reference's) give:

* ``loss_gap``: the first step's |loss - reference loss| / |reference
  loss|;
* ``grad_gap``: over the leaves, the worst gap between the norms of the
  first step's gradients as the optimizers received them, measured
  against the reference's norm of that leaf or of the median leaf,
  whichever is larger (the gap of the norms, not the norm of the
  difference);
* ``change_gap``: the median over the leaves of the same gap for the
  change of every trained leaf after the last step (dense leaves from
  the drawn weights, the sparse ``embed_w`` and ``mf`` from the fresh
  rows);
* ``sparse_gap``: the sparse rows after the last step, row by row: over
  ``embed_w``, ``mf`` and their two ``g2sum`` statistics, the 99th
  percentile of the rows' gaps between the program's change from the
  fresh value and the reference's, over that field's largest change in
  the reference.  The sparse leaves sit far under the dense ones (the
  push carries the mean loss's gradient), so the two gaps above leave
  them out by ``FLOOR``, and a wrong push or rule would not move a
  median of the dense leaves; this gap sees both.  Its percentile
  passes over the few rows of the records whose gradient a flipped
  ReLU moves by some percent (the widest row's gap swings from 1e-4 to
  6e-2 with the seed, in the program and in a second float32 reference
  on the host alike); the widest is reported beside it;
* ``count_mismatch``: the rows whose exact fields after the last step
  (show, click, the embedx size, the slot) differ from the reference's.

A leaf whose reference gradient is under ``FLOOR`` of the median leaf's
is rounding noise under Adam and is left out of ``grad_gap`` and
``change_gap``.

The later steps' losses and the worst leaf's change swing from seed to
seed: rounding that flips a ReLU or the sign of a near-zero gradient
under Adam's first, normalised steps moves a leaf apart in step 2
(PERF.md gives a seed where step 3's loss differs by 1.1e-5 and the
next seed's by 1e-7).  So the first step's loss and the median leaf's
change are compared, and the three steps' worst loss gap and the worst
leaf's change are reported beside them.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

import torch

FLOOR = 1e-3
EXACT_FIELDS = ("show", "click", "mf_size", "slot")
ROW_FIELDS = ("embed_w", "mf", "embed_g2sum", "mf_g2sum")


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64)))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]
              ) -> Dict[str, float]:
    """Each leaf's gap between the norms in ``prog`` and ``ref``, against
    the reference's norm of that leaf or of the median leaf."""
    med = statistics.median(ref.values())
    gaps = {k: abs(prog[k] - r) / max(r, med) for k, r in ref.items()}
    return {k: (g if math.isfinite(g) else math.inf) for k, g in gaps.items()}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def _share(gap: float, top: float) -> float:
    """``gap`` over ``top``: 0 where neither is, infinite where only the
    gap is."""
    if not math.isfinite(gap):
        return math.inf
    if top == 0.0:
        return 0.0 if gap == 0.0 else math.inf
    return gap / top


def row_gaps(prog: torch.Tensor, ref: torch.Tensor, fresh: torch.Tensor
             ) -> Dict[str, float]:
    """Each row's gap between its change from ``fresh`` in ``prog`` and
    in ``ref`` (the widest column's), over the reference's largest change
    of a row: the 99th percentile row's (``q99``) and the widest
    (``max``)."""
    d_ref = (ref - fresh).to(torch.float64).reshape(len(ref), -1)
    d_prog = (prog.to(ref.device) - fresh).to(torch.float64
                                               ).reshape(len(ref), -1)
    if not len(ref):
        return {"q99": 0.0, "max": 0.0}
    gap = (d_prog - d_ref).abs().amax(dim=1)
    top = float(d_ref.abs().max())
    return {"q99": _share(float(torch.quantile(gap, 0.99)), top),
            "max": _share(float(gap.max()), top)}


def readings(traj: Dict, ref: Dict, init: Dict[str, torch.Tensor]
             ) -> Dict[str, float]:
    """The numbers of ``traj`` against the reference's ``ref``; ``init``
    the drawn dense weights both started from."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(traj["losses"], ref["losses"])]
    g_ref = {k: norm(v) for k, v in ref["grad1"].items()}
    med = statistics.median(g_ref.values())
    kept = [k for k, v in g_ref.items() if v >= FLOOR * med]
    grad_gap, grad_leaf = worst(leaf_gaps(
        {k: norm(traj["grad1"][k]) for k in kept},
        {k: g_ref[k] for k in kept}))

    dev = ref["sparse"]["mf"].device
    c_prog, c_ref = {}, {}
    for k in init:
        if k in kept:
            c_prog[k] = norm(traj["params"][k].to(dev) - init[k].to(dev))
            c_ref[k] = norm(ref["params"][k] - init[k].to(dev))
    for f in ("embed_w", "mf"):
        if f in g_ref and f not in kept:
            continue
        c_prog[f] = norm(traj["sparse"][f].to(dev) - ref["fresh"][f])
        c_ref[f] = norm(ref["sparse"][f] - ref["fresh"][f])
    changes = leaf_gaps(c_prog, c_ref)
    change_worst, change_leaf = worst(changes)

    rows = {f: row_gaps(traj["sparse"][f], ref["sparse"][f],
                        ref["fresh"][f]) for f in ROW_FIELDS}
    sparse_gap, sparse_field = worst({f: r["q99"] for f, r in rows.items()})

    bad = torch.zeros(len(ref["keys"]), dtype=torch.bool, device=dev)
    for f in EXACT_FIELDS:
        bad |= traj["sparse"][f].to(dev) != ref["sparse"][f]
    return {"loss_gap": losses[0], "grad_gap": grad_gap,
            "change_gap": statistics.median(changes.values()),
            "sparse_gap": sparse_gap, "count_mismatch": int(bad.sum()),
            "_sparse_field": sparse_field,
            "_sparse_max": max(r["max"] for r in rows.values()),
            "_loss_gap_steps": max(losses), "_change_worst": change_worst,
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf,
            "_left_out": sorted(set(g_ref) - set(kept))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` and each compared number beside its limit (every
    limit the configuration states must have its number)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks


def unchanged(ref: Dict, init: Dict[str, torch.Tensor]) -> Dict:
    """The trajectory of a step that returns its state unchanged: the
    worst leaf's change gap then reads 1, the median leaf's about 1, the
    widest sparse row's 1, and every touched row's counts differ."""
    return {"losses": ref["losses"], "grad1": ref["grad1"],
            "params": {k: v.clone() for k, v in init.items()},
            "sparse": dict(ref["fresh"])}

