"""Bounded-memory streaming sketches for key-space heat telemetry.

The obs stack observes *time* and *verbs* (histograms, spans, flight
events, the timeline); nothing observes the *key space* — yet the whole
design is a bet on zipf skew (a tiny hot set dominates traffic, which is
why an HBM row cache over an SSD tier works at all).  This module is the
measurement substrate: streaming summaries of key frequency, heavy
hitters, distinct counts and per-shard load that are

* **bounded** — memory is fixed at construction, independent of stream
  length or key cardinality (the whole point: per-key dicts in obs code
  are banned by lint rule PB208);
* **mergeable** — every sketch has a ``raw()`` wire form and a
  ``from_raw([...])`` bucket-wise fold, the exact Histogram.raw
  discipline, so the supervisor merges per-worker sketches into one
  fleet-global view instead of taking a statistically-wrong max;
* **decayable** — ``decay(f)`` scales counts at day boundaries like
  every other day-scale score (show_click_decay), so "hot" means *hot
  lately*, not hot-ever.

Error bounds (documented contract, pinned by tests/test_heat.py):

* :class:`CountMinSketch` (width ``w``, depth ``d``): estimates never
  under-count; over-count ≤ (e/w)·N with probability ≥ 1 − e^(−d) for a
  stream of N total increments (classic CM bound; rows are indexed by
  splitmix64 mixing rather than a formal 2-universal family, so the
  bound is the design target and the zipf-stream test pins the actual
  behaviour).  Default 2048×4 ≈ 64 KB per sketch; ε ≈ 0.0013.
* :class:`SpaceSaving` (capacity ``k``): every key with true count
  > N/k is monitored; a monitored key's count over-estimates its true
  count by at most its recorded ``err`` ≤ min-count ≤ N/k.  Merging two
  sketches sums counts key-wise and re-truncates, so merged error grows
  to at most ε_a + ε_b (merge(a, b) agrees with streaming a++b within
  those bounds — associativity is tested, not assumed).
* :class:`HyperLogLog` (precision ``p``): distinct-count standard error
  ≈ 1.04/√(2^p) (~1.6 % at the default p=12, 4 KB).  A distinct count
  cannot decay; ``decay()`` resets it, so working-set estimates read
  "since the last day boundary" by contract.
* :class:`ShardLoad`: exact per-shard key counters (bounded by the
  fleet size); ``imbalance()`` = max shard load / mean shard load
  (1.0 = perfectly even, n = everything on one shard).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray, salt: np.uint64) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (vectorized, wrapping)."""
    z = (x.astype(np.uint64, copy=False) + salt).astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def _row_salt(seed: int, row: int) -> np.uint64:
    """Per-row salt: splitmix64 of (seed, row) so depth rows index
    (near-)independently."""
    base = np.uint64((seed * 1_000_003 + row + 1) & 0xFFFFFFFFFFFFFFFF)
    return _mix64(np.array([base], np.uint64), _GOLDEN)[0]


def unique_with_counts(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(unique uint64 keys, float64 counts) of one observation batch —
    the canonical sketch-update input (taps pass raw key arrays)."""
    keys = np.asarray(keys, np.uint64).ravel()
    if not len(keys):
        return keys, np.zeros((0,), np.float64)
    uniq, counts = np.unique(keys, return_counts=True)
    return uniq, counts.astype(np.float64)


class CountMinSketch:
    """Conservative frequency estimator: ``depth`` rows of ``width``
    float counters; a key increments one counter per row, estimates take
    the row-wise min.  Float cells so day-boundary decay is exact."""

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0):
        self.width = max(8, int(width))
        self.depth = max(1, int(depth))
        self.seed = int(seed)
        self._salts = [_row_salt(self.seed, d) for d in range(self.depth)]
        self.counts = np.zeros((self.depth, self.width), np.float64)
        self.total = 0.0

    def nbytes(self) -> int:
        return int(self.counts.nbytes)

    def _rows(self, keys: np.ndarray) -> List[np.ndarray]:
        w = np.uint64(self.width)
        return [(_mix64(keys, s) % w).astype(np.int64) for s in self._salts]

    def update(self, keys: np.ndarray,
               counts: Optional[np.ndarray] = None) -> None:
        keys = np.asarray(keys, np.uint64).ravel()
        if not len(keys):
            return
        if counts is None:
            counts = np.ones((len(keys),), np.float64)
        counts = np.asarray(counts, np.float64)
        for d, idx in enumerate(self._rows(keys)):
            np.add.at(self.counts[d], idx, counts)
        self.total += float(counts.sum())

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        """Row-wise-min estimates for ``keys`` (float64, ≥ true count up
        to decay; ≤ true + εN w.h.p.)."""
        keys = np.asarray(keys, np.uint64).ravel()
        if not len(keys):
            return np.zeros((0,), np.float64)
        est = None
        for d, idx in enumerate(self._rows(keys)):
            row = self.counts[d][idx]
            est = row if est is None else np.minimum(est, row)
        return est

    def epsilon(self) -> float:
        """The documented per-estimate over-count bound as a fraction of
        stream weight: e/width."""
        return math.e / self.width

    def decay(self, factor: float) -> None:
        f = float(factor)
        self.counts *= f
        self.total *= f

    def merge(self, other: "CountMinSketch") -> None:
        if (other.width, other.depth, other.seed) != \
                (self.width, self.depth, self.seed):
            raise ValueError("count-min geometry/seed mismatch")
        self.counts += other.counts
        self.total += other.total

    def raw(self) -> Dict:
        """Mergeable wire form (geometry + dense rounded cells; a 2048×4
        sketch is ~8 K numbers — one scrape, not a hot path)."""
        return {"w": self.width, "d": self.depth, "s": self.seed,
                "t": self.total,
                "c": [[round(float(v), 3) for v in row]
                      for row in self.counts]}

    @classmethod
    def from_raw(cls, raws: Sequence[Dict]) -> "CountMinSketch":
        """Cell-wise sum of many ``raw()`` exports (identical geometry
        required — the Histogram.from_raw discipline)."""
        raws = [r for r in raws if r]
        if not raws:
            return cls()
        first = raws[0]
        out = cls(width=int(first.get("w", 2048)),
                  depth=int(first.get("d", 4)),
                  seed=int(first.get("s", 0)))
        for r in raws:
            if (int(r.get("w", 0)), int(r.get("d", 0))) \
                    != (out.width, out.depth):
                continue        # foreign geometry: skip, never corrupt
            out.counts += np.asarray(r.get("c", ()), np.float64) \
                .reshape(out.depth, out.width)
            out.total += float(r.get("t", 0.0))
        return out


class SpaceSaving:
    """Top-K heavy hitters (Metwally et al.): at most ``k`` monitored
    keys; an unmonitored arrival evicts the current minimum and inherits
    its count as ``err``.  Batched updates take (unique keys, counts);
    a batch is sequentialized in ascending (count, key) order, which
    turns the eviction heap into a two-pointer merge (see ``update``) —
    O(k log k + u log u) per batch, and keys that do not survive the
    batch never touch the monitored dicts."""

    def __init__(self, k: int = 512):
        self.k = max(1, int(k))
        self._counts: Dict[int, float] = {}
        self._errs: Dict[int, float] = {}
        self.total = 0.0

    def __len__(self) -> int:
        return len(self._counts)

    def update(self, keys: np.ndarray,
               counts: Optional[np.ndarray] = None) -> None:
        keys = np.asarray(keys, np.uint64).ravel()
        if not len(keys):
            return
        if counts is None:
            counts = np.ones((len(keys),), np.float64)
        counts = np.asarray(counts, np.float64).ravel()
        self.total += float(counts.sum())
        cd, ed = self._counts, self._errs
        # Any sequentialization of a batch is a valid SpaceSaving run;
        # ours: monitored-key increments first, then unmonitored keys in
        # ascending (count, key) order.
        if cd:
            tracked = np.fromiter(cd.keys(), np.uint64, len(cd))
            hit = np.isin(keys, tracked)
            for key, c in zip(keys[hit].tolist(), counts[hit].tolist()):
                cd[key] += c
            miss = ~hit
            miss_k = keys[miss]
            miss_c = counts[miss]
        else:
            miss_k = keys
            miss_c = counts
        if not len(miss_k):
            return
        # stable by count == (count, key) order for the canonical taps
        # (unique_with_counts emits keys ascending); any input order is
        # a valid sequentialization regardless
        order = np.argsort(miss_c, kind="stable")
        miss_k = miss_k[order]
        miss_c = miss_c[order]
        free = self.k - len(cd)
        if free > 0:
            for key, c in zip(miss_k[:free].tolist(),
                              miss_c[:free].tolist()):
                cd[key] = c
                ed[key] = 0.0
            miss_k = miss_k[free:]
            miss_c = miss_c[free:]
        m_n = len(miss_k)
        if not m_n:
            return
        # Eviction cascade.  In ascending order the popped minima are
        # non-decreasing and each newcomer re-enters at min + c, also
        # non-decreasing — so the "heap" is exactly a two-pointer merge
        # of the sorted monitored counts with the FIFO of newcomers,
        # and keys that do not survive the batch never touch the dicts.
        base = sorted((c, key) for key, c in cd.items())
        a_c = np.asarray([c for c, _ in base], np.float64)
        a_k = [key for _, key in base]
        na = len(a_k)
        q = np.empty(m_n, np.float64)   # newcomer counts, creation order
        qe = np.empty(m_n, np.float64)  # inherited minima (err bounds)
        ai = 0      # originals popped
        qi = 0      # newcomers popped
        pos = 0     # newcomers created (== ai + qi: one per eviction)
        while pos < m_n:
            if ai < na and (qi >= pos or a_c[ai] <= q[qi]):
                m = float(a_c[ai])          # next min is an original
                ai += 1
                q[pos] = m + miss_c[pos]
                qe[pos] = m
                pos += 1
                continue
            # Next min is a newcomer: with `live` entries queued the
            # cascade is the lag-`live` recurrence q[n] = q[n-live]+c[n],
            # vectorizable until an original out-competes the front.
            live = pos - qi
            take = min(live, m_n - pos)
            if ai < na:
                take = min(take, int(np.searchsorted(
                    q[qi:qi + take], a_c[ai], side="left")))
            block = q[qi:qi + take]
            q[pos:pos + take] = block + miss_c[pos:pos + take]
            qe[pos:pos + take] = block
            qi += take
            pos += take
        for key in a_k[:ai]:       # originals evicted by the cascade
            del cd[key]
            ed.pop(key, None)
        for key, c, e in zip(miss_k[qi:].tolist(), q[qi:].tolist(),
                             qe[qi:].tolist()):
            cd[key] = c            # newcomers that survived the cascade
            ed[key] = e

    def top(self, n: Optional[int] = None) -> List[Tuple[int, float, float]]:
        """[(key, est_count, err)] sorted by est_count desc."""
        items = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if n is not None:
            items = items[:max(0, int(n))]
        return [(key, c, self._errs.get(key, 0.0)) for key, c in items]

    def topk_share(self, n: Optional[int] = None) -> float:
        """Fraction of total stream weight attributed to the top-``n``
        monitored keys (the skew headline: ~1.0 = hot set dominates)."""
        if self.total <= 0:
            return 0.0
        top = self.top(n)
        return min(1.0, sum(c for _, c, _ in top) / self.total)

    def decay(self, factor: float) -> None:
        f = float(factor)
        self._counts = {key: c * f for key, c in self._counts.items()}
        self._errs = {key: e * f for key, e in self._errs.items()}
        self.total *= f

    def merge(self, other: "SpaceSaving") -> None:
        """Key-wise count/err sum over the union, truncated back to the
        larger capacity — merged error ≤ ε_self + ε_other."""
        for key, c in other._counts.items():
            if key in self._counts:
                self._counts[key] += c
                self._errs[key] = self._errs.get(key, 0.0) \
                    + other._errs.get(key, 0.0)
            else:
                self._counts[key] = c
                self._errs[key] = other._errs.get(key, 0.0)
        self.total += other.total
        self.k = max(self.k, other.k)
        if len(self._counts) > self.k:
            keep = sorted(self._counts.items(),
                          key=lambda kv: (-kv[1], kv[0]))[:self.k]
            kept = {key for key, _ in keep}
            self._counts = {key: c for key, c in keep}
            self._errs = {key: e for key, e in self._errs.items()
                          if key in kept}

    def raw(self) -> Dict:
        return {"k": self.k, "t": self.total,
                "c": {str(key): round(c, 3)
                      for key, c in self._counts.items()},
                "e": {str(key): round(e, 3)
                      for key, e in self._errs.items() if e}}

    @classmethod
    def from_raw(cls, raws: Sequence[Dict]) -> "SpaceSaving":
        raws = [r for r in raws if r]
        out = cls(k=max([int(r.get("k", 1)) for r in raws] or [1]))
        for r in raws:
            part = cls(k=out.k)
            part._counts = {int(key): float(c)
                            for key, c in (r.get("c") or {}).items()}
            part._errs = {int(key): float(e)
                          for key, e in (r.get("e") or {}).items()}
            part.total = float(r.get("t", 0.0))
            out.merge(part)
        return out


class HyperLogLog:
    """Distinct-count estimator: 2^p byte registers, register = max
    leading-zero rank of hashed keys routed to it.  Merge = register-wise
    max (exact).  No decay — day boundaries reset it."""

    def __init__(self, p: int = 12, seed: int = 0):
        self.p = min(18, max(4, int(p)))
        self.m = 1 << self.p
        self.seed = int(seed)
        self._salt = _row_salt(self.seed, 97)
        self.regs = np.zeros((self.m,), np.uint8)

    def nbytes(self) -> int:
        return int(self.regs.nbytes)

    def update(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint64).ravel()
        if not len(keys):
            return
        h = _mix64(keys, self._salt)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (h << np.uint64(self.p)) | np.uint64((1 << self.p) - 1)
        # rank = leading zeros of the remaining 64-p bits, + 1
        lz = np.uint64(64) - np.uint64(1) \
            - np.floor(np.log2(rest.astype(np.float64))).astype(np.uint64)
        rank = np.minimum(lz + np.uint64(1),
                          np.uint64(64 - self.p)).astype(np.uint8)
        np.maximum.at(self.regs, idx, rank)

    def estimate(self) -> float:
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        inv = float(np.sum(np.power(2.0, -self.regs.astype(np.float64))))
        e = alpha * m * m / inv
        if e <= 2.5 * m:                      # small-range: linear counting
            zeros = int(np.count_nonzero(self.regs == 0))
            if zeros:
                return m * math.log(m / zeros)
        return e

    def reset(self) -> None:
        self.regs[:] = 0

    def merge(self, other: "HyperLogLog") -> None:
        if other.p != self.p or other.seed != self.seed:
            raise ValueError("hyperloglog precision/seed mismatch")
        np.maximum(self.regs, other.regs, out=self.regs)

    def raw(self) -> Dict:
        nz = np.nonzero(self.regs)[0]
        return {"p": self.p, "s": self.seed,
                "r": {str(int(i)): int(self.regs[i]) for i in nz}}

    @classmethod
    def from_raw(cls, raws: Sequence[Dict]) -> "HyperLogLog":
        raws = [r for r in raws if r]
        if not raws:
            return cls()
        out = cls(p=int(raws[0].get("p", 12)), seed=int(raws[0].get("s", 0)))
        for r in raws:
            if int(r.get("p", 0)) != out.p:
                continue
            for i, v in (r.get("r") or {}).items():
                idx = int(i)
                if 0 <= idx < out.m:
                    out.regs[idx] = max(out.regs[idx], int(v))
        return out


class ShardLoad:
    """Exact per-shard load accumulator (bounded by fleet size).
    ``imbalance()`` is the skew headline the resize decision reads."""

    def __init__(self, n: int = 0):
        self.loads = np.zeros((max(0, int(n)),), np.float64)

    def _ensure(self, n: int) -> None:
        if n > len(self.loads):
            grown = np.zeros((n,), np.float64)
            grown[:len(self.loads)] = self.loads
            self.loads = grown

    def add(self, shard: int, weight: float) -> None:
        shard = int(shard)
        self._ensure(shard + 1)
        self.loads[shard] += float(weight)

    def imbalance(self) -> float:
        """max shard load / mean shard load over shards that exist
        (1.0 = even; n = single-shard hotspot; 0.0 = no traffic yet)."""
        if not len(self.loads):
            return 0.0
        total = float(self.loads.sum())
        if total <= 0:
            return 0.0
        mean = total / len(self.loads)
        return float(self.loads.max()) / mean

    def shares(self) -> List[float]:
        total = float(self.loads.sum())
        if total <= 0:
            return [0.0] * len(self.loads)
        return [round(float(v) / total, 6) for v in self.loads]

    def decay(self, factor: float) -> None:
        self.loads *= float(factor)

    def merge(self, other: "ShardLoad") -> None:
        self._ensure(len(other.loads))
        self.loads[:len(other.loads)] += other.loads

    def raw(self) -> Dict:
        return {"l": [round(float(v), 3) for v in self.loads]}

    @classmethod
    def from_raw(cls, raws: Sequence[Dict]) -> "ShardLoad":
        out = cls()
        for r in raws:
            if not r:
                continue
            part = cls()
            part.loads = np.asarray(r.get("l", ()), np.float64)
            out.merge(part)
        return out


def fit_zipf_exponent(counts: Sequence[float]) -> float:
    """Least-squares slope of log(count) vs log(rank) over a sorted-desc
    count sequence → the zipf exponent estimate ``s`` in count ∝ rank^-s
    (the benches synthesize at s=1.3; /heatz reports what traffic
    actually shows).  0.0 when fewer than 3 positive counts."""
    c = [float(v) for v in counts if float(v) > 0]
    if len(c) < 3:
        return 0.0
    x = np.log(np.arange(1, len(c) + 1, dtype=np.float64))
    y = np.log(np.asarray(sorted(c, reverse=True), np.float64))
    xm, ym = x.mean(), y.mean()
    denom = float(((x - xm) ** 2).sum())
    if denom <= 0:
        return 0.0
    slope = float(((x - xm) * (y - ym)).sum()) / denom
    return round(max(0.0, -slope), 4)


# -- the heat wire schema (one process's mergeable heat state) ---------------
# {"sites": {site: {"cm":…, "tk":…, "hll":…}}, "loads":…, "cache": [h, m]}
# Merging lives HERE (pure sketch math, no ps dependency) so the
# supervisor-side merge_snapshots fold and ps/heat.py publish the SAME
# derived gauges from the same fold — "fleet heat == per-worker sketch
# merge" by construction, never a naive max.

def merge_heat_raw(raws: Sequence[Dict]) -> Dict:
    """Fold many per-process heat exports bucket-wise into one."""
    raws = [r for r in raws if isinstance(r, dict)]
    sites: Dict[str, Dict] = {}
    names = sorted({n for r in raws for n in (r.get("sites") or {})})
    for name in names:
        parts = [r["sites"][name] for r in raws
                 if name in (r.get("sites") or {})]
        sites[name] = {
            "cm": CountMinSketch.from_raw(
                [p.get("cm") for p in parts]).raw(),
            "tk": SpaceSaving.from_raw([p.get("tk") for p in parts]).raw(),
            "hll": HyperLogLog.from_raw(
                [p.get("hll") for p in parts]).raw(),
        }
    loads = ShardLoad.from_raw([r.get("loads") or {} for r in raws])
    cache = [0.0, 0.0]
    for r in raws:
        c = r.get("cache") or (0.0, 0.0)
        cache[0] += float(c[0])
        cache[1] += float(c[1])
    return {"sites": sites, "loads": loads.raw(), "cache": cache}


def heat_gauges_from_raw(raw: Dict, topn: int = 100) -> Dict[str, float]:
    """The derived heat gauges from one (possibly merged) heat export —
    the single formula both ps/heat.py and the cluster merge publish."""
    sites = raw.get("sites") or {}
    pull = sites.get("pull") or {}
    tk = SpaceSaving.from_raw([pull.get("tk")]) if pull else SpaceSaving()
    hll = HyperLogLog.from_raw([pull.get("hll")]) if pull else HyperLogLog()
    loads = ShardLoad.from_raw([raw.get("loads") or {}])
    hits, misses = (list(raw.get("cache") or (0.0, 0.0)) + [0.0, 0.0])[:2]
    denom = float(hits) + float(misses)
    return {
        "heat.topk_share": round(tk.topk_share(topn), 6),
        "heat.shard_imbalance": round(loads.imbalance(), 6),
        "heat.working_set_rows": round(hll.estimate(), 1)
        if pull else 0.0,
        "heat.cache_hot_coverage":
            round(float(hits) / denom, 6) if denom > 0 else 0.0,
    }
