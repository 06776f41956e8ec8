"""Reading a torch.profiler Chrome trace: the device's busy time, the
time of kernels by name, and the idle gaps between device operations.

Only the events inside the host annotation that marks the traced
stretch (``STRETCH``) count, clipped to it.  Device operations are the
events of the trace categories in ``DEVICE_CATS``; the stretch's window
is the annotation's own length, which ends after a synchronize, so every
device operation of the stretch lies inside it.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, List, Optional, Tuple

STRETCH = "portbench.stretch"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}

Interval = Tuple[float, float]


def union_length(intervals: Iterable[Interval]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class TraceView:
    """The stretch of one trace: times in microseconds on the trace's
    clock."""

    def __init__(self, events: List[Dict], stretch: str = STRETCH):
        marks = [e for e in events if e.get("name") == stretch
                 and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        if len(marks) != 1:
            raise ValueError(f"{len(marks)} '{stretch}' annotations in the "
                             "trace, want 1")
        m = marks[0]
        self.lo = float(m["ts"])
        self.hi = self.lo + float(m["dur"])
        self.host_tid = m.get("tid")
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            t = s + float(e["dur"])
            if t <= self.lo or s >= self.hi:
                continue
            s, t = max(s, self.lo), min(t, self.hi)
            if e.get("cat") in DEVICE_CATS:
                self.device.append((e["name"], s, t))
            elif e.get("cat") in HOST_CATS and e.get("tid") == self.host_tid \
                    and e["name"] != stretch:
                self.host.append((e["name"], s, t))
        self.device.sort(key=lambda x: x[1])
        self.host.sort(key=lambda x: x[1])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_length((s, t) for _, s, t in self.device) * 1e-6

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(t - s for n, s, t in self.device if match(n)) * 1e-6

    def launches(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def top_ops(self, k: int = 10) -> List[List]:
        """The ``k`` device operations that took the most time, summed by
        name: [[name, seconds], ...]."""
        by: Dict[str, float] = {}
        for n, s, t in self.device:
            by[n] = by.get(n, 0.0) + (t - s)
        top = sorted(by.items(), key=lambda x: -x[1])[:k]
        return [[n, v * 1e-6] for n, v in top]

    def host_op_at(self, t: float) -> Optional[str]:
        """The innermost host operation of the stretch's thread open at
        ``t`` (the latest-starting one that covers it)."""
        starts = [s for _, s, _ in self.host]
        i = bisect.bisect_right(starts, t)
        best = None
        for n, s, e in reversed(self.host[max(0, i - 256):i]):
            if s <= t < e:
                best = n
                break
        return best

    def idle_gaps(self, k: int = 10,
                  name_at: Optional[Callable[[float], str]] = None
                  ) -> List[List]:
        """The ``k`` longest gaps with no device operation running,
        [[name, seconds], ...], each named by ``name_at(start)`` (by
        default the host operation open when the gap began)."""
        name_at = name_at or (lambda t: self.host_op_at(t) or "(no host op)")
        g = gaps([(s, t) for _, s, t in self.device], self.lo, self.hi)
        g.sort(key=lambda x: -(x[1] - x[0]))
        return [[name_at(s), (e - s) * 1e-6] for s, e in g[:k]]
