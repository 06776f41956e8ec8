"""Shared retry backoff policy — exponential growth, jitter, deadline budget.

Every retry loop in the package sleeps through this helper instead of a
fixed ``time.sleep(const)`` (lint rule PB501, tools/pboxlint/retries.py):
a fixed sleep retries in lockstep under contention and has no overall
bound, while this policy doubles the nominal delay per attempt up to a
cap, jitters each sleep into ``[0.5, 1.0) * nominal`` so a fleet of
clients decorrelates, and charges everything against one deadline budget
so a caller can say "this verb gets 30 s total, however many attempts
that is" (≙ the reference's retry-then-fail discipline,
ps_gpu_wrapper.cc:388-419, upgraded from count-bounded to time-bounded).
"""

from __future__ import annotations

import random
import time
from typing import Optional

from paddlebox_tpu_torch.utils import flight


class Backoff:
    """One retry episode: ``delay(attempt)`` is the pure policy math
    (unit-testable, deterministic under ``seed``), ``sleep(attempt)``
    applies it against the deadline and returns False once the budget is
    spent — the caller's signal to stop retrying and raise."""

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 deadline: Optional[float] = None,
                 seed: Optional[int] = None):
        self.base = float(base)
        self.cap = float(cap)
        self._rng = random.Random(seed)
        self._t0 = time.monotonic()
        self.deadline = None if deadline is None else float(deadline)

    def remaining(self) -> Optional[float]:
        """Seconds left in the budget (None = unbounded)."""
        if self.deadline is None:
            return None
        return self.deadline - (time.monotonic() - self._t0)

    def reset(self) -> None:
        """Restart the episode clock after PROGRESS: a long pipelined
        transfer that keeps landing frames between reconnects should
        measure its deadline from the last success, not from the first
        attempt — only sustained lack of progress exhausts the budget."""
        self._t0 = time.monotonic()

    def delay(self, attempt: int) -> float:
        """Jittered nominal delay for the given 1-based attempt number:
        ``min(cap, base * 2**(attempt-1)) * uniform(0.5, 1.0)``."""
        nominal = min(self.cap, self.base * (2 ** max(0, attempt - 1)))
        return nominal * (0.5 + self._rng.random() / 2)

    def sleep(self, attempt: int) -> bool:
        """Sleep the attempt's jittered delay, clamped to the remaining
        budget.  Returns False (without sleeping) when the budget is
        already spent."""
        d = self.delay(attempt)
        rem = self.remaining()
        if rem is not None:
            if rem <= 0:
                flight.record("backoff_exhausted", attempt=attempt)
                return False
            d = min(d, rem)
        flight.record("backoff_sleep", attempt=attempt,
                      delay_s=round(d, 4))
        time.sleep(d)
        return True
