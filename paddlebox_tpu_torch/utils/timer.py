"""Wall timers (≙ platform/timer.h Timer + the per-device pass timers in
box_wrapper.h:394-403 / PrintSyncTimer box_wrapper.h:795)."""

from __future__ import annotations

import threading
import time
from typing import Dict


class Timer:
    def __init__(self):
        self._start = 0.0
        self._elapsed = 0.0
        self._count = 0
        self._running = False

    def start(self) -> None:
        self._start = time.perf_counter()
        self._running = True

    def pause(self) -> None:
        if self._running:
            self._elapsed += time.perf_counter() - self._start
            self._count += 1
            self._running = False

    def reset(self) -> None:
        self._elapsed = 0.0
        self._count = 0
        self._running = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.pause()

    def elapsed_sec(self) -> float:
        extra = time.perf_counter() - self._start if self._running else 0.0
        return self._elapsed + extra

    def count(self) -> int:
        return self._count


class TimerRegistry:
    """Named timer set printed per pass (≙ DeviceBoxData timers)."""

    def __init__(self):
        self._timers: Dict[str, Timer] = {}
        self._lock = threading.Lock()

    def __call__(self, name: str) -> Timer:
        with self._lock:
            if name not in self._timers:
                self._timers[name] = Timer()
            return self._timers[name]

    def add(self, name: str, seconds: float) -> None:
        """Thread-safe accumulate for timers shared by worker pools (a bare
        ``with registry(name)`` races when two threads time the same name)."""
        with self._lock:
            if name not in self._timers:
                self._timers[name] = Timer()
            t = self._timers[name]
            t._elapsed += seconds
            t._count += 1

    def report(self) -> str:
        with self._lock:
            parts = [f"{k}={t.elapsed_sec():.3f}s/{t.count()}"
                     for k, t in sorted(self._timers.items())]
        return " ".join(parts)

    def rows(self):
        """[(name, elapsed_sec, count)] sorted by name — the structured
        face of report() (the per-pass PrintSyncTimer table renders from
        this, ps/pass_manager.py)."""
        with self._lock:
            return [(k, t.elapsed_sec(), t.count())
                    for k, t in sorted(self._timers.items())]

    def reset(self) -> None:
        with self._lock:
            for t in self._timers.values():
                t.reset()
