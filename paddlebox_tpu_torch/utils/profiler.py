"""Profiling hooks.

Port of ``paddlebox_tpu/utils/profiler.py`` (≙ the reference's two
tracing layers, SURVEY.md §5: the host+device tracer exporting Chrome
traces — paddle.profiler.Profiler, profiler.py:271, with scheduler
states — and the old RecordEvent spans, platform/profiler.cc), mapped
onto ``torch.profiler``: CPU activity, and the card's kernels (CUPTI)
when a card is present.  A ``RecordEvent`` is a
``torch.profiler.record_function`` range plus a host span on the
framework's span tracer (``utils/trace.py``) when that is enabled, so
the exported collection carries both layers.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from paddlebox_tpu_torch.utils import trace


class RecordEvent:
    """≙ platform::RecordEvent span: a named range in the profiler's
    trace and, when the host tracer is on, a host span too."""

    def __init__(self, name: str):
        self.name = name
        self._ctx = None
        self._span = None
        self._tracer = None

    def __enter__(self):
        self._ctx = record_function(self.name)
        self._ctx.__enter__()
        self._tracer = trace.ACTIVE
        if self._tracer is not None:
            self._span = self._tracer.start_span(self.name)
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._tracer.finish(self._span)
            self._span = None
        self._ctx.__exit__(*exc)


class Profiler:
    """≙ paddle.profiler.Profiler (profiler.py:271): scheduler-driven
    start/stop with Chrome-trace export.  States: CLOSED→RECORD→CLOSED by
    step range (the reference's ProfilerState scheduler, profiler.py:34).

    ``stop`` writes ``trace.json`` into ``log_dir`` and, when the host
    tracer is on, ``host_spans.trace.json`` beside it.  The finished
    ``torch.profiler.profile`` stays readable as ``self.profile``
    (``key_averages()`` for device time by kernel)."""

    def __init__(self, log_dir: str = "./profile_out",
                 record_steps: Optional[range] = None):
        self.log_dir = log_dir
        self.record_steps = record_steps or range(2, 7)
        self._step = 0
        self.profile: Optional[profile] = None
        self._running = False

    def start(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # acc_events: key_averages() after stop still sees every event
        self.profile = profile(activities=activities, acc_events=True)
        self.profile.__enter__()
        self._running = True

    def stop(self) -> None:
        if self._running:
            self.profile.__exit__(None, None, None)
            self._running = False
            self.profile.export_chrome_trace(
                os.path.join(self.log_dir, "trace.json"))
            if trace.ACTIVE is not None:
                # the host span ring beside the profiler's trace, so one
                # Perfetto load shows device ops and PS verb spans
                trace.ACTIVE.export_chrome_trace(self.log_dir)

    def step(self) -> None:
        """Call once per train step; starts/stops per the schedule."""
        if self._step == self.record_steps.start:
            self.start()
        elif self._step == self.record_steps.stop:
            self.stop()
        self._step += 1

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


@contextlib.contextmanager
def annotate(name: str):
    with record_function(name):
        yield
