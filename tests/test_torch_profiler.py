"""The port's profiler hooks (ports ``tests/test_aux.py::
test_profiler_trace``): ``Profiler`` records its step window with
``torch.profiler`` (the CPU here) and writes a Chrome trace that holds
the ``RecordEvent`` ranges; with the host span tracer on, the host
spans land beside it."""

import json
import os

import torch

from paddlebox_tpu_torch.utils import trace
from paddlebox_tpu_torch.utils.profiler import Profiler, RecordEvent, annotate


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profiler_trace_holds_record_events(tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "ACTIVE", None)      # the host tracer off
    log_dir = str(tmp_path / "trace")
    prof = Profiler(log_dir=log_dir, record_steps=range(1, 3))
    for i in range(5):
        with RecordEvent(f"step{i}"):
            torch.ones((10, 10)) @ torch.ones((10, 10))
        prof.step()
    names = _names(os.path.join(log_dir, "trace.json"))
    # step() call k starts the trace at k = 1 and stops it at k = 3: the
    # events of loop turns 2 and 3 lie in the window
    assert {"step2", "step3"} <= names
    assert not {"step0", "step1", "step4"} & names
    assert not os.path.exists(os.path.join(log_dir,
                                           "host_spans.trace.json"))
    ops = {e.key for e in prof.profile.key_averages()}
    assert "step2" in ops
    with annotate("outside"):
        pass


def test_profiler_exports_host_spans_beside(tmp_path, monkeypatch):
    log_dir = str(tmp_path / "trace")
    tracer = trace.SpanTracer()
    monkeypatch.setattr(trace, "ACTIVE", tracer)    # the host tracer on
    with Profiler(log_dir=log_dir):
        with RecordEvent("pull"):
            torch.zeros(4).sum()
        with annotate("annotated"):
            torch.zeros(4).sum()
    assert {"pull", "annotated"} <= _names(os.path.join(log_dir,
                                                        "trace.json"))
    assert "pull" in _names(os.path.join(log_dir, "host_spans.trace.json"))
    assert any(s["name"] == "pull" for s in tracer.spans())
