"""The readers of the port's spans (``metrics/sparse_*``,
``dense_ms_per_step``, ``pass_end_*``) on hand-made span dicts and a
hand-made trace."""

import pytest

from portbench import harness
from portbench.trace_view import STRETCH, TraceView

PULL, DENSE, PUSH = ("trainer.step.pull", "trainer.step.dense",
                     "trainer.step.push")
RULE, PASS_END = "ps.optimizer.apply_push", "trainer.pass_end"
SPAN_METRICS = ("sparse_pull_ms_per_step", "dense_ms_per_step",
                "sparse_push_ms_per_step", "sparse_rule_ms_per_step",
                "sparse_rule_useful_pct", "pass_end_ms", "pass_end_idle_pct")


def span(name, sid, parent=None, device_s=None, dur_s=0.001, **attrs):
    d = {"name": name, "span_id": sid, "parent_id": parent, "t0": 0.0,
         "dur_s": dur_s, "device_s": device_s}
    if attrs:
        d["attrs"] = attrs
    return d


def event(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "tid": tid}


def view(kernels=((0, 100),), pass_ends=(), hi=1000):
    """A stretch [0, hi) us with these kernels and pass-end ranges."""
    events = [event(STRETCH, "user_annotation", 0, hi)]
    events += [event("k", "kernel", s, e - s, tid=7) for s, e in kernels]
    events += [event(PASS_END, "user_annotation", s, e - s)
               for s, e in pass_ends]
    return TraceView(events)


def two_steps():
    """Two steps: pushes of 3 and 4 ms with rules of 1 and 2 ms, and a
    rule span outside any push (a multi-device step's)."""
    return [
        span(PULL, "a1", "tp", 0.002), span(PULL, "a2", "tp", 0.004),
        span(DENSE, "d1", "tp", 0.007), span(DENSE, "d2", "tp", 0.009),
        span(PUSH, "p1", "tp", 0.003), span(PUSH, "p2", "tp", 0.004),
        span(RULE, "r1", "p1", 0.001, rows=100),
        span(RULE, "r2", "p2", 0.002, rows=100),
        span(RULE, "r3", "tp", 0.050, rows=7),
        span(PASS_END, "e1", "tp", dur_s=0.2),
        span("trainer.train_pass", "tp", dur_s=1.0)]


def run_of(spans, steps=2, passes=1, trace_view=None, distinct=(10, 30)):
    stretch = {"spans": spans, "steps": steps, "passes": passes,
               "view": trace_view or view()}
    return harness.Run(setup_s=0.0, window={}, device={}, numbers={},
                       limits={}, attempted=steps, failed=0, stretch=stretch,
                       shapes={"distinct": list(distinct)})


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_step_readers_on_two_steps():
    run = run_of(two_steps())
    assert read("sparse_pull_ms_per_step", run) == pytest.approx(3.0)
    assert read("dense_ms_per_step", run) == pytest.approx(8.0)
    # each push less its own child only: ((3 - 1) + (4 - 2)) / 2
    assert read("sparse_push_ms_per_step", run) == pytest.approx(2.0)
    # the rule under a push only (r3 has none): (1 + 2) / 2
    assert read("sparse_rule_ms_per_step", run) == pytest.approx(1.5)
    # 100 x mean distinct 20 / mean rows 100 of the rules under a push
    assert read("sparse_rule_useful_pct", run) == pytest.approx(20.0)
    assert read("pass_end_ms", run) == pytest.approx(200.0)


def test_rule_readers_need_a_rule_under_a_push():
    spans = [s for s in two_steps() if s["span_id"] not in ("r1", "r2")]
    run = run_of(spans)
    for name in ("sparse_push_ms_per_step", "sparse_rule_ms_per_step",
                 "sparse_rule_useful_pct"):
        assert read(name, run) is None, name
    assert read("sparse_pull_ms_per_step", run) == pytest.approx(3.0)


def test_none_on_a_short_ring():
    # the ring lost the oldest step's pull: a span short of one a step
    spans = [s for s in two_steps() if s["span_id"] != "a1"]
    assert read("sparse_pull_ms_per_step", run_of(spans)) is None
    # a pass with no pass-end span
    assert read("pass_end_ms", run_of(two_steps(), passes=2)) is None
    spans = [s for s in two_steps() if s["span_id"] != "p2"]
    assert read("sparse_push_ms_per_step", run_of(spans)) is None
    assert read("sparse_rule_ms_per_step", run_of(spans)) is None


@pytest.mark.parametrize("sid,name", [
    ("a2", "sparse_pull_ms_per_step"), ("d1", "dense_ms_per_step"),
    ("p1", "sparse_push_ms_per_step"), ("r2", "sparse_push_ms_per_step"),
    ("r1", "sparse_rule_ms_per_step")])
def test_none_on_a_missing_device_time(sid, name):
    spans = two_steps()
    for s in spans:
        if s["span_id"] == sid:
            s["device_s"] = None
    assert read(name, run_of(spans)) is None


def test_none_when_untraced():
    run = run_of(two_steps())
    run.stretch = None
    for name in SPAN_METRICS:
        assert read(name, run) is None, name


def test_pass_end_idle_on_a_hand_made_timeline():
    # idle gaps [100, 150), [400, 700), [800, 1000); the pass ends cover
    # [400, 500) and [800, 950) of them: 250 us of a 1000 us stretch
    tv = view(kernels=[(0, 100), (150, 400), (700, 800)],
              pass_ends=[(350, 500), (780, 950)])
    run = run_of(two_steps(), passes=2, trace_view=tv)
    assert read("pass_end_idle_pct", run) == pytest.approx(25.0)
    # a pass end missing from the trace
    run = run_of(two_steps(), passes=3, trace_view=tv)
    assert read("pass_end_idle_pct", run) is None
