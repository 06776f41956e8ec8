"""The port's spans inside the step and the pass end (``utils/trace.py``
sites in ``trainer/trainer.py`` and ``ps/optimizer.py``): a tiny mxu
``train_pass`` on the CPU with the host tracer on, off, and under a CPU
``torch.profiler``; ``RecordEvent``'s one range.  JAX-free, so the card
test at the end runs where the card is:

    python -m pytest --noconftest tests/test_torch_step_spans.py
"""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from torch_data_helpers import B, DENSE, MF, S, datasets
from torch_port_fixtures import cuda_device  # noqa: F401

from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        SlotConfig, SparseSGDConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer
from paddlebox_tpu_torch.utils import trace
from paddlebox_tpu_torch.utils.profiler import RecordEvent

PKG = SimpleNamespace(Feed=DataFeedConfig, Slot=SlotConfig,
                      Block=SlotRecordBlock, Dataset=SlotDataset)
NB = 3
STEP = ("trainer.step.pull", "trainer.step.dense", "trainer.step.push")
RULE = "ps.optimizer.apply_push"


def _pass(device="cpu", seed=0):
    """Engine, trainer and one dataset of NB batches, the pass begun."""
    cfg, data = datasets(PKG, seed=seed, nb=NB)
    ds = SlotDataset(cfg)
    ds._blocks = [d.get_blocks()[0] for d in data]
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF, shard_num=4,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=7,
        device=device)
    eng.begin_feed_pass()
    for blk in ds.get_blocks():
        eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    tr = SparseTrainer(eng, DeepFM(S, 3 + MF, DENSE, hidden=(16, 16)), cfg,
                       batch_size=B, seed=3, sparse_path="mxu",
                       device=device)
    return eng, tr, ds


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "stream"])
def test_step_spans_nest_under_the_pass(monkeypatch, packed):
    tracer = trace.SpanTracer()
    monkeypatch.setattr(trace, "ACTIVE", tracer)
    eng, tr, ds = _pass()
    for _ in range(2):
        feed = tr.build_pass_feed(ds) if packed else ds
        tr.train_pass(feed)
    spans = tracer.spans()
    passes = _by_name(spans, "trainer.train_pass")
    assert len(passes) == 2
    pass_ids = {p["span_id"] for p in passes}
    for name in STEP:
        found = _by_name(spans, name)
        assert len(found) == 2 * NB, name
        assert {s["parent_id"] for s in found} == pass_ids
        # the CPU has no device events
        assert all(s["device_s"] is None for s in found)
    pushes = {s["span_id"] for s in _by_name(spans, "trainer.step.push")}
    rules = _by_name(spans, RULE)
    assert len(rules) == 2 * NB
    assert {r["parent_id"] for r in rules} == pushes
    # the packed feed's rule steps its batch's row list, the streaming
    # step's every working-set row
    rows = (feed.plans["rule_rows"].shape[1] if packed
            else eng.ws["show"].shape[0])
    assert not packed or rows < eng.ws["show"].shape[0]
    assert all(r["attrs"]["rows"] == rows
               and r["device_s"] is None for r in rules)
    ends = _by_name(spans, "trainer.pass_end")
    assert len(ends) == 2 and {e["parent_id"] for e in ends} == pass_ids
    assert all("device_s" not in e and e["dur_s"] > 0 for e in ends)


def test_tracer_off_opens_no_span(monkeypatch):
    monkeypatch.setattr(trace, "ACTIVE", None)
    opened = []
    monkeypatch.setattr(trace.SpanTracer, "start_span",
                        lambda *a, **k: opened.append(a))
    eng, tr, ds = _pass()
    stats = tr.train_pass(tr.build_pass_feed(ds))
    assert stats["batches"] == NB and not opened
    first = trace.span("trainer.step.pull", device=torch.device("cpu"))
    assert first is trace.NO_SPAN
    assert trace.span("x", rows=3) is first
    with first as s:
        assert s is None


def _annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def test_spans_land_in_the_profiler_trace(monkeypatch, tmp_path):
    monkeypatch.setattr(trace, "ACTIVE", trace.SpanTracer())
    eng, tr, ds = _pass()
    feed = tr.build_pass_feed(ds)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            tr.train_pass(feed)
    events = _annotations(prof, tmp_path)
    outer = [e for e in events if e["name"] == "outer"]
    assert len(outer) == 1
    lo, hi, tid = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"], \
        outer[0]["tid"]
    counts = {n: 0 for n in STEP + (RULE, "trainer.pass_end",
                                    "trainer.train_pass")}
    for e in events:
        if e["name"] in counts:
            assert e["tid"] == tid
            assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi
            counts[e["name"]] += 1
    assert counts == dict({n: NB for n in STEP + (RULE,)},
                          **{"trainer.pass_end": 1, "trainer.train_pass": 1})


@pytest.mark.parametrize("tracer_on", [False, True], ids=["off", "on"])
def test_record_event_opens_one_range(monkeypatch, tmp_path, tracer_on):
    tracer = trace.SpanTracer() if tracer_on else None
    monkeypatch.setattr(trace, "ACTIVE", tracer)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with RecordEvent("one.range"):
            torch.ones(4).sum()
    events = _annotations(prof, tmp_path)
    assert [e["name"] for e in events].count("one.range") == 1
    if tracer_on:
        assert [s["name"] for s in tracer.spans()] == ["one.range"]


@pytest.mark.cuda
def test_step_spans_sum_to_the_step_on_card(cuda_device, monkeypatch):
    """The pull's, the dense half's and the push's device time (the rule
    inside the push) add up to the step's CUDA-event interval."""
    tracer = trace.SpanTracer()
    monkeypatch.setattr(trace, "ACTIVE", tracer)
    eng, tr, ds = _pass(device=cuda_device)
    feed = tr.build_pass_feed(ds)
    tr.train_pass(feed)                       # warm up every shape
    tracer.clear()
    stats = tr.train_pass(feed)
    torch.cuda.synchronize()
    spans = tracer.spans()
    parts = [sum(s["device_s"] for s in _by_name(spans, n)) for n in STEP]
    rules = _by_name(spans, RULE)
    assert len(rules) == NB and all(r["device_s"] > 0 for r in rules)
    step_s = sum(stats["step_ms"]) * 1e-3
    assert sum(parts) == pytest.approx(step_s, rel=0.1)
