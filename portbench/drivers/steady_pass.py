"""Window driver of the steady training cells: one pass-resident feed,
trained epoch after epoch.

Set-up, in order: the pass of records from the seed (traffic.py); the
program's engine lifecycle over its keys on an empty table
(``begin_feed_pass`` / ``add_keys`` / ``end_feed_pass`` / ``begin_pass``);
the trainer, ``sparse_path="auto"`` as users get it, with the dense
weights the benchmark drew on the device; ``build_pass_feed`` once; and
a first ``train_pass`` over the feed, which builds the kernels and warms
every shape the window runs.  That first pass is also the check's: after
its first step the dense optimizer's state and the sparse rows' g2sum,
after its third the whole state, are copied to the host (the copies'
seconds are not set-up).

The window calls ``train_pass(feed)`` until ``seconds`` have passed and
ends in a synchronize.  Each pass starts with ``reset_metrics()``, so
that each reports its own AUC (as the port's fleet runner does) and every
pass's end does the same work; a CUDA event after every step (the pass's
``progress`` callback) gives the device intervals between steps.  With
``--trace 1`` a stretch of ``STRETCH_PASSES`` more passes runs under
torch.profiler.  Then ``end_pass`` writes the set back, outside the
window, and the check compares: a sample of the written rows against the
working set before the write-back, and the first three steps against the
reference (reference/), which runs once the program's state is freed.
"""

from __future__ import annotations

import gc
import json
import math
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from portbench import harness, traffic, weights
from portbench.reference import compare, steps
from portbench.trace_view import STRETCH, TraceView

CHECK_STEPS = 3
STRETCH_PASSES = 2
WRITEBACK_SAMPLE = 65536
SPARSE_FIELDS = ("show", "click", "mf_size", "slot", "embed_w", "mf",
                 "embed_g2sum", "mf_g2sum")
DISPATCH = "trainer.step_dispatch_s"


def _seeds(seed: int) -> Dict[str, int]:
    return {"traffic": seed, "table": traffic.sub_seed(seed, 2),
            "dense": traffic.sub_seed(seed, 3),
            "sample": traffic.sub_seed(seed, 4)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy (never an alias, also of a tensor on the CPU)."""
    return t.detach().to("cpu", copy=True)


def sorted_unique_u64(keys: np.ndarray, device) -> np.ndarray:
    """The unique uint64 keys in ascending order (on the card when there
    is one: flipping the sign bit makes the signed order the unsigned)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return np.unique(keys)
    flip = np.int64(-(1 << 63))
    t = torch.as_tensor(keys.view(np.int64), device=dev) ^ flip
    u = torch.unique(t, sorted=True) ^ flip
    return u.cpu().numpy().view(np.uint64)


def program(ctx, records, seeds):
    """The program's engine, trainer, feed and the dense weights drawn
    for it (the run's set-up up to the first pass)."""
    import importlib

    from paddlebox_tpu_torch.config import (DataFeedConfig,
                                            EmbeddingTableConfig,
                                            SlotConfig, SparseSGDConfig)
    from paddlebox_tpu_torch.data.dataset import SlotDataset
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
    from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
    from paddlebox_tpu_torch.trainer.trainer import SparseTrainer

    cfg, tr = ctx.config, ctx.traffic
    n_dense = int(tr["dense_features"])
    if cfg["num_slots"] != len(tr["cardinalities"]) \
            or cfg["dense_dim"] != n_dense:
        raise ValueError(f"{cfg['name']} wants {cfg['num_slots']} slots and "
                         f"{cfg['dense_dim']} dense features; {tr['name']} "
                         f"makes {len(tr['cardinalities'])} and {n_dense}")
    feed_cfg = DataFeedConfig(slots=tuple(
        [SlotConfig("label", dtype="float", is_dense=True, dim=1),
         SlotConfig("dense0", dtype="float", is_dense=True, dim=n_dense)]
        + [SlotConfig(f"s{i}", slot_id=records.slot_ids[i],
                      capacity=int(tr["capacity"]))
           for i in range(len(records.keys))]))
    block = SlotRecordBlock(n=records.n)
    for i, (keys, off) in enumerate(records.keys):
        block.uint64_slots[f"s{i}"] = (keys, off)
    block.float_slots["label"] = (records.labels,
                                  np.arange(records.n + 1, dtype=np.int64))
    block.float_slots["dense0"] = (
        records.dense.reshape(-1),
        np.arange(records.n + 1, dtype=np.int64) * n_dense)
    dataset = SlotDataset(feed_cfg)
    dataset._blocks = [block]

    marks = {"records": time.perf_counter()}
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=int(cfg["embedding_dim"]),
        shard_num=int(cfg["table_shards"]),
        sgd=SparseSGDConfig(optimizer=cfg["sparse_rule"],
                            **cfg["sparse_sgd"])),
        seed=seeds["table"], device=ctx.device)
    engine.begin_feed_pass()
    engine.add_keys(block.all_keys())
    engine.end_feed_pass()
    engine.begin_pass()
    marks["lifecycle"] = time.perf_counter()

    mod_name, cls_name = cfg["program_model"].split(":")
    model = getattr(importlib.import_module(mod_name), cls_name)(
        cfg["num_slots"], 3 + cfg["embedding_dim"], cfg["dense_dim"],
        tuple(cfg["hidden"]))
    trainer = SparseTrainer(engine, model, feed_cfg,
                            batch_size=int(cfg["batch_size"]),
                            seed=seeds["dense"], device=ctx.device)
    opt = trainer.dense_opt
    if type(opt).__name__ != cfg["dense_optimizer"]["name"] \
            or opt.param_groups[0]["lr"] != cfg["dense_optimizer"]["lr"]:
        raise ValueError(f"the trainer's dense optimizer is {opt!r}, the "
                         f"configuration states {cfg['dense_optimizer']}")
    init = weights.draw(steps.model_module(cfg["model"]).param_specs(cfg),
                        seeds["dense"], ctx.device)
    weights.load_into(trainer.model, init)
    _sync(ctx.device)
    marks["trainer"] = time.perf_counter()
    feed = trainer.build_pass_feed(dataset)
    _sync(ctx.device)
    marks["feed"] = time.perf_counter()
    return engine, trainer, feed, init, marks


def first_pass(engine, trainer, feed):
    """The warm-up pass, with the check's copies of the state after its
    first and third steps; returns (copies, their seconds)."""
    opt = trainer.dense_opt
    beta1 = opt.param_groups[0]["betas"][0]
    named = dict(trainer.model.named_parameters())
    snap, spent = {}, [0.0]

    def progress(i: int) -> None:
        if i not in (1, CHECK_STEPS):
            return
        t0 = time.perf_counter()
        if i == 1:
            # Adam's first moment after one step is (1 - beta1) x grad;
            # an optimizer that kept none received no gradient
            snap["grad1"] = {
                n: _host(opt.state[p]["exp_avg"] / (1 - beta1))
                if "exp_avg" in opt.state[p] else torch.zeros(p.shape)
                for n, p in named.items()}
            snap["g2sum1"] = _host(engine.ws["embed_g2sum"])
        if i == CHECK_STEPS:
            snap["params"] = {n: _host(p) for n, p in named.items()}
            snap["ws"] = {f: _host(engine.ws[f]) for f in SPARSE_FIELDS}
        spent[0] += time.perf_counter() - t0

    stats = trainer.train_pass(feed, progress=progress)
    snap["losses"] = stats["losses"][:CHECK_STEPS]
    return snap, spent[0]


def _dispatch():
    from paddlebox_tpu_torch.utils.monitor import stat_snapshot
    return stat_snapshot(DISPATCH)


def _delta(before, after, key: str = DISPATCH):
    """(count, sum) of a histogram's observations between two
    snapshots."""
    return tuple(after.get(f"{key}.{k}", 0.0) - before.get(f"{key}.{k}", 0.0)
                 for k in ("count", "sum"))


def window(trainer, feed, seconds: float, device):
    """Train passes until ``seconds`` have passed; returns the window's
    numbers and the count of non-finite step losses."""
    cuda = torch.device(device).type == "cuda"
    marks = []

    def mark(_i: int) -> None:
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    gc.collect()
    _sync(device)
    before = _dispatch()
    t0 = time.perf_counter()
    mark(0)
    bad = passes = 0
    while True:
        trainer.reset_metrics()
        stats = trainer.train_pass(feed, progress=mark)
        passes += 1
        bad += sum(1 for x in stats["losses"] if not math.isfinite(x))
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    t1 = time.perf_counter()
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    n_steps = len(step_ms)
    return {"seconds": t1 - t0, "steps": n_steps, "passes": passes,
            "records": n_steps * feed.batch_size, "step_ms": step_ms,
            "stats": {DISPATCH: _delta(before, _dispatch())}}, bad


def traced(trainer, feed, device):
    """``STRETCH_PASSES`` passes under torch.profiler: the trace's view
    of the stretch, the program's observation deltas, and the port's
    host spans for naming idle gaps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddlebox_tpu_torch.utils import trace as port_trace

    was_on = port_trace.ACTIVE is not None
    tracer = port_trace.enable()
    tracer.clear()
    before = _dispatch()
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mono = time.monotonic()
        with record_function("portbench.clock"):
            pass
        with record_function(STRETCH):
            for _ in range(STRETCH_PASSES):
                trainer.reset_metrics()
                trainer.train_pass(feed)
            _sync(device)
    after = _dispatch()
    spans = tracer.spans()
    if not was_on:
        port_trace.disable()
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    view = TraceView(events)
    clock = [e for e in events if e.get("name") == "portbench.clock"
             and e.get("cat") == "user_annotation"]
    offset_us = float(clock[0]["ts"]) - mono * 1e6 if clock else None
    stats = {DISPATCH: _delta(before, after)}
    n_steps = STRETCH_PASSES * feed.n_batches
    return {"view": view, "steps": n_steps, "passes": STRETCH_PASSES,
            "records": n_steps * feed.batch_size, "stats": stats,
            "spans": spans, "offset_us": offset_us}


def gap_namer(stretch):
    """Name an idle gap by the port's host span open when it began and
    the innermost host operation of the trace open then."""
    view, off = stretch["view"], stretch["offset_us"]
    spans = [(s["t0"] * 1e6 + off, (s["t0"] + s["dur_s"]) * 1e6 + off,
              s["name"]) for s in stretch["spans"]
             if off is not None and s.get("dur_s") is not None]

    def name_at(t: float) -> str:
        open_ = [(lo, name) for lo, hi, name in spans if lo <= t < hi]
        span = max(open_)[1] if open_ else "(no span)"
        return f"{span} | {view.host_op_at(t) or '(no host op)'}"
    return name_at


def feed_shapes(feed, cfg) -> Dict:
    """What the sorted kernels' byte counts read: the kept sorted width
    of the feed's plans, each batch's distinct rows (run starts) and the
    pull and push widths."""
    rows2d = feed.plans["rows2d"]                 # [N, n_chunks, 1, c]
    first = feed.plans["first_occ"]               # [N, p_pad]
    d = int(cfg["embedding_dim"])
    return {"p_pad": int(rows2d.shape[1] * rows2d.shape[3]),
            "distinct": [int(x) for x in first.sum(dim=1).tolist()],
            "pull_width": 3 + d + 1, "push_width": d + 4}


def writeback(engine, pass_keys: np.ndarray, seed: int, device) -> int:
    """``end_pass``, then a seeded sample of the pass's keys read back from
    the host table against the working set's rows before it: rows whose
    bits differ, plus keys the table lacks or holds beyond the pass."""
    rng = np.random.default_rng(seed)
    n = len(pass_keys)
    pick = np.sort(rng.choice(n, size=min(WRITEBACK_SAMPLE, n),
                              replace=False))
    rows = torch.as_tensor(pick + 1, device=engine.ws["show"].device)
    before = {f: engine.ws[f][rows].cpu().numpy() for f in engine.ws}
    engine.end_pass()
    after = engine.table.bulk_pull(pass_keys[pick])
    bad = np.zeros(len(pick), bool)
    for f, v in before.items():
        a = after[f]
        bad |= (v.view(np.int32) != a.view(np.int32)).reshape(len(pick), -1
                                                                ).any(axis=1)
    bad |= after["unseen_days"] != 0
    return int(bad.sum()) + abs(engine.table.size() - n)


def program_trajectory(snap, pass_keys: np.ndarray, ref: Dict) -> Dict:
    """The program's first steps in the reference's terms: its rows of
    the reference's keys (row i + 1 of the working set is the pass's
    i-th smallest key)."""
    rows = torch.as_tensor(np.searchsorted(pass_keys, ref["keys"]) + 1)
    grad1 = dict(snap["grad1"])
    grad1["embed_w"] = torch.sqrt(snap["g2sum1"][rows])
    return {"losses": snap["losses"], "grad1": grad1,
            "params": snap["params"],
            "sparse": {f: snap["ws"][f][rows] for f in SPARSE_FIELDS}}


class State:
    """A run's set-up: the records, the seeds, the program's objects, the
    drawn weights (host copies) and the check's copies of the first
    steps."""

    def __init__(self, ctx):
        cfg = ctx.config
        self.device = ctx.device
        self.seeds = _seeds(ctx.seed)
        t0 = time.perf_counter()
        self.records = traffic.make_pass(ctx.traffic, int(cfg["batch_size"]),
                                         self.seeds["traffic"], ctx.device)
        self.engine, self.trainer, self.feed, init, marks = program(
            ctx, self.records, self.seeds)
        self.init = {k: v.cpu() for k, v in init.items()}
        self.snap, self.snap_s = first_pass(self.engine, self.trainer,
                                            self.feed)
        self.lowering = self.trainer._resolve_path()
        self.crossing = list(getattr(self.trainer, "_mxu_crossing", ()))
        _sync(ctx.device)
        # seconds of each set-up stage (the first pass less the check's
        # copies), and the engine's own timers of its lifecycle
        marks["first_pass"] = time.perf_counter() - self.snap_s
        stages, prev = {}, t0
        for k, t in marks.items():
            stages[k] = round(t - prev, 3)
            prev = t
        self.stages = {"before": round(t0 - ctx.t_start, 3), **stages,
                       "engine": self.engine.timers.report()}


def check(ctx, st: State) -> Dict[str, float]:
    """The write-back, then (the program's state freed) the first steps
    against the reference: the numbers that decide ``correct``."""
    dev = ctx.device
    st.pass_keys = sorted_unique_u64(st.records.all_keys(), dev)
    wb = writeback(st.engine, st.pass_keys, st.seeds["sample"], dev)
    st.engine = st.trainer = st.feed = None
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ref = steps.follow(st.records, ctx.config, st.init, st.seeds["table"],
                       CHECK_STEPS, dev)
    numbers = compare.readings(program_trajectory(st.snap, st.pass_keys,
                                                  ref), ref, st.init)
    numbers["writeback_mismatch"] = wb
    return numbers


def _mean_ms(count_sum) -> float:
    count, total = count_sum
    return 1e3 * total / count if count > 0 else float("nan")


def run(ctx) -> "harness.Run":
    cfg, dev = ctx.config, ctx.device
    cuda = torch.device(dev).type == "cuda"
    st = State(ctx)
    setup_s = time.perf_counter() - ctx.t_start - st.snap_s

    win, bad = window(st.trainer, st.feed, ctx.seconds, dev)
    stretch = (traced(st.trainer, st.feed, dev) if ctx.trace and cuda
               else None)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": ctx.chips,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if cuda else 0)}
    shapes = feed_shapes(st.feed, cfg) if st.lowering == "mxu" else {}
    numbers = check(ctx, st)

    matmul_tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    notes = {"lowering": st.lowering, "crossing": st.crossing,
             "matmul_tf32": matmul_tf32,
             "working_set_keys": len(st.pass_keys),
             "setup_stages_s": st.stages,
             "window_passes": win["passes"],
             "window_dispatch_ms": _mean_ms(win["stats"][DISPATCH]),
             "loss_gap_steps": numbers["_loss_gap_steps"],
             "change_worst": [numbers["_change_worst"],
                              numbers["_change_leaf"]],
             "grad_leaf": numbers["_grad_leaf"],
             "sparse_field": numbers["_sparse_field"],
             "sparse_max": numbers["_sparse_max"],
             "left_out": numbers["_left_out"]}
    macs = steps.model_module(cfg["model"]).macs_per_record(cfg)
    result = harness.Run(
        setup_s=setup_s, window=win, device=device,
        numbers=numbers, limits=cfg["correct_limits"],
        attempted=win["steps"], failed=bad, shapes=shapes, notes=notes)
    result.shapes.update(macs_per_record=macs, matmul_tf32=matmul_tf32)
    if stretch is not None:
        view = stretch["view"]
        result.stretch = stretch
        notes["stretch_dispatch_ms"] = _mean_ms(stretch["stats"][DISPATCH])
        device["busy_s"] = view.busy_s
        device["window_s"] = view.window_s
        result.breakdown = {"device_ops": view.top_ops(10),
                            "idle_gaps": view.idle_gaps(
                                10, gap_namer(stretch))}
    return result
