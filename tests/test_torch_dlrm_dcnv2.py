"""DLRM-DCNv2 (``models/dlrm_dcnv2.py``) against the benchmark's plain
reference (``portbench/reference/models/dlrm_dcnv2.py``) at a small size
on the CPU: the logits and every gradient on seeded random weights, a
short ``SparseTrainer`` pass on mxu over multi-key slots against
``portbench/reference/steps.py``, the class's default widths against the
configuration file, and the cross network's spans.  The last test runs
the sorted kernels at the cell's pull width on a card:

    python -m pytest --noconftest tests/test_torch_dlrm_dcnv2.py
"""

import copy
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_fixtures import cuda_device  # noqa: F401

from paddlebox_tpu_torch.models import dlrm_dcnv2
from paddlebox_tpu_torch.models.dlrm_dcnv2 import DLRMDCNv2
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.utils import trace
from portbench import harness, traffic, weights
from portbench.reference import compare
from portbench.reference.models import dlrm_dcnv2 as ref

CONFIG = "dlrm-dcnv2-criteo1tb"
FILE = Path(harness.HERE) / "configs" / f"{CONFIG}.json"
# the small size: 4 slots of D = 8, bottom (16, 8), 2 cross layers of
# rank 4, top (16, 8)
SMALL = {"num_slots": 4, "embedding_dim": 8, "dense_dim": 5,
         "bottom_mlp": [16, 8], "cross_layers": 2, "cross_rank": 4,
         "hidden": [16, 8]}
CROSS_SPANS = (dlrm_dcnv2.CROSS, dlrm_dcnv2.CROSS_BACKWARD)


def small_model(num_slots, emb_width, dense_dim, hidden):
    """The harness's constructor call, at the small cross and bottom."""
    return DLRMDCNv2(num_slots, emb_width, dense_dim, hidden,
                     bottom=tuple(SMALL["bottom_mlp"]),
                     cross_layers=SMALL["cross_layers"],
                     cross_rank=SMALL["cross_rank"])


def _small():
    c = SMALL
    return small_model(c["num_slots"], 3 + c["embedding_dim"],
                       c["dense_dim"], tuple(c["hidden"]))


def _random_params(seed):
    """Every leaf the reference names, biases included, N(0, 0.3^2)."""
    g = torch.Generator().manual_seed(seed)
    return {name: 0.3 * torch.randn(shape, generator=g)
            for name, shape, _ in ref.param_specs(SMALL)}


def _inputs(seed, b=32):
    g = torch.Generator().manual_seed(seed + 100)
    w = SMALL["num_slots"] * (3 + SMALL["embedding_dim"])
    return (torch.randn((b, w), generator=g),
            torch.randn((b, SMALL["dense_dim"]), generator=g))


def test_default_widths_are_the_configuration_s():
    cfg = json.loads(FILE.read_text())
    d = {k: v.default for k, v in
         inspect.signature(DLRMDCNv2).parameters.items()}
    assert list(d["hidden"]) == cfg["hidden"] == [1024, 1024, 512, 256]
    assert list(d["bottom"]) == cfg["bottom_mlp"] == [512, 256, 128]
    assert d["cross_layers"] == cfg["cross_layers"] == 3
    assert d["cross_rank"] == cfg["cross_rank"] == 512
    assert cfg["embedding_dim"] == 128 and cfg["num_slots"] == 26
    assert cfg["reduced"] == ["batch_size"]
    # the published widths give a cross width of 128 + 26 x (3 + 128)
    assert ref._width(cfg) == 3534
    assert ref.macs_per_record(cfg) == 170_496 + 10_856_448 + 5_323_008


def test_parameters_are_the_reference_s():
    named = {n: tuple(p.shape) for n, p in _small().named_parameters()}
    assert named == {n: s for n, s, _ in ref.param_specs(SMALL)}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_logits_and_grads_match_the_reference(seed):
    params = _random_params(seed)
    model = _small()
    weights.load_into(model, params)
    pooled, dense = _inputs(seed)
    pooled.requires_grad_(True)
    got = model(pooled, dense)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    p_ref = pooled.detach().clone().requires_grad_(True)
    want = ref.logits(leaves, p_ref.reshape(len(p_ref), SMALL["num_slots"],
                                            -1), dense, SMALL)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # a non-linear loss so that every gradient depends on the logits
    (torch.sigmoid(got) ** 2).sum().backward()
    (torch.sigmoid(want) ** 2).sum().backward()
    torch.testing.assert_close(pooled.grad, p_ref.grad, rtol=1e-5, atol=1e-6)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, leaves[name].grad, rtol=1e-5,
                                   atol=1e-6, msg=name)


def _small_cell(seed=9, capacity=4):
    """The driver's context of the small net over multi-key slots of
    ``capacity`` (1 to ``capacity`` keys a slot) on the CPU."""
    bench = copy.deepcopy(harness.load_benchmark())
    bench["configs"] = [{"name": CONFIG, "file": f"portbench/configs/"
                                                 f"{CONFIG}.json"}]
    bench["workloads"] = [{"name": "dlrm.small", "config": CONFIG,
                           "traffic": "criteo1tb_multihot", "chips": 1}]
    cell, cfg, tr = harness.cell_files(bench, "dlrm.small")
    cfg = copy.deepcopy(cfg)
    cfg.update(SMALL, batch_size=64,
               program_model=f"{__name__}:small_model")
    # hot keys reach the embedx threshold within the three checked steps
    cfg["sparse_sgd"]["mf_create_thresholds"] = 2.0
    tr = dict(tr, cardinalities=[50, 300, 2000, 7], batches_per_pass=4,
              dense_features=SMALL["dense_dim"], keys_per_slot=[1, capacity],
              capacity=capacity)
    return harness.Context(cell=cell, config=cfg, traffic=tr, seed=seed,
                           seconds=0.2, trace=False, device="cpu", chips=1,
                           t_start=0.0)


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_trainer_pass_on_mxu_matches_the_reference(seed):
    """Three steps of ``SparseTrainer.train_pass`` on ``auto`` (mxu) over
    slots of 1-4 keys, against the reference's (the benchmark's driver
    and check, run in this process): the losses, the dense gradients and
    changes, the sparse rows and counts, the write-back."""
    run = harness.load_module("drivers", "steady_pass").run(
        _small_cell(seed))
    ok, checks = compare.judge(run.numbers, run.limits)
    assert ok and run.failed == 0, checks
    assert checks["loss_gap"]["value"] < 1e-6
    assert checks["grad_gap"]["value"] < 1e-5
    assert checks["change_gap"]["value"] < 1e-5
    assert checks["sparse_gap"]["value"] < 1e-3
    assert checks["count_mismatch"]["value"] == 0
    assert checks["writeback_mismatch"]["value"] == 0
    assert run.notes["lowering"] == "mxu" and run.notes["left_out"] == []


def _trained_pass(monkeypatch, tracer_on):
    """One pass of the small cell's feed with the tracer on or off; the
    spans it left and the hooks registered."""
    steady_pass = harness.load_module("drivers", "steady_pass")
    ctx = _small_cell()
    seeds = steady_pass._seeds(ctx.seed)
    records = traffic.make_pass(ctx.traffic, ctx.config["batch_size"],
                                seeds["traffic"], "cpu")
    engine, trainer, feed, _, _ = steady_pass.program(ctx, records, seeds)
    hooks = []
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, fn: hooks.append(fn) or register(t, fn))
    was = trace.ACTIVE
    tracer = trace.enable() if tracer_on else None
    try:
        if tracer_on:
            tracer.clear()
        trainer.train_pass(feed)
        spans = tracer.spans() if tracer_on else []
    finally:
        trace.disable()
        if was is not None:
            trace.ACTIVE = was
    return spans, hooks, feed.n_batches


def test_cross_spans_once_a_step(monkeypatch):
    spans, hooks, steps = _trained_pass(monkeypatch, True)
    assert len(hooks) == 2 * steps
    dense = {s["span_id"] for s in spans if s["name"] == "trainer.step.dense"}
    assert len(dense) == steps
    width = 8 + 4 * (3 + 8)
    for name in CROSS_SPANS:
        found = [s for s in spans if s["name"] == name]
        assert len(found) == steps, name
        for s in found:
            assert s["attrs"] == {"rows": 64, "width": width, "rank": 4,
                                  "layers": 2}
            assert s["parent_id"] in dense and s["dur_s"] >= 0
            assert "device_s" in s      # None: a host device has no events
    # the backward opens after the forward closes, within its step
    fwd = sorted(s["t0"] for s in spans if s["name"] == CROSS_SPANS[0])
    bwd = sorted(s["t0"] for s in spans if s["name"] == CROSS_SPANS[1])
    assert all(f < b for f, b in zip(fwd, bwd))


def test_no_hook_and_no_span_with_the_tracer_off(monkeypatch):
    spans, hooks, _ = _trained_pass(monkeypatch, False)
    assert spans == [] and hooks == []


def test_cross_metrics_read_the_spans():
    """``cross_ms_per_step`` and ``cross_peak_pct`` on hand-made spans;
    None without them, as in a cell whose net has no cross network."""
    attrs = {"rows": 8192, "width": 3534, "rank": 512, "layers": 3}
    spans = [{"name": n, "span_id": f"{n}{i}", "parent_id": None,
              "device_s": t, "attrs": attrs}
             for i in range(2) for n, t in zip(CROSS_SPANS, (0.004, 0.008))]
    run = harness.Run(setup_s=0.0, window={}, device={}, numbers={},
                      limits={}, attempted=2, failed=0,
                      stretch={"spans": spans, "steps": 2, "passes": 1},
                      shapes={"matmul_tf32": False})
    read = lambda name, r: harness.load_module("metrics", name).read(r)
    assert read("cross_ms_per_step", run) == pytest.approx(12.0)
    flops = 6 * 8192 * 2 * 3534 * 512 * 3
    assert read("cross_peak_pct", run) == pytest.approx(
        100 * flops / 0.012 / 67e12)
    for name in ("cross_ms_per_step", "cross_peak_pct"):
        short = dict(run.stretch, spans=spans[:3])
        assert read(name, harness.Run(**{**run.__dict__,
                                         "stretch": short})) is None
        assert read(name, harness.Run(**{**run.__dict__,
                                         "stretch": None})) is None


@pytest.mark.cuda
def test_sorted_kernels_at_the_cell_s_width_on_card(cuda_device):
    """``gather_sorted`` and ``scatter_add_sorted`` at the cell's pull and
    push width (3 + 128 + 1 = 132 = 128 + 4) over a plan of 26 slots of
    capacity 16 (1-16 keys, Zipf rows, the rest padding), trimmed as the
    pass feed trims it: the gather bit-equal to the plain version, the
    scatter within rtol 1e-5 plus 1e-5 of each row's sum of |terms|."""
    rng = np.random.default_rng(0)
    s, cap, b, n_rows, w = 26, 16, 1024, 200_000, 132
    lens = rng.integers(1, cap + 1, (s, b))
    rows = np.minimum(rng.zipf(1.1, (s, cap, b)), n_rows - 1)
    rows[np.arange(cap)[None, :, None] >= lens[:, None, :]] = 0
    rows = np.asarray(rows, np.int32).reshape(-1)
    dims = sp.spmm_dims(len(rows), n_rows)
    kd = sp.trimmed_dims(dims, int((rows != 0).sum()))
    plan = sp.build_plan(torch.as_tensor(rows, device=cuda_device), dims, kd)
    g = torch.Generator().manual_seed(3)
    table = torch.randn((w, dims.n_kernel), generator=g)
    table[:, 0] = 0
    table[:, n_rows:] = 0
    table = table.to(cuda_device)
    assert torch.equal(sp.gather_sorted(table, plan[0], kd),
                       sp.gather_sorted_plain(table, plan[0], kd))
    pay = torch.randn((w, kd.p_pad), generator=g).to(cuda_device)
    got = sp.scatter_add_sorted(pay, plan[0], plan[7], kd)
    want = sp.scatter_add_sorted_plain(pay, plan[0], plan[7], kd)
    abs_sum = sp.scatter_add_sorted_plain(pay.abs(), plan[0], plan[7], kd)
    assert bool(((got - want).abs()
                 <= 1e-5 * want.abs() + 1e-5 * abs_sum + 1e-6).all())
