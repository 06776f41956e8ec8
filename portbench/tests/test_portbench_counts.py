"""The yardstick's arithmetic on numbers worked out by hand: FLOPs and
bytes of both configurations, the percentile, the idle union and the
metric readers on synthetic traces."""

import numpy as np
import pytest

from portbench import harness, quantiles, roofline
from portbench.reference import steps
from portbench.trace_view import STRETCH, TraceView, gaps, union_length


def _cfg(config):
    return harness.load_json(harness.HERE / "configs" / f"{config}.json")


def test_dense_flops_of_the_configuration():
    wd = _cfg("widedeep-criteo")
    # 923*1024 + 1024*512 + 512*256 + 256*1 + the wide 923
    assert steps.model_module("widedeep").macs_per_record(wd) == 1_601_691
    assert roofline.step_flops(1_601_691, 16384) == 157_452_632_064
    assert roofline.step_flops(1_601_691, wd["batch_size"]) \
        == 314_905_264_128


def test_sorted_kernel_bytes():
    # pull width 14 and push width 36, the trimmed plan's 958,464 kept
    # positions, 300,000 distinct rows
    g = roofline.gather_sorted_bytes(958_464, 14, 300_000)
    assert g == 4 * 958_464 + 4 * 14 * 300_000 + 4 * 14 * 958_464
    s = roofline.scatter_add_sorted_bytes(958_464, 36, 300_000)
    assert s == 4 * 36 * 958_464 + 4 * 958_464 + 4 * 36 * 300_000
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.matmul_precision(False) == "float32"


def test_percentile():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0, 10.0, 7.0]
    for q in (0, 50, 95, 100):
        assert quantiles.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert union_length(iv) == 4
    assert gaps(iv, -1, 8) == [(-1, 0), (3, 5), (6, 8)]


def _events():
    x = lambda name, cat, ts, dur, tid=1: {"name": name, "cat": cat,
                                           "ph": "X", "ts": ts, "dur": dur,
                                           "tid": tid}
    return [x(STRETCH, "user_annotation", 1000, 1000),
            x("aten::mm", "cpu_op", 1000, 100),
            x("aten::copy_", "cpu_op", 1500, 300),
            x("sm80_xmma_gemm_f32f32_nn", "kernel", 1100, 200, 7),
            x("void gather_sorted_kernel(float const*)", "kernel", 1300, 50, 7),
            x("scatter_tiles_kernel", "kernel", 1350, 100, 7),
            x("scatter_combine_kernel", "kernel", 1450, 20, 7),
            x("Memcpy DtoH", "gpu_memcpy", 1600, 100, 7),
            x("cutlass::Kernel2<cutlass_80_simt_sgemm>", "kernel", 900, 400,
              7)]


def test_trace_view_busy_idle_and_names():
    v = TraceView(_events())
    assert v.window_s == pytest.approx(1e-3)
    # [1000, 1470) from the kernels (the cut one starts at 1000), then
    # the copy [1600, 1700)
    assert v.busy_s == pytest.approx(570e-6)
    gaps_ = v.idle_gaps(2)
    # [1700, 2000) while the copy's host op runs, then [1470, 1600)
    assert gaps_[0] == ["aten::copy_", pytest.approx(300e-6)]
    assert gaps_[1] == ["(no host op)", pytest.approx(130e-6)]
    assert v.top_ops(1)[0][1] == pytest.approx(300e-6)


def _run(stretch_steps=2):
    v = TraceView(_events())
    return harness.Run(
        setup_s=12.5,
        window={"seconds": 2.0, "records": 4 * 16384, "steps": 4,
                "step_ms": [1.0, 2.0, 3.0, 10.0],
                "stats": {"trainer.step_dispatch_s": (4.0, 0.02)}},
        device={}, numbers={}, limits={}, attempted=4, failed=0,
        stretch={"view": v, "steps": stretch_steps, "passes": 1,
                 "records": stretch_steps * 100, "stats": {}},
        shapes={"p_pad": 1000, "distinct": [100, 300], "pull_width": 14,
                "push_width": 14, "macs_per_record": 1000,
                "matmul_tf32": False})


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_metric_readers_on_a_synthetic_run():
    run = _run()
    assert _read("setup_s", run) == 12.5
    assert _read("train_examples_per_s", run) == 4 * 16384 / 2.0
    assert _read("step_ms_p95", run) == pytest.approx(
        float(np.percentile([1, 2, 3, 10], 95)))
    assert _read("step_dispatch_ms", run) == pytest.approx(5.0)
    assert _read("device_idle_pct", run) == pytest.approx(43.0)
    # the two GEMMs: 200 us and the 300 us of the cut one inside
    assert _read("gemm_ms_per_step", run) == pytest.approx(0.25)
    # 6 FLOP a MAC, 1000 MACs, 200 records, over 1 ms, over 67 TFLOP/s
    assert _read("mfu", run) == pytest.approx(
        100 * 6 * 1000 * 200 / 1e-3 / 67e12)
    g = (roofline.gather_sorted_bytes(1000, 14, 100)
         + roofline.gather_sorted_bytes(1000, 14, 300)) / 2
    assert _read("gather_sorted_roofline_pct", run) == pytest.approx(
        100 * g / 3.35e12 / 50e-6)
    s = (roofline.scatter_add_sorted_bytes(1000, 14, 100)
         + roofline.scatter_add_sorted_bytes(1000, 14, 300)) / 2
    assert _read("scatter_add_sorted_roofline_pct", run) == pytest.approx(
        100 * s / 3.35e12 / 120e-6)


def test_readers_find_nothing_untraced():
    run = _run()
    run.stretch = None
    for name in ("step_dispatch_ms", "gemm_ms_per_step", "mfu",
                 "device_idle_pct", "gather_sorted_roofline_pct",
                 "scatter_add_sorted_roofline_pct"):
        assert _read(name, run) is None


def test_a_trace_without_one_stretch_is_refused():
    with pytest.raises(ValueError):
        TraceView([e for e in _events() if e["name"] != STRETCH])
