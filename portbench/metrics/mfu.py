"""The whole step's share of the card's peak: the dense net's forward
and backward FLOPs (6 a multiply-add of its matrix products, from the
configuration's shapes) over the traced stretch's records, over the
stretch's seconds, over the peak of the precision the run's float32
matmuls compute in (TF32 when PyTorch's switch is on, else float32)."""

from portbench import roofline


def read(run):
    if run.stretch is None:
        return None
    view = run.stretch["view"]
    flops = roofline.step_flops(run.shapes["macs_per_record"],
                                run.stretch["records"])
    peak = roofline.PEAK_FLOPS[roofline.matmul_precision(
        run.shapes["matmul_tf32"])]
    return 100.0 * flops / view.window_s / peak
