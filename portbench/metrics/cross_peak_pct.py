"""The cross network's share of the card's peak: its FLOPs over the
device seconds of its forward and backward spans (``model.dcn.cross``
and ``model.dcn.cross.backward``), over the peak of the precision the
run's float32 matmuls compute in (as ``mfu`` chooses it).

The count is this file's own; only the shapes come from the forward
spans' attributes: a cross layer's two low-rank products are 2 x width x
rank multiply-adds a row, 6 FLOP a multiply-add forward and backward, so
6 x rows x 2 x width x rank x layers a step."""

from portbench import harness, roofline


def flops(attrs) -> int:
    return 6 * attrs["rows"] * 2 * attrs["width"] * attrs["rank"] \
        * attrs["layers"]


def read(run):
    sp = harness.load_module("metrics", "sparse_pull_ms_per_step")
    cross = harness.load_module("metrics", "cross_ms_per_step")
    fwd, bwd = sp.spans(run, cross.CROSS), sp.spans(run, cross.BACKWARD)
    t_fwd, t_bwd = sp.device_seconds(fwd), sp.device_seconds(bwd)
    if not t_fwd or not t_bwd:
        return None
    peak = roofline.PEAK_FLOPS[roofline.matmul_precision(
        run.shapes["matmul_tf32"])]
    total = sum(flops(s["attrs"]) for s in fwd)
    return 100.0 * total / (sum(t_fwd) + sum(t_bwd)) / peak
