"""Device ms a step in the dense net's matrix products: every kernel of
the traced stretch whose name marks a cuBLAS / CUTLASS GEMM or its
split-K reduction, summed, over the stretch's steps."""

import re

GEMM = re.compile(r"gemm|nvjet|splitk|xmma|cutlass", re.IGNORECASE)


def is_gemm(name: str) -> bool:
    return bool(GEMM.search(name))


def read(run):
    if run.stretch is None:
        return None
    view = run.stretch["view"]
    if view.launches(is_gemm) == 0:
        return None
    return view.kernel_seconds(is_gemm) * 1e3 / run.stretch["steps"]
