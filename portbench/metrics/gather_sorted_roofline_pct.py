"""``gather_sorted``'s share of its roofline: the least time its bytes
need (roofline.gather_sorted_bytes of each batch's plan, over the HBM
bandwidth) over its measured device time, summed over the traced
stretch's launches."""

import re

from portbench import roofline

KERNEL = re.compile(r"\bgather_sorted_kernel\b")


def read(run):
    if run.stretch is None or not run.shapes.get("distinct"):
        return None
    view = run.stretch["view"]
    match = lambda n: bool(KERNEL.search(n))
    launches = view.launches(match)
    if launches == 0:
        return None
    s = run.shapes
    per_batch = [roofline.gather_sorted_bytes(s["p_pad"], s["pull_width"], u)
                 for u in s["distinct"]]
    n_bytes = sum(per_batch) / len(per_batch) * launches
    return 100.0 * roofline.least_seconds(n_bytes) \
        / view.kernel_seconds(match)
