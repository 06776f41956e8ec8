"""``scatter_add_sorted``'s share of its roofline: the least time of its
bytes and adds (roofline.scatter_add_sorted_*, each batch's plan) over
the device time of its two kernels (the tiles and the runs that cross
a tile edge), summed over the traced stretch's launches."""

import re

from portbench import roofline

TILES = re.compile(r"\bscatter_tiles_kernel\b")
KERNELS = re.compile(r"\bscatter_(tiles|combine)_kernel\b")


def read(run):
    if run.stretch is None or not run.shapes.get("distinct"):
        return None
    view = run.stretch["view"]
    launches = view.launches(lambda n: bool(TILES.search(n)))
    if launches == 0:
        return None
    s = run.shapes
    least = [roofline.least_seconds(
        roofline.scatter_add_sorted_bytes(s["p_pad"], s["push_width"], u),
        roofline.scatter_add_sorted_ops(s["p_pad"], s["push_width"]))
        for u in s["distinct"]]
    return 100.0 * sum(least) / len(least) * launches \
        / view.kernel_seconds(lambda n: bool(KERNELS.search(n)))
