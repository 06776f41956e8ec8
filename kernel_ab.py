#!/usr/bin/env python3
"""The hand-written kernels of several checkouts of the port, on one timer.

    python3 kernel_ab.py [--profile] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repo (``.`` for this
one), or of a copy with a design constant changed; list two as
``A B B A`` to compare them on one card in one run.  For each, in order,
a fresh interpreter imports that checkout's ``paddlebox_tpu_torch`` and
runs THIS checkout's ``chip_smoke.py`` phases on it: the build of its
kernels, the sorted gather and scatter at uniform, Zipf-1.2 and padded
ids, ``gather_pool`` on the table layouts its wrapper accepts (one that
refuses a strided table is timed on the contiguous one alone) and, with
``--profile``, the profiled short passes of every lowering.  Every time
comes from ``chip_smoke.time_ms`` and every check of those phases
applies.  Needs one CUDA card and ``nvcc``.

Prints the card's name and power limit, then per checkout one JSON line
of everything measured and one ``summary`` line of the kernel times (ms).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the wrappers' CUDA kernels under this design's names and the previous
# scatter's (two passes: piece sums, then one thread per run)
OLD_SCATTER = ("scatter_pieces_kernel", "scatter_runs_kernel")


def child(root: str, profile: bool) -> dict:
    """Runs in the fresh interpreter: ``root``'s package, this
    checkout's chip_smoke phases."""
    sys.path.insert(0, str(Path(root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    dev = torch.device("cuda")
    out = {"checkout": root, "package": cs.pg.__file__,
           "build_s": cs.cuda_lib.build_all()}
    probe = torch.zeros((4, 12), device=dev)[:, :11]
    try:
        cs.pg.gather_pool(probe, torch.zeros((1, 1), dtype=torch.int32,
                                             device=dev),
                          torch.ones((1,), dtype=torch.int32, device=dev))
        layouts = ("stride12", "stride11")
    except ValueError:           # the wrapper takes contiguous tables only
        layouts = ("stride11",)
    out["kernels_by_dist"] = cs.kernel_phase(dev)
    out["gather_pool_by_layout"] = cs.gather_pool_phase(dev, layouts=layouts)
    if profile:
        symbols = dict(cs.SYMBOLS)
        symbols["scatter_add_sorted"] += OLD_SCATTER
        out["profile"] = cs.profile_phase(symbols=symbols)
    return out


def summary(res: dict) -> dict:
    kern, pool = res["kernels_by_dist"], res["gather_pool_by_layout"]
    line = {"checkout": res["checkout"]}
    for name in ("gather_sorted", "scatter_add_sorted"):
        line[name] = {d: kern[d][name]["ms"] for d in kern}
    line["gather_pool"] = {f"{d}/{lay}": k["ms"] for d in pool
                           for lay, k in pool[d].items()}
    if "profile" in res:
        line["device_busy_ms_per_step"] = {
            p: v["device_busy_ms"] / len(v["step_ms"])
            for p, v in res["profile"].items()}
        line["kernel_ms_per_step"] = {
            p: v["kernel_ms_per_step"] for p, v in res["profile"].items()}
    return line


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1], argv[2] == "1")), flush=True)
        return 0
    profile = "--profile" in argv
    roots = [a for a in argv if a != "--profile"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card visible", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    for root in roots:
        proc = subprocess.run(
            [sys.executable, str(HERE / "kernel_ab.py"), "--child", root,
             "1" if profile else "0"], capture_output=True, text=True,
            cwd=HERE)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"kernel_ab: {root} failed "
                               f"(exit {proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(res), flush=True)
        print("summary " + json.dumps(summary(res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
