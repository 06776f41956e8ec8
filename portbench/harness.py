"""The benchmark's harness: finds a cell's files by name, hands the cell
to its window driver, reads the metrics and prints the result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  A
configuration is ``configs/<name>.json`` (the path in its ``file``
entry), a traffic mix ``traffic/<name>.json``; the traffic file names
the window driver, ``drivers/<driver>.py``; each metric is read by
``metrics/<name>.py``.  So a later cell, configuration, traffic mix or
metric is a new file, and no file here changes.

A driver's ``run(ctx)`` returns a ``Run`` (below); a metric module's
``read(run)`` returns a number, or None where the run holds nothing to
read, and the metric is then left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "paddlebox_tpu")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    run's arguments and the device."""

    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    t_start: float


@dataclasses.dataclass
class Run:
    """What a driver returns.  ``window``: ``seconds``, ``steps``,
    ``records`` and ``step_ms`` (the device intervals between steps);
    ``stretch``: the traced stretch (``view``, a TraceView; ``steps``,
    ``records``, ``passes`` and the program's observation deltas
    ``stats``), or None; ``shapes``: what the kernels' byte counts read;
    ``numbers`` and ``limits``: what decides ``correct``."""

    setup_s: float
    window: Dict[str, Any]
    device: Dict[str, Any]
    numbers: Dict[str, float]
    limits: Dict[str, float]
    attempted: int
    failed: int
    stretch: Optional[Dict[str, Any]] = None
    shapes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    breakdown: Optional[Dict[str, List]] = None


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> Dict:
    with open(path) as f:
        return json.load(f)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder (a name may hold
    dots, so the file is loaded by its path)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    key = f"portbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: Dict, workload: str):
    """(cell, configuration, traffic) of a cell named in ``bench``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_of(bench: Dict, trace: bool) -> List[Dict]:
    """The metric entries a run reports: the end-to-end metrics
    untraced, the per-layer metrics traced (a reader with nothing to
    read in a cell returns None)."""
    return bench["per_layer"] if trace else bench["end_to_end"]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unread"


def read_metrics(run: Run, entries: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(run: Run, metrics: Dict, correct: bool,
                checks: Dict) -> Dict:
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": run.device}
    if run.breakdown is not None:
        line["breakdown"] = run.breakdown
    line["notes"] = run.notes
    line["checks"] = checks
    return line


def run_cell(bench: Dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             config: Dict = None, traffic: Dict = None):
    """Run one cell; returns (result line, exit code).  ``config`` /
    ``traffic`` replace the cell's files (the tests' tiny sizes)."""
    import torch
    from portbench.reference import compare

    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, tr = cell_files(bench, workload)
    cfg, tr = config or cfg, traffic or tr
    chips = int(cell["chips"])
    if device == "cuda":
        if not torch.cuda.is_available():
            print("portbench: no CUDA device", file=sys.stderr)
            return None, 2
        if torch.cuda.device_count() < chips:
            print(f"portbench: {workload} needs {chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return None, 2
    ctx = Context(cell=cell, config=cfg, traffic=tr, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device,
                  chips=chips, t_start=t_start)
    run = load_module("drivers", tr["driver"]).run(ctx)
    metrics = read_metrics(run, metrics_of(bench, trace))
    correct, checks = compare.judge(run.numbers, run.limits)
    correct = correct and run.failed == 0
    if device == "cuda":
        run.notes["card"] = card_power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not use: "
              f"{bad}", file=sys.stderr)
        return None, 3
    return result_line(run, metrics, correct, checks), 0


def print_result(line: Dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for k, v in line["notes"].items():
        print(f"note {k}: {v}", file=sys.stderr)
    for name, c in line["checks"].items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None, t_start: float = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    line, code = run_cell(load_benchmark(), args.workload, args.seed,
                          args.seconds, bool(args.trace), "cuda", t_start)
    if line is not None:
        print_result(line)
    return code


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every kernel and build cache at a fixed path inside the checkout
    (the port's own nvcc and g++ outputs live in ``build/`` already)."""
    base = root / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
