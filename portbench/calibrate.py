"""The readings a training cell's limits are set from (not part of a
benchmark run).

    python3 portbench/calibrate.py --config widedeep-criteo \
        --traffic criteo_zipf --program-seeds 1,2,3 --control-seeds 11,12,13 \
        [--out FILE]

For each program seed: a run's whole set-up and first pass on one card,
then the check exactly as a run makes it (no window).  For each control seed,
without the program: the reference against itself put in the program's
place in TF32 (the control, one precision below the configuration's),
and with a fault planted: half of every batch left out, the lr weight's
or the embedx push lost before the sparse rule, or the state left
unchanged (which reads 1).  Every reading is printed as a JSON line,
and each fault's is judged against the configuration's limits
(``correct``); the last line gives each number's largest program
reading (the lower end of its limit) and smallest control and fault
readings (the upper end).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def _seeds(text: str):
    return [int(x) for x in text.split(",") if x.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, traffic, weights
    from portbench.reference import compare, steps

    cfg = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")
    tr = harness.load_json(harness.HERE / "traffic" / f"{args.traffic}.json")
    cell = {"name": f"{args.config}.{args.traffic}", "chips": 1}
    driver = harness.load_module("drivers", tr["driver"])
    rows = []

    def emit(kind, seed, numbers, seconds):
        row = {"kind": kind, "seed": seed, "seconds": round(seconds, 3),
               "correct": compare.judge(numbers, cfg["correct_limits"])[0],
               **{k: v for k, v in numbers.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in _seeds(args.program_seeds):
        t0 = time.perf_counter()
        ctx = harness.Context(cell=cell, config=cfg, traffic=tr, seed=seed,
                              seconds=0.0, trace=False, device=args.device,
                              chips=int(cell["chips"]), t_start=t0)
        st = driver.State(ctx)
        numbers = driver.check(ctx, st)
        numbers["lowering"] = st.lowering
        del st
        gc.collect()
        emit("program", seed, numbers, time.perf_counter() - t0)

    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        sd = driver._seeds(seed)
        records = traffic.make_pass(tr, int(cfg["batch_size"]),
                                    sd["traffic"], args.device)
        init = weights.draw(steps.model_module(cfg["model"]).param_specs(cfg),
                            sd["dense"], args.device)
        init = {k: v.cpu() for k, v in init.items()}
        follow = lambda **kw: steps.follow(records, cfg, init, sd["table"],
                                           driver.CHECK_STEPS, args.device,
                                           **kw)
        ref = follow()
        # a second witness: the same reference in float32 on the host
        cpu = steps.follow(records, cfg, init, sd["table"],
                           driver.CHECK_STEPS, "cpu")
        emit("reference_cpu", seed, compare.readings(cpu, ref, init),
             time.perf_counter() - t0)
        del cpu
        for kind, traj in (("control_tf32", follow(tf32=True)),
                           ("half_batch", follow(half_batch=True)),
                           ("lost_embed_push", follow(lost_push="g_embed")),
                           ("lost_embedx_push", follow(lost_push="g_embedx")),
                           ("unchanged", compare.unchanged(ref, init))):
            numbers = compare.readings(traj, ref, init)
            # the write-back is the program's own; the reference's
            # stand-in copies its rows exactly
            numbers["writeback_mismatch"] = 0
            emit(kind, seed, numbers, time.perf_counter() - t0)
        del records, ref
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    names = ("loss_gap", "grad_gap", "change_gap", "sparse_gap",
             "count_mismatch", "_loss_gap_steps", "_change_worst",
             "_sparse_max")
    summary = {}
    for kind in ("program", "reference_cpu", "control_tf32", "half_batch",
                 "lost_embed_push",
                 "lost_embedx_push", "unchanged"):
        got = [r for r in rows if r["kind"] == kind]
        if got:
            pick = max if kind in ("program", "reference_cpu") else min
            summary[kind] = {n: pick(r[n] for r in got) for n in names}
            summary[kind]["correct_runs"] = sum(r["correct"] for r in got)
    print(json.dumps({"summary": summary, "config": args.config}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench import harness as _h
    _h.set_cache_dirs()
    sys.exit(main())
