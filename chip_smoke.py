#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Three phases, each of which raises on failure (exit code != 0, and then
no result line is printed):

1. build  — compile every hand-written kernel of ``paddlebox_tpu_torch``
   (one ``nvcc`` per source, started together) and print the build time;
2. kernels — at the slice's shapes (W = 12, p = 26·3·16384 = 1,277,952
   sorted occurrences, the 1,835,008-row working-set bucket of a
   ~1.6 M-key pass) build a plan from uniform and
   from Zipf-1.2 row ids and hold each kernel against its plain PyTorch
   version on the card: the gather bit-exact, the scatter within rtol
   1e-5 plus 1e-5 of each row's sum of |terms| (the plain ``index_add_``
   adds with atomics in another order).  Times come from CUDA events;
3. slice  — train one DeepFM pass (26 slots × capacity 3, mf_dim 8,
   13 dense, MLP 400-400-400, batch 16384, 4 batches, keys from a 2 M
   key space) through ``BoxPSEngine`` → ``SparseTrainer.train_pass`` →
   ``end_pass`` with every kernel launch counter set to 0 just before;
   assert finite losses, a reported AUC and that every kernel of the
   path launched at least once per batch.  Then the first step of the
   same pass runs again on the CPU (``device="cpu"``) from the same
   weights and data; its loss must agree within rtol 1e-4 (f32 sums in
   another order on the two devices).

A last, short profiled pass reports device time by kernel and the
device-busy share (not part of the checks above).

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        SlotConfig, SparseSGDConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ops import cuda_lib
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps.embedding import size_bucket
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer

N_SLOTS, CAP, MF_DIM, DENSE_DIM = 26, 3, 8, 13
HIDDEN = (400, 400, 400)
BATCH, N_BATCHES, KEY_SPACE = 16384, 4, 2_000_000
P = N_SLOTS * CAP * BATCH                  # 1,277,952 occurrences / step
W_PULL, W_PUSH = 3 + MF_DIM + 1, MF_DIM + 4
TABLE_ROWS = size_bucket(1_600_001)        # a ~1.6 M-key pass's bucket

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                     # H100 SXM, outside tensor cores
SOURCE = "paddlebox_tpu_torch/csrc/sorted_spmm.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: the kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(dev: torch.device, seed: int = 0):
    rng = np.random.default_rng(seed)
    rows_by_dist = {
        "uniform": rng.integers(1, TABLE_ROWS, P),
        # Zipf-1.2 ranks wrapped onto the table: one very hot row
        "zipf1.2": (rng.zipf(1.2, P) - 1) % (TABLE_ROWS - 1) + 1,
    }
    dims = sp.spmm_dims(P, TABLE_ROWS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((W_PULL, dims.n_kernel), generator=gen, device=dev)
    table[:, 0] = 0.0
    table[:, TABLE_ROWS:] = 0.0             # the zero sentinel tile
    results = {}
    for dist, rows_np in rows_by_dist.items():
        rows = torch.as_tensor(rows_np.astype(np.int32), device=dev)
        plan = sp.build_plan(rows, dims)
        rows2d, first_occ = plan[0], plan[7]
        payload = torch.randn((W_PUSH, dims.p_pad), generator=gen,
                              device=dev)
        payload[:, dims.p:] = 0.0            # pad columns carry nothing
        n_unique = int(first_occ.sum().item())

        got = sp.gather_sorted(table, rows2d, dims)
        want = sp.gather_sorted_plain(table, rows2d, dims)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_sorted != plain ({dist})")
        g_err = float((got - want).abs().max())

        got = sp.scatter_add_sorted(payload, rows2d, first_occ, dims)
        want = sp.scatter_add_sorted_plain(payload, rows2d, first_occ, dims)
        abs_sum = sp.scatter_add_sorted_plain(payload.abs(), rows2d,
                                              first_occ, dims)
        torch.cuda.synchronize()
        err = (got - want).abs()
        limit = 1e-5 * want.abs() + 1e-5 * abs_sum + 1e-6
        if not bool((err <= limit).all()):
            raise AssertionError(
                f"scatter_add_sorted != plain ({dist}): max err "
                f"{float(err.max())}")
        s_err = float(err.max())

        rows_l = rows2d.reshape(-1).long()
        g = {"ms": time_ms(lambda: sp.gather_sorted(table, rows2d, dims)),
             "plain_ms": time_ms(
                 lambda: sp.gather_sorted_plain(table, rows2d, dims)),
             "library_ms": time_ms(
                 lambda: torch.index_select(table, 1, rows_l)),
             "max_abs_err": g_err}
        # bytes the gather must move: its row ids, the table columns this
        # plan touches, the output
        g["bound_ms"], g["bound_by"] = bound_ms(
            4 * dims.p_pad + 4 * W_PULL * n_unique + 4 * W_PULL * dims.p_pad,
            0)
        s = {"ms": time_ms(lambda: sp.scatter_add_sorted(
                 payload, rows2d, first_occ, dims)),
             "plain_ms": time_ms(lambda: sp.scatter_add_sorted_plain(
                 payload, rows2d, first_occ, dims)),
             "library_ms": time_ms(lambda: torch.zeros(
                 (W_PUSH, dims.n_kernel), device=dev).index_add_(
                     1, rows_l, payload)),
             "max_abs_err": s_err}
        # payload + row ids + run starts in, the whole merged delta out;
        # one add per payload value
        s["bound_ms"], s["bound_by"] = bound_ms(
            4 * W_PUSH * dims.p_pad + 8 * dims.p_pad
            + 4 * W_PUSH * dims.n_kernel, W_PUSH * dims.p)
        results[dist] = {"gather_sorted": g, "scatter_add_sorted": s,
                         "distinct_rows": n_unique}
        log(f"kernels[{dist}]: distinct rows {n_unique}; gather "
            f"{g['ms']:.4f} ms (plain {g['plain_ms']:.4f}, bound "
            f"{g['bound_ms']:.4f}); scatter {s['ms']:.4f} ms (plain "
            f"{s['plain_ms']:.4f}, bound {s['bound_ms']:.4f}); max err "
            f"{g_err} / {s_err}")
    return results


# ---------------------------------------------------------------------------
# phase 3: one training pass of the slice
# ---------------------------------------------------------------------------

def feed_config() -> DataFeedConfig:
    return DataFeedConfig(slots=tuple(
        [SlotConfig("label", dtype="float", is_dense=True, dim=1),
         SlotConfig("dense0", dtype="float", is_dense=True, dim=DENSE_DIM)]
        + [SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(N_SLOTS)]))


def make_block(rng, n: int) -> SlotRecordBlock:
    """n records: 1..CAP feasigns per slot from the key space, a 0/1
    label and DENSE_DIM normal dense features."""
    blk = SlotRecordBlock(n=n)
    for i in range(N_SLOTS):
        lens = rng.integers(1, CAP + 1, size=n)
        offsets = np.zeros((n + 1,), np.int64)
        np.cumsum(lens, out=offsets[1:])
        blk.uint64_slots[f"s{i}"] = (rng.integers(
            1, KEY_SPACE, size=int(offsets[-1])).astype(np.uint64), offsets)
    blk.float_slots["label"] = (rng.integers(0, 2, size=n).astype(np.float32),
                                np.arange(n + 1, dtype=np.int64))
    blk.float_slots["dense0"] = (
        rng.normal(0, 1, size=n * DENSE_DIM).astype(np.float32),
        np.arange(n + 1, dtype=np.int64) * DENSE_DIM)
    return blk


def run_pass(block: SlotRecordBlock, device: str, params=None):
    """Engine lifecycle + one train_pass + end_pass on ``device``."""
    cfg = feed_config()
    dataset = SlotDataset(cfg)
    dataset._blocks = [block]
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0,
        device=device)
    engine.begin_feed_pass()
    engine.add_keys(block.all_keys())
    engine.end_feed_pass()
    engine.begin_pass()
    trainer = SparseTrainer(engine, DeepFM(N_SLOTS, 3 + MF_DIM, DENSE_DIM,
                                           HIDDEN),
                            cfg, batch_size=BATCH, seed=0, device=device)
    if params is not None:
        trainer.model.load_jax_params(params)
    params0 = trainer.model.jax_params()
    n_keys = engine.num_keys
    stats = trainer.train_pass(dataset, pack_threads=4)
    engine.end_pass()
    stats["timers"] = {"trainer": trainer.timers.report(),
                       "engine": engine.print_sync_timers()}
    if engine.table.size() != n_keys:
        raise AssertionError("end_pass did not write every pass key back")
    return stats, params0, n_keys


def slice_phase(seed: int = 0):
    rng = np.random.default_rng(seed)
    block = make_block(rng, N_BATCHES * BATCH)
    sp.gather_sorted.launches = 0
    sp.scatter_add_sorted.launches = 0
    t0 = time.perf_counter()
    stats, params0, n_keys = run_pass(block, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gather_sorted": sp.gather_sorted.launches,
                "scatter_add_sorted": sp.scatter_add_sorted.launches}
    losses = stats["losses"]
    if stats["batches"] != N_BATCHES or len(losses) != N_BATCHES:
        raise AssertionError(f"trained {stats['batches']} batches")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not math.isfinite(stats["auc"]):
        raise AssertionError(f"AUC not reported: {stats['auc']}")
    for name, n in launches.items():
        if n < N_BATCHES:
            raise AssertionError(f"{name} launched {n} times in a pass of "
                                 f"{N_BATCHES} batches")
    step_ms = stats["step_ms"]
    steady = float(np.median(step_ms[1:]))
    log(f"slice: {n_keys} pass keys, losses {losses}, auc "
        f"{stats['auc']}, launches {launches}, step device ms {step_ms} "
        f"(steady median {steady:.3f}), pass wall {wall:.2f} s")
    log(f"slice timers:\n{stats['timers']['trainer']}\n"
        f"{stats['timers']['engine']}")

    # the first step again on the CPU, from the same weights and data
    cpu_stats, _, _ = run_pass(block.slice(0, BATCH), "cpu", params=params0)
    cpu_loss = cpu_stats["losses"][0]
    if not math.isclose(cpu_loss, losses[0], rel_tol=1e-4):
        raise AssertionError(f"first-step loss: card {losses[0]} vs CPU "
                             f"{cpu_loss}")
    log(f"slice: first-step loss card {losses[0]!r} vs CPU {cpu_loss!r} "
        "(rtol 1e-4)")
    return launches, {"losses": losses, "cpu_first_loss": cpu_loss,
                      "auc": stats["auc"], "step_ms": step_ms,
                      "steady_step_ms": steady, "pass_wall_s": wall,
                      "pass_keys": n_keys}


def profile_phase(seed: int = 1) -> dict:
    """A second, short pass (2 batches) under torch.profiler: device time
    by kernel, and the device-busy share of the train_pass window."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed)
    block = make_block(rng, 2 * BATCH)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        stats, _, _ = run_pass(block, "cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpys, memsets): an operator's
    # row would count its kernels' time a second time
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"profile: 2-batch pass wall {wall_ms:.1f} ms (engine build, "
        f"pack, train, write-back), device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), step device ms "
        f"{stats['step_ms']}")
    for key, ms, n in rows[:15]:
        log(f"profile:   {ms:9.3f} ms  x{n:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                    for k, ms, n in rows[:15]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    secs = cuda_lib.build_all()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.2f} s)")

    kern = kernel_phase(dev)
    launches, slice_out = slice_phase()
    slice_out["profile"] = profile_phase()

    replaces = {"gather_sorted": "paddlebox_tpu/ops/sorted_spmm.py:238",
                "scatter_add_sorted": "paddlebox_tpu/ops/sorted_spmm.py:263"}
    line = {"kernels": []}
    for name in ("gather_sorted", "scatter_add_sorted"):
        k = kern["uniform"][name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(kern[d][name]["max_abs_err"] for d in kern),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    log("detail: " + json.dumps({"kernels_by_dist": kern,
                                 "slice": slice_out}))
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
