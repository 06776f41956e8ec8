#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, and then no
result line is printed):

1. build  — compile every hand-written kernel of ``paddlebox_tpu_torch``
   (one ``nvcc`` per source, started together) and print the build time;
2. kernels — each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, for uniform and Zipf-1.2 row
   ids.  The sorted gather and scatter at W = 12, p = 26·3·16384 =
   1,277,952 sorted occurrences over the 1,835,008-row working-set
   bucket of a ~1.6 M-key pass: the gather bit-exact, the scatter within
   rtol 1e-5 plus 1e-5 of each row's sum of |terms| (the plain
   ``index_add_`` adds with atomics in another order).  ``gather_pool``
   at the fast pull's shapes (table [1,835,008, 11], idx [425,984, 3],
   lengths 1..3): within rtol 1e-6 / atol 1e-6 (both sum at most 3 terms
   in order l = 0, 1, 2; whether they are bit-equal is printed).  Times
   come from CUDA events;
3. slice  — train one DeepFM pass (26 slots × capacity 3, mf_dim 8,
   13 dense, MLP 400-400-400, batch 16384, 4 batches, keys from a 2 M
   key space) through ``BoxPSEngine`` → ``SparseTrainer.train_pass`` →
   ``end_pass`` on the streaming mxu lowering; assert finite losses, a
   reported AUC, that every kernel of the path launched at least once
   per batch, and that the first step's loss matches the same step on
   the CPU (``device="cpu"``, same weights and data) within rtol 1e-4;
4. packed — the same model, one pass of 4 × 16384 records through
   ``build_pass_feed`` → ``train_pass(feed)`` → ``end_pass`` on each of
   the ``mxu`` (trimmed plans with static planes), ``fast`` and
   ``ragged`` lowerings, each with every launch counter set to 0 just
   before and read just after: finite losses, a reported AUC, every
   kernel of the lowering launched at least once per batch, the first
   step's loss within rtol 1e-4 of the same step on the CPU, and the
   three lowerings' first-step losses within rtol 1e-4 of each other.
   The fast and ragged passes run a second time from the same state and
   must leave a bit-identical working set (no float atomics).

Last, short profiled passes (2 batches; streaming mxu and each packed
lowering) report device time by kernel and the device-busy share of the
steps' event windows (not part of the checks above).

Output: progress lines, a ``detail:`` JSON line, then a
``{"kernels": [...]}`` JSON line, the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
from paddlebox_tpu_torch.data import pass_feed as pf
from paddlebox_tpu_torch.ops import cuda_lib
from paddlebox_tpu_torch.ops import pallas_gather as pg
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

R_POOL = N_SLOTS * BATCH                   # 425,984 pooled rows / step
W_POOL = 3 + MF_DIM                        # 11 pooled columns

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                     # H100 SXM, outside tensor cores
KERNELS = {"gather_sorted": sp.gather_sorted,
           "scatter_add_sorted": sp.scatter_add_sorted,
           "gather_pool": pg.gather_pool}
SOURCES = {"gather_sorted": "paddlebox_tpu_torch/csrc/sorted_spmm.cu",
           "scatter_add_sorted": "paddlebox_tpu_torch/csrc/sorted_spmm.cu",
           "gather_pool": "paddlebox_tpu_torch/csrc/gather_pool.cu"}
REPLACES = {"gather_sorted": "paddlebox_tpu/ops/sorted_spmm.py:238",
            "scatter_add_sorted": "paddlebox_tpu/ops/sorted_spmm.py:263",
            "gather_pool": "paddlebox_tpu/ops/pallas_gather.py:82"}


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


def gather_pool_phase(dev: torch.device, seed: int = 0):
    """gather_pool at the fast pull's shapes: table [TABLE_ROWS, 11],
    idx [425,984, 3] (26 slots × 16384 records), lengths 1..3."""
    rng = np.random.default_rng(seed)
    lengths_np = rng.integers(1, CAP + 1, R_POOL).astype(np.int32)
    ids_by_dist = {
        "uniform": rng.integers(1, TABLE_ROWS, (R_POOL, CAP)),
        "zipf1.2": (rng.zipf(1.2, (R_POOL, CAP)) - 1) % (TABLE_ROWS - 1) + 1,
    }
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((TABLE_ROWS, W_POOL), generator=gen, device=dev)
    table[0] = 0.0
    lengths = torch.as_tensor(lengths_np, device=dev)
    live = np.arange(CAP)[None, :] < lengths_np[:, None]
    results = {}
    for dist, ids_np in ids_by_dist.items():
        idx = torch.as_tensor(ids_np.astype(np.int32), device=dev)
        got = pg.gather_pool(table, idx, lengths)
        want = pg.gather_pool_plain(table, idx, lengths)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
            raise AssertionError(f"gather_pool != plain ({dist}): max err "
                                 f"{err}")
        mask = torch.as_tensor(live.astype(np.float32), device=dev)
        idx_l = idx.long()
        n_rows = int(np.unique(ids_np[live]).size)
        k = {"ms": time_ms(lambda: pg.gather_pool(table, idx, lengths)),
             "plain_ms": time_ms(
                 lambda: pg.gather_pool_plain(table, idx, lengths)),
             "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(
                 idx_l, table, mode="sum", per_sample_weights=mask)),
             "max_abs_err": err, "bit_equal": bool(torch.equal(got, want)),
             "distinct_rows": n_rows}
        # ids and lengths read once, each distinct live row once, the
        # output written once; one add per live (row, column)
        k["bound_ms"], k["bound_by"] = bound_ms(
            4 * R_POOL * CAP + 4 * R_POOL + 4 * W_POOL * n_rows
            + 4 * W_POOL * R_POOL, W_POOL * int(lengths_np.sum()))
        results[dist] = k
        log(f"gather_pool[{dist}]: distinct rows {n_rows}; {k['ms']:.4f} ms "
            f"(plain {k['plain_ms']:.4f}, embedding_bag "
            f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f}); max err "
            f"{err}, bit-equal {k['bit_equal']}")
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


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def run_pass(block: SlotRecordBlock, device: str, params=None,
             path: str = "mxu", packed: bool = False,
             keep_ws: bool = False, around_train=contextlib.nullcontext):
    """Engine lifecycle + one train_pass + end_pass on ``device``, on the
    streaming entry point or (packed) through build_pass_feed.  Returns
    (stats, the model's initial params, pass keys); stats carries the
    feed build seconds and, with keep_ws, a copy of the trained working
    set taken before end_pass.  ``around_train()`` is a context manager
    entered around the train_pass call alone."""
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
                            cfg, batch_size=BATCH, seed=0, sparse_path=path,
                            device=device)
    if params is not None:
        trainer.model.load_jax_params(params)
    params0 = trainer.model.jax_params()
    n_keys = engine.num_keys
    extra = {}
    if packed:
        t0 = time.perf_counter()
        feed = trainer.build_pass_feed(dataset)
        if device == "cuda":
            torch.cuda.synchronize()
        extra["build_pass_feed_s"] = time.perf_counter() - t0
        if path == "mxu":
            kept = feed.plans["rows2d"].shape[1] * feed.plan_dims.chunk
            extra["mxu_kept_fraction"] = kept / feed.plan_dims.p_pad
        with around_train():
            stats = trainer.train_pass(feed)
    else:
        with around_train():
            stats = trainer.train_pass(dataset, pack_threads=4)
    if keep_ws:
        extra["ws"] = {k: v.clone() for k, v in engine.ws.items()}
    engine.end_pass()
    stats.update(extra)
    stats["timers"] = {"trainer": trainer.timers.report(),
                       "engine": engine.print_sync_timers()}
    if engine.table.size() != n_keys:
        raise AssertionError("end_pass did not write every pass key back")
    return stats, params0, n_keys


def check_pass(what: str, stats: dict, launches: dict,
               per_batch: dict) -> None:
    """Finite losses, a reported AUC, and each kernel of the path
    launched at least ``per_batch[name]`` times per batch."""
    losses = stats["losses"]
    if stats["batches"] != N_BATCHES or len(losses) != N_BATCHES:
        raise AssertionError(f"{what}: trained {stats['batches']} batches")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss: {losses}")
    if not math.isfinite(stats["auc"]):
        raise AssertionError(f"{what}: AUC not reported: {stats['auc']}")
    for name, k in per_batch.items():
        if launches[name] < k * N_BATCHES:
            raise AssertionError(
                f"{what}: {name} launched {launches[name]} times in a pass "
                f"of {N_BATCHES} batches (want >= {k} per batch)")


def cpu_first_loss(what: str, block: SlotRecordBlock, card_loss: float,
                   params, **kw) -> float:
    """The first step again on the CPU, from the same weights and data;
    f32 sums run in another order on the two devices: rtol 1e-4."""
    cpu_stats, _, _ = run_pass(block.slice(0, BATCH), "cpu", params=params,
                               **kw)
    cpu_loss = cpu_stats["losses"][0]
    if not math.isclose(cpu_loss, card_loss, rel_tol=1e-4):
        raise AssertionError(f"{what}: first-step loss card {card_loss} vs "
                             f"CPU {cpu_loss}")
    log(f"{what}: first-step loss card {card_loss!r} vs CPU {cpu_loss!r} "
        "(rtol 1e-4)")
    return cpu_loss


def slice_phase(seed: int = 0):
    rng = np.random.default_rng(seed)
    block = make_block(rng, N_BATCHES * BATCH)
    reset_counts()
    t0 = time.perf_counter()
    stats, params0, n_keys = run_pass(block, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check_pass("slice", stats, launches,
               {"gather_sorted": 1, "scatter_add_sorted": 1})
    losses = stats["losses"]
    step_ms = stats["step_ms"]
    steady = float(np.median(step_ms[1:]))
    log(f"slice: {n_keys} pass keys, losses {losses}, auc "
        f"{stats['auc']}, launches {launches}, step device ms {step_ms} "
        f"(steady median {steady:.3f}), pass wall {wall:.2f} s")
    log(f"slice timers:\n{stats['timers']['trainer']}\n"
        f"{stats['timers']['engine']}")
    cpu_loss = cpu_first_loss("slice", block, losses[0], params0)
    return launches, {"losses": losses, "cpu_first_loss": cpu_loss,
                      "auc": stats["auc"], "step_ms": step_ms,
                      "steady_step_ms": steady, "pass_wall_s": wall,
                      "pass_keys": n_keys}


# kernels each packed lowering must launch, per batch
PACKED_KERNELS = {"mxu": {"gather_sorted": 1, "scatter_add_sorted": 1},
                  "fast": {"gather_pool": 1, "scatter_add_sorted": 1},
                  "ragged": {"scatter_add_sorted": 2}}


def packed_phase(seed: int = 2):
    """One packed pass per lowering, its CPU first step, the cross-
    lowering check and the fast/ragged determinism reruns."""
    rng = np.random.default_rng(seed)
    block = make_block(rng, N_BATCHES * BATCH)
    params0, launches, out = None, {}, {}
    for path, per_batch in PACKED_KERNELS.items():
        reset_counts()
        t0 = time.perf_counter()
        stats, p0, n_keys = run_pass(block, "cuda", params=params0,
                                     path=path, packed=True,
                                     keep_ws=path != "mxu")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = read_counts()
        params0 = params0 or p0      # every lowering from the same weights
        check_pass(f"packed[{path}]", stats, launches[path], per_batch)
        steady = float(np.median(stats["step_ms"][1:]))
        cpu_loss = cpu_first_loss(f"packed[{path}]", block,
                                  stats["losses"][0], params0, path=path,
                                  packed=True)
        out[path] = {"losses": stats["losses"], "auc": stats["auc"],
                     "cpu_first_loss": cpu_loss, "step_ms": stats["step_ms"],
                     "steady_step_ms": steady,
                     "build_pass_feed_s": stats["build_pass_feed_s"],
                     "pass_wall_s": wall, "pass_keys": n_keys,
                     "launches": launches[path]}
        if path == "mxu":
            out[path]["mxu_kept_fraction"] = stats["mxu_kept_fraction"]
        log(f"packed[{path}]: losses {stats['losses']}, auc {stats['auc']}, "
            f"launches {launches[path]}, step device ms {stats['step_ms']} "
            f"(steady median {steady:.3f}), build_pass_feed "
            f"{stats['build_pass_feed_s']:.2f} s, pass wall {wall:.2f} s"
            + (f", mxu plans keep {stats['mxu_kept_fraction']:.4f} of the "
               "sorted domain" if path == "mxu" else ""))
        if path != "mxu":
            # the same pass again from the same state: bit-identical ws
            again, _, _ = run_pass(block, "cuda", params=params0, path=path,
                                   packed=True, keep_ws=True)
            diff = [k for k in stats["ws"]
                    if not torch.equal(stats["ws"][k], again["ws"][k])]
            if diff:
                raise AssertionError(f"packed[{path}]: two identical passes "
                                     f"left different fields {diff}")
            out[path]["deterministic"] = True
            log(f"packed[{path}]: rerun left a bit-identical working set")
    first = [out[p]["losses"][0] for p in out]
    spread = (max(first) - min(first)) / abs(min(first))
    if spread > 1e-4:
        raise AssertionError(f"first-step losses of the lowerings differ by "
                             f"{spread:.3g} relative: {first}")
    log(f"packed: first-step losses {dict(zip(out, first))} agree within "
        f"{spread:.3g} relative (rtol 1e-4)")
    return launches, out


def profile_phase(seed: int = 1) -> dict:
    """Short passes (2 batches) with torch.profiler tracing the device
    during train_pass alone, one per entry point and lowering: device time
    by kernel, and the device-busy share of the steps' event windows
    (the rest is the device waiting for the host to launch work)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed)
    block = make_block(rng, 2 * BATCH)
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name, path, packed in (("slice_mxu", "mxu", False),
                               ("packed_mxu", "mxu", True),
                               ("packed_fast", "fast", True),
                               ("packed_ragged", "ragged", True)):
        holder = {}

        def around():
            holder["prof"] = profile(activities=[ProfilerActivity.CUDA],
                                     acc_events=True)
            return holder["prof"]

        stats, _, _ = run_pass(block, "cuda", path=path, packed=packed,
                               around_train=around)
        # device-side events only (kernels, memcpys, memsets): an
        # operator's row would count its kernels' time a second time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in holder["prof"].key_averages()
                if e.device_type == cuda and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        window_ms = sum(stats["step_ms"])
        share = 100 * busy_ms / window_ms
        log(f"profile[{name}]: device busy {busy_ms:.2f} ms of the steps' "
            f"{window_ms:.2f} ms event windows ({share:.1f} %), step "
            f"device ms {stats['step_ms']}")
        for key, ms, n in rows[:12]:
            log(f"profile[{name}]: {ms:8.3f} ms  x{n:<4d} {key[:80]}")
        out[name] = {"device_busy_ms": busy_ms, "step_window_ms": window_ms,
                     "step_ms": stats["step_ms"],
                     "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                             for k, ms, n in rows[:12]]}
    return out


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
    pool = gather_pool_phase(dev)
    for dist in kern:
        kern[dist]["gather_pool"] = pool[dist]
    slice_launches, slice_out = slice_phase()
    packed_launches, packed_out = packed_phase()
    profile_out = profile_phase()

    by_path = {"slice_mxu": slice_launches,
               **{f"packed_{p}": n for p, n in packed_launches.items()}}
    line = {"kernels": []}
    for name in KERNELS:
        k = kern["uniform"][name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(kern[d][name]["max_abs_err"] for d in kern),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    log("detail: " + json.dumps({"kernels_by_dist": kern,
                                 "slice": slice_out, "packed": packed_out,
                                 "profile": profile_out}))
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
