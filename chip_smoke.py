#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, and then no
result line is printed):

1. build  — compile every hand-written kernel of ``paddlebox_tpu_torch``
   (one ``nvcc`` per source, started together) and print the build time;
2. kernels — each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, for uniform, Zipf-1.2 and
   ``padded`` row ids (the packer's: lengths 1..3 of capacity 3, every
   padding occurrence on row 0 — a third of all positions, one sorted
   run).  The sorted gather and scatter at W = 12, p = 26·3·16384 =
   1,277,952 sorted occurrences over the 1,835,008-row working-set
   bucket of a ~1.6 M-key pass: the gather bit-exact, the scatter within
   rtol 1e-5 plus 1e-5 of each row's sum of |terms| (the plain
   ``index_add_`` adds with atomics in another order).  ``gather_pool``
   at the fast pull's shapes (table [1,835,008, 11], idx [425,984, 3],
   lengths 1..3), on a contiguous table and on the [N, 12] buffer's
   [N, 11] view that the fast path passes: bit-equal to the plain version
   (both sum at most 3 terms in order l = 0, 1, 2).  Two back-to-back
   calls of every kernel must be bit-identical.  Times are device times:
   CUDA events around back-to-back calls that are enqueued behind a
   device-side sleep, so host work between calls leaves no gaps;
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

5. reference — the streaming ``reference`` lowering (gather pull,
   ``fused_seqpool_cvm``, merged push through ``segment_sum``) on the
   slice's data and weights, 4 batches: exactly one ``scatter_add_sorted``
   launch per step and no other kernel; first-step loss = the CPU's
   (rtol 1e-4) and = the streaming mxu slice's (rtol 1e-5); a rerun gives
   bit-identical losses and working set;
6. amp — ``amp=True`` (bf16 model over f32 masters) on the packed ragged
   lowering (the JAX bench's configuration) and on packed mxu, on the
   packed phase's data and weights: steady step ms and
   ``build_pass_feed`` seconds, first-step loss within rtol 1e-2 of the
   same lowering's f32 run, and a bit-identical rerun;
7. rules — ``shared_adam``, ``adam``, ``std_adagrad`` and ``naive`` on
   packed mxu and ``shared_adam`` on ragged, 2 batches of 2048 each on
   the card, each step replayed on the CPU from the card's state before
   it with the card's pooled grads: the step's loss within rtol 1e-4,
   the working set after it within rtol 1e-4 / atol 1e-6, integer fields
   equal (``rules_phase`` says why);
8. models — ``CtrDnn`` (512-256-128) and ``WideDeep`` (256-128-64) on the
   reference lowering, and ``MMoE`` (4 experts, 2 tasks) through
   ``MultiTaskSparseTrainer`` with two label slots, 2 batches each at
   full batch: first-step loss = the CPU's within rtol 1e-4;
9. crossing — packed mxu with FLAGS_mxu_crossing pinned to take, then to
   sort, on the packed phase's data: losses and working set bit-equal;
   prints ``best_mode``'s measured choice and both timings for the pull
   and push crossings at this geometry.

Every phase sets the launch counters to 0 just before its main run and
reads them just after; a kernel of the path that did not launch fails
the run (and a kernel that the reference lowering does not run must not
launch).  The reruns of phases 5 and 6 are traced by torch.profiler, and
last, short traced passes (2 batches; streaming mxu and each packed
lowering) do the same for phases 3-4: device time by kernel, each
hand-written kernel's device time per step, the cuBLAS GEMMs' device
time per step, and the device-busy share of the steps' event windows.

Output: progress lines, a ``detail:`` JSON line, then a
``{"kernels": [...]}`` JSON line, the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        SlotConfig, SparseSGDConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM
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
# the CUDA kernels each wrapper launches, as the profiler names them
SYMBOLS = {"gather_sorted": ("gather_sorted_kernel",),
           "scatter_add_sorted": ("scatter_tiles_kernel",
                                  "scatter_combine_kernel"),
           "gather_pool": ("gather_pool_kernel",)}
# cuBLAS GEMM kernels as the profiler names them (the MLP's matmuls)
GEMM_MARKS = ("gemm", "nvjet", "splitK")

LABELS = ("label", "label1")               # MMoE's two label slots
RULES_BATCH = 2048
RULES = (("shared_adam", "mxu"), ("adam", "mxu"), ("std_adagrad", "mxu"),
         ("naive", "mxu"), ("shared_adam", "ragged"))


def make_model(name: str):
    """The models of the run at their widths.  Modules that only later
    slices of the port have are imported here, not at the top, so that
    kernel_ab.py can run the kernel phases on an older checkout."""
    emb = 3 + MF_DIM
    if name == "deepfm":
        return DeepFM(N_SLOTS, emb, DENSE_DIM, HIDDEN)
    if name == "ctr_dnn":
        from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
        return CtrDnn(N_SLOTS, emb, DENSE_DIM, (512, 256, 128))
    if name == "widedeep":
        from paddlebox_tpu_torch.models.widedeep import WideDeep
        return WideDeep(N_SLOTS, emb, DENSE_DIM, (256, 128, 64))
    if name == "mmoe":
        from paddlebox_tpu_torch.models.mmoe import MMoE
        return MMoE(N_SLOTS, emb, DENSE_DIM, num_experts=4, num_tasks=2)
    raise ValueError(f"unknown model {name!r}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(what: str, fn, iters: int = 20, warmup: int = 3,
            hold_cycles: int = 50_000_000) -> float:
    """Mean device time of one call of ``fn``, by CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls.  The calls are
    enqueued while a device-side sleep holds the stream, so the host's
    work per call (Python, allocation, launch) leaves no idle gaps between
    them on the device.  If the sleep ran out before the last call was
    enqueued, the timing is taken again behind a 4× longer sleep, three
    times in all; then it raises (``fn`` waits on the device, or its host
    work outlasts every sleep)."""
    tries = 3
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        held = not a.query()   # the device had not started the calls yet
        torch.cuda.synchronize()
        if held:
            return a.elapsed_time(b) / iters
        hold_cycles *= 4
    raise AssertionError(
        f"time_ms({what}): the device started the calls before the last "
        f"was enqueued, {tries} times; the last sleep held "
        f"{hold_cycles // 4} cycles")


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: the kernels against their plain versions
# ---------------------------------------------------------------------------

def twice(what: str, fn):
    """fn() twice back to back: the two results must be bit-identical
    (every kernel adds in a fixed order).  Returns the first."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    return a


def padded_rows(rng) -> np.ndarray:
    """The streaming packer's row ids for one step: each of the R_POOL
    (slot, record) rows holds 1..CAP ids and parks the CAP - length
    padding occurrences on row 0, about a third of all P positions."""
    lens = rng.integers(1, CAP + 1, R_POOL)
    ids = rng.integers(1, TABLE_ROWS, (R_POOL, CAP))
    return np.where(np.arange(CAP)[None, :] < lens[:, None], ids,
                    0).reshape(-1)


def kernel_phase(dev: torch.device, seed: int = 0):
    rng = np.random.default_rng(seed)
    rows_by_dist = {
        "uniform": rng.integers(1, TABLE_ROWS, P),
        # Zipf-1.2 ranks wrapped onto the table: one very hot row
        "zipf1.2": (rng.zipf(1.2, P) - 1) % (TABLE_ROWS - 1) + 1,
        "padded": padded_rows(rng),
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

        got = twice(f"gather_sorted ({dist})",
                    lambda: sp.gather_sorted(table, rows2d, dims))
        want = sp.gather_sorted_plain(table, rows2d, dims)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_sorted != plain ({dist})")
        g_err = float((got - want).abs().max())

        got = twice(f"scatter_add_sorted ({dist})",
                    lambda: sp.scatter_add_sorted(payload, rows2d,
                                                  first_occ, dims))
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
        g = {"ms": time_ms(f"gather_sorted ({dist})",
                           lambda: sp.gather_sorted(table, rows2d, dims)),
             "plain_ms": time_ms(
                 f"gather_sorted_plain ({dist})",
                 lambda: sp.gather_sorted_plain(table, rows2d, dims)),
             "library_ms": time_ms(
                 f"index_select ({dist})",
                 lambda: torch.index_select(table, 1, rows_l)),
             "max_abs_err": g_err}
        # bytes the gather must move: its row ids, the table columns this
        # plan touches, the output
        g["bound_ms"], g["bound_by"] = bound_ms(
            4 * dims.p_pad + 4 * W_PULL * n_unique + 4 * W_PULL * dims.p_pad,
            0)
        s = {"ms": time_ms(f"scatter_add_sorted ({dist})",
                           lambda: sp.scatter_add_sorted(
                               payload, rows2d, first_occ, dims)),
             "plain_ms": time_ms(f"scatter_add_sorted_plain ({dist})",
                                 lambda: sp.scatter_add_sorted_plain(
                                     payload, rows2d, first_occ, dims)),
             "library_ms": time_ms(f"index_add_ ({dist})", lambda: torch.zeros(
                 (W_PUSH, dims.n_kernel), device=dev).index_add_(
                     1, rows_l, payload)),
             "max_abs_err": s_err}
        # payload + row ids in (the run starts follow from the sorted
        # ids), the whole merged delta out; one add per payload value
        s["bound_ms"], s["bound_by"] = bound_ms(
            4 * W_PUSH * dims.p_pad + 4 * dims.p_pad
            + 4 * W_PUSH * dims.n_kernel, W_PUSH * dims.p)
        results[dist] = {"gather_sorted": g, "scatter_add_sorted": s,
                         "distinct_rows": n_unique,
                         "longest_run": int(torch.unique_consecutive(
                             rows2d.reshape(-1), return_counts=True)[1]
                             .max())}
        log(f"kernels[{dist}]: distinct rows {n_unique}, longest run "
            f"{results[dist]['longest_run']}; gather "
            f"{g['ms']:.4f} ms (plain {g['plain_ms']:.4f}, bound "
            f"{g['bound_ms']:.4f}); scatter {s['ms']:.4f} ms (plain "
            f"{s['plain_ms']:.4f}, bound {s['bound_ms']:.4f}); max err "
            f"{g_err} / {s_err}")
    return results


def gather_pool_phase(dev: torch.device, seed: int = 0,
                      layouts=("stride12", "stride11")):
    """gather_pool at the fast pull's shapes: table [TABLE_ROWS, 11],
    idx [425,984, 3] (26 slots × 16384 records), lengths 1..3, on two
    layouts of the same values: ``stride12`` (the [N, 12] buffer's
    [N, 11] view that the fast path passes; float4 rows) and ``stride11``
    (a contiguous table; 4-byte loads).  Beside each kernel time stands
    ``index_select`` of the same live rows with no pooling: the cost of
    fetching them.  Returns {dist: {layout: ...}}."""
    rng = np.random.default_rng(seed)
    lengths_np = rng.integers(1, CAP + 1, R_POOL).astype(np.int32)
    ids_by_dist = {
        "uniform": rng.integers(1, TABLE_ROWS, (R_POOL, CAP)),
        "zipf1.2": (rng.zipf(1.2, (R_POOL, CAP)) - 1) % (TABLE_ROWS - 1) + 1,
    }
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = {"stride12": torch.zeros((TABLE_ROWS, W_POOL + 1),
                                      device=dev)[:, :W_POOL]}
    tables["stride12"].copy_(torch.randn((TABLE_ROWS, W_POOL), generator=gen,
                                         device=dev))
    tables["stride12"][0] = 0.0
    tables["stride11"] = tables["stride12"].contiguous()
    lengths = torch.as_tensor(lengths_np, device=dev)
    live = np.arange(CAP)[None, :] < lengths_np[:, None]
    results = {}
    for dist, ids_np in ids_by_dist.items():
        idx = torch.as_tensor(ids_np.astype(np.int32), device=dev)
        mask = torch.as_tensor(live.astype(np.float32), device=dev)
        idx_l = idx.long()
        live_l = torch.as_tensor(ids_np[live], device=dev)
        n_rows = int(np.unique(ids_np[live]).size)
        results[dist] = {}
        for layout in layouts:
            table, what = tables[layout], f"({dist}, {layout})"
            got = twice(f"gather_pool {what}",
                        lambda: pg.gather_pool(table, idx, lengths))
            want = pg.gather_pool_plain(table, idx, lengths)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"gather_pool != plain {what}: max err "
                                     f"{err}")
            dense = tables["stride11"]
            k = {"ms": time_ms(f"gather_pool {what}",
                               lambda: pg.gather_pool(table, idx, lengths)),
                 "plain_ms": time_ms(
                     f"gather_pool_plain {what}",
                     lambda: pg.gather_pool_plain(table, idx, lengths)),
                 "library_ms": time_ms(
                     f"embedding_bag {what}",
                     lambda: torch.nn.functional.embedding_bag(
                         idx_l, dense, mode="sum",
                         per_sample_weights=mask)),
                 "live_rows_index_select_ms": time_ms(
                     f"index_select of the live rows {what}",
                     lambda: torch.index_select(table, 0, live_l)),
                 "max_abs_err": err, "distinct_rows": n_rows}
            # the same work on either layout: ids and lengths read once,
            # each distinct live row's 11 values once, the output written
            # once; one add per live (row, column)
            k["bound_ms"], k["bound_by"] = bound_ms(
                4 * R_POOL * CAP + 4 * R_POOL + 4 * W_POOL * n_rows
                + 4 * W_POOL * R_POOL, W_POOL * int(lengths_np.sum()))
            results[dist][layout] = k
            log(f"gather_pool[{dist}, {layout}]: distinct rows {n_rows}; "
                f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
                f"embedding_bag {k['library_ms']:.4f}, index_select of the "
                f"live rows {k['live_rows_index_select_ms']:.4f}, bound "
                f"{k['bound_ms']:.4f}); bit-equal to plain")
    return results


# ---------------------------------------------------------------------------
# phase 3: one training pass of the slice
# ---------------------------------------------------------------------------

def feed_config(n_labels: int = 1) -> DataFeedConfig:
    return DataFeedConfig(slots=tuple(
        [SlotConfig(name, dtype="float", is_dense=True, dim=1)
         for name in LABELS[:n_labels]]
        + [SlotConfig("dense0", dtype="float", is_dense=True, dim=DENSE_DIM)]
        + [SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(N_SLOTS)]))


def make_block(rng, n: int, n_labels: int = 1) -> SlotRecordBlock:
    """n records: 1..CAP feasigns per slot from the key space, 0/1 labels
    (one per label slot) and DENSE_DIM normal dense features."""
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
    for name in LABELS[1:n_labels]:
        blk.float_slots[name] = (rng.integers(0, 2, size=n).astype(
            np.float32), np.arange(n + 1, dtype=np.int64))
    return blk


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def make_trainer(block: SlotRecordBlock, device: str, params=None,
                 path: str = "mxu", model: str = "deepfm", amp: bool = False,
                 optimizer: str = "adagrad", batch: int = 0):
    """Engine lifecycle up to begin_pass over ``block``'s keys, and a
    trainer on ``device`` (from ``params`` when given).  model "mmoe"
    trains through MultiTaskSparseTrainer on two label slots (the
    reference lowering); ``path`` names the lowering of the others.
    ``batch``: the batch size, BATCH when 0.  Returns (engine, trainer,
    a dataset of ``block``, the model's initial params)."""
    n_labels = 2 if model == "mmoe" else 1
    cfg = feed_config(n_labels)
    dataset = SlotDataset(cfg)
    dataset._blocks = [block]
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0, optimizer=optimizer)),
        seed=0, device=device)
    engine.begin_feed_pass()
    engine.add_keys(block.all_keys())
    engine.end_feed_pass()
    engine.begin_pass()
    if model == "mmoe":
        from paddlebox_tpu_torch.trainer.multitask import \
            MultiTaskSparseTrainer
        trainer = MultiTaskSparseTrainer(
            engine, make_model(model), cfg, batch_size=batch or BATCH,
            label_slots=list(LABELS), seed=0, device=device)
    else:
        # amp only when asked, so an older checkout's trainer (kernel_ab)
        # takes the same call
        trainer = SparseTrainer(engine, make_model(model), cfg,
                                batch_size=batch or BATCH, seed=0,
                                sparse_path=path, device=device,
                                **({"amp": True} if amp else {}))
    if params is not None:
        trainer.model.load_jax_params(params)
    return engine, trainer, dataset, trainer.model.jax_params()


def run_pass(block: SlotRecordBlock, device: str, params=None,
             path: str = "mxu", packed: bool = False,
             keep_ws: bool = False, around_train=contextlib.nullcontext,
             **kw):
    """Engine lifecycle + one train_pass + end_pass on ``device``, on the
    streaming entry point or (packed) through build_pass_feed; ``kw``
    goes to :func:`make_trainer`.  Returns (stats, the model's initial
    params, pass keys); stats carries the feed build seconds and, with
    keep_ws, a copy of the trained working set taken before end_pass.
    ``around_train()`` is a context manager entered around the
    train_pass call alone."""
    engine, trainer, dataset, params0 = make_trainer(
        block, device, params, path, **kw)
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
            extra["mxu_eff_p_pad"] = kept
        with around_train():
            stats = trainer.train_pass(feed)
    else:
        with around_train():
            stats = trainer.train_pass(dataset, pack_threads=4)
    extra["crossing"] = list(getattr(trainer, "_mxu_crossing", ()))
    if keep_ws:
        extra["ws"] = {k: v.clone() for k, v in engine.ws.items()}
    engine.end_pass()
    stats.update(extra)
    stats["timers"] = {"trainer": trainer.timers.report(),
                       "engine": engine.print_sync_timers()}
    if engine.table.size() != n_keys:
        raise AssertionError("end_pass did not write every pass key back")
    return stats, params0, n_keys


def check_pass(what: str, stats: dict, launches: dict, per_batch: dict,
               n_batches: int = N_BATCHES, exact: bool = False) -> None:
    """Finite losses, a reported AUC, and each kernel of the path
    launched at least (exact: exactly) ``per_batch[name]`` times per
    batch."""
    losses = stats["losses"]
    if stats["batches"] != n_batches or len(losses) != n_batches:
        raise AssertionError(f"{what}: trained {stats['batches']} batches")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss: {losses}")
    if not math.isfinite(stats["auc"]):
        raise AssertionError(f"{what}: AUC not reported: {stats['auc']}")
    for name, k in per_batch.items():
        n = launches[name]
        if n != k * n_batches if exact else n < k * n_batches:
            raise AssertionError(
                f"{what}: {name} launched {n} times in a pass of "
                f"{n_batches} batches (want {'' if exact else '>= '}{k} per "
                "batch)")


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


def same_bits(what: str, a: dict, b: dict) -> None:
    """Two runs of one pass: equal losses and a bit-identical working
    set."""
    if a["losses"] != b["losses"]:
        raise AssertionError(f"{what}: rerun losses {b['losses']} != "
                             f"{a['losses']}")
    diff = [k for k in a["ws"] if not torch.equal(a["ws"][k], b["ws"][k])]
    if diff:
        raise AssertionError(f"{what}: two identical passes left different "
                             f"fields {diff}")


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
                      "pass_keys": n_keys}, block, params0


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
            out[path]["crossing"] = stats["crossing"]
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
            same_bits(f"packed[{path}]", stats, again)
            out[path]["deterministic"] = True
            log(f"packed[{path}]: rerun left a bit-identical working set")
    first = [out[p]["losses"][0] for p in out]
    spread = (max(first) - min(first)) / abs(min(first))
    if spread > 1e-4:
        raise AssertionError(f"first-step losses of the lowerings differ by "
                             f"{spread:.3g} relative: {first}")
    log(f"packed: first-step losses {dict(zip(out, first))} agree within "
        f"{spread:.3g} relative (rtol 1e-4)")
    return launches, out, block, params0


def profiled(what: str, prof, stats: dict, symbols=SYMBOLS) -> dict:
    """Summary of a pass traced by torch.profiler: device time by kernel,
    the device time per step of each wrapper's CUDA kernels (named in
    ``symbols``) and of the cuBLAS GEMMs, and the device-busy share of
    the steps' event windows (the rest is the device waiting for the host
    to launch work)."""
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events only (kernels, memcpys, memsets): an operator's
    # row would count its kernels' time a second time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    window_ms = sum(stats["step_ms"])
    n_steps = len(stats["step_ms"])
    per_step = {k: sum(ms for key, ms, _ in rows
                       if any(sym in key for sym in syms)) / n_steps
                for k, syms in symbols.items()}
    gemm = sum(ms for key, ms, _ in rows
               if any(m in key for m in GEMM_MARKS)) / n_steps
    log(f"profile[{what}]: device busy {busy_ms:.2f} ms of the steps' "
        f"{window_ms:.2f} ms event windows ({100 * busy_ms / window_ms:.1f} "
        f"%), step device ms {stats['step_ms']}; device ms per step: "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_step.items())
        + f", GEMMs {gemm:.4f}")
    for key, ms, n in rows[:12]:
        log(f"profile[{what}]: {ms:8.3f} ms  x{n:<4d} {key[:80]}")
    return {"device_busy_ms": busy_ms, "step_window_ms": window_ms,
            "busy_share": busy_ms / window_ms, "step_ms": stats["step_ms"],
            "kernel_ms_per_step": per_step, "gemm_ms_per_step": gemm,
            "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                    for k, ms, n in rows[:12]]}


def tracer(holder: dict):
    """A context-manager factory for run_pass's ``around_train`` that
    traces the device and keeps the profiler in ``holder["prof"]``."""
    from torch.profiler import ProfilerActivity, profile

    def around():
        holder["prof"] = profile(activities=[ProfilerActivity.CUDA],
                                 acc_events=True)
        return holder["prof"]
    return around


# ---------------------------------------------------------------------------
# phases 5-9: the reference lowering, amp, the optimizer rules, the models
# and the sort crossing
# ---------------------------------------------------------------------------

def reference_phase(block: SlotRecordBlock, params0, mxu_first: float):
    """The streaming reference lowering on the slice's data and weights:
    one scatter launch per step and nothing else; first step = the
    CPU's and = the streaming mxu slice's; a rerun (traced) gives the
    same bits."""
    reset_counts()
    stats, _, _ = run_pass(block, "cuda", params=params0, path="reference",
                           keep_ws=True)
    launches = read_counts()
    check_pass("reference", stats, launches,
               {"gather_sorted": 0, "scatter_add_sorted": 1,
                "gather_pool": 0}, exact=True)
    first = stats["losses"][0]
    if not math.isclose(first, mxu_first, rel_tol=1e-5):
        raise AssertionError(f"reference: first-step loss {first} vs the "
                             f"streaming mxu slice's {mxu_first}")
    cpu_loss = cpu_first_loss("reference", block, first, params0,
                              path="reference")
    holder = {}
    again, _, _ = run_pass(block, "cuda", params=params0, path="reference",
                           keep_ws=True, around_train=tracer(holder))
    same_bits("reference", stats, again)
    steady = float(np.median(stats["step_ms"][1:]))
    log(f"reference: losses {stats['losses']}, auc {stats['auc']}, "
        f"launches {launches}, step device ms {stats['step_ms']} (steady "
        f"median {steady:.3f}); first step = mxu's {mxu_first!r} (rtol "
        "1e-5); rerun bit-identical")
    return launches, {"losses": stats["losses"], "auc": stats["auc"],
                      "cpu_first_loss": cpu_loss, "mxu_first_loss": mxu_first,
                      "step_ms": stats["step_ms"], "steady_step_ms": steady,
                      "deterministic": True,
                      "profile": profiled("reference", holder["prof"],
                                          again)}


def amp_phase(block: SlotRecordBlock, params0, packed_out: dict):
    """amp=True on packed ragged and mxu with the packed phase's data and
    weights: first step within rtol 1e-2 of the lowering's f32 run, and a
    (traced) rerun with the same bits."""
    launches, out = {}, {}
    for path in ("ragged", "mxu"):
        reset_counts()
        stats, _, _ = run_pass(block, "cuda", params=params0, path=path,
                               packed=True, keep_ws=True, amp=True)
        launches[path] = read_counts()
        what = f"amp[{path}]"
        check_pass(what, stats, launches[path], PACKED_KERNELS[path])
        f32 = packed_out[path]["losses"][0]
        gap = abs(stats["losses"][0] - f32) / abs(f32)
        if gap > 1e-2:
            raise AssertionError(f"{what}: first-step loss "
                                 f"{stats['losses'][0]} vs f32 {f32}")
        holder = {}
        again, _, _ = run_pass(block, "cuda", params=params0, path=path,
                               packed=True, keep_ws=True, amp=True,
                               around_train=tracer(holder))
        same_bits(what, stats, again)
        steady = float(np.median(stats["step_ms"][1:]))
        log(f"{what}: losses {stats['losses']}, auc {stats['auc']}, "
            f"launches {launches[path]}, step device ms {stats['step_ms']} "
            f"(steady median {steady:.3f}, f32 "
            f"{packed_out[path]['steady_step_ms']:.3f}), build_pass_feed "
            f"{stats['build_pass_feed_s']:.2f} s; first step {gap:.3g} "
            "relative from f32 (rtol 1e-2); rerun bit-identical")
        out[path] = {"losses": stats["losses"], "auc": stats["auc"],
                     "f32_first_loss": f32, "first_loss_gap": gap,
                     "step_ms": stats["step_ms"], "steady_step_ms": steady,
                     "build_pass_feed_s": stats["build_pass_feed_s"],
                     "deterministic": True,
                     "profile": profiled(what, holder["prof"], again)}
    return launches, out


def close_ws(what: str, card: dict, cpu: dict) -> None:
    """The card's and the CPU's working set after the same step: integer
    fields equal, float fields within rtol 1e-4 / atol 1e-6."""
    for k, v in card.items():
        got, want = v.cpu(), cpu[k].cpu()
        if got.dtype.is_floating_point:
            ok = torch.allclose(got, want, rtol=1e-4, atol=1e-6)
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(
                f"{what}: field {k} differs between the card and the CPU "
                f"(max abs {float((got.double() - want.double()).abs().max())})")


def pooled_grads(trainer, sink: list, replace=None) -> None:
    """Record the pooled-feature grads that each step of ``trainer``
    hands to its sparse push (the dense half's third result); with
    ``replace``, hand on the next of those tensors instead."""
    half = trainer._pooled_dense_half

    def spy(*args):
        loss, preds, d_pooled = half(*args)
        sink.append(d_pooled.clone())
        if replace is not None:
            d_pooled = replace.pop(0)
        return loss, preds, d_pooled
    trainer._pooled_dense_half = spy


def trainer_state(engine, trainer) -> dict:
    """A copy of everything one step reads and writes but the data: the
    working set, the dense weights and the dense optimizer's state."""
    return {"ws": {k: v.clone() for k, v in engine.ws.items()},
            "model": {k: v.clone()
                      for k, v in trainer.model.state_dict().items()},
            "opt": copy.deepcopy(trainer.dense_opt.state_dict())}


def load_state(engine, trainer, state: dict) -> None:
    for k, v in state["ws"].items():
        engine.ws[k].copy_(v)
    trainer.model.load_state_dict(state["model"])
    trainer.dense_opt.load_state_dict(state["opt"])


def rules_phase(seed: int = 3):
    """Each sparse optimizer rule, 2 batches of RULES_BATCH on the card;
    each step is replayed on the CPU from the card's state before it,
    its sparse push fed the card's pooled grads: the step's loss within
    rtol 1e-4, the working set after it close (close_ws).

    Why the replay, and why the card's pooled grads.  A ReLU unit whose
    input lies within rounding of 0 passes the grad on one device and
    not on the other: the loss does not move, but that record's pooled
    grads do.  And the adam rules' update m1 / (sqrt(m2) + eps) is
    steepest, 1.6e5 times the grad, where a scaled grad lies near
    eps / sqrt(1 - beta2) ~ 3e-7; the dense Adam's first steps amplify
    likewise.  So a pass trained through on two devices drifts apart by
    up to the learning rate without a fault.  The pooled grads' largest
    gap is logged."""
    rng = np.random.default_rng(seed)
    block = make_block(rng, 2 * RULES_BATCH)
    halves = [block.slice(i * RULES_BATCH, (i + 1) * RULES_BATCH)
              for i in range(2)]
    launches, out = {}, {}
    for rule, path in RULES:
        what, key = f"rules[{rule}, {path}]", f"{rule}_{path}"
        kw = dict(path=path, optimizer=rule, batch=RULES_BATCH)
        engine, trainer, dataset, params0 = make_trainer(block, "cuda", **kw)
        feed = trainer.build_pass_feed(dataset)
        states, grads = [trainer_state(engine, trainer)], []
        pooled_grads(trainer, grads)
        reset_counts()
        card = trainer.train_pass(feed, progress=lambda _: states.append(
            trainer_state(engine, trainer)))
        launches[key] = read_counts()
        check_pass(what, card, launches[key], PACKED_KERNELS[path],
                   n_batches=2)
        cpu_engine, cpu_trainer, _, _ = make_trainer(block, "cpu", params0,
                                                     **kw)
        cpu_grads = []
        pooled_grads(cpu_trainer, cpu_grads, [g.cpu() for g in grads])
        cpu_losses, grad_gap = [], []
        for i, half in enumerate(halves):
            load_state(cpu_engine, cpu_trainer, states[i])
            one = SlotDataset(dataset.feed_config)
            one._blocks = [half]
            loss = cpu_trainer.train_pass(
                cpu_trainer.build_pass_feed(one))["losses"][0]
            cpu_losses.append(loss)
            if not math.isclose(card["losses"][i], loss, rel_tol=1e-4):
                raise AssertionError(f"{what}: step {i} loss card "
                                     f"{card['losses'][i]} vs CPU {loss}")
            close_ws(f"{what} step {i}", states[i + 1]["ws"], cpu_engine.ws)
            grad_gap.append(float((grads[i].cpu() - cpu_grads[i])
                                  .abs().max()))
        engine.end_pass()
        cpu_engine.end_pass()
        log(f"{what}: losses card {card['losses']} vs CPU {cpu_losses} "
            "(rtol 1e-4); working set after each step within rtol 1e-4 / "
            f"atol 1e-6; pooled grads' largest gap per step {grad_gap}")
        out[key] = {"losses": card["losses"], "cpu_losses": cpu_losses,
                    "pooled_grad_gap": grad_gap, "step_ms": card["step_ms"]}
    return launches, out


def models_phase(seed: int = 4):
    """CtrDnn and WideDeep on the reference lowering and MMoE through
    MultiTaskSparseTrainer, 2 batches at full batch: one scatter launch
    per step, first step = the CPU's."""
    rng = np.random.default_rng(seed)
    block = make_block(rng, 2 * BATCH, n_labels=2)
    launches, out = {}, {}
    for model in ("ctr_dnn", "widedeep", "mmoe"):
        reset_counts()
        stats, params0, _ = run_pass(block, "cuda", path="reference",
                                     model=model)
        launches[model] = read_counts()
        check_pass(f"models[{model}]", stats, launches[model],
                   {"gather_sorted": 0, "scatter_add_sorted": 1,
                    "gather_pool": 0}, n_batches=2, exact=True)
        cpu_loss = cpu_first_loss(f"models[{model}]", block,
                                  stats["losses"][0], params0,
                                  path="reference", model=model)
        out[model] = {"losses": stats["losses"], "auc": stats["auc"],
                      "cpu_first_loss": cpu_loss, "step_ms": stats["step_ms"]}
        if model == "mmoe":
            out[model]["task_aucs"] = [stats["task0_auc"],
                                       stats["task1_auc"]]
        log(f"models[{model}]: losses {stats['losses']}, auc {stats['auc']}, "
            f"launches {launches[model]}, step device ms {stats['step_ms']}")
    return launches, out


def crossing_phase(block: SlotRecordBlock, params0):
    """Packed mxu with FLAGS_mxu_crossing pinned to take, then to sort:
    the same bits; then best_mode's measured choice at this geometry."""
    from paddlebox_tpu_torch.ops import crossing as cx
    launches, runs = {}, {}
    try:
        for mode in ("take", "sort"):
            flags.set_flags({"mxu_crossing": mode})
            reset_counts()
            runs[mode], _, _ = run_pass(block, "cuda", params=params0,
                                        path="mxu", packed=True, keep_ws=True)
            launches[mode] = read_counts()
            check_pass(f"crossing[{mode}]", runs[mode], launches[mode],
                       PACKED_KERNELS["mxu"])
            if runs[mode]["crossing"] != [mode, mode]:
                raise AssertionError(f"crossing[{mode}]: the step crossed by "
                                     f"{runs[mode]['crossing']}")
    finally:
        flags.set_flags({"mxu_crossing": "auto"})
    same_bits("crossing: sort vs take", runs["take"], runs["sort"])
    p = N_SLOTS * CAP * BATCH
    eff = runs["take"]["mxu_eff_p_pad"]
    # the geometries _crossing_modes asks for with the static planes
    tuned = {"pull": cx.measure(p, p, 3 + MF_DIM, "float32"),
             "push": cx.measure(eff, p, 1 + MF_DIM, "float32")}
    for k, (mode, t_take, t_sort) in tuned.items():
        log(f"crossing[{k}]: best_mode picks {mode} (take {t_take:.4f} ms, "
            f"sort {t_sort:.4f} ms)")
    log("crossing: sort and take leave bit-equal losses and working set; "
        f"step device ms take {runs['take']['step_ms']}, sort "
        f"{runs['sort']['step_ms']}")
    return launches, {
        "losses": runs["take"]["losses"],
        "step_ms": {m: runs[m]["step_ms"] for m in runs},
        "best_mode": {k: {"mode": m, "take_ms": a, "sort_ms": b}
                      for k, (m, a, b) in tuned.items()}}


def profile_phase(seed: int = 1, symbols=SYMBOLS) -> dict:
    """Short traced passes (2 batches) of the lowerings that phases 3-4
    run once untraced: device time by kernel, per step, and the
    device-busy share (see :func:`profiled`)."""
    rng = np.random.default_rng(seed)
    block = make_block(rng, 2 * BATCH)
    out = {}
    for name, path, packed in (("slice_mxu", "mxu", False),
                               ("packed_mxu", "mxu", True),
                               ("packed_fast", "fast", True),
                               ("packed_ragged", "ragged", True)):
        holder = {}
        stats, _, _ = run_pass(block, "cuda", path=path, packed=packed,
                               around_train=tracer(holder))
        out[name] = profiled(name, holder["prof"], stats, symbols)
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
    for dist in pool:     # the fast path's table layout
        kern[dist]["gather_pool"] = pool[dist]["stride12"]
    slice_launches, slice_out, slice_block, slice_params = slice_phase()
    packed_launches, packed_out, packed_block, packed_params = packed_phase()
    ref_launches, ref_out = reference_phase(slice_block, slice_params,
                                            slice_out["losses"][0])
    amp_launches, amp_out = amp_phase(packed_block, packed_params,
                                      packed_out)
    rules_launches, rules_out = rules_phase()
    models_launches, models_out = models_phase()
    cross_launches, cross_out = crossing_phase(packed_block, packed_params)
    profile_out = profile_phase()

    by_path = {"slice_mxu": slice_launches,
               **{f"packed_{p}": n for p, n in packed_launches.items()},
               "slice_reference": ref_launches,
               **{f"amp_{p}": n for p, n in amp_launches.items()},
               **{f"rules_{p}": n for p, n in rules_launches.items()},
               **{f"models_{p}": n for p, n in models_launches.items()},
               **{f"crossing_{p}": n for p, n in cross_launches.items()}}
    line = {"kernels": []}
    for name in KERNELS:
        k = kern["uniform"][name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(kern[d][name]["max_abs_err"] for d in kern
                               if name in kern[d]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    log("detail: " + json.dumps({"kernels_by_dist": kern,
                                 "gather_pool_by_layout": pool,
                                 "slice": slice_out, "packed": packed_out,
                                 "reference": ref_out, "amp": amp_out,
                                 "rules": rules_out, "models": models_out,
                                 "crossing": cross_out,
                                 "profile": profile_out}))
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
