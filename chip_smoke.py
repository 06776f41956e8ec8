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
   calls of every kernel must be bit-identical.  The sorted gather and
   scatter run again at W = 20 (3 + 8 + 8 + 1 pull, 8 + 8 + 4 push: an
   expand table with mf_ex width 8), where the scatter stages its 12
   payload columns per round twice, the second round partial (8), under
   the same checks.  Times are device times:
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
   and push crossings at this geometry;
10. lifecycle — the multi-pass day loop: 2 days × 3 passes × 4 batches of
   16384 (fresh keys per pass from the 2 M key space, so consecutive
   passes share most of their keys), a date change between the days, on
   the default lowering (auto → mxu) and on ragged; each first through
   the serial engine lifecycle, then through ``PassPrefetcher`` with
   in-memory loads, from the same data, weights and table seed.  Per-pass
   losses, the final host table (every key, every field), the dense
   weights and Adam's state must be bit-identical between the two, and
   the prefetched run must have re-pulled stale rows.  Then the device
   row cache (``LIFE_CACHE_RUNS``): mxu serial and prefetched with
   2,097,152 rows (the whole key space), mxu prefetched with the flag's
   default 262,144 rows (evicts every pass; key-space heat on), ragged
   prefetched with 2,097,152, each over day 1's 3 passes and day 2's
   first — each must leave the bits of its lowering's cache-off serial
   run after those 4 passes, hit on every warm pass, and (262,144)
   evict.  Every run's pass mapper must have resolved its keys through
   the native hash.  Before the runs, ``host_tier_ab`` times the host
   tier's choices at the day loop's sizes, each against its
   alternative, and checks that both give the same answer: the host
   table's pass pull and write-back on its sorted view and on the native
   hash, ``PassKeyMapper`` on the native hash and on the binary search
   (the packer's calls and one refresh call), and ``build_working_set``'s
   fresh pinned buffers against a reused pinned pool (two working sets
   built back to back must both stay intact).  Prints the day walls, the
   pass walls, the prefetch wait and build seconds, the last pass's
   ``feed.*_hidden_s``, the stale-row refresh, the engine timers, the
   mapper's native and binary-search rows and, per cache run, the
   per-pass hit rate, table rows, refreshed rows, fallback rows and
   evictions, the cache's gather and fold seconds, its row and store
   bytes, the median pass wall beside the cache-off run's over the
   same passes, and the heat summary;
11. recovery — ``fleet.train_passes`` over 3 slot text files of 4 × 16384
   records (one reader thread) with a ``TrainCheckpoint``: the feed's
   parser must be the native one and read a pass file into the Python
   parser's blocks bit for bit (both timed); a fault-free run, then
   seeded kills (``FaultPlan(seed=13).kill_at(point, at=(1,))``) at
   ``end_pass`` (serial and prefetched) and at ``ckpt_commit`` (serial),
   and with the device cache on at the third pass's ``end_pass``
   (prefetched; that pass served hits), each resumed
   (``resume=2``) to the fault-free run's bits with at least one
   auto-resume.  Prints the checkpoint save seconds by kind, the restore
   seconds, the generations kept and their size, and a base save and
   restore of the whole table after the day;
12. rank — ``RankAttentionCTR`` (att_out 32, max_rank 3, MLP 128-64) on
   the page-view feed: the bench widths (26 slots × capacity 3, mf_dim 8,
   13 dense, batch 16384, keys from the 2 M key space), one pass of 4
   pv-aligned batches (page views of 1-4 records with distinct search
   ids, cmatch from {222, 223, 224}, rank 0-3; batches 2-4 a few records
   short, so padded), slot s0's first feasign one of 4,096 user ids and
   named as uid_slot, ``rank_offset`` and ``ads_offset`` on, after
   ``preprocess_instance()``; through the streaming and the packed
   entry point on auto → mxu from the same weights.  Each pass must
   launch ``gather_sorted`` and ``scatter_add_sorted`` exactly once a
   batch (and ``gather_pool`` never), report wuauc over at least one
   user, and its first step must equal the same step on the CPU (rtol
   1e-4); the two passes' losses agree within rtol 1e-4 and their user
   counts equal the data's count of users with both classes; the packed
   feed's rank_offset and ads_offset planes on the card equal the host
   planes bit for bit; a packed rerun from the
   same state (traced, rank_attention's forward annotated) leaves the
   same losses, working set and dense weights bit for bit; and
   ``Fleet.metrics`` fed the packed pass's preds through
   ``MetricGroup.update`` gives an ``auc`` metric equal to the trainer's
   within 1e-6, a ``cmatch_rank_group="222:1,223:2"`` metric over exactly
   those records and a ``wuauc`` metric equal to the trainer's within
   1e-9.  Prints the steady step, the WuAUC host seconds a pass (the
   preds' copy to the host each batch), ``build_pass_feed`` and
   ``plane_build`` seconds, and rank_attention's device ms a step in the
   traced pass and alone (forward + backward at the step's shapes), with
   the GEMMs' ms.
13. options — the rest of the one-card trainer at the bench widths (26
   slots × capacity 3, mf_dim 8, 13 dense, batch 16384, 4 batches, keys
   from the 2 M key space): (a) an expand table (``expand_dim`` 8) under
   ``CtrDnn(emb_width=19)`` (MLP 400-400-400), streaming and packed on
   auto → mxu: ``gather_sorted`` and ``scatter_add_sorted`` exactly once
   a batch, each at W = 20, ``gather_pool`` never; the first step = the
   CPU's (rtol 1e-4); mf_ex trained; a packed rerun (traced) keeps the
   bits; (b) DeepFM on packed mxu with
   ``TrainerConfig(dense_sync_mode="async_table", sync_weight_step=1)``
   beside the same pass with synchronous Adam: finite losses, pushed =
   applied, the module's final params = the table's ``pull()``,
   ``dense_opt`` never stepped, every grads' copy on the main thread and
   the table's updates on its own thread (numpy only); (c) a packed pass
   with ``dump_path`` in a temporary directory over records with
   ``ins_id``s, the last batch short: one line per real record, ids and
   labels in order, preds = the pass's to 6 decimals; (d) the five
   ``fused_seqpool_cvm`` variants forward + backward at [26, 16384, 3, E]
   against the CPU (rtol 1e-5, atol 1e-6) with device ms each; (e)
   ``alias_sample`` of 10^6 draws from a card generator, chi-square
   against the table at p > 1e-3.  Prints the steady steps, the two
   kernels' traced device ms a step, the grads' copy ms, the dump's host
   seconds, the variants' ms and the sampler's.

Depth cuts of phases 10-11 (the widths are the bench model's): a day of
3 passes of 4 batches; the cache runs of phase 10 stop after the first
pass of day 2 (4 passes).

Every phase sets the launch counters to 0 just before its main run and
reads them just after; a kernel of the path that did not launch fails
the run (and a kernel that the reference lowering does not run must not
launch).  The reruns of phases 5, 6 and 12 are traced by torch.profiler, and
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
import os
import shutil
import subprocess
import sys
import tempfile
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
EX_DIM = 8                                 # phase 13's expand (mf_ex) width
W_EX = 3 + MF_DIM + EX_DIM + 1             # 20: pull and push with mf_ex
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
    if name == "ctr_dnn_ex":    # over an expand table: 3 + D + Dex = 19
        from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
        return CtrDnn(N_SLOTS, emb + EX_DIM, DENSE_DIM, HIDDEN)
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


def kernel_phase(dev: torch.device, seed: int = 0, w_pull: int = W_PULL,
                 w_push: int = W_PUSH):
    """The sorted gather and scatter against their plain versions at
    widths ``w_pull`` / ``w_push`` (12 on the bench table; 20 with an
    expand table, whose scatter runs a second, partial column round).
    Returns {dist: {kernel: numbers}}."""
    rng = np.random.default_rng(seed)
    rows_by_dist = {
        "uniform": rng.integers(1, TABLE_ROWS, P),
        # Zipf-1.2 ranks wrapped onto the table: one very hot row
        "zipf1.2": (rng.zipf(1.2, P) - 1) % (TABLE_ROWS - 1) + 1,
        "padded": padded_rows(rng),
    }
    dims = sp.spmm_dims(P, TABLE_ROWS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((w_pull, dims.n_kernel), generator=gen, device=dev)
    table[:, 0] = 0.0
    table[:, TABLE_ROWS:] = 0.0             # the zero sentinel tile
    results = {}
    for dist, rows_np in rows_by_dist.items():
        rows = torch.as_tensor(rows_np.astype(np.int32), device=dev)
        plan = sp.build_plan(rows, dims)
        rows2d, first_occ = plan[0], plan[7]
        payload = torch.randn((w_push, dims.p_pad), generator=gen,
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
            4 * dims.p_pad + 4 * w_pull * n_unique + 4 * w_pull * dims.p_pad,
            0)
        s = {"ms": time_ms(f"scatter_add_sorted ({dist})",
                           lambda: sp.scatter_add_sorted(
                               payload, rows2d, first_occ, dims)),
             "plain_ms": time_ms(f"scatter_add_sorted_plain ({dist})",
                                 lambda: sp.scatter_add_sorted_plain(
                                     payload, rows2d, first_occ, dims)),
             "library_ms": time_ms(f"index_add_ ({dist})", lambda: torch.zeros(
                 (w_push, dims.n_kernel), device=dev).index_add_(
                     1, rows_l, payload)),
             "max_abs_err": s_err}
        # payload + row ids in (the run starts follow from the sorted
        # ids), the whole merged delta out; one add per payload value
        s["bound_ms"], s["bound_by"] = bound_ms(
            4 * w_push * dims.p_pad + 4 * dims.p_pad
            + 4 * w_push * dims.n_kernel, w_push * dims.p)
        results[dist] = {"gather_sorted": g, "scatter_add_sorted": s,
                         "distinct_rows": n_unique,
                         "longest_run": int(torch.unique_consecutive(
                             rows2d.reshape(-1), return_counts=True)[1]
                             .max())}
        log(f"kernels[{dist}, W={w_pull}/{w_push}]: distinct rows "
            f"{n_unique}, longest run "
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
                 optimizer: str = "adagrad", batch: int = 0,
                 trainer_config=None):
    """Engine lifecycle up to begin_pass over ``block``'s keys, and a
    trainer on ``device`` (from ``params`` when given).  model "mmoe"
    trains through MultiTaskSparseTrainer on two label slots (the
    reference lowering); ``path`` names the lowering of the others.
    ``batch``: the batch size, BATCH when 0.  Model "ctr_dnn_ex" trains
    over a table with an EX_DIM-wide expand embedding;
    ``trainer_config``: the trainer's TrainerConfig.  Returns (engine,
    trainer, a dataset of ``block``, the model's initial params)."""
    n_labels = 2 if model == "mmoe" else 1
    cfg = feed_config(n_labels)
    dataset = SlotDataset(cfg)
    dataset._blocks = [block]
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        expand_dim=EX_DIM if model == "ctr_dnn_ex" else 0,
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
        # amp and trainer_config only when asked, so an older checkout's
        # trainer (kernel_ab) takes the same call
        extra = {"amp": True} if amp else {}
        if trainer_config is not None:
            extra["trainer_config"] = trainer_config
        trainer = SparseTrainer(engine, make_model(model), cfg,
                                batch_size=batch or BATCH, seed=0,
                                sparse_path=path, device=device, **extra)
    if params is not None:
        trainer.model.load_jax_params(params)
    return engine, trainer, dataset, trainer.model.jax_params()


def run_pass(block: SlotRecordBlock, device: str, params=None,
             path: str = "mxu", packed: bool = False,
             keep_ws: bool = False, around_train=contextlib.nullcontext,
             hold: dict = None, **kw):
    """Engine lifecycle + one train_pass + end_pass on ``device``, on the
    streaming entry point or (packed) through build_pass_feed; ``kw``
    goes to :func:`make_trainer`.  Returns (stats, the model's initial
    params, pass keys); stats carries the feed build seconds and, with
    keep_ws, a copy of the trained working set taken before end_pass.
    ``around_train()`` is a context manager entered around the
    train_pass call alone.  ``hold``: a dict that gets the engine, the
    trainer and (with keep_ws) the working set before training."""
    engine, trainer, dataset, params0 = make_trainer(
        block, device, params, path, **kw)
    if hold is not None:
        hold.update(engine=engine, trainer=trainer)
        if keep_ws:
            hold["ws0"] = {k: v.clone() for k, v in engine.ws.items()}
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
    extra["path"] = trainer._resolve_path()
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


def check_launches(what: str, launches: dict, per_batch: dict,
                   n_batches: int) -> None:
    """Each kernel of the path launched at least ``per_batch[name]``
    times per batch over ``n_batches`` batches."""
    for name, k in per_batch.items():
        if launches[name] < k * n_batches:
            raise AssertionError(
                f"{what}: {name} launched {launches[name]} times over "
                f"{n_batches} batches (want >= {k} per batch)")


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
    # row would count its kernels' time a second time, and so would the
    # device-timeline span of a record_function (a trace with CPU activity
    # has them)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
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


# ---------------------------------------------------------------------------
# phases 10-11: the multi-pass day loop and crash recovery
# ---------------------------------------------------------------------------

LIFE_DATES = ("20261016", "20261017")      # 2 days
LIFE_PASSES = 3                            # passes per day, N_BATCHES each
REC_PASSES, REC_DATE = 3, "20261016"       # recovery: 3 passes, full size
# the lowerings of the day loop: the default (auto → mxu on one card) and
# ragged, whose host CSR build the prefetch exists to hide
LIFE_PATHS = (("mxu", "auto"), ("ragged", "ragged"))
# the device-cache runs of the day loop, each held against the cache-off
# serial run of its lowering: (label, path, prefetch, cache rows, heat).
# 2,097,152 rows hold the whole 2 M key space; 262,144 (the flag's
# default) evicts every pass and makes the prefetched adoption take the
# fallback pull
CACHE_ROWS = 2_097_152
# the cache runs' depth: day 1's passes and day 2's first (the change of
# date drops the cache, so the 4th pass is cold again), held against the
# cache-off serial run's world after the same 4 passes
LIFE_CACHE_DEPTH = LIFE_PASSES + 1
LIFE_CACHE_RUNS = (("mxu", "auto", False, CACHE_ROWS, False),
                   ("mxu", "auto", True, CACHE_ROWS, False),
                   ("mxu", "auto", True, 262_144, True),
                   ("ragged", "ragged", True, CACHE_ROWS, False))
# counters the main thread moves, read at every pass end
PASS_COUNTERS = ("ps.cache.hits", "ps.cache.gather_fallback_rows",
                 "ps.cache.evictions", "ps.engine.stale_refresh_rows")
# which index resolved the pass mapper's keys
INDEX_COUNTERS = ("ps.mapper.native_rows", "ps.mapper.sorted_rows")


def day_trainer(device: str, path: str):
    """A fresh engine and trainer of the bench model on ``device``."""
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0, device=device)
    trainer = SparseTrainer(engine, make_model("deepfm"), feed_config(),
                            batch_size=BATCH, seed=0, sparse_path=path,
                            device=device)
    return engine, trainer


@contextlib.contextmanager
def engine_flags(cache_rows: int = 0, heat_on: bool = False):
    """Engines built inside take the device cache (``cache_rows`` > 0)
    and key-space heat; both are off again after."""
    from paddlebox_tpu_torch.ps import heat
    flags.set_flags({"ps_device_cache": cache_rows > 0,
                     "ps_device_cache_rows": cache_rows or CACHE_ROWS,
                     "obs_heat": heat_on})
    try:
        yield
    finally:
        flags.set_flags({"ps_device_cache": False, "obs_heat": False})
        heat.disable()


def one_pass_dataset(block: SlotRecordBlock) -> SlotDataset:
    ds = SlotDataset(feed_config())
    ds._blocks = [block]
    return ds


def stat_delta(before: dict, after: dict, key: str) -> float:
    return after.get(key, 0.0) - before.get(key, 0.0)


def table_state(table):
    """Every key of the host table, sorted, and all its fields."""
    keys = np.sort(table.export_keys())
    return keys, table.bulk_pull(keys)


def same_world(what: str, a: dict, b: dict) -> None:
    """Two runs left bit-identical per-pass losses, host tables (every
    key, every field) and dense weights and optimizer state."""
    if a["losses"] != b["losses"]:
        raise AssertionError(f"{what}: per-pass losses differ: "
                             f"{a['losses']} vs {b['losses']}")
    (ka, ta), (kb, tb) = a["table"], b["table"]
    if not np.array_equal(ka, kb):
        raise AssertionError(f"{what}: the tables hold other keys "
                             f"({len(ka)} vs {len(kb)})")
    diff = [f for f in ta if not np.array_equal(ta[f], tb[f])]
    if diff:
        raise AssertionError(f"{what}: table fields {diff} differ")
    diff = [k for k in a["dense"] if not torch.equal(a["dense"][k],
                                                      b["dense"][k])]
    if diff:
        raise AssertionError(f"{what}: dense tensors {diff} differ")


def world_of(engine, trainer, losses) -> dict:
    dense = {f"model.{k}": v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    for i, st in trainer.dense_opt.state_dict()["state"].items():
        for k, v in st.items():
            dense[f"opt.{i}.{k}"] = v.clone()
    return {"losses": losses, "table": table_state(engine.table),
            "dense": dense}


def heat_summary() -> dict:
    """What the heat sketches saw of the run: the pull site's working-set
    rows (HLL, since the last change of date) and Zipf fit, the sketches'
    bytes and the device cache's coverage."""
    from paddlebox_tpu_torch.ps import heat
    if heat.ACTIVE is None:
        raise AssertionError("heat was asked for but is off")
    r = heat.ACTIVE.render(topn=100)
    pull = r["sites"]["pull"]
    return {"working_set_rows": pull["working_set_rows"],
            "zipf_exponent": pull["zipf_exponent"],
            "topk_share": pull["topk_share"],
            "sketch_bytes": r["sketch_bytes"],
            "cache_hot_coverage": r["cache_hot_coverage"],
            "sites": sorted(r["sites"])}


def day_loop(blocks, device: str, path: str, prefetch: bool,
             capture_at: int = 0):
    """The passes of ``blocks`` (one list of pass blocks per day of
    LIFE_DATES) through the engine lifecycle, serially or through
    PassPrefetcher.  Returns the world it left and a dict: the time each
    pass's end_pass returned, the loop start, the engine's timers
    {name: (seconds, count)}, the feed seconds hidden under step windows
    summed over the passes, and per pass the keys, the cache hit rate set
    at adoption and the deltas of PASS_COUNTERS; with the cache on, its
    row and store bytes; with heat on, its summary; with ``capture_at``,
    the world after that many passes (``world_at``)."""
    from paddlebox_tpu_torch.data.prefetch import PassPrefetcher
    from paddlebox_tpu_torch.utils.monitor import stat_get
    engine, trainer = day_trainer(device, path)
    losses, ends, per_pass = [], [], []
    hidden = dict.fromkeys(("pull", "pack", "upload", "write"), 0.0)
    prev = {k: stat_get(k) for k in PASS_COUNTERS}

    paused = [0.0]      # seconds spent capturing, kept out of the walls

    def pass_ended():
        ends.append(time.perf_counter() - paused[0])
        if len(ends) == capture_at:
            c0 = time.perf_counter()
            info["world_at"] = world_of(engine, trainer, list(losses))
            paused[0] += time.perf_counter() - c0
        for k in hidden:
            hidden[k] += stat_get(f"feed.{k}_hidden_s")
        cur = {k: stat_get(k) for k in PASS_COUNTERS}
        per_pass.append({"keys": engine.num_keys,
                         "hit_rate": stat_get("ps.cache.hit_rate"),
                         **{k.split(".")[-1]: cur[k] - prev[k]
                            for k in PASS_COUNTERS}})
        prev.update(cur)

    info = {}
    t0 = time.perf_counter()
    if not prefetch:
        for date, day in zip(LIFE_DATES, blocks):
            engine.set_date(date)
            for block in day:
                engine.begin_feed_pass()
                engine.add_keys(block.all_keys())
                engine.end_feed_pass()
                engine.begin_pass()
                feed = trainer.build_pass_feed(one_pass_dataset(block))
                losses.append(trainer.train_pass(feed)["losses"])
                engine.end_pass()
                pass_ended()
    else:
        with PassPrefetcher(engine, trainer) as pre:
            for date, day in zip(LIFE_DATES, blocks):
                for block in day:
                    def load(block=block):
                        engine.add_keys(block.all_keys())
                        return one_pass_dataset(block)
                    pre.submit(load, tag=date, date=date)
            for _ in range(sum(len(day) for day in blocks)):
                feed = pre.next_pass()
                losses.append(trainer.train_pass(feed)["losses"])
                pre.end_pass()
                pass_ended()
    if device == "cuda":
        torch.cuda.synchronize()
    info.update(ends=ends, t0=t0, per_pass=per_pass, hidden=hidden,
                timers={n: (secs, c) for n, secs, c in engine.timers.rows()})
    if engine.cache is not None:
        if engine.cache.device != engine.device:
            raise AssertionError("the cache's store is not on the engine's "
                                 "device")
        info["cache"] = {"row_bytes": engine.cache.row_bytes,
                         "store_bytes": engine.cache.store_bytes,
                         "resident_rows": engine.cache.resident_rows}
    from paddlebox_tpu_torch.ps import heat
    if heat.ACTIVE is not None:
        info["heat"] = heat_summary()
    return world_of(engine, trainer, losses), info


def median_s(fn, reps: int = 3) -> float:
    """Median wall seconds of ``reps`` calls of ``fn`` after one warm
    call (which also fills PyTorch's pinned-memory cache)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# the packer's mapper calls: 4 pack threads → 8 record ranges per slot
# of a 65,536-record pass, 1-3 keys a record (``pass_feed._record_ranges``)
PACK_CALL_KEYS = N_BATCHES * BATCH // 8 * (CAP + 1) // 2


def pooled_build(host_soa: dict, dev: torch.device, pool: dict) -> dict:
    """The staging the port does not keep, timed against its fresh
    buffers: ``build_working_set`` with each field's pinned buffer of the
    last build rewritten in place once that build's copy (a CUDA event)
    has finished; only row 0 and the stale tail are zeroed."""
    n = len(host_soa["show"])
    total, ws = size_bucket(n + 1), {}
    for f, src in host_soa.items():
        if f == "unseen_days":
            continue
        dtype = torch.int32 if src.dtype == np.int32 else torch.float32
        shape = (total,) + src.shape[1:]
        buf, done = pool.get(f, (None, None))
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            buf = torch.zeros(shape, dtype=dtype,
                              pin_memory=dev.type == "cuda")
        else:
            if done is not None:
                done.synchronize()
            host = buf.numpy()
            host[0] = 0
            host[n + 1:] = 0
        buf.numpy()[1:n + 1] = src
        done = None
        if dev.type == "cuda":
            ws[f] = buf.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            ws[f] = buf.clone()
        pool[f] = (buf, done)
    return ws


def native_lookup(shard, keys):
    """``_Shard.lookup`` through the native hash, which the port's host
    table does not use, for the index A/B: the hash takes the keys the
    shard appended since the last call (the A/B never replaces a
    shard's rows), then answers one probe per key."""
    from paddlebox_tpu_torch.native import hash_map
    with shard.lock:
        h = shard.__dict__.get("_ab_hash")
        if h is None:
            h = shard._ab_hash = hash_map.NativeKeyHash(max(shard.size, 1024))
        if len(h) < shard.size:
            h.upsert(shard.keys[len(h):])
        rows = h.find(np.asarray(keys, np.uint64))
        return np.maximum(rows, 0), rows >= 0


def host_tier_ab(seed: int = 12, device: str = "cuda",
                 occurrences: int = N_BATCHES * BATCH * N_SLOTS * (CAP + 1)
                 // 2) -> dict:
    """The host tier's choices, timed at the day loop's sizes on this
    machine's CPU, each against its alternative: the key
    index of the host table's pass pull and write-back (the port's sorted
    view against the native hash, ``native_lookup``), the index of
    ``PassKeyMapper`` at the packer's call size and at a refresh's (the
    port's native hash against the binary search), and the working set's
    staging (fresh pinned buffers, which PyTorch's caching host allocator
    recycles once their copies finish, against ``pooled_build``).  Both
    sides of each must give the same answer, and two working sets built
    back to back must both stay intact."""
    from paddlebox_tpu_torch.native import hash_map
    from paddlebox_tpu_torch.ps import embedding, host_table
    if not hash_map.available():
        raise AssertionError("index: the native library did not build")
    rng = np.random.default_rng(seed)
    occs = [rng.integers(1, KEY_SPACE, size=occurrences).astype(np.uint64)
            for _ in range(3)]
    passes = [np.unique(o) for o in occs]
    cfg = EmbeddingTableConfig(embedding_dim=MF_DIM, shard_num=8,
                               sgd=SparseSGDConfig(mf_create_thresholds=0.0))

    def table_run():
        table, t, pulled = host_table.ShardedHostTable(cfg, seed=0), {}, []
        for i, keys in enumerate(passes):
            t0 = time.perf_counter()
            rows = table.bulk_pull(keys)
            t[f"pull{i}"] = time.perf_counter() - t0
            rows["show"] = rows["show"] + 1.0
            pulled.append(rows)
            t0 = time.perf_counter()
            table.bulk_write(keys, rows)
            t[f"write{i}"] = time.perf_counter() - t0
        return t, pulled

    def mapper_run():
        t0 = time.perf_counter()
        mapper = embedding.PassKeyMapper(passes[2])
        pack = [mapper(occs[2][i:i + PACK_CALL_KEYS])
                for i in range(0, occurrences, PACK_CALL_KEYS)]
        pack_s = time.perf_counter() - t0
        stale = passes[2][np.isin(passes[2], passes[1])]
        t0 = time.perf_counter()
        refresh = mapper(stale)
        return (pack_s, time.perf_counter() - t0, np.concatenate(pack),
                refresh)

    srt_t, srt_rows = table_run()
    real_lookup = host_table._Shard.lookup
    host_table._Shard.lookup = native_lookup
    try:
        nat_t, nat_rows = table_run()
    finally:
        host_table._Shard.lookup = real_lookup
    nat_map = mapper_run()
    real_available = hash_map.available
    hash_map.available = lambda: False
    try:
        srt_map = mapper_run()
    finally:
        hash_map.available = real_available
    for a, b in zip(nat_rows, srt_rows):
        if any(not np.array_equal(a[f], b[f]) for f in a):
            raise AssertionError("index: the native and sorted host-table "
                                 "pulls differ")
    if not (np.array_equal(nat_map[2], srt_map[2])
            and np.array_equal(nat_map[3], srt_map[3])):
        raise AssertionError("index: the native and sorted mappers differ")
    index = {"keys_per_pass": [len(k) for k in passes],
             "table_sorted_s": srt_t, "table_native_s": nat_t,
             "mapper_pack_calls": -(-occurrences // PACK_CALL_KEYS),
             "mapper_pack_keys": occurrences,
             "mapper_pack_s": {"native": nat_map[0], "sorted": srt_map[0]},
             "mapper_refresh_keys": int(len(nat_map[3])),
             "mapper_refresh_s": {"native": nat_map[1],
                                  "sorted": srt_map[1]}}
    log("index: host table pull/write s of passes 2-3, sorted view (the "
        "port's) "
        + " ".join(f"{k}={v:.3f}" for k, v in srt_t.items() if k[-1] != "0")
        + " | native hash "
        + " ".join(f"{k}={v:.3f}" for k, v in nat_t.items() if k[-1] != "0")
        + f"; mapper: {index['mapper_pack_calls']} pack calls of "
        f"{PACK_CALL_KEYS} keys native (the port's, hash build included) "
        f"{nat_map[0]:.3f} s, binary search {srt_map[0]:.3f} s; one refresh "
        f"call of {len(nat_map[3])} keys native {nat_map[1]:.3f} s, binary "
        f"search {srt_map[1]:.3f} s")

    soa = dict(srt_rows[2])
    soa2 = {f: v + 1 for f, v in soa.items()}
    n, dev, pool = len(soa["show"]), torch.device(device), {}

    def build(src, pooled=False):
        ws = (pooled_build(src, dev, pool) if pooled
              else embedding.build_working_set(src, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return ws

    staging = {"rows": n, "fields": len(soa),
               "fresh_s": median_s(lambda: build(soa)),
               "pooled_s": median_s(lambda: build(soa, True))}
    ws1, ws2 = build(soa), build(soa2)
    pooled = build(soa2, True)
    for f in ws1:
        got = ws1[f][1:n + 1].cpu().numpy()
        if not np.array_equal(got, soa[f].astype(got.dtype)):
            raise AssertionError(f"staging: the first working set's {f} "
                                 "was overwritten by the second build")
        if not torch.equal(ws2[f], pooled[f]):
            raise AssertionError(f"staging: the fresh and pooled builds' "
                                 f"{f} differ")
    log(f"staging: build_working_set of {n} rows × {len(ws1)} fields, "
        f"fresh buffers (the port's) {staging['fresh_s']:.4f} s, a reused "
        f"pinned pool {staging['pooled_s']:.4f} s (medians of 3); two "
        "working sets built back to back stay intact")
    return {"index": index, "staging": staging}


def log_run(what: str, r: dict, info: dict) -> None:
    walls = r["pass_wall_s"]
    timers = info["timers"]
    log(f"{what}: day wall s {[round(x, 3) for x in r['day_wall_s']]}"
        f", median pass wall {r['median_pass_wall_s']:.3f} s (passes "
        f"{[round(x, 3) for x in walls]}), prefetch wait "
        f"{r.get('prefetch_wait_s', 0.0):.3f} s, prefetch build "
        f"{r.get('prefetch_build_s', 0.0):.3f} s, hidden s of the "
        f"last pass {r['hidden_s_last_pass']} and of all passes "
        f"{info['hidden']}, refresh_stale {r['refresh_stale_s']:.3f} s for "
        f"{int(r['stale_refresh_rows'])} rows, launches {r['launches']}; "
        f"index rows {r['index_rows']}; engine timers s "
        + " ".join(f"{n}={t:.3f}/{c}" for n, (t, c) in sorted(timers.items())))


def lifecycle_phase(seed: int = 5, device: str = "cuda"):
    """The day loop at the bench model's full width: 2 days × 3 passes ×
    N_BATCHES batches, each lowering serial then prefetched from the same
    data, weights and table seed; the two runs must leave the same bits,
    and the prefetched one must have re-pulled stale rows.  Then the
    LIFE_CACHE_RUNS with the device cache on, each of which must leave
    the bits of its lowering's cache-off run."""
    from paddlebox_tpu_torch.utils.monitor import stat_get, stat_snapshot
    rng = np.random.default_rng(seed)
    t_data = time.perf_counter()
    blocks = [[make_block(rng, N_BATCHES * BATCH)
               for _ in range(LIFE_PASSES)] for _ in LIFE_DATES]
    log(f"lifecycle: data for {len(LIFE_DATES)} days × {LIFE_PASSES} passes "
        f"× {N_BATCHES} batches made in {time.perf_counter() - t_data:.2f} s")
    n_batches = len(LIFE_DATES) * LIFE_PASSES * N_BATCHES
    launches, out = {}, {"host_ab": host_tier_ab(device=device)}

    cut = [blocks[0], blocks[1][:LIFE_CACHE_DEPTH - LIFE_PASSES]]

    def one_run(key, what, label, path, prefetch, cache=False):
        s0 = stat_snapshot("")
        reset_counts()
        world, info = day_loop(
            cut if cache else blocks, device, path, prefetch,
            capture_at=LIFE_CACHE_DEPTH if not (cache or prefetch) else 0)
        launches[key] = read_counts()
        s1 = stat_snapshot("")
        check_launches(what, launches[key], PACKED_KERNELS[label],
                       LIFE_CACHE_DEPTH * N_BATCHES if cache else n_batches)
        flat = [x for p in world["losses"] for x in p]
        if not all(math.isfinite(x) for x in flat):
            raise AssertionError(f"{what}: non-finite loss")
        ends, t0 = info["ends"], info["t0"]
        walls = [float(x) for x in np.diff([t0] + ends)]
        index = {k: stat_delta(s0, s1, k) for k in INDEX_COUNTERS}
        if index["ps.mapper.native_rows"] <= 0 or \
                index["ps.mapper.sorted_rows"] > 0:
            raise AssertionError(f"{what}: the pass mapper did not run "
                                 f"native: {index}")
        r = {"day_wall_s": [ends[LIFE_PASSES - 1] - t0,
                            ends[-1] - ends[LIFE_PASSES - 1]],
             "passes": len(ends),
             "pass_wall_s": walls,
             "median_pass_wall_s": float(np.median(walls)),
             "stale_refresh_rows": stat_delta(
                 s0, s1, "ps.engine.stale_refresh_rows"),
             "refresh_stale_s": info["timers"].get(
                 "refresh_stale", (0.0, 0))[0],
             "build_pull_rows": stat_delta(s0, s1,
                                           "ps.engine.build_pull_rows"),
             "hidden_s_last_pass": {
                 k: stat_get(f"feed.{k}_hidden_s")
                 for k in ("pull", "pack", "upload", "write")},
             "hidden_s_all_passes": info["hidden"],
             "engine_timers": info["timers"],
             "per_pass": info["per_pass"],
             "index_rows": {k.split(".", 1)[1]: v for k, v in index.items()},
             "first_losses": world["losses"][0],
             "launches": launches[key]}
        if prefetch:
            r["prefetch_wait_s"] = stat_delta(s0, s1,
                                              "data.prefetch.wait_s.sum")
            r["prefetch_build_s"] = stat_delta(s0, s1,
                                               "data.prefetch.build_s.sum")
        for k in ("cache", "heat"):
            if k in info:
                r[k] = info[k]
        out[key] = r
        log_run(what, r, info)
        return world, r, info.get("world_at")

    for label, path in LIFE_PATHS:
        worlds = {}
        for mode in ("serial", "prefetch"):
            key, what = f"{label}_{mode}", f"lifecycle[{label},{mode}]"
            worlds[mode], r, at = one_run(key, what, label, path,
                                          mode == "prefetch")
            if at is not None:
                worlds["cut"] = at   # what the cache runs must leave
            if mode == "prefetch" and r["stale_refresh_rows"] <= 0:
                raise AssertionError(f"{what}: the stale-row refresh "
                                     "re-pulled no row")
        same_world(f"lifecycle[{label}] prefetch vs serial",
                   worlds["serial"], worlds["prefetch"])
        log(f"lifecycle[{label}]: prefetched = serial bitwise (per-pass "
            f"losses, {len(worlds['serial']['table'][0])} table keys × "
            "every field, dense weights and Adam state)")
        for c_label, c_path, prefetch, rows, heat_on in LIFE_CACHE_RUNS:
            if c_label != label:
                continue
            mode = "prefetch" if prefetch else "serial"
            key = f"{label}_{mode}_cache{rows}"
            what = f"lifecycle[{label},{mode},cache={rows}]"
            with engine_flags(rows, heat_on):
                world, r, _ = one_run(key, what, label, c_path, prefetch,
                                      cache=True)
            same_world(f"{what} vs cache off", worlds["cut"], world)
            check_cache_run(what, r, prefetch, rows)
            base = float(np.median(
                out[f"{label}_{mode}"]["pass_wall_s"][:LIFE_CACHE_DEPTH]))
            pp = r["per_pass"]
            log(f"{what}: = cache off bitwise; median pass wall "
                f"{r['median_pass_wall_s']:.3f} s vs {base:.3f} s cache off "
                f"({mode}); per pass hit_rate "
                f"{[round(p['hit_rate'], 4) for p in pp]}, build_pull_rows "
                f"{[p['keys'] - int(p['hits']) for p in pp]}, "
                f"stale_refresh_rows "
                f"{[int(p['stale_refresh_rows']) for p in pp]}, "
                f"gather_fallback_rows "
                f"{[int(p['gather_fallback_rows']) for p in pp]}, evictions "
                f"{[int(p['evictions']) for p in pp]}; cache_gather "
                f"{r['engine_timers'].get('cache_gather', (0.0, 0))[0]:.3f} s"
                f", cache_fold "
                f"{r['engine_timers'].get('cache_fold', (0.0, 0))[0]:.3f} s;"
                f" row_bytes {r['cache']['row_bytes']}, store "
                f"{r['cache']['store_bytes'] / 2**20:.1f} MiB"
                + (f"; heat {r['heat']}" if "heat" in r else ""))
            del world
        del worlds
    return launches, out


def check_cache_run(what: str, r: dict, prefetch: bool, rows: int) -> None:
    """Passes 1 and 4 are cold (set_date drops the cache).  Serially,
    passes 2 and 3 find the earlier passes' rows resident.  Under the
    prefetcher, pass N+1's snapshot is taken while pass N trains, before
    its fold-back: pass 3 finds pass 1's rows, and whether pass 2 finds
    any races the worker against the fold-back.  The per-pass table rows
    must add up to the run's ``build_pull_rows``, and the 262,144-row
    cache must evict."""
    pp = r["per_pass"]
    warm = (1, 2) if not prefetch else (2,)
    cold = [i + 1 for i in warm if pp[i]["hits"] <= 0]
    if cold or pp[0]["hits"] or pp[LIFE_PASSES]["hits"]:
        raise AssertionError(f"{what}: hits per pass "
                             f"{[p['hits'] for p in pp]}")
    pulled = sum(p["keys"] - p["hits"] for p in pp)
    if pulled != r["build_pull_rows"]:
        raise AssertionError(f"{what}: per-pass pulls {pulled} vs "
                             f"build_pull_rows {r['build_pull_rows']}")
    evictions = sum(p["evictions"] for p in pp)
    if rows < KEY_SPACE and evictions <= 0:
        raise AssertionError(f"{what}: a {rows}-row cache evicted nothing")
    if r["cache"]["store_bytes"] != r["cache"]["row_bytes"] * rows:
        raise AssertionError(f"{what}: store bytes {r['cache']}")


def write_slot_file(path: str, block: SlotRecordBlock) -> None:
    """``block`` as MultiSlot text: per record the label, the dense
    values and each slot's feasigns, each group led by its length.  Built
    column by column (one list of per-record strings per group)."""
    n = block.n
    label = block.float_slots["label"][0].astype(np.int64).tolist()
    dense = np.char.mod("%.6g", block.float_slots["dense0"][0].reshape(
        n, DENSE_DIM)).tolist()
    cols = [[f"1 {x}" for x in label],
            [f"{DENSE_DIM} " + " ".join(row) for row in dense]]
    for i in range(N_SLOTS):
        vals, off = block.uint64_slots[f"s{i}"]
        ids = vals.astype(str).tolist()
        off = off.tolist()
        cols.append([f"{off[r + 1] - off[r]} "
                     + " ".join(ids[off[r]:off[r + 1]]) for r in range(n)])
    with open(path, "w") as f:
        f.write("\n".join(" ".join(parts) for parts in zip(*cols)) + "\n")


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


# (case, kill point, which hit of it kills (0 = the first pass's),
#  prefetch, device-cache rows or 0).  The cache case dies at the third
# pass's write-back: under the prefetcher that pass is the first to find
# rows resident (its snapshot follows pass 1's fold-back), so the kill
# drops a cache that served hits
RECOVERY_CASES = (("fault_free", None, 0, False, 0),
                  ("end_pass_serial", "end_pass", 1, False, 0),
                  ("end_pass_prefetch", "end_pass", 1, True, 0),
                  ("ckpt_commit_serial", "ckpt_commit", 1, False, 0),
                  ("end_pass_prefetch_cache", "end_pass", 2, True,
                   CACHE_ROWS))


def parser_check(path: str) -> dict:
    """The feed's parser on the card is the native one, and it reads one
    pass file into the Python parser's blocks bit for bit; both timed."""
    from paddlebox_tpu_torch.data.data_feed import DataFeed, make_parser
    from paddlebox_tpu_torch.native.slot_parser import NativeSlotParser
    if not isinstance(make_parser(feed_config()), NativeSlotParser):
        raise AssertionError("recovery: make_parser did not return the "
                             "native parser (did the native library build?)")
    feeds = {"native": DataFeed(feed_config()),
             "python": DataFeed(feed_config(), use_native=False)}
    blocks, secs = {}, {}
    for name, feed in feeds.items():
        t0 = time.perf_counter()
        blocks[name] = list(feed.read_file(path))
        secs[name] = time.perf_counter() - t0
    nat, py = blocks["native"], blocks["python"]
    if sum(b.n for b in nat) != N_BATCHES * BATCH or len(nat) != len(py):
        raise AssertionError(f"recovery: parsed {sum(b.n for b in nat)} "
                             f"records in {len(nat)} blocks")
    for a, b in zip(nat, py):
        for kind in ("uint64_slots", "float_slots"):
            ga, gb = getattr(a, kind), getattr(b, kind)
            for name in gb:
                if any(x.dtype != y.dtype or not np.array_equal(x, y)
                       for x, y in zip(ga[name], gb[name])):
                    raise AssertionError(f"recovery: native and Python "
                                         f"parsers differ on {name}")
    log(f"recovery: the native parser reads a pass file ({N_BATCHES * BATCH}"
        f" records) in {secs['native']:.3f} s, the Python parser in "
        f"{secs['python']:.3f} s: the same blocks bitwise")
    return {"native_parse_s": secs["native"],
            "python_parse_s": secs["python"]}


def recovery_phase(seed: int = 6, device: str = "cuda"):
    """fleet.train_passes over slot text files (REC_PASSES passes of
    N_BATCHES × BATCH records, one reader thread, the native parser) with
    a TrainCheckpoint: a fault-free run, then seeded kills at end_pass
    (serial, prefetched, and prefetched with the device cache on) and at
    ckpt_commit (serial), each resumed (resume=2) to the fault-free run's
    bits."""
    from paddlebox_tpu_torch import fleet
    from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
    from paddlebox_tpu_torch.ps import faults
    from paddlebox_tpu_torch.utils import flight
    from paddlebox_tpu_torch.utils.monitor import stat_snapshot
    rng = np.random.default_rng(seed)
    work = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    try:
        files = []
        t0 = time.perf_counter()
        for p in range(REC_PASSES):
            path = os.path.join(work, f"pass{p}.txt")
            write_slot_file(path, make_block(rng, N_BATCHES * BATCH))
            files.append([path])
        write_s = time.perf_counter() - t0
        log(f"recovery: {REC_PASSES} files of {N_BATCHES * BATCH} records "
            f"written in {write_s:.2f} s")
        launches, out, base = {}, parser_check(files[0][0]), None
        for case, point, hit, prefetch, cache_rows in RECOVERY_CASES:
            what = f"recovery[{case}]"
            with engine_flags(cache_rows):
                engine, trainer = day_trainer(device, "auto")
            ds = fleet.BoxPSDataset(feed_config(), engine=engine,
                                    read_threads=1)
            root = os.path.join(work, case)
            ck = TrainCheckpoint(root)
            s0 = stat_snapshot("")
            m0 = time.monotonic()
            reset_counts()
            if point is not None:
                flags.set_flags({"ps_fault_injection": True})
                faults.install(faults.FaultPlan(seed=13).kill_at(point,
                                                                 at=(hit,)))
            try:
                metrics = fleet.train_passes(trainer, ds, files,
                                             date=REC_DATE,
                                             prefetch=prefetch,
                                             checkpoint=ck, resume=2)
            finally:
                faults.uninstall()
                flags.set_flags({"ps_fault_injection": False})
            if device == "cuda":
                torch.cuda.synchronize()
            launches[case] = read_counts()
            s1 = stat_snapshot("")
            check_launches(what, launches[case], PACKED_KERNELS["mxu"],
                           REC_PASSES * N_BATCHES)
            if any(m is None for m in metrics) or len(metrics) != REC_PASSES:
                raise AssertionError(f"{what}: trained {metrics!r}")
            world = world_of(engine, trainer, [m["losses"] for m in metrics])
            resumes = stat_delta(s0, s1, "ps.fleet.auto_resume")
            if point is not None and resumes < 1:
                raise AssertionError(f"{what}: no auto-resume ran")
            saves = [(e["gen_kind"], e["save_s"])
                     for e in reversed(flight.events(kind="ckpt_commit"))
                     if e["mono"] >= m0]
            gens = sorted(n for n in os.listdir(root)
                          if n.startswith("gen-"))
            r = {"losses": world["losses"], "auto_resume": resumes,
                 "base_save_s": [t for k, t in saves if k == "base"],
                 "delta_save_s": [t for k, t in saves if k == "delta"],
                 "restores": stat_delta(s0, s1, "ckpt.restore_s.count"),
                 "restore_s": stat_delta(s0, s1, "ckpt.restore_s.sum"),
                 "generations_kept": gens, "ckpt_bytes": dir_bytes(root),
                 "table_rows": len(world["table"][0]),
                 "launches": launches[case]}
            if engine.cache is not None:
                r["cache_hits"] = stat_delta(s0, s1, "ps.cache.hits")
                r["cache_invalidations"] = stat_delta(
                    s0, s1, "ps.cache.invalidations")
                if r["cache_invalidations"] < 2 or r["cache_hits"] <= 0:
                    raise AssertionError(
                        f"{what}: {int(r['cache_hits'])} cache hits, "
                        f"{int(r['cache_invalidations'])} invalidations")
            if base is None:
                base = world
                # a base generation of the whole table after the day, the
                # size a day change writes, timed and restored once
                full = TrainCheckpoint(os.path.join(work, "full"))
                t0 = time.perf_counter()
                full.save(engine, trainer)
                r["full_base_save_s"] = time.perf_counter() - t0
                r["full_base_bytes"] = dir_bytes(full.root)
                e2, t2 = day_trainer(device, "auto")
                t0 = time.perf_counter()
                full.resume(e2, t2)
                r["full_base_restore_s"] = time.perf_counter() - t0
                same_world(f"{what} full base restore",
                           world, world_of(e2, t2, world["losses"]))
                del e2, t2
            else:
                same_world(f"{what} vs fault-free", base, world)
            out[case] = r
            log(f"{what}: losses {world['losses']}, auto_resume "
                f"{int(resumes)}, ckpt save s base {r['base_save_s']} delta "
                f"{r['delta_save_s']}, restore {r['restore_s']:.3f} s over "
                f"{int(r['restores'])} restores, generations kept {gens} "
                f"({r['ckpt_bytes'] / 2**20:.1f} MiB), launches "
                f"{launches[case]}"
                + ("" if point is None else "; = fault-free bitwise")
                + (f"; cache hits {int(r['cache_hits'])}, invalidations "
                   f"{int(r['cache_invalidations'])}"
                   if "cache_hits" in r else "")
                + (f"; full-table base ({r['table_rows']} rows) save "
                   f"{r['full_base_save_s']:.2f} s, "
                   f"{r['full_base_bytes'] / 2**20:.1f} MiB, restore "
                   f"{r['full_base_restore_s']:.2f} s"
                   if "full_base_save_s" in r else ""))
            shutil.rmtree(root, ignore_errors=True)
        return launches, out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: the page-view feed, RankAttentionCTR and the per-user metrics
# ---------------------------------------------------------------------------

RANK_WIDTHS = dict(att_out=32, max_rank=3, hidden=(128, 64))
N_USERS = 4096                       # slot s0's first feasign: the user id
# the autograd nodes of rank_attention's backward, as the profiler names
# them (the MLP's are AddmmBackward0): its row-gather, one-hot product and
# GEMM
RANK_BACKWARD = tuple(f"autograd::engine::evaluate_function: {n}"
                      for n in ("IndexBackward0", "BmmBackward0",
                                "MmBackward0"))


def rank_feed_config() -> DataFeedConfig:
    return DataFeedConfig(slots=feed_config().slots, rank_offset=True,
                          ads_offset=True, max_rank=3, uid_slot="s0")


def pv_sizes(rng, total: int) -> np.ndarray:
    """Page-view sizes 1..4 summing to ``total``, the first of size 4."""
    draws = rng.integers(1, 5, total)
    csum = 4 + np.cumsum(draws)
    k = int(np.searchsorted(csum, total))
    return np.concatenate([[4], draws[:k], [total - csum[k - 1]]])


def rank_block(rng) -> SlotRecordBlock:
    """N_BATCHES groups of page views, group k holding BATCH - k records
    (so batches 2-4 are short and padded), each group's search ids above
    the last group's, every group opening with a 4-record pv: after
    preprocess_instance the pv-aligned cuts are exactly the groups.
    cmatch from {222, 223, 224}, rank 0..3, and slot s0's first feasign
    one of N_USERS user ids."""
    groups = [pv_sizes(rng, BATCH - k) for k in range(N_BATCHES)]
    n = sum(int(g.sum()) for g in groups)
    blk = make_block(rng, n)
    vals, offs = blk.uint64_slots["s0"]
    vals[offs[:-1]] = rng.integers(1, N_USERS + 1, n).astype(np.uint64)
    blk.search_ids = np.concatenate([
        np.repeat((k * 10**6 + rng.choice(10**6, len(g), replace=False))
                  .astype(np.uint64), g) for k, g in enumerate(groups)])
    blk.cmatch = rng.choice([222, 223, 224], n).astype(np.int32)
    blk.rank = rng.integers(0, 4, n).astype(np.int32)
    return blk


def rank_trainer(block: SlotRecordBlock, device: str, params=None):
    """Engine lifecycle over ``block``'s keys and a RankAttentionCTR
    trainer (auto → mxu) on a pv-grouped dataset of it."""
    from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR
    cfg = rank_feed_config()
    dataset = SlotDataset(cfg)
    dataset._blocks = [block]
    dataset.preprocess_instance()
    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=8,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=0, device=device)
    engine.begin_feed_pass()
    engine.add_keys(block.all_keys())
    engine.end_feed_pass()
    engine.begin_pass()
    trainer = SparseTrainer(
        engine, RankAttentionCTR(N_SLOTS, 3 + MF_DIM, DENSE_DIM,
                                 **RANK_WIDTHS),
        cfg, batch_size=BATCH, seed=0, device=device)
    if params is not None:
        trainer.model.load_jax_params(params)
    return engine, trainer, dataset, trainer.model.jax_params()


def rank_run(block: SlotRecordBlock, device: str, params=None,
             packed: bool = False, around_train=contextlib.nullcontext):
    """One pass of the rank model on the streaming or (packed) the
    pass-resident entry point.  Returns (stats, initial params, extra):
    extra holds each step's preds, the trained working set and dense
    weights, and for a packed pass its host arrays, its feed and the
    build and plane-build seconds."""
    from paddlebox_tpu_torch.utils.monitor import stat_snapshot
    engine, trainer, dataset, params0 = rank_trainer(block, device, params)
    extra = {"preds": []}
    core = trainer._core

    def spy(*args, **kw):
        loss, preds = core(*args, **kw)
        extra["preds"].append(preds.detach().clone())
        return loss, preds
    trainer._core = spy
    key = "data.pass_feed.plane_build_s.sum"
    if packed:
        before = stat_snapshot("data.pass_feed").get(key, 0.0)
        t0 = time.perf_counter()
        arrays = trainer.pack_pass_host(dataset)
        feed = trainer.finish_pass_feed(arrays)
        if device == "cuda":
            torch.cuda.synchronize()
        extra.update(build_pass_feed_s=time.perf_counter() - t0,
                     plane_build_s=stat_snapshot("data.pass_feed").get(
                         key, 0.0) - before,
                     arrays=arrays, feed=feed)
        with around_train():
            stats = trainer.train_pass(feed)
    else:
        with around_train():
            stats = trainer.train_pass(dataset, pack_threads=4)
    extra["ws"] = {k: v.clone() for k, v in engine.ws.items()}
    extra["dense"] = {k: v.clone()
                      for k, v in trainer.model.state_dict().items()}
    extra["auc_table_size"] = trainer.auc_table_size
    engine.end_pass()
    return stats, params0, extra


def rank_attention_profile(prof, n_steps: int) -> float:
    """Device ms per step of rank_attention in a traced pass: its forward
    (a ``rank_attention`` record_function) and its three backward nodes."""
    keys = ("rank_attention",) + RANK_BACKWARD
    cpu = torch.autograd.DeviceType.CPU
    return sum(e.device_time_total for e in prof.key_averages()
               if e.key in keys and e.device_type == cpu) / 1e3 / n_steps


@contextlib.contextmanager
def rank_annotated(holder: dict):
    """Trace CPU and CUDA with rank_attention's forward annotated (its
    backward nodes carry their own names)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddlebox_tpu_torch.models import rank_ctr
    plain = rank_ctr.rank_attention

    def annotated(*args, **kw):
        with record_function("rank_attention"):
            return plain(*args, **kw)
    rank_ctr.rank_attention = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            holder["prof"] = prof
            yield prof
    finally:
        rank_ctr.rank_attention = plain


def rank_attention_time(feed, dev: torch.device, seed: int = 0) -> float:
    """rank_attention forward + backward alone, at the step's shapes, on
    batch 0's rank_offset plane (device ms, time_ms)."""
    from paddlebox_tpu_torch.ops.rank_attention import rank_attention
    gen = torch.Generator(device=dev).manual_seed(seed)
    in_col = N_SLOTS * (3 + MF_DIM)
    x = torch.randn((BATCH, in_col), generator=gen, device=dev,
                    requires_grad=True)
    param = torch.randn((9 * in_col, RANK_WIDTHS["att_out"]), generator=gen,
                        device=dev, requires_grad=True)
    g = torch.randn((BATCH, RANK_WIDTHS["att_out"]), generator=gen,
                    device=dev)
    ro = feed.data["rank_offset"][0]

    def step():
        out, _ = rank_attention(x, ro, param, 3)
        out.backward(g)
    return time_ms("rank_attention fwd+bwd", step)


def rank_metrics(extra: dict, stats: dict, block_sorted: SlotRecordBlock):
    """Fleet.metrics fed the packed pass's preds, batch by batch, through
    MetricGroup.update: an auc metric (must equal the trainer's auc within
    1e-6), a cmatch_rank_group="222:1,223:2" metric and a wuauc metric
    (must equal the trainer's wuauc within 1e-9)."""
    from paddlebox_tpu_torch import fleet
    group = fleet.init().metrics
    group.init_metric("rank_auc", table_size=extra["auc_table_size"])
    group.init_metric("rank_cr", table_size=extra["auc_table_size"],
                      cmatch_rank_group="222:1,223:2")
    group.init_metric("rank_wuauc", metric_type="wuauc")
    h = extra["arrays"]
    nb = h.n_batches * h.batch_size
    cmatch = np.zeros((nb,), np.int32)
    rank = np.zeros((nb,), np.int32)
    for i in range(h.n_batches):
        lo, cnt, base = (i * h.batch_size, int(h.batch_real[i]),
                         int(h.batch_base[i]))
        cmatch[lo:lo + cnt] = block_sorted.cmatch[base:base + cnt]
        rank[lo:lo + cnt] = block_sorted.rank[base:base + cnt]
    for i, preds in enumerate(extra["preds"]):
        sl = slice(i * h.batch_size, (i + 1) * h.batch_size)
        p = preds.cpu().numpy()
        for name in ("rank_auc", "rank_cr", "rank_wuauc"):
            group.update(name, p, h.labels[sl], mask=h.valid[sl],
                         cmatch=cmatch[sl], rank=rank[sl], uid=h.uid[sl])
    msg = {n: group.get_metric_msg(n)
           for n in ("rank_auc", "rank_cr", "rank_wuauc")}
    if abs(msg["rank_auc"]["auc"] - stats["auc"]) > 1e-6:
        raise AssertionError(f"rank: Fleet.metrics auc "
                             f"{msg['rank_auc']['auc']} vs the trainer's "
                             f"{stats['auc']}")
    if abs(msg["rank_wuauc"]["wuauc"] - stats["wuauc"]) > 1e-9:
        raise AssertionError(f"rank: Fleet.metrics wuauc "
                             f"{msg['rank_wuauc']['wuauc']} vs the "
                             f"trainer's {stats['wuauc']}")
    want = int((h.valid & (((cmatch == 222) & (rank == 1))
                           | ((cmatch == 223) & (rank == 2)))).sum())
    if msg["rank_cr"]["size"] != want:
        raise AssertionError(f"rank: the cmatch_rank metric counted "
                             f"{msg['rank_cr']['size']} records, not {want}")
    return msg


def rank_phase(seed: int = 13):
    """RankAttentionCTR on the pv feed, streaming and packed on mxu (see
    the module docstring, phase 12)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    block = rank_block(rng)
    launches, out, runs = {}, {}, {}
    per_batch = {"gather_sorted": 1, "scatter_add_sorted": 1,
                 "gather_pool": 0}
    params0 = None
    for mode in ("streaming", "packed"):
        reset_counts()
        t0 = time.perf_counter()
        stats, p0, extra = rank_run(block, "cuda", params0,
                                    packed=mode == "packed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = read_counts()
        params0 = params0 or p0
        check_pass(f"rank[{mode}]", stats, launches[mode], per_batch,
                   exact=True)
        if not stats["wuauc_users"] > 0:
            raise AssertionError(f"rank[{mode}]: no user with both classes")
        runs[mode] = (stats, extra)
        steady = float(np.median(stats["step_ms"][1:]))
        out[mode] = {"losses": stats["losses"], "auc": stats["auc"],
                     "uauc": stats["uauc"], "wuauc": stats["wuauc"],
                     "wuauc_users": stats["wuauc_users"],
                     "wuauc_s": stats["wuauc_s"],
                     "step_ms": stats["step_ms"], "steady_step_ms": steady,
                     "pass_wall_s": wall, "launches": launches[mode]}
        if mode == "packed":
            out[mode].update(build_pass_feed_s=extra["build_pass_feed_s"],
                             plane_build_s=extra["plane_build_s"])
        log(f"rank[{mode}]: losses {stats['losses']}, auc {stats['auc']}, "
            f"uauc {stats['uauc']}, wuauc {stats['wuauc']} over "
            f"{stats['wuauc_users']:.0f} users, launches {launches[mode]}, "
            f"step device ms {stats['step_ms']} (steady median "
            f"{steady:.3f}), WuAUC host {stats['wuauc_s']:.3f} s a pass, "
            f"pass wall {wall:.2f} s"
            + (f", build_pass_feed {extra['build_pass_feed_s']:.2f} s, "
               f"plane_build {extra['plane_build_s']:.4f} s"
               if mode == "packed" else ""))
    (s_stats, _), (p_stats, p_extra) = runs["streaming"], runs["packed"]
    # the first step on the CPU, from the same weights and batch
    pv = SlotDataset(rank_feed_config())
    pv._blocks = [block]
    pv.preprocess_instance()
    lo, hi = pv.batch_bounds(BATCH)[0]
    first = pv.get_blocks()[0].slice(lo, hi)
    cpu_stats, _, _ = rank_run(first, "cpu", params0)
    cpu_loss = cpu_stats["losses"][0]
    for mode, (stats, _) in runs.items():
        if not math.isclose(stats["losses"][0], cpu_loss, rel_tol=1e-4):
            raise AssertionError(f"rank[{mode}]: first-step loss card "
                                 f"{stats['losses'][0]} vs CPU {cpu_loss}")
    for a, b in zip(s_stats["losses"], p_stats["losses"]):
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"rank: streaming losses "
                                 f"{s_stats['losses']} vs packed "
                                 f"{p_stats['losses']}")
    # users with both classes, counted from the data
    vals, offs = block.uint64_slots["s0"]
    _, user = np.unique(vals[offs[:-1]], return_inverse=True)
    pos = np.bincount(user, weights=block.float_slots["label"][0])
    both = int(((pos > 0) & (pos < np.bincount(user))).sum())
    if not s_stats["wuauc_users"] == p_stats["wuauc_users"] == both:
        raise AssertionError(f"rank: wuauc users streaming "
                             f"{s_stats['wuauc_users']} vs packed "
                             f"{p_stats['wuauc_users']}, {both} in the data")
    # the packed feed's pv planes on the card = the host planes
    h, feed = p_extra["arrays"], p_extra["feed"]
    n, b = h.n_batches, h.batch_size
    planes = {"rank_offset": h.rank_offset.reshape(n, b, -1),
              "ads_offset": h.ads_offset}
    for k, want in planes.items():
        if not np.array_equal(feed.data[k].cpu().numpy(), want):
            raise AssertionError(f"rank: the card's {k} plane differs from "
                                 "the host's")
    if not (h.rank_offset[:, 0] > 0).any() or h.batch_real.min() == b:
        raise AssertionError("rank: no ranked record or no short batch")
    # a packed rerun from the same state, traced: the same bits
    holder = {}
    again, _, a_extra = rank_run(block, "cuda", params0, packed=True,
                                 around_train=lambda: rank_annotated(holder))
    if again["losses"] != p_stats["losses"]:
        raise AssertionError(f"rank: packed rerun losses {again['losses']} "
                             f"!= {p_stats['losses']}")
    for what in ("ws", "dense"):
        diff = [k for k in p_extra[what]
                if not torch.equal(p_extra[what][k], a_extra[what][k])]
        if diff:
            raise AssertionError(f"rank: the packed rerun left different "
                                 f"{what} fields {diff}")
    prof = profiled("rank[packed]", holder["prof"], again)
    prof["rank_attention_ms_per_step"] = rank_attention_profile(
        holder["prof"], len(again["step_ms"]))
    alone = rank_attention_time(feed, dev)
    msg = rank_metrics(p_extra, p_stats, pv.get_blocks()[0])
    log(f"rank: first-step loss CPU {cpu_loss!r} (rtol 1e-4 of both); "
        "streaming = packed within rtol 1e-4; the packed rerun is "
        f"bit-identical; device planes = host planes; rank_attention "
        f"device ms per step {prof['rank_attention_ms_per_step']:.4f} in the "
        f"traced step, {alone:.4f} fwd+bwd alone; GEMMs "
        f"{prof['gemm_ms_per_step']:.4f}; Fleet.metrics auc "
        f"{msg['rank_auc']['auc']!r} (= the trainer's within 1e-6), "
        f"cmatch_rank 222:1,223:2 auc {msg['rank_cr']['auc']!r} over "
        f"{msg['rank_cr']['size']:.0f}, wuauc {msg['rank_wuauc']['wuauc']!r}")
    out.update(cpu_first_loss=cpu_loss, deterministic=True, profile=prof,
               rank_attention_alone_ms=alone,
               fleet_metrics={k: {kk: vv for kk, vv in v.items()}
                              for k, v in msg.items()})
    return launches, out


# ---------------------------------------------------------------------------
# phase 13: the rest of the one-card trainer options
# ---------------------------------------------------------------------------

OPTIONS_KERNELS = {"gather_sorted": 1, "scatter_add_sorted": 1,
                   "gather_pool": 0}


@contextlib.contextmanager
def kernel_widths(seen: dict):
    """Record the width W (rows of the feature-major operand) of each
    sorted-SpMM wrapper call on the card, by name.  A wrapper counts its
    launches on the module-level name it is bound to, so the recording
    stand-in carries the count while it is bound and hands it back to
    the wrapper after."""
    plain = {n: getattr(sp, n) for n in ("gather_sorted",
                                         "scatter_add_sorted")}

    def wrap(name, fn):
        def call(x, *args, **kw):
            if x.is_cuda:
                seen.setdefault(name, []).append(int(x.shape[0]))
            return fn(x, *args, **kw)
        call.launches = fn.launches
        return call
    stand_ins = {n: wrap(n, fn) for n, fn in plain.items()}
    for n, fn in stand_ins.items():
        setattr(sp, n, fn)
    try:
        yield seen
    finally:
        for n, fn in plain.items():
            fn.launches = stand_ins[n].launches
            setattr(sp, n, fn)


def options_expand(block: SlotRecordBlock):
    """(a) CtrDnn over an expand table, streaming and packed on auto:
    both sorted-SpMM kernels once a batch at W = 20, gather_pool never;
    the first step = the CPU's; mf_ex trained; a packed rerun (traced)
    gives the same bits."""
    launches, out, params0 = {}, {}, None
    runs = {}
    for mode in ("streaming", "packed"):
        seen, hold = {}, {}
        reset_counts()
        with kernel_widths(seen):
            stats, p0, _ = run_pass(block, "cuda", params0, path="auto",
                                    packed=mode == "packed", keep_ws=True,
                                    hold=hold, model="ctr_dnn_ex")
        torch.cuda.synchronize()
        what = f"options[expand,{mode}]"
        launches[mode] = read_counts()
        params0 = params0 or p0
        check_pass(what, stats, launches[mode], OPTIONS_KERNELS, exact=True)
        for name in ("gather_sorted", "scatter_add_sorted"):
            if seen.get(name) != [W_EX] * N_BATCHES:
                raise AssertionError(f"{what}: {name} ran at widths "
                                     f"{seen.get(name)}, not {W_EX}")
        if stats["path"] != "mxu":
            raise AssertionError(f"{what}: auto did not resolve to mxu")
        if torch.equal(hold["ws0"]["mf_ex"], stats["ws"]["mf_ex"]):
            raise AssertionError(f"{what}: mf_ex did not train")
        cpu_first_loss(what, block, stats["losses"][0], params0,
                       path="auto", model="ctr_dnn_ex")
        runs[mode] = stats
        steady = float(np.median(stats["step_ms"][1:]))
        out[mode] = {"losses": stats["losses"], "auc": stats["auc"],
                     "step_ms": stats["step_ms"], "steady_step_ms": steady,
                     "launches": launches[mode], "widths": seen}
        log(f"{what}: losses {stats['losses']}, auc {stats['auc']}, "
            f"launches {launches[mode]} at W {W_EX}, step device ms "
            f"{stats['step_ms']} (steady median {steady:.3f}); mf_ex moved")
    holder = {}
    again, _, _ = run_pass(block, "cuda", params0, path="auto", packed=True,
                           keep_ws=True, model="ctr_dnn_ex",
                           around_train=tracer(holder))
    same_bits("options[expand,packed]", runs["packed"], again)
    out["profile"] = profiled("options[expand,packed]", holder["prof"],
                              again)
    log("options[expand]: the packed rerun is bit-identical; kernel device "
        "ms per step " + json.dumps(out["profile"]["kernel_ms_per_step"]))
    return launches, out


def options_async(block: SlotRecordBlock):
    """(b) DeepFM on packed mxu with the async dense table (sync every
    batch) beside the same pass with synchronous Adam."""
    from paddlebox_tpu_torch.config import TrainerConfig
    import threading
    launches, out = {}, {}
    calls = []
    plain_step = SparseTrainer._async_dense_step

    def recorded(self, *args, **kw):
        calls.append(threading.current_thread())
        return plain_step(self, *args, **kw)
    params0 = None
    for mode in ("sync", "async"):
        hold = {}
        tc = TrainerConfig(dense_sync_mode="async_table",
                           sync_weight_step=1) if mode == "async" else None
        reset_counts()
        SparseTrainer._async_dense_step = recorded
        try:
            stats, p0, _ = run_pass(block, "cuda", params0, path="mxu",
                                    packed=True, hold=hold,
                                    trainer_config=tc)
        finally:
            SparseTrainer._async_dense_step = plain_step
        torch.cuda.synchronize()
        params0 = params0 or p0
        what = f"options[async,{mode}]"
        launches[mode] = read_counts()
        check_pass(what, stats, launches[mode], OPTIONS_KERNELS, exact=True)
        steady = float(np.median(stats["step_ms"][1:]))
        out[mode] = {"losses": stats["losses"], "step_ms": stats["step_ms"],
                     "steady_step_ms": steady}
        if mode == "async":
            tr = hold["trainer"]
            table = tr.async_dense
            if not table.pushed == table.applied == N_BATCHES:
                raise AssertionError(f"{what}: pushed {table.pushed}, "
                                     f"applied {table.applied}")
            final = table.pull()
            for n, p in tr.model.named_parameters():
                if not np.array_equal(p.detach().cpu().numpy(), final[n]):
                    raise AssertionError(f"{what}: param {n} != pull()")
            if tr.dense_opt.state_dict()["state"]:
                raise AssertionError(f"{what}: dense_opt stepped")
            main = threading.main_thread()
            if len(calls) != N_BATCHES or any(t is not main for t in calls):
                raise AssertionError(f"{what}: the grads' copies ran on "
                                     f"{[t.name for t in calls]}")
            if table.thread is main or not table.thread.is_alive():
                raise AssertionError(f"{what}: no live update thread")
            copy_ms = 1e3 * stats["dense_copy_s"] / N_BATCHES
            out[mode].update(dense_copy_ms_per_step=copy_ms,
                             pushed=table.pushed, applied=table.applied)
            log(f"{what}: losses {stats['losses']} (synchronous Adam "
                f"{out['sync']['losses']}), steady step "
                f"{steady:.3f} ms vs synchronous Adam "
                f"{out['sync']['steady_step_ms']:.3f} ms; grads' copy "
                f"{copy_ms:.3f} ms a step; pushed = applied = "
                f"{table.pushed}; final params = pull(); the copies ran "
                "on the main thread, the table's updates on "
                f"{table.thread.name!r} (numpy only)")
    return launches, out


def options_dump(seed: int = 15):
    """(c) a packed pass with dump_path into a temporary directory, over
    records that carry ins_ids: one line per real record, the step's
    preds to 6 decimals."""
    from paddlebox_tpu_torch.config import TrainerConfig
    rng = np.random.default_rng(seed)
    n = N_BATCHES * BATCH - 1000           # the last batch is short
    block = make_block(rng, n)
    block.ins_ids = [f"ins{i:06d}" for i in range(n)]
    tmp = tempfile.mkdtemp(prefix="pbox_dump_")
    try:
        engine, trainer, dataset, _ = make_trainer(
            block, "cuda", trainer_config=TrainerConfig(dump_path=tmp))
        preds = []
        core = trainer._core

        def spy(*args, **kw):
            loss, p = core(*args, **kw)
            preds.append(p.detach().clone())
            return loss, p
        trainer._core = spy
        reset_counts()
        feed = trainer.build_pass_feed(dataset)
        stats = trainer.train_pass(feed)
        launches = read_counts()
        check_pass("options[dump]", stats, launches, OPTIONS_KERNELS,
                   exact=True)
        path = os.path.join(tmp, f"dump-pass-{engine.pass_id}.txt")
        with open(path) as f:
            lines = [ln.rstrip("\n").split("\t") for ln in f]
        engine.end_pass()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(lines) != n:
        raise AssertionError(f"options[dump]: {len(lines)} lines for {n} "
                             "records")
    if [ln[0] for ln in lines] != block.ins_ids:
        raise AssertionError("options[dump]: ids out of order")
    want = torch.cat(preds).cpu().numpy()[:n]
    if [ln[2] for ln in lines] != [f"{p:.6f}" for p in want]:
        raise AssertionError("options[dump]: preds differ from the pass's")
    labels = block.float_slots["label"][0]
    if [ln[1] for ln in lines] != [f"{x:g}" for x in labels]:
        raise AssertionError("options[dump]: labels differ")
    log(f"options[dump]: {len(lines)} lines (one per real record of a "
        f"{N_BATCHES}-batch pass, the last batch short), preds = the "
        f"pass's to 6 decimals; dump host {stats['dump_s']:.4f} s a pass")
    return launches, {"lines": len(lines), "dump_s": stats["dump_s"],
                      "losses": stats["losses"]}


def seqpool_variants_phase(dev: torch.device, seed: int = 16):
    """(d) the five fused_seqpool_cvm variants forward + backward at
    [26, 16384, 3, E] on the card against the CPU (rtol 1e-5, atol
    1e-6), with device ms each (time_ms of forward + backward)."""
    from paddlebox_tpu_torch.ops import seqpool_cvm_variants as sv
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, CAP + 1, (N_SLOTS, BATCH)).astype(np.int32)

    def ins(w):
        return rng.uniform(0, 2, (BATCH, w)).astype(np.float32)
    thresholds = rng.uniform(0, 1.5, N_SLOTS).astype(np.float32)
    cases = {   # name: (fn, E, [per-instance inputs], attributes(device))
        "tradew": (sv.fused_seqpool_cvm_tradew, 2 + 3 + MF_DIM, [ins(2)],
                   lambda d: (True, 0.0, 2, 1, 3)),
        "with_conv": (sv.fused_seqpool_cvm_with_conv, 3 + MF_DIM, [ins(3)],
                      lambda d: (True, 0.0, True, 0.2, 1.0, 0.96, False, 1)),
        "with_credit": (sv.fused_seqpool_cvm_with_credit, 4 + MF_DIM,
                        [ins(4)], lambda d: (True, 0.0, False)),
        # the per-slot thresholds lie on the device (no upload a call)
        "with_diff_thres": (sv.fused_seqpool_cvm_with_diff_thres,
                            2 + MF_DIM, [ins(2)],
                            lambda d: (True, 0.0, True, 0.2, 1.0, 0.96,
                                       torch.as_tensor(thresholds, device=d),
                                       0, False, True)),
        "with_pcoc": (sv.fused_seqpool_cvm_with_pcoc, 7 + MF_DIM,
                      [ins(7), ins(3)],
                      lambda d: (True, 0.0, False, 0.2, 1.0, 0.96, 7, 7, 0)),
    }
    out = {}
    for name, (fn, e, extra, attrs) in cases.items():
        emb = rng.uniform(0, 2, (N_SLOTS, BATCH, CAP, e)).astype(np.float32)
        runs = {}
        for where in ("cpu", dev):
            x = torch.tensor(emb, device=where, requires_grad=True)
            args = [torch.as_tensor(lengths, device=where)] + [
                torch.as_tensor(a, device=where) for a in extra]
            kw = attrs(where)
            y = fn(x, *args, *kw)
            dy = torch.ones_like(y)
            (g,) = torch.autograd.grad(y, x, dy)
            runs[str(where)] = (y.detach().cpu().numpy(), g.cpu().numpy(),
                                (x, args + list(kw), dy))
        for k, label in ((0, "forward"), (1, "backward")):
            got, want = runs[str(dev)][k], runs["cpu"][k]
            if got.shape != want.shape or not np.allclose(
                    got, want, rtol=1e-5, atol=1e-6):
                raise AssertionError(
                    f"variants[{name}]: {label} on the card differs from the "
                    f"CPU by {float(np.abs(got - want).max())}")
        x, args, dy = runs[str(dev)][2]

        def fwd_bwd():
            return torch.autograd.grad(fn(x, *args), x, dy)
        ms = time_ms(f"variants[{name}]", fwd_bwd)
        out[name] = {"e": e, "ms": ms,
                     "out_shape": list(runs[str(dev)][0].shape)}
        log(f"variants[{name}]: [{N_SLOTS}, {BATCH}, {CAP}, {e}] forward + "
            f"backward {ms:.4f} ms on the card, = the CPU (rtol 1e-5)")
    return out


def alias_phase(dev: torch.device, seed: int = 17,
                n_draws: int = 1_000_000) -> dict:
    """(e) alias_sample of 10^6 draws on the card from a seeded card
    generator: chi-square against the table's probabilities."""
    from scipy import stats as sstats
    from paddlebox_tpu_torch.ops import alias_method as am
    probs = 1.0 / np.arange(1, 1001) ** 1.1       # a Zipf-like negatives
    p = probs / probs.sum()
    accept, alias = am.build_alias_table(probs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a, l = torch.as_tensor(accept, device=dev), torch.as_tensor(alias,
                                                                device=dev)
    draws = am.alias_sample(gen, a, l, (n_draws,))
    if draws.device.type != dev.type or draws.dtype != torch.int32:
        raise AssertionError("alias: the draws are not int32 on the card")
    counts = np.bincount(draws.cpu().numpy(), minlength=len(p))
    chi2, pval = sstats.chisquare(counts, n_draws * p)
    if not pval > 1e-3:
        raise AssertionError(f"alias: chi-square p {pval} over {n_draws} "
                             "draws")
    ms = time_ms("alias_sample", lambda: am.alias_sample(gen, a, l,
                                                         (n_draws,)))
    log(f"alias: {n_draws} draws over {len(p)} outcomes on the card, "
        f"chi-square {chi2:.1f}, p {pval:.4f}; {ms:.4f} ms a call")
    return {"draws": n_draws, "chi2": float(chi2), "p": float(pval),
            "ms": ms}


def options_phase(seed: int = 14, device: str = "cuda"):
    """Phase 13 (see the module docstring)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    block = make_block(rng, N_BATCHES * BATCH)
    ex_launches, ex_out = options_expand(block)
    as_launches, as_out = options_async(block)
    dump_launches, dump_out = options_dump()
    launches = {**{f"expand_{m}": n for m, n in ex_launches.items()},
                **{f"async_{m}": n for m, n in as_launches.items()},
                "dump": dump_launches}
    return launches, {"expand": ex_out, "async": as_out, "dump": dump_out,
                      "variants": seqpool_variants_phase(dev),
                      "alias": alias_phase(dev)}


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

    phase_s = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        log(f"phase[{name}]: {phase_s[name]:.1f} s")
        return out

    kern = timed("kernels", kernel_phase, dev)
    kern_ex = timed("kernels_w20", kernel_phase, dev, w_pull=W_EX,
                    w_push=W_EX)
    pool = timed("gather_pool", gather_pool_phase, dev)
    for dist in pool:     # the fast path's table layout
        kern[dist]["gather_pool"] = pool[dist]["stride12"]
    slice_launches, slice_out, slice_block, slice_params = timed(
        "slice", slice_phase)
    packed_launches, packed_out, packed_block, packed_params = timed(
        "packed", packed_phase)
    ref_launches, ref_out = timed("reference", reference_phase, slice_block,
                                  slice_params, slice_out["losses"][0])
    amp_launches, amp_out = timed("amp", amp_phase, packed_block,
                                  packed_params, packed_out)
    rules_launches, rules_out = timed("rules", rules_phase)
    models_launches, models_out = timed("models", models_phase)
    cross_launches, cross_out = timed("crossing", crossing_phase,
                                      packed_block, packed_params)
    life_launches, life_out = timed("lifecycle", lifecycle_phase)
    rec_launches, rec_out = timed("recovery", recovery_phase)
    rank_launches, rank_out = timed("rank", rank_phase)
    opt_launches, opt_out = timed("options", options_phase)
    profile_out = timed("profile", profile_phase)

    by_path = {"slice_mxu": slice_launches,
               **{f"packed_{p}": n for p, n in packed_launches.items()},
               "slice_reference": ref_launches,
               **{f"amp_{p}": n for p, n in amp_launches.items()},
               **{f"rules_{p}": n for p, n in rules_launches.items()},
               **{f"models_{p}": n for p, n in models_launches.items()},
               **{f"crossing_{p}": n for p, n in cross_launches.items()},
               **{f"lifecycle_{p}": n for p, n in life_launches.items()},
               **{f"recovery_{p}": n for p, n in rec_launches.items()},
               **{f"rank_{p}": n for p, n in rank_launches.items()},
               **{f"options_{p}": n for p, n in opt_launches.items()}}
    line = {"kernels": []}
    for name in KERNELS:
        k = kern["uniform"][name]
        at_w20 = {}
        if name in kern_ex["uniform"]:
            # the expand table's width, uniform ids (phase 13's path)
            k20 = kern_ex["uniform"][name]
            at_w20 = {"at_w20": {
                f: k20[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")} | {
                "max_abs_err": max(kern_ex[d][name]["max_abs_err"]
                                   for d in kern_ex)}}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(kern[d][name]["max_abs_err"] for d in kern
                               if name in kern[d]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], **at_w20})
    log("detail: " + json.dumps({"kernels_by_dist": kern,
                                 "kernels_by_dist_w20": kern_ex,
                                 "gather_pool_by_layout": pool,
                                 "slice": slice_out, "packed": packed_out,
                                 "reference": ref_out, "amp": amp_out,
                                 "rules": rules_out, "models": models_out,
                                 "crossing": cross_out,
                                 "lifecycle": life_out, "recovery": rec_out,
                                 "rank": rank_out, "options": opt_out,
                                 "profile": profile_out,
                                 "phase_s": phase_s}))
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
