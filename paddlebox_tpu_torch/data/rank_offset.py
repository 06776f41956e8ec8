"""PV-merge rank_offset assembly — GetRankOffset / CopyRankOffset equivalent.

Copy of ``paddlebox_tpu/data/rank_offset.py`` (numpy only).

≙ PaddleBoxDataFeed::GetRankOffset (data_feed.cc:1855-1903) + the device
copy CopyRankOffset (data_feed.cu:1371): under PV merge (records grouped by
search_id), each batch carries a [B, 1 + 2*max_rank] int32 plane consumed
by rank-attention models (ops/rank_attention.py):

  col 0        = own rank, or -1 (valid iff cmatch in {222, 223} and
                 1 <= rank <= max_rank — data_feed.cc:1873)
  col 2m+1/2m+2 = for each peer rank m+1 present in the pv: that peer's
                 rank and its BATCH ROW index; -1 where absent.  When a pv
                 holds several ads with the same rank the LAST one wins
                 (the reference's overwrite loop, data_feed.cc:1880-1895).

TPU-first: the reference fills the matrix with a per-pv nested loop on
host then memcpys to GPU; here the whole batch is assembled with
vectorized numpy (group runs from the pv-sorted order, last-wins via
duplicate fancy assignment) and ships with the rest of the pass pack.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

CMATCH_RANKED = (222, 223)      # data_feed.cc:1873 — join-phase ad cmatches


def build_rank_offset(search_ids: Optional[np.ndarray],
                      cmatch: Optional[np.ndarray],
                      rank: Optional[np.ndarray],
                      n: int, max_rank: int = 3) -> np.ndarray:
    """[n, 1 + 2*max_rank] int32 for one batch of pv-contiguous records.

    search_ids/cmatch/rank: per-record arrays for the batch's REAL records
    (may be shorter than n — the tail padding rows stay all -1), or None
    (no pv/logkey data parsed → all -1, matching a feed without pv merge).
    """
    col = 2 * max_rank + 1
    out = np.full((n, col), -1, np.int32)
    if search_ids is None or cmatch is None or rank is None or not len(
            search_ids):
        return out
    m = len(search_ids)
    valid = np.zeros((m,), bool)
    for c in CMATCH_RANKED:
        valid |= cmatch == c
    valid &= (rank >= 1) & (rank <= max_rank)
    r = np.where(valid, rank, -1).astype(np.int32)
    out[:m, 0] = r

    # pv groups are contiguous runs of equal search_id (preprocess_instance
    # sorts stable by search_id, dataset.py:199 ≙ PreprocessInstance)
    new_group = np.empty((m,), bool)
    new_group[0] = True
    np.not_equal(search_ids[1:], search_ids[:-1], out=new_group[1:])
    group_id = np.cumsum(new_group) - 1                   # [m]
    n_groups = int(group_id[-1]) + 1

    # per (group, rank) slot: batch row of the LAST valid ad with that rank
    # (duplicate fancy assignment keeps the last occurrence — the
    # reference's overwrite order)
    g_row = np.full((n_groups, max_rank), -1, np.int64)
    vk = np.nonzero(valid)[0]
    g_row[group_id[vk], r[vk] - 1] = vk

    rows = np.nonzero(r > 0)[0]                           # own rank valid
    peers = g_row[group_id[rows]]                         # [R, max_rank]
    present = peers >= 0
    out[rows[:, None], 1 + 2 * np.arange(max_rank)[None]] = np.where(
        present, np.arange(1, max_rank + 1)[None], -1)
    out[rows[:, None], 2 + 2 * np.arange(max_rank)[None]] = peers.astype(
        np.int32)
    return out


def build_rank_offset_batched(search_ids: Optional[np.ndarray],
                              cmatch: Optional[np.ndarray],
                              rank: Optional[np.ndarray],
                              batch_real: np.ndarray,
                              batch_base: np.ndarray,
                              batch_size: int,
                              max_rank: int = 3) -> np.ndarray:
    """[N*B, 1 + 2*max_rank] int32 for a WHOLE pass of pv-aligned batches
    in one vectorized build — bit-identical to calling
    :func:`build_rank_offset` per batch (the former pack_pass loop), but
    without N python iterations.

    search_ids/cmatch/rank index the pass's real records in concatenated
    batch order; batch_real/batch_base are the per-batch real counts and
    their prefix sums (HostPassArrays.batch_real/batch_base).
    """
    n_batches = len(batch_real)
    col = 2 * max_rank + 1
    out = np.full((n_batches * batch_size, col), -1, np.int32)
    if search_ids is None or cmatch is None or rank is None:
        return out
    m = int(batch_base[-1] + batch_real[-1]) if n_batches else 0
    if m == 0:
        return out
    batch_of = np.repeat(np.arange(n_batches), batch_real)        # [m]
    local = np.arange(m) - batch_base[batch_of]                   # in-batch
    plane_row = batch_of * batch_size + local

    valid = np.zeros((m,), bool)
    for c in CMATCH_RANKED:
        valid |= cmatch[:m] == c
    valid &= (rank[:m] >= 1) & (rank[:m] <= max_rank)
    r = np.where(valid, rank[:m], -1).astype(np.int32)
    out[plane_row, 0] = r

    # pv groups are contiguous equal-search_id runs, with a break FORCED
    # at every batch start (a pv never spans batches under pv-aligned
    # cuts, and per-batch builds could never see across the cut anyway)
    new_group = np.empty((m,), bool)
    new_group[0] = True
    np.not_equal(search_ids[1:m], search_ids[:m - 1], out=new_group[1:])
    new_group[batch_base[batch_real > 0]] = True
    group_id = np.cumsum(new_group) - 1
    n_groups = int(group_id[-1]) + 1

    # per (group, rank): BATCH-LOCAL row of the last valid ad (duplicate
    # fancy assignment keeps the last occurrence; global ascending order
    # equals per-batch ascending order, so last-wins matches the loop)
    g_row = np.full((n_groups, max_rank), -1, np.int64)
    vk = np.nonzero(valid)[0]
    g_row[group_id[vk], r[vk] - 1] = local[vk]

    rows = np.nonzero(r > 0)[0]
    peers = g_row[group_id[rows]]                         # [R, max_rank]
    present = peers >= 0
    prow = plane_row[rows][:, None]
    out[prow, 1 + 2 * np.arange(max_rank)[None]] = np.where(
        present, np.arange(1, max_rank + 1)[None], -1)
    out[prow, 2 + 2 * np.arange(max_rank)[None]] = peers.astype(np.int32)
    return out


def build_ads_offset_batched(search_ids: Optional[np.ndarray],
                             batch_real: np.ndarray,
                             batch_base: np.ndarray,
                             batch_size: int) -> np.ndarray:
    """[N, B+1] int32 pv prefix offsets for a whole pass in one build —
    bit-identical to calling :func:`build_ads_offset` per batch."""
    n_batches = len(batch_real)
    out = np.repeat(np.asarray(batch_real, np.int32)[:, None],
                    batch_size + 1, axis=1)
    m = int(batch_base[-1] + batch_real[-1]) if n_batches else 0
    if m == 0:
        return out
    if search_ids is None:
        raise ValueError(
            "ads_offset needs search_ids (parse_logkey pv data) — without "
            "them every batch would silently become one page view")
    batch_of = np.repeat(np.arange(n_batches), batch_real)
    local = np.arange(m) - batch_base[batch_of]
    new_pv = np.empty((m,), bool)
    new_pv[0] = True
    np.not_equal(search_ids[1:m], search_ids[:m - 1], out=new_pv[1:])
    new_pv[batch_base[batch_real > 0]] = True
    starts = np.nonzero(new_pv)[0]
    b_of = batch_of[starts]
    # pv ordinal within its batch: starts are sorted, so each batch's
    # starts form one contiguous run — ordinal = index − run start
    run_start = np.empty((len(starts),), bool)
    run_start[0] = True
    np.not_equal(b_of[1:], b_of[:-1], out=run_start[1:])
    seg = np.cumsum(run_start) - 1
    first_pos = np.nonzero(run_start)[0][seg]
    ordinal = np.arange(len(starts)) - first_pos
    out[b_of, ordinal] = local[starts]
    return out


def build_ads_offset(search_ids: Optional[np.ndarray], n_real: int,
                     batch_size: int) -> np.ndarray:
    """[B+1] int32 pv prefix offsets for one batch (≙ GetAdsOffset,
    data_feed.cc:3592: ads_offset[k] = first instance row of pv k, final
    entry = instance count).  Static shape: at most B pvs; unused tail
    entries repeat n_real so downstream diffs yield empty pvs."""
    out = np.full((batch_size + 1,), n_real, np.int32)
    if n_real == 0:
        out[0] = 0
        return out
    if search_ids is None:
        raise ValueError(
            "ads_offset needs search_ids (parse_logkey pv data) — without "
            "them every batch would silently become one page view")
    sid = search_ids[:n_real]
    new_pv = np.empty((n_real,), bool)
    new_pv[0] = True
    np.not_equal(sid[1:], sid[:-1], out=new_pv[1:])
    starts = np.nonzero(new_pv)[0]
    out[:len(starts)] = starts
    return out
