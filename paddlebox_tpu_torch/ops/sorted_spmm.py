"""Sorted-occurrence gather / merged scatter — the mxu pull and push.

Port of ``paddlebox_tpu/ops/sorted_spmm.py``.  The plan is the same:
sort the batch's row ids once, keep the permutation both ways, and mark
the first occurrence of each distinct row (``build_plan`` keeps the JAX
package's 8-tuple, worklist included, so plans compare one to one).  The
two kernels are different: the TPU walks a (chunk, tile) worklist of
one-hot MXU matmuls because its gathers and scatters are serial; on
Hopper both are hand-written CUDA kernels (``csrc/sorted_spmm.cu``) that
work straight on the sorted domain and ignore the worklist:

* ``gather_sorted``      replaces ``_gather_kernel`` / ``gather_sorted``
  of the JAX package: one thread per sorted position copies the W values
  of its row.  Exact f32, so it equals ``table_fm[:, rows]`` bit for bit.
* ``scatter_add_sorted`` replaces ``_scatter_kernel`` /
  ``scatter_add_sorted``: a segmented sum over the runs of equal rows in
  a fixed order — tiles of ``SCATTER_TILE`` sorted positions reduced
  block-cooperatively, then one warp per run that crosses a tile edge —
  that writes each row once: deterministic, no float atomics, and a
  cost that does not grow with the length of a run.

Both are bound by device-memory bytes (see the source note in the .cu
file).  Each wrapper takes its plain PyTorch version for a tensor on the
CPU, and launches its kernel for a tensor on a card — it never falls
back.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from paddlebox_tpu_torch.ops import cuda_lib

CHUNK = 512     # occurrences per chunk (plan geometry, as in the JAX package)
TILE = 2048     # table rows per tile
SCATTER_TILE = 1024   # sorted positions per block of the Hopper scatter


def _round_up(n: int, a: int) -> int:
    return (n + a - 1) // a * a


@dataclasses.dataclass(frozen=True)
class SpmmDims:
    """Static geometry shared by the plan and both kernels."""
    p: int           # real occurrence count
    p_pad: int       # p rounded up to CHUNK
    n_chunks: int
    n_kernel: int    # table rows incl. the trailing sentinel tile
    n_tiles: int     # n_kernel // TILE
    n_work: int      # n_chunks + n_tiles (static worklist bound)
    chunk: int = CHUNK
    tile: int = TILE

    @property
    def sentinel(self) -> int:
        """Row id pad occurrences are parked at: first row of the last
        (sentinel) tile — gathers zeros, scatters into a discarded tile."""
        return self.n_kernel - self.tile


def spmm_dims(p: int, n_rows: int, chunk: int = CHUNK,
              tile: int = TILE) -> SpmmDims:
    """n_rows: logical table height (rows 0..n_rows-1 addressable)."""
    p_pad = _round_up(max(p, 1), chunk)
    n_kernel = _round_up(n_rows, tile) + tile  # + sentinel tile
    n_tiles = n_kernel // tile
    n_chunks = p_pad // chunk
    return SpmmDims(p=p, p_pad=p_pad, n_chunks=n_chunks, n_kernel=n_kernel,
                    n_tiles=n_tiles, n_work=n_chunks + n_tiles,
                    chunk=chunk, tile=tile)


def with_p_pad(dims: SpmmDims, p_pad: int) -> SpmmDims:
    """The same table geometry over a different (chunk-aligned) sorted-
    domain width."""
    n_chunks = p_pad // dims.chunk
    return dataclasses.replace(dims, p=p_pad, p_pad=p_pad, n_chunks=n_chunks,
                               n_work=n_chunks + dims.n_tiles)


def trimmed_dims(dims: SpmmDims, max_real: int) -> SpmmDims:
    """Static geometry for a plan that drops leading padding occurrences.

    Padding occurrences carry row 0 and sort to the FRONT of the sorted
    domain; keeping only the last ``keep`` sorted positions (chunk-aligned,
    ``keep >= max_real + sentinel tail``) still covers every real
    occurrence.  The kept width is bucketed to 1/8ths of the full width.
    """
    tail = dims.p_pad - dims.p          # sentinel-padded tail, always kept
    keep = _round_up(min(dims.p_pad, max(max_real + tail, 1)), dims.chunk)
    granule = _round_up(max(dims.p_pad // 8, dims.chunk), dims.chunk)
    keep = min(_round_up(keep, granule), dims.p_pad)
    return with_p_pad(dims, keep)


def build_plan(rows: torch.Tensor, dims: SpmmDims,
               eff: Optional[SpmmDims] = None):
    """Sort the occurrence row ids and enumerate (chunk, tile) work items.

    rows: [p] int32 in canonical (slot, lod, batch) order, on any device.
    Returns (rows2d [n_chunks, 1, chunk] sorted+padded, perm [p],
    inv_perm [p], chunk_ids [n_work], tile_ids [n_work], first_gather
    [n_work], first_scatter [n_work], first_occ [p_pad]) — the JAX
    package's tuple, value for value.  first_occ marks the first
    occurrence of each distinct row in sorted order; the Hopper scatter
    uses it as its run starts.  The worklist (items 3..6) is only read
    by the TPU kernels; it is kept so both packages' plans compare.

    The sort is stable (``jax.lax.sort`` is too): equal rows keep their
    canonical order, which fixes which occurrence is "first".

    eff (from ``trimmed_dims``): emit the trimmed plan — the sorted arrays
    keep only the last eff.p_pad positions; perm stays the FULL [p]
    bijection; inv_perm becomes the kept-domain position, negative for
    dropped (row-0) occurrences.
    """
    p, c, t = dims.p, dims.chunk, dims.tile
    dev = rows.device
    i32 = dict(dtype=torch.int32, device=dev)
    sorted_rows, perm = torch.sort(rows.to(torch.int32), stable=True)
    perm = perm.to(torch.int32)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm.long()] = torch.arange(p, **i32)
    pad = torch.full((dims.p_pad - p,), dims.sentinel, **i32)
    rows_padded = torch.cat([sorted_rows, pad])
    if eff is not None and eff.p_pad < dims.p_pad:
        p0 = dims.p_pad - eff.p_pad     # static, chunk-aligned
        rows_padded = rows_padded[p0:]
        inv_perm = inv_perm - p0
        dims = eff
    first_occ = torch.cat(
        [torch.ones((1,), dtype=torch.float32, device=dev),
         (rows_padded[1:] != rows_padded[:-1]).to(torch.float32)])
    rows2d = rows_padded.reshape(dims.n_chunks, 1, c)

    tile_of = rows2d[:, 0, :] // t                          # [n_chunks, c]
    lo, hi = tile_of[:, 0], tile_of[:, -1]
    # visit range per chunk: cover inter-chunk tile gaps and share
    # boundary tiles (the TPU kernels' schedule)
    vlo = torch.cat([torch.zeros((1,), **i32),
                     torch.minimum(lo[1:], hi[:-1] + 1)])
    vhi = torch.cat([hi[:-1], torch.full((1,), dims.n_tiles - 1, **i32)])
    slots = vhi - vlo + 1                                   # >= 1
    cum = torch.cumsum(slots, 0, dtype=torch.int32)
    work = torch.arange(dims.n_work, **i32)
    c_of = torch.searchsorted(cum, work, right=True).to(torch.int32)
    c_of = torch.clamp(c_of, max=dims.n_chunks - 1)
    base = torch.where(c_of > 0, cum[torch.clamp(c_of - 1, min=0).long()],
                       torch.zeros_like(c_of))
    tile_ids = torch.clamp(vlo[c_of.long()] + work - base, 0,
                           dims.n_tiles - 1).to(torch.int32)
    first_g = torch.cat([torch.ones((1,), **i32),
                         (c_of[1:] != c_of[:-1]).to(torch.int32)])
    first_s = torch.cat([torch.ones((1,), **i32),
                         (tile_ids[1:] != tile_ids[:-1]).to(torch.int32)])
    return rows2d, perm, inv_perm, c_of, tile_ids, first_g, first_s, first_occ


def kept_perm(perm: torch.Tensor, dims: SpmmDims,
              kd: SpmmDims) -> torch.Tensor:
    """Canonical source position of each sorted position a plan keeps:
    the last ``kd.p_pad`` entries of ``perm`` padded with 0 for the
    sentinel tail (kd = the trimmed geometry, or dims itself)."""
    tail = torch.zeros((dims.p_pad - dims.p,), dtype=perm.dtype,
                       device=perm.device)
    return torch.cat([perm, tail])[dims.p_pad - kd.p_pad:]


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values [P, W] → [num_segments, W]: each segment the sum of its
    rows in their order in ``values``, empty segments exactly 0 (≙
    ``jax.ops.segment_sum`` / ``.at[].add``).  A stable sort of the
    segment ids, then ``scatter_add_sorted`` — a segmented sum in a fixed
    order, where ``index_add_`` on a card would add with float atomics
    in an order that changes from run to run."""
    dims = spmm_dims(segments.numel(), num_segments)
    plan = build_plan(segments.to(torch.int32), dims)
    rows2d, perm, first_occ = plan[0], plan[1], plan[7]
    srt = torch.zeros((values.shape[1], dims.p_pad), dtype=torch.float32,
                      device=values.device)
    srt[:, :dims.p] = values[perm.long()].T
    out = scatter_add_sorted(srt, rows2d, first_occ, dims)
    return out[:, :num_segments].T


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; the card's kernels are held to them)
# ---------------------------------------------------------------------------

def gather_sorted_plain(table_fm: torch.Tensor, rows2d: torch.Tensor,
                        dims: SpmmDims) -> torch.Tensor:
    return table_fm[:, rows2d.reshape(-1).long()]


def scatter_add_sorted_plain(payload_fm: torch.Tensor, rows2d: torch.Tensor,
                             first_occ: torch.Tensor,
                             dims: SpmmDims) -> torch.Tensor:
    out = torch.zeros((payload_fm.shape[0], dims.n_kernel),
                      dtype=torch.float32, device=payload_fm.device)
    return out.index_add_(1, rows2d.reshape(-1).long(), payload_fm)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.library("sorted_spmm")
    if not getattr(lib, "_pbt_typed", False):
        lib.pbt_gather_sorted.argtypes = [_P, ctypes.c_int64, _P, _P,
                                          ctypes.c_int64, ctypes.c_int, _P]
        lib.pbt_gather_sorted.restype = ctypes.c_int
        lib.pbt_scatter_add_sorted.argtypes = [_P, ctypes.c_int64, _P, _P,
                                               _P, ctypes.c_int64,
                                               ctypes.c_int, _P]
        lib.pbt_scatter_add_sorted.restype = ctypes.c_int
        lib.pbt_scatter_scratch_floats.argtypes = [ctypes.c_int64,
                                                   ctypes.c_int]
        lib.pbt_scatter_scratch_floats.restype = ctypes.c_int64
        lib.pbt_scatter_tile.argtypes = []
        lib.pbt_scatter_tile.restype = ctypes.c_int
        if lib.pbt_scatter_tile() != SCATTER_TILE:
            raise RuntimeError(
                f"sorted_spmm.cu tiles the scatter by "
                f"{lib.pbt_scatter_tile()} positions, the wrapper by "
                f"{SCATTER_TILE}")
        lib._pbt_typed = True
    return lib


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    """The kernels take contiguous tensors of one card and fixed dtypes;
    anything else raises (never a silent copy or fallback)."""
    want = {"table_fm": torch.float32, "payload_fm": torch.float32,
            "first_occ": torch.float32, "rows2d": torch.int32}
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != want[arg]:
            raise TypeError(f"{name}: {arg} must be {want[arg]}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def gather_sorted(table_fm: torch.Tensor, rows2d: torch.Tensor,
                  dims: SpmmDims) -> torch.Tensor:
    """table_fm [W, n_kernel] feature-major -> gathered [W, p_pad] in sorted
    occurrence order (pad columns read the zero sentinel tile).  ``dims``
    is the geometry the plan was built with (trimmed or not)."""
    if table_fm.device.type == "cpu":
        return gather_sorted_plain(table_fm, rows2d, dims)
    if table_fm.device.type != "cuda":
        raise ValueError(f"gather_sorted: unsupported device {table_fm.device}")
    _check_cuda("gather_sorted", table_fm.device, table_fm=table_fm,
                rows2d=rows2d)
    w, n_kernel = table_fm.shape
    if n_kernel != dims.n_kernel:
        raise ValueError(f"gather_sorted: table has {n_kernel} columns, "
                         f"dims want {dims.n_kernel}")
    p_pad = rows2d.numel()
    out = torch.empty((w, p_pad), dtype=torch.float32, device=table_fm.device)
    with torch.cuda.device(table_fm.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_lib.check(_lib().pbt_gather_sorted(
            table_fm.data_ptr(), n_kernel, rows2d.data_ptr(),
            out.data_ptr(), p_pad, w, stream), "gather_sorted")
    gather_sorted.launches += 1
    return out


def scatter_add_sorted(payload_fm: torch.Tensor, rows2d: torch.Tensor,
                       first_occ: torch.Tensor,
                       dims: SpmmDims) -> torch.Tensor:
    """payload_fm [W, p_pad] in sorted order -> merged delta [W, n_kernel]:
    every table row = the sum of its occurrences' payload columns,
    untouched rows exactly zero, the sentinel row holds the (zero) pad
    sum — slice it off.  The kernel finds the runs of equal rows from
    ``rows2d`` itself; ``first_occ`` (the plan's run starts) is checked
    and kept in the signature so the plan tuple stays the JAX package's."""
    if payload_fm.device.type == "cpu":
        return scatter_add_sorted_plain(payload_fm, rows2d, first_occ, dims)
    if payload_fm.device.type != "cuda":
        raise ValueError(
            f"scatter_add_sorted: unsupported device {payload_fm.device}")
    _check_cuda("scatter_add_sorted", payload_fm.device,
                payload_fm=payload_fm, rows2d=rows2d, first_occ=first_occ)
    w, p_pad = payload_fm.shape
    if rows2d.numel() != p_pad or first_occ.numel() != p_pad:
        raise ValueError("scatter_add_sorted: payload, rows2d and first_occ "
                         "must cover the same sorted domain")
    lib = _lib()
    out = torch.zeros((w, dims.n_kernel), dtype=torch.float32,
                      device=payload_fm.device)
    # per-tile carries of the runs that cross a tile edge, and tile flags
    # (see the .cu source note)
    scratch = torch.empty((lib.pbt_scatter_scratch_floats(p_pad, w),),
                          dtype=torch.float32, device=payload_fm.device)
    with torch.cuda.device(payload_fm.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_lib.check(lib.pbt_scatter_add_sorted(
            payload_fm.data_ptr(), p_pad, rows2d.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), dims.n_kernel, w, stream),
            "scatter_add_sorted")
    scatter_add_sorted.launches += 1
    return out


gather_sorted.launches = 0
scatter_add_sorted.launches = 0
