"""Fused embedding-row gather + sequence sum-pool — the fast lowering's pull.

Port of ``paddlebox_tpu/ops/pallas_gather.py``.  For each pooled row r,
``pooled[r] = sum(table[idx[r, l]] for l < lengths[r])``; row 0 of the
table is the reserved zero row.  The TPU kernel streams table rows
through double-buffered DMAs from scalar-prefetched ids; on Hopper the
kernel is hand-written CUDA (``csrc/gather_pool.cu``): a group of lanes
owns a pooled row, loads its length and ids once, issues every live
row's load before the first add and sums each column in the order
l = 0, 1, ..., never reading rows at or past the length.  The table may
be a column view of a wider buffer (row stride >= D): rows padded to
16 bytes are read as float4 words.

``gather_pool`` takes its plain PyTorch version (``gather_pool_plain``,
the same sequential sum) for a tensor on the CPU, and launches the kernel
for a tensor on a card — it never falls back.  ``gather_pool.launches``
counts kernel launches.  The TPU version's ``R % 128 == 0`` is a tiling
artefact of its grid and is not required here.
"""

from __future__ import annotations

import ctypes

import torch

from paddlebox_tpu_torch.ops import cuda_lib


def gather_pool_plain(table: torch.Tensor, idx: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """table [N, D]; idx [R, L]; lengths [R] → pooled [R, D]: ids at or
    past ``lengths[r]`` are never looked up, and the L terms are added in
    order (one [R, D] gather per l, never an [R, L, D] tensor)."""
    r, l_cap = idx.shape
    out = torch.zeros((r, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    for l in range(l_cap):
        live = lengths > l
        ids = torch.where(live, idx[:, l], torch.zeros_like(idx[:, l]))
        out += torch.where(live[:, None], table[ids.long()], zero)
    return out


_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.library("gather_pool")
    if not getattr(lib, "_pbt_typed", False):
        lib.pbt_gather_pool.argtypes = [_P, ctypes.c_int64, _P, _P, _P,
                                        ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, _P]
        lib.pbt_gather_pool.restype = ctypes.c_int
        lib._pbt_typed = True
    return lib


def _check_cuda(table: torch.Tensor, idx: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """The kernel takes tensors of one card: table f32 [N, D] with unit
    column stride and row stride >= D (a column view of a wider buffer
    is fine), contiguous idx int32 [R, L] and lengths int32 [R]; anything
    else raises (never a silent copy or fallback)."""
    want = {"table": (table, torch.float32, 2),
            "idx": (idx, torch.int32, 2),
            "lengths": (lengths, torch.int32, 1)}
    for arg, (t, dtype, ndim) in want.items():
        if t.device != table.device:
            raise ValueError(f"gather_pool: {arg} is on {t.device}, not "
                             f"{table.device}")
        if t.dtype != dtype:
            raise TypeError(f"gather_pool: {arg} must be {dtype}, got "
                            f"{t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"gather_pool: {arg} must have {ndim} dims, "
                             f"got shape {tuple(t.shape)}")
        if arg == "table":
            if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
                raise ValueError(
                    f"gather_pool: table needs unit column stride and row "
                    f"stride >= D, got strides {t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"gather_pool: {arg} must be contiguous")
    if lengths.shape[0] != idx.shape[0]:
        raise ValueError(f"gather_pool: {idx.shape[0]} rows of ids but "
                         f"{lengths.shape[0]} lengths")


def _vector_rows(table: torch.Tensor) -> bool:
    """Whether the kernel may read every row as float4 words: a 16-byte
    aligned base and row stride, and storage behind the last row up to
    D rounded up to 4 floats."""
    n, d = table.shape
    ld = table.stride(0)
    end = table.storage_offset() + (n - 1) * ld + (d + 3) // 4 * 4
    return (ld % 4 == 0 and table.data_ptr() % 16 == 0
            and end * 4 <= table.untyped_storage().nbytes())


def gather_pool(table: torch.Tensor, idx: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """table [N, D] f32 (row stride >= D); idx [R, L] int32 row ids
    (0 = reserved zero row); lengths [R] int32 → pooled [R, D] = sum of
    the first ``lengths[r]`` rows.  Ids must lie in [0, N) wherever
    l < lengths[r]."""
    if table.device.type == "cpu":
        return gather_pool_plain(table, idx, lengths)
    if table.device.type != "cuda":
        raise ValueError(f"gather_pool: unsupported device {table.device}")
    _check_cuda(table, idx, lengths)
    r, l_cap = idx.shape
    d = table.shape[1]
    out = torch.empty((r, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out               # nothing to pool: no launch, no count
    ld = table.stride(0)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_lib.check(_lib().pbt_gather_pool(
            table.data_ptr(), ld, idx.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), r, l_cap, d, int(_vector_rows(table)),
            table.device.index, stream),
            "gather_pool")
    cuda_lib.count_launch(gather_pool)
    return out


gather_pool.launches = 0
