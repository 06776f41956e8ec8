"""The yardstick's peaks and the bytes and operations a kernel needs.

Peaks are NVIDIA's data-sheet numbers for one H100 SXM at its full power
limit of 700 W (dense rates, no sparsity).  A kernel's least time is the
larger of its bytes over the memory bandwidth and its operations over the
peak of the precision it computes in; bytes count each input byte read
once and each output byte written once, for what these inputs need (the
rows a plan touches, not the whole table).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# FLOP/s by the precision a matrix product runs in on the card
PEAK_FLOPS = {
    "float32": 67e12,     # CUDA cores, outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
}


def matmul_precision(allow_tf32: bool) -> str:
    """The precision a float32 matmul runs in under PyTorch's TF32 flag."""
    return "tf32" if allow_tf32 else "float32"


def least_seconds(n_bytes: float, n_ops: float = 0.0,
                  precision: str = "float32") -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[precision])


def gather_sorted_bytes(p_pad: int, width: int, distinct: int) -> int:
    """``gather_sorted``: the plan's sorted row ids in (int32), each
    distinct row's ``width`` columns of the feature-major table in, the
    [width, p_pad] gathered values out (float32)."""
    return 4 * p_pad + 4 * width * distinct + 4 * width * p_pad


def scatter_add_sorted_bytes(p_pad: int, width: int, distinct: int) -> int:
    """``scatter_add_sorted``: the [width, p_pad] payload and the sorted
    row ids in, one merged row of ``width`` columns out for each distinct
    row (the rows no occurrence touches are zeroed by a separate fill,
    not by the kernel)."""
    return 4 * width * p_pad + 4 * p_pad + 4 * width * distinct


def scatter_add_sorted_ops(p_pad: int, width: int) -> int:
    """One add per payload value."""
    return width * p_pad


def step_flops(macs_per_record: int, records: int) -> int:
    """Forward and backward of the dense net: 2 FLOP a MAC forward, 4
    backward (the grads of the weights and of the layer's input)."""
    return 6 * macs_per_record * records
