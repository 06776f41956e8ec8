// Fused row gather + sum-pool for Hopper (sm_90a) — the fast lowering's pull.
//
// Replaces the Pallas kernel of paddlebox_tpu/ops/pallas_gather.py
// (_kernel :29, gather_pool :82): for each pooled row r of idx [R, L],
//   pooled[r, :] = sum over l < lengths[r] of table[idx[r, l], :D]
// without materialising the [R, L, D] gathered rows.  The TPU version
// scalar-prefetches the ids into SMEM and streams one table row at a time
// through double-buffered DMAs, 128 pooled rows per grid step.  An H100
// gathers natively, so here a group of G lanes owns one pooled row and
// reads the table directly.
//
// Bound by device-memory bytes, not operations (one add per gathered
// value): it reads idx [R, L] and lengths [R] once, the table rows it
// touches, and writes pooled [R, D] once.  What the design does about it:
// - the table's row stride `ld` is separate from D, so a caller can pad
//   its rows to 16 bytes (the fast path's [N, 12] buffer seen as
//   [N, 11]); when ld and the base are 16-byte aligned each lane loads
//   float4 words (kV = 4; 4 lanes cover a row of D = 11), else the same
//   kernel loads floats (kV = 1, 2 words a lane, 8 lanes a row);
// - lane 0 of a group loads the row's length and lanes q < L its ids at
//   once (one round trip, ids shared by shuffles), and every lane issues
//   all its live-row loads before the first add, so a pooled row waits on
//   about two round trips, not one per id;
// - the block's pooled rows are staged in shared memory and written out
//   as one contiguous, coalesced range.
// Each column sums l = 0, 1, ... from 0.0 — the plain version's order,
// with no atomics — so the result is bit-equal to the plain version.
// Rows at or past lengths[r] are never read.
//
// What the design replaces (measured with chip_smoke.py's timer by
// kernel_ab.py, NVIDIA H100 80GB HBM3, 700.00 W): one thread per output
// value, each reloading its row's length and ids and then doing up to 3
// dependent 4-byte loads from 44-byte rows that straddle sectors: 0.060
// ms at the fast pull's shapes (uniform ids; 0.039 at Zipf-1.2) against
// a 0.0166 ms byte bound.  This design: 0.044 ms (0.032) on 16-byte rows.
// What is left is fetching ~0.85 M random rows: PyTorch's index_select
// of the same live rows, with no pooling, takes 0.059 ms (0.036;
// chip_smoke.py).  On a contiguous 44-byte-row table the old design stays
// faster: this kernel's 4-byte route takes 0.064 ms (0.055).
//
// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;   // live-row loads in flight per lane

template <int kV> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
  static __device__ __forceinline__ float get(const T& a, int) { return a; }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ float get(const T& a, int e) {
    return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
  }
};

// Lane q of a group of G = 1 << g_log2 lanes owns words j0 + q + G * i
// (i < kW) of a pooled row, each word kV floats; rows_per_block =
// kThreads / G pooled rows per block.  kW = 2 on the float route keeps
// more rows in flight than one word a lane (16 lanes a row of 11): 0.064
// against 0.087 ms at chip_smoke.py's uniform ids, and 0.077 ms at 4
// words a lane (kernel_ab.py on copies of the tree, NVIDIA H100 80GB
// HBM3, 700.00 W).
template <int kV, int kW>
__global__ void __launch_bounds__(kThreads)
gather_pool_kernel(const float* __restrict__ table, int64_t ld,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ lengths,
                   float* __restrict__ out, int64_t r_rows, int l_cap, int d,
                   int g_log2) {
  using V = Vec<kV>;
  using T = typename V::T;
  extern __shared__ float s_out[];   // [rows_per_block, d]
  const int g = 1 << g_log2;
  const int q = threadIdx.x & (g - 1);
  const int lane = threadIdx.x & 31;
  const unsigned mask = g == 32 ? 0xffffffffu
                                : ((1u << g) - 1u) << (lane & ~(g - 1));
  const int rows_per_block = kThreads >> g_log2;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int local = threadIdx.x >> g_log2;
  const int64_t r = r_begin + local;
  const bool row_ok = r < r_rows;
  const int nv = (d + kV - 1) / kV;
  const int32_t* ids = idx + r * l_cap;

  // one round trip: the length (lane 0) and the first g ids (lanes q < L)
  int len = 0;
  if (row_ok && q == 0) len = __ldg(lengths + r);
  int first_ids = 0;
  if (row_ok && q < l_cap) first_ids = __ldg(ids + q);
  len = __shfl_sync(mask, len, 0, g);
  len = len < l_cap ? len : l_cap;

  for (int j0 = 0; j0 < nv; j0 += g * kW) {
    T acc[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = T{};   // 0.0 in every float
    for (int l0 = 0; l0 < len; l0 += g) {
      int chunk_ids = first_ids;
      if (l0 > 0) chunk_ids = l0 + q < len ? __ldg(ids + l0 + q) : 0;
      const int nb = len - l0 < g ? len - l0 : g;
      for (int b0 = 0; b0 < nb; b0 += kBatch) {
        // every load of the batch is issued before the first add
        T v[kBatch][kW];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int id = __shfl_sync(mask, chunk_ids, (b0 + k) & (g - 1), g);
          const float* row = table + static_cast<int64_t>(id) * ld;
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            const int j = j0 + q + g * i;
            if (j < nv && b0 + k < nb) v[k][i] = V::load(row + j * kV);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            if (j0 + q + g * i < nv && b0 + k < nb) V::add(acc[i], v[k][i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int j = j0 + q + g * i;
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        if (j < nv && j * kV + e < d) {
          s_out[local * d + j * kV + e] = V::get(acc[i], e);
        }
      }
    }
  }
  __syncthreads();
  const int64_t n_rows = r_rows - r_begin < rows_per_block
                             ? r_rows - r_begin : rows_per_block;
  float* dst = out + r_begin * d;
  for (int64_t i = threadIdx.x; i < n_rows * d; i += kThreads) {
    dst[i] = s_out[i];
  }
}

template <int kV, int kW>
cudaError_t launch(const float* table, int64_t ld, const int32_t* idx,
                   const int32_t* lengths, float* out, int64_t r_rows,
                   int l_cap, int d, cudaStream_t st) {
  const int nv = (d + kV - 1) / kV;
  int g_log2 = 0;
  while ((1 << g_log2) * kW < nv && g_log2 < 5) ++g_log2;
  const int rows_per_block = kThreads >> g_log2;
  const size_t smem = sizeof(float) * rows_per_block * static_cast<size_t>(d);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const unsigned int blocks = static_cast<unsigned int>(
      (r_rows + rows_per_block - 1) / rows_per_block);
  gather_pool_kernel<kV, kW><<<blocks, kThreads, smem, st>>>(
      table, ld, idx, lengths, out, r_rows, l_cap, d, g_log2);
  return cudaGetLastError();
}

}  // namespace

// vec != 0: ld % 4 == 0, the base 16-byte aligned and every row's words
// up to round_up(d, 4) readable (the caller checks the storage).
extern "C" int pbt_gather_pool(const float* table, int64_t ld,
                               const int32_t* idx, const int32_t* lengths,
                               float* out, int64_t r_rows, int l_cap, int d,
                               int vec, void* stream) {
  if (r_rows == 0 || d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch<4, 1>(table, ld, idx, lengths, out, r_rows, l_cap, d, st)
          : launch<1, 2>(table, ld, idx, lengths, out, r_rows, l_cap, d, st);
  return static_cast<int>(err);
}
