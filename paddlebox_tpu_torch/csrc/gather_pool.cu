// Fused row gather + sum-pool for Hopper (sm_90a) — the fast lowering's pull.
//
// Replaces the Pallas kernel of paddlebox_tpu/ops/pallas_gather.py
// (_kernel :29, gather_pool :82): for each pooled row r of idx [R, L],
//   pooled[r, :] = sum over l < lengths[r] of table[idx[r, l], :]
// without materialising the [R, L, D] gathered rows.  The TPU version
// scalar-prefetches the ids into SMEM and streams one table row at a time
// through double-buffered DMAs, 128 pooled rows per grid step.  An H100
// gathers natively, so here every thread loads its own ids and reads the
// table directly: thread (r, c) owns one output value and sums column c of
// its row's first lengths[r] table rows in the order l = 0, 1, ... — the
// same order as the plain version, with no atomics, so the result is
// deterministic (and equal to the plain version's sequential sum).  Rows
// at or past lengths[r] are never read.
//
// Bound by device-memory bytes, not operations (one add per gathered
// value): it reads idx [R, L] and lengths [R] once, the table rows it
// touches, and writes pooled [R, D] once.  Neighbouring threads cover the
// D columns of one row and then of the next, so the table reads of a row
// fall in one or two sectors and the output writes are coalesced; the D
// threads of a row read the same ids, which the L1 cache serves.
//
// Known limit, the first thing a redesign would fix: at the bench's width
// (D = 3 + mf_dim 8 = 11) a table row is 44 bytes, not a multiple of
// 16 bytes, so rows cannot be loaded as aligned 16-byte vectors and one row
// usually spans two 32-byte sectors.  Padding the row to 12 or 16 floats
// (and loading float4) would cut the sectors read per row.
//
// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_pool_kernel(const float* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   const int32_t* __restrict__ lengths,
                                   float* __restrict__ out, int64_t r_rows,
                                   int l_cap, int d) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (g >= r_rows * d) return;
  const int64_t r = g / d;
  const int c = static_cast<int>(g - r * d);
  int len = __ldg(lengths + r);
  len = len < l_cap ? len : l_cap;
  const int32_t* ids = idx + r * l_cap;
  float acc = 0.0f;
  for (int l = 0; l < len; ++l) {
    const int64_t row = __ldg(ids + l);
    acc += __ldg(table + row * d + c);
  }
  out[g] = acc;
}

}  // namespace

extern "C" int pbt_gather_pool(const float* table, const int32_t* idx,
                               const int32_t* lengths, float* out,
                               int64_t r_rows, int l_cap, int d,
                               void* stream) {
  const int64_t n = r_rows * d;
  if (n == 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  gather_pool_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      table, idx, lengths, out, r_rows, l_cap, d);
  return static_cast<int>(cudaGetLastError());
}
