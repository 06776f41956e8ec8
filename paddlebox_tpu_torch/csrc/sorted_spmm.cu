// Sorted-occurrence gather and merged scatter for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of paddlebox_tpu/ops/sorted_spmm.py:
//   gather_sorted       (_gather_kernel)  — the mxu pull
//   scatter_add_sorted  (_scatter_kernel) — the mxu merged push
// The TPU versions walk a (512-occurrence chunk x 2048-row tile) worklist
// of one-hot bf16 hi/lo matmuls because TPU gathers and scatters run as
// serial loops.  An H100 gathers natively, so both kernels here work
// directly on the sorted occurrence domain and ignore the worklist.
//
// Both are bound by device-memory bytes, not operations (a gather does no
// arithmetic; the scatter does one add per payload value):
//   gather:  reads the rows it touches of table_fm [W, n_kernel] plus
//            rows [p_pad], writes out [W, p_pad].  Because rows are sorted,
//            neighbouring threads read neighbouring (often equal) table
//            columns, so the reads of one warp fall in few sectors; the
//            writes out[c, j] are coalesced along j.
//   scatter: reads payload [W, p_pad], rows and first_occ, writes each
//            touched column of out [W, n_kernel] exactly once; untouched
//            columns keep the zeros the caller allocated.  A deterministic
//            segmented sum with no float atomics, in two passes: the sorted
//            domain is cut into pieces of kPiece positions; pass 1 sums, in
//            parallel, every piece that continues a run begun in an earlier
//            piece; pass 2 has one thread per run start sum its head and
//            then add the run's later pieces in order.  A run of length n
//            thus costs one thread ~kPiece + n / kPiece steps instead of n:
//            this matters on the main path, where every padding occurrence
//            sits on row 0 (a third of all occurrences at the bench's
//            lengths) and a hot key's run can span a large share of the
//            batch.
//
// Plain C interface, loaded with ctypes: every function returns the
// cudaError_t of its launch (0 = success).  Pointers and the stream come
// from torch tensors / torch.cuda.current_stream() on the Python side.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColBlock = 8;   // payload columns summed together (ILP)
constexpr int64_t kPiece = 256;  // sorted positions per piece of a long run

__global__ void gather_sorted_kernel(const float* __restrict__ table,
                                     int64_t n_kernel,
                                     const int32_t* __restrict__ rows,
                                     float* __restrict__ out,
                                     int64_t p_pad, int w) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (j >= p_pad) return;
  const int64_t r = rows[j];
  for (int c = 0; c < w; ++c) {
    out[c * p_pad + j] = __ldg(table + c * n_kernel + r);
  }
}

// Sum payload[c0 .. c0+nc)[lo .. hi) into acc, in position order.
__device__ __forceinline__ void sum_columns(const float* __restrict__ payload,
                                            int64_t p_pad, int c0, int nc,
                                            int64_t lo, int64_t hi,
                                            float* acc) {
  for (int64_t k = lo; k < hi; ++k) {
#pragma unroll
    for (int c = 0; c < kColBlock; ++c) {
      if (c < nc) acc[c] += payload[(c0 + c) * p_pad + k];
    }
  }
}

// First position >= lo (and < limit) whose row differs from r.
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ rows,
                                           int64_t lo, int64_t limit,
                                           int32_t r) {
  while (lo < limit && rows[lo] == r) ++lo;
  return lo;
}

// Pass 1: a piece starts at every multiple of kPiece that lies INSIDE a
// run (not at its start); its thread sums the piece — up to the next
// multiple or the run's end — into partial[c, k / kPiece].
__global__ void scatter_pieces_kernel(const float* __restrict__ payload,
                                      int64_t p_pad,
                                      const int32_t* __restrict__ rows,
                                      const float* __restrict__ first_occ,
                                      float* __restrict__ partial,
                                      int64_t n_pieces, int w) {
  const int64_t piece = static_cast<int64_t>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  const int64_t k = piece * kPiece;
  if (k >= p_pad || first_occ[k] != 0.0f) return;
  const int64_t limit = (k + kPiece < p_pad) ? k + kPiece : p_pad;
  const int64_t end = run_end(rows, k + 1, limit, rows[k]);
  for (int c0 = 0; c0 < w; c0 += kColBlock) {
    const int nc = (w - c0) < kColBlock ? (w - c0) : kColBlock;
    float acc[kColBlock];
#pragma unroll
    for (int c = 0; c < kColBlock; ++c) acc[c] = 0.0f;
    sum_columns(payload, p_pad, c0, nc, k, end, acc);
#pragma unroll
    for (int c = 0; c < kColBlock; ++c) {
      if (c < nc) partial[(c0 + c) * n_pieces + piece] = acc[c];
    }
  }
}

// Pass 2: one thread per run start sums its head (up to the next
// multiple of kPiece), then adds the pieces of pass 1 in order while the
// run continues, and writes the row once.
__global__ void scatter_runs_kernel(const float* __restrict__ payload,
                                    int64_t p_pad,
                                    const int32_t* __restrict__ rows,
                                    const float* __restrict__ first_occ,
                                    const float* __restrict__ partial,
                                    int64_t n_pieces,
                                    float* __restrict__ out,
                                    int64_t n_kernel, int w) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (j >= p_pad || first_occ[j] == 0.0f) return;
  const int32_t r = rows[j];
  const int64_t boundary = (j / kPiece + 1) * kPiece;
  const int64_t limit = boundary < p_pad ? boundary : p_pad;
  const int64_t head_end = run_end(rows, j + 1, limit, r);
  for (int c0 = 0; c0 < w; c0 += kColBlock) {
    const int nc = (w - c0) < kColBlock ? (w - c0) : kColBlock;
    float acc[kColBlock];
#pragma unroll
    for (int c = 0; c < kColBlock; ++c) acc[c] = 0.0f;
    sum_columns(payload, p_pad, c0, nc, j, head_end, acc);
    for (int64_t k = boundary; head_end == limit && k < p_pad && rows[k] == r;
         k += kPiece) {
#pragma unroll
      for (int c = 0; c < kColBlock; ++c) {
        if (c < nc) acc[c] += partial[(c0 + c) * n_pieces + k / kPiece];
      }
    }
#pragma unroll
    for (int c = 0; c < kColBlock; ++c) {
      if (c < nc) out[(c0 + c) * n_kernel + r] = acc[c];
    }
  }
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int pbt_gather_sorted(const float* table, int64_t n_kernel,
                                 const int32_t* rows, float* out,
                                 int64_t p_pad, int w, void* stream) {
  if (p_pad == 0) return 0;
  gather_sorted_kernel<<<blocks_for(p_pad), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, n_kernel, rows, out, p_pad, w);
  return static_cast<int>(cudaGetLastError());
}

int64_t pieces_for(int64_t p_pad) { return (p_pad + kPiece - 1) / kPiece; }

extern "C" int64_t pbt_scatter_scratch_floats(int64_t p_pad, int w) {
  return static_cast<int64_t>(w) * pieces_for(p_pad);
}

extern "C" int pbt_scatter_add_sorted(const float* payload, int64_t p_pad,
                                      const int32_t* rows,
                                      const float* first_occ, float* scratch,
                                      float* out, int64_t n_kernel, int w,
                                      void* stream) {
  if (p_pad == 0) return 0;
  const int64_t n_pieces = pieces_for(p_pad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  scatter_pieces_kernel<<<blocks_for(n_pieces), kThreads, 0, st>>>(
      payload, p_pad, rows, first_occ, scratch, n_pieces, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_runs_kernel<<<blocks_for(p_pad), kThreads, 0, st>>>(
      payload, p_pad, rows, first_occ, scratch, n_pieces, out, n_kernel, w);
  return static_cast<int>(cudaGetLastError());
}
