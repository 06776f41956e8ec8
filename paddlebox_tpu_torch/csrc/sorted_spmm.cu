// Sorted-occurrence gather and merged scatter for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of paddlebox_tpu/ops/sorted_spmm.py:
//   gather_sorted       (_gather_kernel)  — the mxu pull
//   scatter_add_sorted  (_scatter_kernel) — the mxu merged push, and through
//                        segment_sum the fast and ragged merges
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
//   scatter: reads payload [W, p_pad] and rows once, writes each touched
//            column of out [W, n_kernel] exactly once; untouched columns
//            keep the zeros the caller allocated.
//
// The scatter is a deterministic segmented sum with no float atomics, in
// two kernels whose cost does not grow with the length of a run:
//   1. scatter_tiles_kernel: one block per tile of kTile sorted positions.
//      The block stages the tile's rows and payload columns in shared
//      memory with 16-byte cp.async copies (coalesced), derives run starts
//      from rows[k] != rows[k-1] (reading the neighbouring tiles' edge
//      rows), lets each thread sum its kPer consecutive positions in
//      order, and joins the pieces of runs that span threads with a
//      fixed-shape segmented scan (warp shuffles, then one step through
//      shared memory between warps).  A run that begins and ends in the
//      tile is written once: its sum is parked in shared memory at its
//      last position.  Where the tile's runs are dense in its row span
//      (from the row after the previous tile's last row to its own last
//      row; at most kSpanPerRun rows a run), the block writes every row of
//      the span: a run's sum, or 0 for a row no run of the tile ends on.
//      Consecutive lanes write consecutive rows, so every 32-byte sector
//      is written whole, and the spans of two tiles never overlap.
//      Writing only the runs' rows — about half the span at uniform ids —
//      leaves partial sectors of the zero-filled output that L2 has to
//      merge with device memory (the wrapper at chip_smoke.py's uniform
//      ids: 0.152 ms for the runs' rows alone, 0.118 ms for whole spans;
//      kernel_ab.py, NVIDIA H100 80GB HBM3, 700.00 W).  Where the runs
//      are sparse (a Zipf tail), writing the zeros costs more than the
//      merges, and the block writes the runs alone, lane j on run j (its
//      stores still coalesce: runs ascend by row).  Either way every row
//      gets one value.  The tile's first run, if it continues an
//      earlier tile, and its last run, if it continues into the next, go
//      to a carry scratch [n_tiles][2][W] with per-tile flags; a tile
//      that is one run throughout is flagged kWhole.
//   2. scatter_combine_kernel: one warp per run that crosses a tile edge.
//      Lanes take the run's tiles at a stride of 32 (the start tile's tail
//      carry, the whole tiles' sums, the end tile's head carry), then a
//      __shfl_xor tree of the same shape for every run; the row is
//      written once.
// Every add's order depends only on p_pad, kTile and the row ids, never
// on scheduling, so two calls give bit-identical output.
//
// What the design replaces (measured, chip_smoke.py on NVIDIA H100 80GB
// HBM3, 700.00 W): the previous two-pass kernel gave each run one thread
// that added the run's 256-position piece sums one after another.  On the
// main path every padding occurrence sits on row 0 — ~426 k of 1,277,952
// sorted positions — so one thread walked ~1.7 k pieces per column block
// (~3.3 k dependent loads): 2.31–2.47 ms per step on the fast and
// streaming mxu lowerings against a 0.048 ms bound for the whole scatter.
//
// Plain C interface, loaded with ctypes: every function returns the
// cudaError_t of its launch (0 = success).  Pointers, the device ordinal
// and the stream come from torch tensors / torch.cuda.current_stream() on
// the Python side; the launch runs on that device.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.h"

#include <atomic>

namespace {

constexpr int kThreads = 256;

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

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// scatter
// ---------------------------------------------------------------------------

constexpr int kTile = 1024;               // sorted positions per tile
constexpr int kPer = kTile / kThreads;    // consecutive positions per thread
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 12;                 // payload columns staged per round
// sparsest span (rows per run) still written row by row.  The wrapper at
// chip_smoke.py's uniform, Zipf-1.2 and padded ids with 4: 0.118, 0.126,
// 0.132 ms; with 0: 0.152, 0.126, 0.160; unbounded: 0.118, 0.176, 0.133
// (kernel_ab.py on copies of the tree, NVIDIA H100 80GB HBM3, 700.00 W)
constexpr int kSpanPerRun = 4;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPer == 4, "a thread reads its positions as one 16-byte word");

// per-tile flags
constexpr int32_t kHeadCont = 1;  // first position continues an earlier run
constexpr int32_t kTailCont = 2;  // last position's run continues after
constexpr int32_t kWhole = 4;     // the tile is one run, open at both ends

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's committed groups are in
// flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Copy n 4-byte values src[0..n) to shared dst[0..n): 16-byte copies when
// kVec (src 16-byte aligned, n a multiple of 4), else 4-byte copies.
template <bool kVec>
__device__ __forceinline__ void stage(void* dst, const void* src, int n) {
  if (kVec) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      cp_async16(static_cast<char*>(dst) + 16 * i,
                 static_cast<const char*>(src) + 16 * i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      cp_async4(static_cast<char*>(dst) + 4 * i,
                static_cast<const char*>(src) + 4 * i);
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* s, int i) {
  return reinterpret_cast<const float4*>(s)[i];
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
scatter_tiles_kernel(const float* __restrict__ payload, int64_t p_pad,
                     const int32_t* __restrict__ rows,
                     float* __restrict__ carry, int32_t* __restrict__ flags,
                     float* __restrict__ out, int64_t n_kernel, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_rows = reinterpret_cast<int32_t*>(smem);
  int32_t* s_end = s_rows + kTile;   // last position of each run, in order
  int32_t* s_end_row = s_end + kTile;  // and its row
  float* s_pay = reinterpret_cast<float*>(s_end_row + kTile);
  __shared__ float s_warp_v[kWarps][kCols];
  __shared__ int s_warp_f[kWarps];
  __shared__ int s_warp_n[kWarps];

  const int64_t tile = blockIdx.x;
  const int64_t t0 = tile * kTile;
  const int n = static_cast<int>(p_pad - t0 < kTile ? p_pad - t0 : kTile);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nc0 = w < kCols ? w : kCols;

  // two copy groups: the rows, then the payload, which lands while the
  // block finds the runs
  stage<kVec>(s_rows, rows + t0, n);
  cp_async_commit();
  for (int c = 0; c < nc0; ++c) {
    stage<kVec>(s_pay + c * kTile, payload + c * p_pad + t0, n);
  }
  cp_async_commit();
  // the neighbouring tiles' edge rows decide whether the first run
  // continues an earlier tile and the last continues into the next
  const bool has_prev = t0 > 0;
  const bool has_next = t0 + n < p_pad;
  const int32_t prev_row = has_prev ? __ldg(rows + t0 - 1) : 0;
  const int32_t next_row = has_next ? __ldg(rows + t0 + n) : 0;
  cp_async_wait<1>();
  __syncthreads();

  // this thread's positions i0 .. i0 + m - 1 of the tile
  const int i0 = tid * kPer;
  const int m = n - i0 < 0 ? 0 : (n - i0 < kPer ? n - i0 : kPer);
  bool head[kPer], tail[kPer];
  bool any_head = false;
  bool last_open = false;   // this thread's last position's run continues
  int last_head = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int pos = i0 + k;
    const bool valid = k < m;
    const int32_t r = valid ? s_rows[pos] : 0;
    const bool same_prev = pos == 0 ? (has_prev && prev_row == r)
                                    : (valid && s_rows[pos - 1] == r);
    const bool same_next = pos == n - 1 ? (has_next && next_row == r)
                                        : (valid && s_rows[pos + 1] == r);
    head[k] = valid && !same_prev;
    tail[k] = valid && !same_next;
    if (head[k]) {
      any_head = true;
      last_head = k;
    }
    if (k == m - 1) last_open = !tail[k];
  }
  // this thread holds the tile's last position
  const bool holds_last = m > 0 && i0 + m == n;
  const bool head_cont = has_prev && prev_row == s_rows[0];

  // list the positions where runs end, in order (an exclusive scan of
  // the per-thread counts); when the tile's first run continues an
  // earlier tile, its end is entry 0 and goes to the carry instead
  int n_end = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) n_end += tail[k] ? 1 : 0;
  int incl = n_end;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp_n[warp] = incl;
  __syncthreads();
  int slot = incl - n_end;
  int n_runs = 0;
  for (int wi = 0; wi < kWarps; ++wi) {
    slot += wi < warp ? s_warp_n[wi] : 0;
    n_runs += s_warp_n[wi];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (tail[k]) {
      s_end[slot] = i0 + k;
      s_end_row[slot++] = s_rows[i0 + k];
    }
  }

  for (int c0 = 0; c0 < w; c0 += kCols) {
    const int nc = w - c0 < kCols ? w - c0 : kCols;
    if (c0 > 0) {
      __syncthreads();  // every thread is done with the previous columns
      for (int c = 0; c < nc; ++c) {
        stage<kVec>(s_pay + c * kTile, payload + (c0 + c) * p_pad + t0, n);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();

    // (a) the sum of this thread's last fragment: from its last run start
    // (or its first position, if no run starts here) to its end
    float sv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float acc = 0.0f;
      if (c < nc) {
        const float4 v = lds4(s_pay + c * kTile, tid);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (k >= last_head && k < m) acc += at(v, k);
        }
      }
      sv[c] = acc;
    }

    // (b) inclusive segmented scan over the threads of the tile of
    // (starts a run, fragment sum): a later element that starts a run
    // resets the sum; otherwise the earlier sum is added in front
    bool f = any_head;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool fu = __shfl_up_sync(kFull, static_cast<int>(f), d) != 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vu = __shfl_up_sync(kFull, sv[c], d);
        if (lane >= d && !f) sv[c] = vu + sv[c];
      }
      if (lane >= d) f = f || fu;
    }
    if (lane == 31) {
      s_warp_f[warp] = f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) s_warp_v[warp][c] = sv[c];
    }
    __syncthreads();
    // exclusive prefix of this thread: earlier warps, in order, then the
    // previous lane's inclusive value
    bool ef = false;
    float ev[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) ev[c] = 0.0f;
    for (int wi = 0; wi < warp; ++wi) {
      const bool wf = s_warp_f[wi];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        ev[c] = wf ? s_warp_v[wi][c] : ev[c] + s_warp_v[wi][c];
      }
      ef = ef || wf;
    }
    const bool pf = __shfl_up_sync(kFull, static_cast<int>(f), 1) != 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float pv = __shfl_up_sync(kFull, sv[c], 1);
      if (lane > 0) ev[c] = pf ? pv : ev[c] + pv;
    }
    if (lane > 0) ef = ef || pf;

    // (c) walk the positions again from the carried-in sum; park the sum
    // of each run that starts and ends in the tile at its last position
    // (this thread's own, already read), and the open ones in carry
    float* carry_t = carry + tile * 2 * w;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= nc || m == 0) continue;
      const float4 v = lds4(s_pay + c * kTile, tid);
      float acc = ev[c];
      bool started = ef;   // the current run starts inside this tile
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (k >= m) break;
        if (head[k]) {
          acc = at(v, k);
          started = true;
        } else {
          acc += at(v, k);
        }
        if (tail[k]) {
          if (started) {
            s_pay[c * kTile + i0 + k] = acc;
          } else {
            carry_t[c0 + c] = acc;            // head run, ends here
          }
        }
      }
      if (holds_last && last_open) {
        // the last run continues into the next tile
        carry_t[(started ? w : 0) + c0 + c] = acc;
      }
    }
    if (c0 == 0 && holds_last) {
      const bool one_run = !(ef || any_head);
      flags[tile] = (head_cont ? kHeadCont : 0) | (last_open ? kTailCont : 0)
                    | (head_cont && last_open && one_run ? kWhole : 0);
    }

    // (d) write the tile's complete runs (entry 0 went to the carry if
    // the tile's first run continues an earlier tile)
    __syncthreads();
    const int j_first = head_cont ? 1 : 0;
    const int64_t lo = has_prev ? static_cast<int64_t>(prev_row)
                                : static_cast<int64_t>(s_rows[0]) - 1;
    const int64_t hi = s_rows[n - 1];
    if (hi - lo > static_cast<int64_t>(kSpanPerRun) * (n_runs - j_first + 1)) {
      // sparse: the runs' rows alone
      for (int j = j_first + tid; j < n_runs; j += kThreads) {
        const int pos = s_end[j];
        float* dst = out + s_end_row[j];
        for (int c = 0; c < nc; ++c) {
          dst[static_cast<int64_t>(c0 + c) * n_kernel] =
              s_pay[c * kTile + pos];
        }
      }
      continue;
    }
    // dense: every row of the span (lo, hi], lane by lane — the sum of the
    // complete run that ends on the row (binary search of the run rows),
    // else 0: a gap, or the run left open at the tile's end, which the
    // combine kernel overwrites afterwards
    for (int64_t row = lo + 1 + tid; row <= hi; row += kThreads) {
      int a = j_first, b = n_runs;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (s_end_row[mid] < row) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      const bool hit = a < n_runs && s_end_row[a] == row;
      const int pos = hit ? s_end[a] : 0;
      for (int c = 0; c < nc; ++c) {
        out[static_cast<int64_t>(c0 + c) * n_kernel + row] =
            hit ? s_pay[c * kTile + pos] : 0.0f;
      }
    }
  }
}

// One warp per tile s whose last run continues (and that is not itself
// inside a longer run): that run spans tiles s .. e, where e is the first
// later tile not flagged kWhole.  Its sum = tail carry of s + the whole
// tiles' sums + head carry of e, all in carry slots [t][1] (t == s) or
// [t][0] (t > s).
__global__ void scatter_combine_kernel(const float* __restrict__ carry,
                                       const int32_t* __restrict__ flags,
                                       const int32_t* __restrict__ rows,
                                       int64_t n_tiles,
                                       float* __restrict__ out,
                                       int64_t n_kernel, int w) {
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= n_tiles) return;
  const int32_t fs = flags[s];
  if (!(fs & kTailCont) || (fs & kWhole)) return;
  int64_t e = -1;
  for (int64_t base = s + 1; base < n_tiles && e < 0; base += 32) {
    const int64_t t = base + lane;
    const unsigned stop = __ballot_sync(
        kFull, t < n_tiles && !(flags[t] & kWhole));
    if (stop) e = base + __ffs(stop) - 1;
  }
  if (e < 0) return;  // unreachable: the last tile never continues
  const int32_t row = rows[s * kTile + kTile - 1];
  for (int c = 0; c < w; ++c) {
    float acc = 0.0f;
    for (int64_t t = s + lane; t <= e; t += 32) {
      acc += carry[(t * 2 + (t == s ? 1 : 0)) * w + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, off);
    }
    if (lane == 0) out[static_cast<int64_t>(c) * n_kernel + row] = acc;
  }
}

int64_t tiles_for(int64_t p_pad) { return (p_pad + kTile - 1) / kTile; }

size_t tile_smem_bytes(int w) {
  return 3 * sizeof(int32_t) * kTile
         + sizeof(float) * kTile * static_cast<size_t>(w < kCols ? w : kCols);
}

constexpr int kMaxDevices = 64;

template <bool kVec>
cudaError_t launch_tiles(const float* payload, int64_t p_pad,
                         const int32_t* rows, float* carry, int32_t* flags,
                         float* out, int64_t n_kernel, int w, int device,
                         cudaStream_t st) {
  // above 48 KB a block's dynamic shared memory must be opted into, once
  // on each device (a repeated opt-in from a racing thread is harmless)
  static std::atomic<bool> opted[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[device].load()) {
    const cudaError_t attr = cudaFuncSetAttribute(
        scatter_tiles_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile_smem_bytes(kCols)));
    if (attr != cudaSuccess) return attr;
    opted[device].store(true);
  }
  scatter_tiles_kernel<kVec><<<static_cast<unsigned int>(tiles_for(p_pad)),
                               kThreads, tile_smem_bytes(w), st>>>(
      payload, p_pad, rows, carry, flags, out, n_kernel, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pbt_gather_sorted(const float* table, int64_t n_kernel,
                                 const int32_t* rows, float* out,
                                 int64_t p_pad, int w, int device,
                                 void* stream) {
  if (p_pad == 0) return 0;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  gather_sorted_kernel<<<blocks_for(p_pad), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, n_kernel, rows, out, p_pad, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pbt_scatter_tile() { return kTile; }

// Scratch floats for one call: carry [n_tiles][2][w], then n_tiles int32
// flags.
extern "C" int64_t pbt_scatter_scratch_floats(int64_t p_pad, int w) {
  return tiles_for(p_pad) * (2 * static_cast<int64_t>(w) + 1);
}

extern "C" int pbt_scatter_add_sorted(const float* payload, int64_t p_pad,
                                      const int32_t* rows, float* scratch,
                                      float* out, int64_t n_kernel, int w,
                                      int device, void* stream) {
  if (p_pad == 0 || w == 0) return 0;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const int64_t n_tiles = tiles_for(p_pad);
  float* carry = scratch;
  int32_t* flags = reinterpret_cast<int32_t*>(scratch + n_tiles * 2 * w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = p_pad % 4 == 0
                   && reinterpret_cast<uintptr_t>(payload) % 16 == 0
                   && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  cudaError_t err = vec
      ? launch_tiles<true>(payload, p_pad, rows, carry, flags, out, n_kernel,
                           w, device, st)
      : launch_tiles<false>(payload, p_pad, rows, carry, flags, out,
                            n_kernel, w, device, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_combine_kernel<<<blocks_for(n_tiles * 32), kThreads, 0, st>>>(
      carry, flags, rows, n_tiles, out, n_kernel, w);
  return static_cast<int>(cudaGetLastError());
}
