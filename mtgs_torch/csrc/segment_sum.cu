// Per-gaussian sums of slot-ordered gradient rows.
//
// Replaces the TPU kernel mtgs_tpu/raster/segment_sum.py::dense_segment_sum
// (_kernel). Input rows [w, I] in slot order, keyed by src [I], a
// non-decreasing owner id per slot with the sentinel n on dead slots;
// output out [w, n + 1], column g the sum of the rows of the slots whose
// src is g (column n: the sentinel slots, which hold zero rows). Every
// column is written, so the output needs no zero-fill.
//
// The TPU kernel reduces through one-hot MXU matmuls over 1024-wide id
// windows because the TPU has neither atomics nor fast gathers. Here the
// slots of one id are contiguous (a segment), so the sums need neither.
//
// What bounds it on an H100: bytes. Each live slot's w rows are read
// once, src once, and each of the (n + 1) w outputs written once. The
// earlier kernel ran one thread per output column: two dependent binary
// searches over src (~21 loads each) before the first row read, then its
// segment's rows one 4-byte load at a time, a warp's addresses scattered
// by the segments' lengths; it ran at ~11x the bound. Design:
//   * slot-parallel: a warp takes 32 consecutive slots, one a lane, and
//     reads each row as 128 contiguous bytes, with the loads of 8 rows in
//     flight a lane before the first sum (and at most 64 registers a
//     thread, so that four blocks of 256 threads stay resident an SM);
//   * a segment's head is the slot whose id differs from its
//     predecessor's; no search. A segmented suffix sum over the warp (up
//     to 5 shuffles a row, in a fixed order; a step no lane needs is left
//     out) leaves at each head the sum of its segment's slots in the
//     warp;
//   * the segment that runs past the warp's last slot is finished by the
//     warp that holds its head, which reads ahead 64 slots a step until
//     the id changes (a segment spans at most num_tiles slots). The slots
//     before a warp's first head belong to an earlier warp's segment and
//     are left to it. Each head writes its column once;
//   * the head that follows ids with no slot writes zeros into their
//     columns (the warp together, a column a lane);
//   * the dead tail: a warp whose first slot holds the sentinel returns
//     after one load of src. The columns after the last live id, the
//     sentinel's among them, are written as zeros by fill blocks at the
//     end of the grid, 2,048 columns each, without reading a row: each
//     finds the first sentinel slot by a 256-way search of src (a few
//     rounds of one load a thread; at the main path's shapes hundreds of
//     thousands of ids own no slot and sit in that tail, the zero-pair
//     gaussians the depth sort puts last).
// No float atomics: the sums are taken in a fixed order, and two launches
// give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // rows a pass holds in registers (one value a lane each)
constexpr int kMinBlocks = 4;     // resident blocks an SM (at most 64 registers a thread)
constexpr int kFillCols = 2048;   // tail columns a fill block writes
constexpr unsigned kFull = 0xffffffffu;

// Fill block f: zeros in columns [f kFillCols, (f + 1) kFillCols) past the
// last live id, in every row.
__device__ void fill_tail(int f, int w, long long n_slots, const int* __restrict__ src,
                          int n_cols, float* __restrict__ out) {
  const int n = n_cols - 1;
  // the first sentinel slot (n_slots if none) lies in [lo, hi]: the live
  // slots are a prefix, so the live probes are too
  long long lo = 0, hi = n_slots;
  while (lo < hi) {
    const long long step = (hi - lo + kThreads - 1) / kThreads;
    const long long pos = lo + threadIdx.x * step;
    const int k = __syncthreads_count(pos < hi && src[pos] < n);
    if (k == 0) break;  // src[lo] is the sentinel
    const long long base = lo;
    lo = base + (k - 1) * step + 1;
    hi = min(hi, base + k * step);
  }
  const int last_live = lo > 0 ? src[lo - 1] : -1;
  const int c_lo = max(f * kFillCols, last_live + 1);
  const int c_hi = min(f * kFillCols + kFillCols, n_cols);
  for (int r = 0; r < w; ++r) {
    for (int c = c_lo + threadIdx.x; c < c_hi; c += kThreads)
      out[(long long)r * n_cols + c] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_sum_kernel(const float* __restrict__ rows, int w, long long n_slots,
                   const int* __restrict__ src, int n_cols, int slot_blocks,
                   float* __restrict__ out) {
  if ((int)blockIdx.x >= slot_blocks) {
    fill_tail((int)blockIdx.x - slot_blocks, w, n_slots, src, n_cols, out);
    return;
  }
  const int n = n_cols - 1;
  const int lane = threadIdx.x & 31;
  const long long c0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (c0 >= n_slots) return;
  const long long s = c0 + lane;
  const int id = s < n_slots ? src[s] : n;
  if (__shfl_sync(kFull, id, 0) == n) return;  // the dead tail
  const int before = c0 > 0 ? src[c0 - 1] : -1;
  const int up = __shfl_up_sync(kFull, id, 1);
  const int prev = lane > 0 ? up : before;
  const bool member = id < n && id != before;  // its segment's head is in this warp
  const bool head = member && id != prev;
  const int last = __shfl_sync(kFull, id, 31);
  // the warp's last segment runs on past it (its head is in this warp)
  const bool spill = last < n && last != before && c0 + 32 < n_slots && src[c0 + 32] == last;
  bool same[5];  // lane + d holds the same id (the segment is contiguous)
  unsigned steps = 0;  // the shuffle steps some lane needs
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int o = __shfl_down_sync(kFull, id, 1 << k);
    same[k] = lane + (1 << k) < 32 && o == id;
    steps |= __any_sync(kFull, same[k] && member) ? 1u << k : 0u;
  }

  // the ids after the previous slot's and before a head's own have no slot
  for (unsigned gaps = __ballot_sync(kFull, head && id > prev + 1); gaps; gaps &= gaps - 1) {
    const int l = __ffs(gaps) - 1;
    const int g0 = __shfl_sync(kFull, prev, l) + 1, g1 = __shfl_sync(kFull, id, l);
    for (int r = 0; r < w; ++r) {
      for (int c = g0 + lane; c < g1; c += 32) out[(long long)r * n_cols + c] = 0.0f;
    }
  }

  for (int r0 = 0; r0 < w; r0 += kRows) {
    float v[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      v[j] = member && r0 + j < w ? rows[(long long)(r0 + j) * n_slots + s] : 0.0f;
    // segmented suffix sums: lane l ends with the sum over l .. the end of
    // its segment or of the warp
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (!(steps >> k & 1)) continue;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float y = __shfl_down_sync(kFull, v[j], 1 << k);
        if (same[k]) v[j] += y;
      }
    }
    if (spill) {  // the same in every lane
      float a[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) a[j] = 0.0f;
      for (long long c = c0 + 32;; c += 64) {
        const long long s1 = c + lane, s2 = c + 32 + lane;
        const bool m1 = s1 < n_slots && src[s1] == last;
        const bool m2 = s2 < n_slots && src[s2] == last;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (r0 + j >= w) continue;
          const float* row = rows + (long long)(r0 + j) * n_slots;
          const float x1 = s1 < n_slots ? row[s1] : 0.0f;
          const float x2 = s2 < n_slots ? row[s2] : 0.0f;
          a[j] += m1 ? x1 : 0.0f;
          a[j] += m2 ? x2 : 0.0f;
        }
        if (!__all_sync(kFull, m2)) break;  // the segment ended in these 64 slots
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) a[j] += __shfl_xor_sync(kFull, a[j], d);
      }
      if (head && id == last) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) v[j] += a[j];
      }
    }
    if (head) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < w) out[(long long)(r0 + j) * n_cols + id] = v[j];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mtgs_dense_segment_sum(const float* rows, int w, long long n_slots,
                                      const int* src, int n_cols, float* out,
                                      void* stream) {
  if (n_cols <= 0 || w <= 0) return 0;
  const long long slot_blocks = (n_slots + kThreads - 1) / kThreads;
  const long long fill_blocks = (n_cols + kFillCols - 1) / kFillCols;
  segment_sum_kernel<<<(unsigned)(slot_blocks + fill_blocks), kThreads, 0,
                       (cudaStream_t)stream>>>(rows, w, n_slots, src, n_cols,
                                               (int)slot_blocks, out);
  return (int)cudaGetLastError();
}
