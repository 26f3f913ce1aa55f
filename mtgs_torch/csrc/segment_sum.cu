// Per-gaussian sums of slot-ordered gradient rows.
//
// Replaces the TPU kernel mtgs_tpu/raster/segment_sum.py::dense_segment_sum
// (_kernel). Input rows [w, I] in slot order, keyed by src [I], a
// non-decreasing owner id per slot with the sentinel n on dead slots;
// output out [w, n + 1], column g the sum of the rows of the slots whose
// src is g (column n: the sentinel slots, which hold zero rows).
//
// The TPU kernel reduces through one-hot MXU matmuls over 1024-wide id
// windows because the TPU has neither atomics nor fast gathers. Here the
// slots of one id are contiguous, so one thread per output column finds
// its segment [lower_bound(g), lower_bound(g + 1)) by binary search over
// src and adds its rows in slot order: exact f32 sums in a fixed order,
// no atomics, the same result on every run. The sentinel column is
// written as zeros without reading its slots: dead slots hold zero rows,
// and their run (the unused tail of the intersection buffer, 17-38% of
// it at the main path's shapes) would otherwise fall to one thread.
// Every column is written, so the output needs no zero-fill.
//
// What bounds it on an H100: bytes. Each slot's w rows are read once and
// each of the (n + 1) w outputs written once; the binary searches read
// src at ~2 log2(I) places per column, mostly from L2. Neighbouring
// threads own neighbouring segments, so the row reads of a warp fall on
// neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long lower_bound(const int* __restrict__ src,
                                                 long long n_slots, int key) {
  long long lo = 0, hi = n_slots;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (src[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ rows, int w, long long n_slots,
                   const int* __restrict__ src, int n_cols, float* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_cols) return;
  long long lo = 0, hi = 0;  // the sentinel column n_cols - 1: zeros
  if (g < n_cols - 1) {
    lo = lower_bound(src, n_slots, g);
    hi = lower_bound(src, n_slots, g + 1);
  }
  for (int r = 0; r < w; ++r) {
    const float* row = rows + (long long)r * n_slots;
    float acc = 0.0f;
    for (long long s = lo; s < hi; ++s) acc += row[s];
    out[(long long)r * n_cols + g] = acc;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mtgs_dense_segment_sum(const float* rows, int w, long long n_slots,
                                      const int* src, int n_cols, float* out,
                                      void* stream) {
  if (n_cols <= 0 || w <= 0) return 0;
  const int blocks = (n_cols + kThreads - 1) / kThreads;
  segment_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, w, n_slots, src, n_cols, out);
  return (int)cudaGetLastError();
}
