// Classic pair expansion: depth-sorted pair offsets and span words ->
// per-slot (tile, owner).
//
// Replaces the TPU kernel mtgs_tpu/raster/expand_pallas.py::expand_pairs
// (_kernel). Its plain version is binning.searchsorted_expand, and this
// kernel is bit-equal to it on every slot, dead ones included.
//
// What bounds it on an H100: device-memory bytes. Each slot writes two
// int32 words; the offsets and span words are read by binary search,
// and consecutive slots share owners, so those reads hit in L1/L2. The
// TPU kernel found owners by telescoping delta-encoded values through a
// one-hot MXU matmul over a 640-wide offset window, because a TPU has no
// fast gather. Here each thread owns one slot and
//   * finds its owner j = upper_bound(offsets, s) - 1, clamped to
//     [0, n - 1] (past `total` that is always gaussian n - 1),
//   * decodes the owner's span word tmin_x | tmin_y << 11 | span_x << 22
//     into the slot's tile (tile = num_tiles for s >= total),
//   * writes tile[s] and src[s]: integer math, stores coalesced along s.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int upper_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand_pairs_kernel(const int* __restrict__ offsets, const int* __restrict__ packed,
                    int n, const int* __restrict__ total_p, int num_slots,
                    int tiles_x, int num_tiles, int* __restrict__ tile,
                    int* __restrict__ src) {
  const long long s64 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s64 >= num_slots) return;
  const int s = (int)s64;
  const int total = *total_p;
  const int j = min(max(upper_bound(offsets, n, s) - 1, 0), n - 1);
  int t = num_tiles;
  if (s < total) {
    const int pk = packed[j];
    const int local = s - offsets[j];
    const int span_x = max(pk >> 22, 1);
    const int ly = local / span_x;
    const int lx = local - ly * span_x;
    t = (((pk >> 11) & 0x7FF) + ly) * tiles_x + (pk & 0x7FF) + lx;
  }
  tile[s] = t;
  src[s] = j;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mtgs_expand_pairs(const int* offsets, const int* packed, int n,
                                 const int* total, int num_slots, int tiles_x,
                                 int num_tiles, int* tile, int* src, void* stream) {
  if (num_slots == 0) return 0;
  const int blocks = (int)(((long long)num_slots + kThreads - 1) / kThreads);
  expand_pairs_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      offsets, packed, n, total, num_slots, tiles_x, num_tiles, tile, src);
  return (int)cudaGetLastError();
}
