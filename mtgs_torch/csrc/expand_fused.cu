// Fused pair expansion: depth-sorted gaussian table -> per-slot
// (sort key, owner, attribute columns).
//
// Replaces the TPU kernel mtgs_tpu/raster/expand_fused.py::expand_fused
// (_kernel / _kernel_db / _compute).
//
// What bounds it on an H100: device-memory bytes. Per slot it writes two
// int32 words and round8(nw) f32 attribute rows, and it reads the owner's
// nw table entries (consecutive slots share owners, so those reads hit in
// L1/L2). The TPU kernel found owners with one-hot MXU matmuls over a
// 384-wide table window because a TPU has no fast gather; here each
// thread owns one slot and
//   * finds its owner j = upper_bound(offsets, s) - 1 by binary search
//     over the depth-sorted pair offsets (L2-resident),
//   * decodes the owner's packed span word into its tile,
//   * writes key = tile << sb | s (tile = num_tiles on dead slots), src = j
//     and attrs[r][s] = table[r][j]: integer math and exact copies, every
//     store coalesced along s.
// Dead slots (s >= total) reproduce the TPU kernel's values exactly: the
// last gaussian n-1 is their owner when it lies inside the 384-column
// table window anchored at the block's first owner (binning.window_anchors);
// otherwise the one-hot row was empty there, giving src 0 and zero attrs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSlots = 256;  // the TPU kernel's B
constexpr int kAlign = 128;       // ALIGN
constexpr int kWindow = 384;      // WINA

__device__ __forceinline__ int upper_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand_fused_kernel(const float* __restrict__ table, int nw, int n,
                    const int* __restrict__ offsets, const int* __restrict__ packed,
                    const int* __restrict__ total_p, int num_slots, int sb,
                    int tiles_x, int num_tiles, int w_out,
                    int* __restrict__ key, int* __restrict__ src,
                    float* __restrict__ attrs) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= num_slots) return;
  const int total = *total_p;
  const int j = min(max(upper_bound(offsets, n, s) - 1, 0), n - 1);
  int tile;
  bool owned = true;
  if (s < total) {
    const int pk = packed[j];
    const int local = s - offsets[j];
    const int span_x = max(pk >> 22, 1);
    const int ly = local / span_x;
    const int lx = local - ly * span_x;
    tile = (((pk >> 11) & 0x7FF) + ly) * tiles_x + (pk & 0x7FF) + lx;
  } else {
    tile = num_tiles;
    const int b = (s / kBlockSlots) * kBlockSlots;
    const int g = min(max(upper_bound(offsets, n, b) - 1, 0), n - 1);
    owned = (n - 1) < (g / kAlign) * kAlign + kWindow;
  }
  key[s] = (tile << sb) | s;
  src[s] = owned ? j : 0;
  for (int r = 0; r < w_out; ++r) {
    attrs[(long long)r * num_slots + s] =
        (owned && r < nw) ? table[(long long)r * n + j] : 0.0f;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mtgs_expand_fused(const float* table, int nw, int n,
                                 const int* offsets, const int* packed,
                                 const int* total, int num_slots, int sb,
                                 int tiles_x, int num_tiles, int w_out,
                                 int* key, int* src, float* attrs, void* stream) {
  if (num_slots == 0) return 0;
  const int blocks = (num_slots + kThreads - 1) / kThreads;
  expand_fused_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, nw, n, offsets, packed, total, num_slots, sb, tiles_x, num_tiles,
      w_out, key, src, attrs);
  return (int)cudaGetLastError();
}
