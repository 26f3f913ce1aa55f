// Classic pair expansion: depth-sorted pair offsets and span words ->
// per-slot (tile, owner).
//
// Replaces the TPU kernel mtgs_tpu/raster/expand_pallas.py::expand_pairs
// (_kernel). Its plain version is binning.searchsorted_expand, and this
// kernel is bit-equal to it on every slot, dead ones included, on any
// non-decreasing offsets.
//
// What bounds it on an H100: device-memory bytes, 8 a slot written (the
// offsets and span words it reads are ~1/4 of that and stay in L2). The
// TPU kernel found owners by telescoping delta-encoded values through a
// one-hot MXU matmul over a 640-wide offset window, because a TPU has no
// fast gather. Here the owners come from expand_math.cuh: a warp takes a
// 256-slot tile (a block of 256 threads 2,048 slots), 4 consecutive slots
// a lane in each of two passes, and
//   * a tile past offsets[n - 1] (most of a capacity sized for growth:
//     64% of a 1920x1080 frame's slots) is owned by gaussian n - 1 and
//     written with no search; blocks are dealt from both ends of the
//     slots (block_slice), so these stores overlap the searches;
//   * any other tile makes one warp-cooperative search of device memory
//     and stages its owners' offsets and span words in shared memory,
//     where each lane finds its own;
//   * each lane decodes its slots' tiles (tile = num_tiles for
//     s >= total) and writes both outputs as one 16-byte store each, a
//     warp 512 contiguous bytes; a tail of I % 4 slots is stored one by
//     one. No warp waits for another.

#include <cuda_runtime.h>

#include "expand_math.cuh"

namespace {

using namespace mtgs_expand;

constexpr int kThreads = 256;  // 8 warps a block, a 256-slot tile each
constexpr int kWarps = kThreads / 32;
constexpr int kBlockSlots = kWarps * kTileSlots;  // 2,048

__global__ void __launch_bounds__(kThreads)
expand_pairs_kernel(const int* __restrict__ offsets, const int* __restrict__ packed,
                    int n, const int* __restrict__ total_p, int num_slots,
                    int tiles_x, int num_tiles, int* __restrict__ tile,
                    int* __restrict__ src) {
  __shared__ OwnerWindow win[kWarps];
  OwnerWindow& w = win[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  const long long t0 = ((long long)block_slice() * kWarps + threadIdx.x / 32) * kTileSlots;
  if (t0 >= num_slots) return;  // warp-uniform
  const int total = *total_p;
  const Owner last{n - 1, __ldg(offsets + n - 1), __ldg(packed + n - 1)};
  const bool search = t0 < last.off;  // warp-uniform; past it every owner is n - 1
  int j_lo = n - 1;
  if (search) {
    j_lo = max(warp_upper_bound(offsets, 0, n, (int)t0) - 1, 0);
    stage_window(w, offsets, packed, n, j_lo);
  }
#pragma unroll 1
  for (int p = 0; p < kPasses; ++p) {
    const long long s64 = t0 + p * kPassSlots + lane * kSlots;
    const int cnt = (int)min((long long)kSlots, num_slots - s64);  // <= 0 past the end
    if (cnt <= 0) break;
    const int s = (int)s64;
    Owner o[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) o[k] = last;
    if (search) find_owners(w, j_lo, offsets, packed, n, last, s, cnt, o);
    int t[kSlots], j[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int sk = s + k;
      t[k] = sk < total ? slot_tile(o[k].pk, sk - o[k].off, tiles_x) : num_tiles;
      j[k] = o[k].j;
    }
    if (cnt == kSlots) {
      *reinterpret_cast<int4*>(tile + s) = make_int4(t[0], t[1], t[2], t[3]);
      *reinterpret_cast<int4*>(src + s) = make_int4(j[0], j[1], j[2], j[3]);
    } else {
      for (int k = 0; k < cnt; ++k) {
        tile[s + k] = t[k];
        src[s + k] = j[k];
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mtgs_expand_pairs(const int* offsets, const int* packed, int n,
                                 const int* total, int num_slots, int tiles_x,
                                 int num_tiles, int* tile, int* src, void* stream) {
  if (num_slots == 0) return 0;
  const int blocks = (int)(((long long)num_slots + kBlockSlots - 1) / kBlockSlots);
  expand_pairs_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      offsets, packed, n, total, num_slots, tiles_x, num_tiles, tile, src);
  return (int)cudaGetLastError();
}
