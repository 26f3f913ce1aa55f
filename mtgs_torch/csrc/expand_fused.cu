// Fused pair expansion: depth-sorted gaussian table -> per-slot
// (sort key, owner, attribute columns).
//
// Replaces the TPU kernel mtgs_tpu/raster/expand_fused.py::expand_fused
// (_kernel / _kernel_db / _compute).
//
// What bounds it on an H100: device-memory bytes. Per slot it writes two
// int32 words and round8(nw) f32 attribute rows (72 bytes at nw 13), and
// it reads the owner's nw table entries. The TPU kernel found owners with
// one-hot MXU matmuls over a 384-wide table window because a TPU has no
// fast gather. Here the owners come from expand_math.cuh, a warp a
// 256-slot tile, 8 warps a block:
//   * a tile past offsets[n - 1] is owned by gaussian n - 1 and needs no
//     search; any other finds its first owner by one warp-cooperative
//     search and the rest in its shared-memory window; blocks are dealt
//     from both ends of the slots (block_slice);
//   * each lane writes key = tile << sb | s (tile = num_tiles on dead
//     slots) and src = j for its 4 + 4 slots as 16-byte stores, and keeps
//     the 8 owners in registers;
//   * then, after one barrier, the block's warps write the attribute rows
//     together, rows outer: attrs[r][s] = table[r][j], a row's 8 gathers
//     issued at once through L1 (consecutive slots share owners) and
//     written as two 16-byte stores. Integer math and exact copies.
// The gathers are most of what holds it above its bound: with every gather
// sent to one column it runs a fifth faster (chip_expand_variants.py,
// PERF.md). Staging the block's owners' columns in shared memory (16-byte
// cp.async) was slower on a serving view's inputs, where the owners'
// columns of a third of the blocks exceed 48 KiB.
//
// Dead slots (s >= total) reproduce the TPU kernel's values exactly: the
// last gaussian n-1 is their owner when it lies inside the 384-column
// table window anchored at the 128-aligned owner g of the slot's 256-slot
// group (binning.window_anchors); otherwise the one-hot row was empty
// there, giving src 0 and zero attrs. A group is a warp's tile, so g is
// the owner of the tile's first slot, lane 0's; past offsets[n - 1] it is
// n - 1, which the window always holds.

#include <cuda_runtime.h>

#include "expand_math.cuh"

namespace {

using namespace mtgs_expand;

constexpr int kThreads = 256;  // 8 warps a block, a 256-slot tile each
constexpr int kWarps = kThreads / 32;
constexpr int kAlign = 128;    // ALIGN
constexpr int kWindow = 384;   // WINA
static_assert(kTileSlots == 256, "a warp's tile is one of the TPU kernel's 256-slot groups");

__global__ void __launch_bounds__(kThreads)
expand_fused_kernel(const float* __restrict__ table, int nw, int n,
                    const int* __restrict__ offsets, const int* __restrict__ packed,
                    const int* __restrict__ total_p, int num_slots, int sb,
                    int tiles_x, int num_tiles, int w_out,
                    int* __restrict__ key, int* __restrict__ src,
                    float* __restrict__ attrs) {
  __shared__ OwnerWindow win[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int total = *total_p;
  const Owner last{n - 1, __ldg(offsets + n - 1), __ldg(packed + n - 1)};
  const int t0 = (block_slice() * kWarps + warp) * kTileSlots;
  const bool in = t0 < num_slots;          // warp-uniform
  const bool search = in && t0 < last.off;  // past offsets[n - 1] every owner is n - 1
  int j_lo = n - 1;
  if (search) {
    j_lo = max(warp_upper_bound(offsets, 0, n, t0) - 1, 0);
    stage_window(win[warp], offsets, packed, n, j_lo);
  }

  // key and src; each slot's owner whose columns it copies (-1: zeros)
  int jv[kPasses][kSlots];
  bool dead_owned = true;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int s = t0 + p * kPassSlots + lane * kSlots;
    Owner o[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) o[k] = last;
    if (search) find_owners(win[warp], j_lo, offsets, packed, n, last, s, kSlots, o);
    if (p == 0) {
      // the tile is one 256-slot group: g is the owner of its first slot
      const int g = __shfl_sync(kFull, o[0].j, 0);
      dead_owned = (n - 1) < (g / kAlign) * kAlign + kWindow;
    }
    int kv[kSlots], sv[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int sk = s + k;
      const bool live = sk < total;
      const int t = live ? slot_tile(o[k].pk, sk - o[k].off, tiles_x) : num_tiles;
      kv[k] = (int)(((unsigned)t << sb) | (unsigned)sk);
      const bool own = live || dead_owned;
      jv[p][k] = own ? o[k].j : -1;
      sv[k] = own ? o[k].j : 0;
    }
    if (in) {
      *reinterpret_cast<int4*>(key + s) = make_int4(kv[0], kv[1], kv[2], kv[3]);
      *reinterpret_cast<int4*>(src + s) = make_int4(sv[0], sv[1], sv[2], sv[3]);
    }
  }

  // the attribute rows, rows outer, the block's warps in step. A row's 8
  // gathers are predicated loads with no branch between them, so they go
  // out together (a conditional expression here compiles to branches that
  // issue them two at a time, and runs slower: chip_expand_variants.py)
  __syncthreads();
  if (!in) return;
  for (int r = 0; r < w_out; ++r) {
    const float* row_in = table + (size_t)r * n;
    float* row = attrs + (size_t)r * num_slots;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      float v[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        v[k] = 0.0f;
        if (r < nw && jv[p][k] >= 0) v[k] = __ldg(row_in + jv[p][k]);
      }
      *reinterpret_cast<float4*>(row + t0 + p * kPassSlots + lane * kSlots) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue if num_slots is no multiple of 256 (the fused
// path's capacities always are).
extern "C" int mtgs_expand_fused(const float* table, int nw, int n,
                                 const int* offsets, const int* packed,
                                 const int* total, int num_slots, int sb,
                                 int tiles_x, int num_tiles, int w_out,
                                 int* key, int* src, float* attrs, void* stream) {
  if (num_slots % kTileSlots != 0) return (int)cudaErrorInvalidValue;
  if (num_slots == 0) return 0;
  const int tiles = num_slots / kTileSlots;
  expand_fused_kernel<<<(tiles + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
      table, nw, n, offsets, packed, total, num_slots, sb, tiles_x, num_tiles,
      w_out, key, src, attrs);
  return (int)cudaGetLastError();
}
