// Owner search and span decode shared by csrc/expand_fused.cu and
// csrc/expand_pairs.cu.
//
// Both kernels map each depth-order pair slot s to its owner
// j = upper_bound(offsets, s) - 1, clamped to [0, n - 1] (offsets is the
// non-decreasing exclusive prefix of the gaussians' pair counts), and
// decode the slot's tile from the owner's span word
// tmin_x | tmin_y << 11 | span_x << 22. Both cut the slots into tiles of
// kTileSlots consecutive slots, a warp a tile, in kPasses passes of
// kSlots consecutive slots a lane, and deal blocks from both ends of the
// slots (block_slice).
//
// A tile that starts at or past offsets[n - 1] is owned by gaussian n - 1
// throughout and needs no search. For any other tile the warp finds the
// owner of the tile's first slot, j_lo, by a warp-cooperative search over
// device memory, copies offsets[j_lo .. j_lo + kWin] and the span words
// beside them into its shared-memory window, and each lane finds its
// first slot's owner by a binary search there and walks forward over its
// other slots. On the rasterizer's inputs every live gaussian owns at
// least one pair (zero-pair gaussians sort last), so a tile's owners span
// at most kTileSlots gaussians and always fit the window. Slots past the
// window (a run of zero-pair gaussians inside the live range, on other
// inputs) take gaussian n - 1 when past offsets[n - 1], and otherwise a
// binary search of device memory bounded below by the window's end:
// slower, and exact.

#pragma once

#include <climits>

namespace mtgs_expand {

constexpr int kSlots = 4;                          // consecutive slots of a lane in a pass
constexpr int kPassSlots = 32 * kSlots;            // a warp's slots in one pass
constexpr int kPasses = 2;
constexpr int kTileSlots = kPassSlots * kPasses;   // 256: a warp's tile
constexpr int kWin = kTileSlots;                   // the owners a window holds
constexpr unsigned kFull = 0xffffffffu;

// First index in [lo, hi) whose a[index] > v, or hi; a non-decreasing.
__device__ __forceinline__ int upper_bound(const int* __restrict__ a, int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// upper_bound(a, lo, hi, v) by the 32 lanes of a warp together: each round
// probes 32 pivots that cut [lo, hi) into 33 parts (4 rounds and a last
// one over 10^6 entries). Every lane calls it with the same arguments and
// gets the answer.
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ a, int lo, int hi,
                                                int v) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    // strictly increasing pivots inside [lo, hi), since hi - lo >= 33
    const int p = lo + (int)((long long)(hi - lo) * (lane + 1) / 33);
    const unsigned le = __ballot_sync(kFull, __ldg(a + p) <= v);  // a prefix of the lanes
    const int c = __popc(le);
    const int p_below = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    const int p_above = __shfl_sync(kFull, p, c < 32 ? c : 31);
    if (c > 0) lo = p_below + 1;
    if (c < 32) hi = p_above;
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(kFull, p < hi && __ldg(a + p) <= v));
}

// The block's place in the slots: blocks 0, 1, 2, 3, ... take the first,
// the last, the second, the second-last, ... gridDim.x slices, so that the
// blocks resident at any time mix the slots before offsets[n - 1], which
// search, with the dead ones past it, which only store (most of a capacity
// sized for growth), and the stores overlap the searches.
__device__ __forceinline__ int block_slice() {
  const int b = blockIdx.x >> 1;
  return (blockIdx.x & 1) ? gridDim.x - 1 - b : b;
}

// The tile of the slot `local` pairs past its owner's first, from the
// owner's span word. The floor division and the wrapping int32 sums are
// those of the plain versions (torch.div(..., rounding_mode="floor")), so
// the result is theirs on any input, a slot before offsets[0] included.
__device__ __forceinline__ int slot_tile(int pk, int local, int tiles_x) {
  const int span_x = max(pk >> 22, 1);
  int ly = local / span_x;
  if (ly * span_x > local) --ly;
  const int lx = local - ly * span_x;
  const unsigned row = (unsigned)((pk >> 11) & 0x7FF) + (unsigned)ly;
  return (int)(row * (unsigned)tiles_x + (unsigned)(pk & 0x7FF) + (unsigned)lx);
}

// A slot's owner, its first slot and its span word.
struct Owner {
  int j, off, pk;
};

// A warp's owners: offsets[j_lo + k] (INT_MAX past n - 1) and the span
// words beside them; j_lo stays in the warp's registers.
struct OwnerWindow {
  int off[kWin + 1];
  int pk[kWin];
};

// dst[0] = src[0], device memory to shared memory, asynchronously
// (cp.async: no register holds the value); stage_window waits for them.
__device__ __forceinline__ void copy_async(int* dst, const int* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}

// Fills the warp's window `w` from owner j_lo. Every lane of the warp
// calls it; the warp reads `w` when it returns.
__device__ __forceinline__ void stage_window(OwnerWindow& w, const int* __restrict__ offsets,
                                             const int* __restrict__ packed, int n, int j_lo) {
  for (int k = threadIdx.x & 31; k <= kWin; k += 32) {
    if (k < n - j_lo) {
      copy_async(w.off + k, offsets + j_lo + k);
      if (k < kWin) copy_async(w.pk + k, packed + j_lo + k);
    } else {
      w.off[k] = INT_MAX;
      if (k < kWin) w.pk[k] = 0;
    }
  }
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  __syncwarp();
}

// The owners of the `cnt` (<= kSlots) consecutive slots from s, whose
// warp staged `w` from owner j_lo; `last` is gaussian n - 1's owner entry.
__device__ __forceinline__ void find_owners(const OwnerWindow& w, int j_lo,
                                            const int* __restrict__ offsets,
                                            const int* __restrict__ packed, int n,
                                            const Owner& last, int s, int cnt,
                                            Owner (&o)[kSlots]) {
  int r = -1;  // the window index of the previous slot's owner
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (k >= cnt) break;
    const int sk = s + k;
    if (sk < w.off[kWin]) {
      if (r < 0 || sk >= w.off[r + 1]) r = max(upper_bound(w.off, r + 1, kWin, sk) - 1, 0);
      o[k] = Owner{j_lo + r, w.off[r], w.pk[r]};
    } else if (sk >= last.off) {
      o[k] = last;
    } else {  // a zero-pair run longer than the window: search past it
      const int j = upper_bound(offsets, j_lo + kWin, n, sk) - 1;
      o[k] = Owner{j, __ldg(offsets + j), __ldg(packed + j)};
    }
  }
}

}  // namespace mtgs_expand
