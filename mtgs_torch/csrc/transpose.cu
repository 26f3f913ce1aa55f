// Blocked transposes between slot rows [cap, w] and attribute-major
// columns [w_out, cap] (w_out >= w; pad rows w..w_out are zeros).
//
// Replaces the TPU kernels mtgs_tpu/raster/blend_pallas.py::rows_to_attr_major
// and ::attr_major_to_rows (_transpose_kernel). On the classic path the
// first turns the gathered per-slot attribute rows into the blend's slab,
// the second the per-gaussian gradient sums back into rows.
//
// What bounds it on an H100: device-memory bytes, each element read once
// and written once. A transpose read or written element by element along
// the strided side wastes most of every 32-byte sector, so a block stages
// kRows consecutive slots in shared memory: the [kRows, w] side is one
// contiguous run of kRows * w floats and each of the w rows of the other
// side a contiguous run of kRows floats, both moved coalesced. To reach
// the memory's rate an SM must keep ~18 KB of loads in flight (3.35 TB/s
// x ~0.7 us over 132 SMs). The width w is a template parameter (a switch
// over 1..32), so every load of a block is unrolled and issued before the
// first shared-memory store: a thread holds all its loads in flight, up
// to 8 blocks of 256 threads an SM.
//   * attr_major_to_rows moves 16 bytes a thread on both sides: each
//     attribute row's slots are read as the aligned float4 chunks that
//     cover them (one chunk more than kRows / 4, whatever the alignment of
//     cap; scalar loads at the tensor's ends), kept in shared memory in
//     the chunks' own order (float4 stores, no bank conflicts; the row
//     stride 260 makes the gather of a [slots, w] run at most 2-way), and
//     the contiguous [slots, w] run is written as float4 with a scalar
//     tail;
//   * rows_to_attr_major reads the run with one coalesced scalar load a
//     thread and element (a float4 a thread would put 4 of a warp's
//     stores on one bank), into a tile of odd row stride w | 1, and writes
//     each of the w_out rows with consecutive threads on consecutive
//     slots.
// The last block takes the tail of a cap that is not a multiple of kRows.
// Indices are 64-bit: cap * w_out passes 2^31 once the capacity grows
// past 134M floats.
//
// The TPU kernel's blocks had to be 512 slots and 8-row aligned (Mosaic's
// DMA tiling); here any cap and any w <= kMaxW is taken, and the result
// is a bit-exact copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // slots per block
constexpr int kMaxW = 32;

// rows [cap, W] -> attrs [w_out, cap]
template <int W>
__global__ void __launch_bounds__(kThreads)
rows_to_attr_major_kernel(const float* __restrict__ rows, long long cap, int w_out,
                          float* __restrict__ attrs) {
  constexpr int kWs = W | 1;
  constexpr int kPer = W * kRows / kThreads;  // elements a thread moves
  __shared__ float tile_s[kRows * kWs];
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nr = (int)min((long long)kRows, cap - r0);
  const float* src = rows + r0 * W;
  float buf[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    buf[k] = i < nr * W ? src[i] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int r = i / W;
    tile_s[r * kWs + (i - r * W)] = buf[k];
  }
  __syncthreads();
  for (int c = 0; c < w_out; ++c) {
    float* dst = attrs + c * cap + r0;
    for (int r = threadIdx.x; r < nr; r += kThreads) dst[r] = c < W ? tile_s[r * kWs + c] : 0.0f;
  }
}

constexpr int kChunks = kRows / 4 + 1;  // float4 chunks that cover kRows floats at any offset
constexpr int kRs = 4 * kChunks;        // 260: float4-aligned, 4 mod 32 banks

// attrs [W, cap] -> rows [cap, W]; rows is 16-byte aligned, attrs any
template <int W>
__global__ void __launch_bounds__(kThreads)
attr_major_to_rows_kernel(const float* __restrict__ attrs, long long cap,
                          float* __restrict__ rows) {
  constexpr int kIters = (W * kChunks + kThreads - 1) / kThreads;
  __shared__ __align__(16) float tile_s[W * kRs];
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nr = (int)min((long long)kRows, cap - r0);
  // flat indices from the 16-byte aligned address at or below attrs
  const int m0 = (int)(((uintptr_t)attrs >> 2) & 3);
  const float* abase = attrs - m0;
  const long long end = m0 + W * cap;
  const int cap4 = (int)(cap & 3);

  float4 buf[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int j = threadIdx.x + k * kThreads;
    const int c = j / kChunks;
    const long long first = m0 + c * cap + r0;     // slot r0 of attribute row c
    const long long g = (first & ~3LL) + 4 * (j - c * kChunks);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < W * kChunks && g < first + nr) {
      if (g >= m0 && g + 4 <= end) {
        v = *reinterpret_cast<const float4*>(abase + g);
      } else {  // a chunk across either end of the tensor
        if (g >= m0 && g < end) v.x = abase[g];
        if (g + 1 >= m0 && g + 1 < end) v.y = abase[g + 1];
        if (g + 2 >= m0 && g + 2 < end) v.z = abase[g + 2];
        if (g + 3 >= m0 && g + 3 < end) v.w = abase[g + 3];
      }
    }
    buf[k] = v;
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < W * kChunks)
      *reinterpret_cast<float4*>(&tile_s[4 * j]) = buf[k];  // row c at c * kRs, chunk order
  }
  __syncthreads();
  // slot r of attribute row c sits at tile_s[c * kRs + (that row's offset) + r]
  float* dst = rows + r0 * W;
  const int n = nr * W;
  for (int j = threadIdx.x; 4 * j < n; j += kThreads) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = min(4 * j + e, n - 1);
      const int r = i / W, c = i - r * W;
      o[e] = tile_s[c * kRs + ((m0 + c * cap4) & 3) + r];
    }
    if (4 * j + 4 <= n) {
      *reinterpret_cast<float4*>(dst + 4 * j) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * j + e < n) dst[4 * j + e] = o[e];
    }
  }
}

int blocks_for(long long cap) { return (int)((cap + kRows - 1) / kRows); }

#define MTGS_W_CASES(X)                                                             \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) \
  X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) X(26) X(27) X(28)    \
  X(29) X(30) X(31) X(32)

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success); 1 for
// a width the kernel does not take or an output that is not 16-byte
// aligned.
extern "C" int mtgs_rows_to_attr_major(const float* rows, long long cap, int w, int w_out,
                                       float* attrs, void* stream) {
  if (w < 1 || w > kMaxW || w_out < w) return 1;
  if (cap == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
#define MTGS_R2A(N)                                                                \
  case N:                                                                          \
    rows_to_attr_major_kernel<N><<<blocks_for(cap), kThreads, 0, s>>>(rows, cap,   \
                                                                      w_out, attrs); \
    break;
    MTGS_W_CASES(MTGS_R2A)
#undef MTGS_R2A
  }
  return (int)cudaGetLastError();
}

extern "C" int mtgs_attr_major_to_rows(const float* attrs, long long cap, int w,
                                       float* rows, void* stream) {
  if (w < 1 || w > kMaxW || ((uintptr_t)rows & 15)) return 1;
  if (cap == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
#define MTGS_A2R(N)                                                                     \
  case N:                                                                               \
    attr_major_to_rows_kernel<N><<<blocks_for(cap), kThreads, 0, s>>>(attrs, cap, rows); \
    break;
    MTGS_W_CASES(MTGS_A2R)
#undef MTGS_A2R
  }
  return (int)cudaGetLastError();
}
