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
// contiguous run of kRows * w floats, moved with consecutive threads on
// consecutive addresses, and each of the w_out rows of the other side is
// a contiguous run of kRows floats, also moved coalesced. The staging
// tile's row stride is odd (w | 1), so a warp walking down one attribute
// column touches 32 different banks. The last block takes the tail of a
// cap that is not a multiple of kRows. Indices are 64-bit: cap * w_out
// passes 2^31 once the capacity grows past 134M floats.
//
// The TPU kernel's blocks had to be 512 slots and 8-row aligned (Mosaic's
// DMA tiling); here any cap and any w <= kMaxW is taken, and the result
// is a bit-exact copy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // slots per block
constexpr int kMaxW = 32;

// rows [cap, w] -> attrs [w_out, cap]
__global__ void __launch_bounds__(kThreads)
rows_to_attr_major_kernel(const float* __restrict__ rows, long long cap, int w,
                          int w_out, float* __restrict__ attrs) {
  extern __shared__ float tile_s[];  // [kRows][w | 1]
  const int ws = w | 1;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nr = (int)min((long long)kRows, cap - r0);
  const float* src = rows + r0 * w;
  for (int i = threadIdx.x; i < nr * w; i += kThreads) {
    const int r = i / w;
    tile_s[r * ws + (i - r * w)] = src[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < w_out * kRows; i += kThreads) {
    const int c = i / kRows;
    const int r = i - c * kRows;
    if (r < nr) attrs[(long long)c * cap + r0 + r] = c < w ? tile_s[r * ws + c] : 0.0f;
  }
}

// attrs [w, cap] -> rows [cap, w]
__global__ void __launch_bounds__(kThreads)
attr_major_to_rows_kernel(const float* __restrict__ attrs, long long cap, int w,
                          float* __restrict__ rows) {
  extern __shared__ float tile_s[];  // [kRows][w | 1]
  const int ws = w | 1;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nr = (int)min((long long)kRows, cap - r0);
  for (int i = threadIdx.x; i < w * kRows; i += kThreads) {
    const int c = i / kRows;
    const int r = i - c * kRows;
    if (r < nr) tile_s[r * ws + c] = attrs[(long long)c * cap + r0 + r];
  }
  __syncthreads();
  float* dst = rows + r0 * w;
  for (int i = threadIdx.x; i < nr * w; i += kThreads) {
    const int r = i / w;
    dst[i] = tile_s[r * ws + (i - r * w)];
  }
}

size_t smem_bytes(int w) { return sizeof(float) * kRows * (size_t)(w | 1); }

int blocks_for(long long cap) { return (int)((cap + kRows - 1) / kRows); }

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success); 1 for
// a width the kernel does not take.
extern "C" int mtgs_rows_to_attr_major(const float* rows, long long cap, int w, int w_out,
                                       float* attrs, void* stream) {
  if (w < 1 || w > kMaxW || w_out < w) return 1;
  if (cap == 0) return 0;
  rows_to_attr_major_kernel<<<blocks_for(cap), kThreads, smem_bytes(w),
                              (cudaStream_t)stream>>>(rows, cap, w, w_out, attrs);
  return (int)cudaGetLastError();
}

extern "C" int mtgs_attr_major_to_rows(const float* attrs, long long cap, int w,
                                       float* rows, void* stream) {
  if (w < 1 || w > kMaxW) return 1;
  if (cap == 0) return 0;
  attr_major_to_rows_kernel<<<blocks_for(cap), kThreads, smem_bytes(w),
                              (cudaStream_t)stream>>>(attrs, cap, w, rows);
  return (int)cudaGetLastError();
}
