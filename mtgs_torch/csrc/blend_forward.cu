// Forward alpha blend of each tile's depth-ordered intersections.
//
// Replaces the TPU kernel mtgs_tpu/raster/blend_pallas.py::blend_forward_pallas
// (_fwd_kernel / _fwd_kernel_db; math in chunk_math.forward_chunk).
//
// What bounds it on an H100: every (pixel, intersection) pair the
// front-to-back loop reaches costs ~14 f32 operations and an exp, a
// composited one a log1p, another exp and 2 * c_total more; the slab is
// read once (13 rows x 4 B per intersection at the main path's c_total =
// 7). With early exit the two bounds come out about equal at the main
// path's shapes (PERF.md: ~0.03 ms each on an H100 SXM at 700 W), and the
// kernel runs at ~20x that: it is latency-bound, one block per tile.
// The design keeps everything but that work out of device memory:
//   * one thread block per tile, 256 threads; at tile 32 each thread owns
//     4 pixels, at tile 16 one, so a staged gaussian is reused 4x from
//     registers/shared memory;
//   * batches of 128 intersections are staged into shared memory with
//     consecutive threads reading consecutive slab columns (coalesced),
//     and the 6 conic coefficients Q of the tile-local expanded form are
//     computed once per intersection at staging time;
//   * per pixel: sigma = Q . [x², y², xy, x, y, 1] in the fixed order of
//     separately rounded products and sums that the plain version uses
//     (chunk_math.sigma), so the alpha >= 1/255 and sigma >= 0 cut-offs
//     fall on the same side as there;
//   * termination in log space like the JAX kernel: the running sum of
//     log1p(-alpha) (blend_math.cuh's log1p_neg and cut-offs, shared
//     with the backward) over contributing gaussians; a pixel stops before the
//     gaussian that would take it to <= log(1e-4); t_final is
//     exp(sum over composited gaussians);
//   * the block leaves its batch loop once __syncthreads_count sees no
//     live pixel (the warp `done` break of gsplat, per block).
// The kernel reads only [start, start + count) of each tile's run;
// tile_offsets + tile_heads give start (the TPU's 128-aligned window
// convention is kept at the Python boundary only).

#include <cuda_runtime.h>

#include "blend_math.cuh"

namespace {

using mtgs::kAlphaMax;
using mtgs::kAlphaMin;
using mtgs::kLogTEps;

constexpr int kThreads = 256;
constexpr int kBatch = 128;

template <int CT, int PPT>
__global__ void __launch_bounds__(kThreads)
blend_forward_kernel(const float* __restrict__ slab, long long cap,
                     const int* __restrict__ tile_offsets,
                     const int* __restrict__ tile_heads,
                     const int* __restrict__ tile_counts,
                     int tile_size, int tiles_x, int tile_base,
                     float* __restrict__ rgb_out, float* __restrict__ tfin_out) {
  __shared__ float q_s[6][kBatch];
  __shared__ float op_s[kBatch];
  __shared__ float col_s[CT][kBatch];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = tile_size * tile_size;
  const int gt = tile_base + t;
  const float ox = (float)((gt % tiles_x) * tile_size);
  const float oy = (float)((gt / tiles_x) * tile_size);
  const long long start = (long long)tile_offsets[t] + tile_heads[t];
  const int count = tile_counts[t];

  float fx[PPT], fy[PPT], fxx[PPT], fyy[PPT], fxy[PPT];
  float acc[PPT][CT];
  float log_all[PPT], log_out[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * kThreads;
    fx[k] = (float)(p % tile_size) + 0.5f;
    fy[k] = (float)(p / tile_size) + 0.5f;
    fxx[k] = fx[k] * fx[k];
    fyy[k] = fy[k] * fy[k];
    fxy[k] = fx[k] * fy[k];
    log_all[k] = 0.0f;
    log_out[k] = 0.0f;
    done[k] = false;
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[k][c] = 0.0f;
  }

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int nb = min(kBatch, count - b0);
    __syncthreads();  // the previous batch is consumed
    if (tid < nb) {
      const long long idx = start + b0 + tid;
      const float mxl = __fsub_rn(slab[idx], ox);
      const float myl = __fsub_rn(slab[cap + idx], oy);
      const float cA = slab[2 * cap + idx];
      const float cB = slab[3 * cap + idx];
      const float cC = slab[4 * cap + idx];
      q_s[0][tid] = __fmul_rn(0.5f, cA);
      q_s[1][tid] = __fmul_rn(0.5f, cC);
      q_s[2][tid] = cB;
      q_s[3][tid] = -__fadd_rn(__fmul_rn(cA, mxl), __fmul_rn(cB, myl));
      q_s[4][tid] = -__fadd_rn(__fmul_rn(cC, myl), __fmul_rn(cB, mxl));
      q_s[5][tid] = __fadd_rn(
          __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(cA, mxl), mxl),
                                    __fmul_rn(__fmul_rn(cC, myl), myl))),
          __fmul_rn(__fmul_rn(cB, mxl), myl));
      op_s[tid] = slab[5 * cap + idx];
#pragma unroll
      for (int c = 0; c < CT; ++c) col_s[c][tid] = slab[(6 + c) * cap + idx];
    }
    __syncthreads();

    for (int i = 0; i < nb; ++i) {
      const float q0 = q_s[0][i], q1 = q_s[1][i], q2 = q_s[2][i];
      const float q3 = q_s[3][i], q4 = q_s[4][i], q5 = q_s[5][i];
      const float op = op_s[i];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done[k]) continue;
        float s = __fmul_rn(fxx[k], q0);
        s = __fadd_rn(s, __fmul_rn(fyy[k], q1));
        s = __fadd_rn(s, __fmul_rn(fxy[k], q2));
        s = __fadd_rn(s, __fmul_rn(fx[k], q3));
        s = __fadd_rn(s, __fmul_rn(fy[k], q4));
        s = __fadd_rn(s, q5);
        const float raw = __fmul_rn(op, expf(-s));
        if (!(s >= 0.0f && raw >= kAlphaMin)) continue;
        const float alpha = fminf(raw, kAlphaMax);
        const float L = mtgs::log1p_neg(alpha);
        const float incl = __fadd_rn(log_all[k], L);
        if (incl > kLogTEps) {
          const float w = alpha * expf(log_all[k]);
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[k][c] += col_s[c][i] * w;
          log_out[k] = __fadd_rn(log_out[k], L);
          log_all[k] = incl;
        } else {
          done[k] = true;
        }
      }
    }
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= done[k] ? 0 : 1;
    if (__syncthreads_count(live) == 0) break;
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * kThreads;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      rgb_out[((long long)t * CT + c) * pix + p] = acc[k][c];
    tfin_out[(long long)t * pix + p] = expf(log_out[k]);
  }
}

template <int CT>
void launch_ct(const float* slab, long long cap, const int* offs, const int* heads,
               const int* counts, int num_tiles, int tile_size, int tiles_x,
               int tile_base, float* rgb, float* tfin, cudaStream_t stream) {
  if (tile_size == 32) {
    blend_forward_kernel<CT, 4><<<num_tiles, kThreads, 0, stream>>>(
        slab, cap, offs, heads, counts, tile_size, tiles_x, tile_base, rgb, tfin);
  } else {
    blend_forward_kernel<CT, 1><<<num_tiles, kThreads, 0, stream>>>(
        slab, cap, offs, heads, counts, tile_size, tiles_x, tile_base, rgb, tfin);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); 1 for a
// tile size or channel count the kernel does not take.
extern "C" int mtgs_blend_forward(const float* slab, long long cap,
                                  const int* tile_offsets, const int* tile_heads,
                                  const int* tile_counts, int num_tiles,
                                  int tile_size, int tiles_x, int tile_base,
                                  int c_total, float* rgb, float* tfin,
                                  void* stream) {
  if (tile_size != 16 && tile_size != 32) return 1;
  if (num_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define MTGS_CT_CASE(N)                                                        \
  case N:                                                                      \
    launch_ct<N>(slab, cap, tile_offsets, tile_heads, tile_counts, num_tiles,  \
                 tile_size, tiles_x, tile_base, rgb, tfin, s);                 \
    break;
  switch (c_total) {
    MTGS_CT_CASE(1) MTGS_CT_CASE(2) MTGS_CT_CASE(3) MTGS_CT_CASE(4)
    MTGS_CT_CASE(5) MTGS_CT_CASE(6) MTGS_CT_CASE(7) MTGS_CT_CASE(8)
    default:
      return 1;
  }
#undef MTGS_CT_CASE
  return (int)cudaGetLastError();
}
