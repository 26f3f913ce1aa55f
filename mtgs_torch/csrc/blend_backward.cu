// Backward of the per-tile alpha blend: per-intersection gradients.
//
// Replaces the TPU kernel mtgs_tpu/raster/blend_pallas.py::blend_backward_pallas
// (_bwd_kernel / _bwd_kernel_db; math in chunk_math.backward_chunk).
//
// Each tile is replayed front to back with no stored per-intersection
// state: the suffix colour term that drives d(loss)/d(alpha) is
// total_dot - (running sum of w * gdot), total_dot = sum_c g_rgb * rgb
// being recovered from the forward's output, and the transmittance is
// the forward's running log sum. For each composited (pixel,
// intersection) pair:
//   ga      = T gdot - suffix / (1 - alpha) - g_t T_final / (1 - alpha)
//   g_sigma = -alpha ga            (0 where alpha was clamped at 0.999)
//   g_opac += exp(-sigma) ga       (same clamp factor)
//   g_col  += g_rgb w
// and each intersection's sums over the tile's pixels give its gradients
// g_mx, g_my, g_cA, g_cB, g_cC, g_opac, g_colours (the slab's row order).
//
// What bounds it on an H100: like the forward, the (pixel, intersection)
// pairs the early-exit loop reaches (~14 f32 operations and an exp each)
// and, per composited pair, ~30 more for the gradient terms plus 13
// warp-shuffle reductions per intersection; the slab, the forward's
// outputs and the cotangents are read once and the gradient slab written
// once. Design:
//   * one thread block per tile, 256 threads; at tile 32 each thread owns
//     4 pixels, at tile 16 one;
//   * batches of 64 intersections are staged into shared memory with
//     their conic coefficients Q, computed in the forward kernel's order;
//   * sigma, alpha and the log-space termination are evaluated with the
//     same __fmul_rn/__fadd_rn sequence and the same expf/log1pf calls as
//     csrc/blend_forward.cu, so the 1/255, sigma >= 0 and T = 1e-4
//     decisions fall exactly as they did in the forward on the same card;
//   * the five geometry sums are taken in the centred form
//     sum g_sigma (x - mx)^2, (y - my)^2, (x - mx)(y - my), (x - mx),
//     (y - my) (the plain version's raw moments give the same values but
//     lose digits to cancellation when a mean lies far from the tile);
//   * every intersection belongs to one tile, so there is no
//     read-modify-write of shared windows as on the TPU: a warp reduces
//     its pixels with shuffles (skipped when no lane composited), each
//     warp leaves its partial in shared memory, and one thread per
//     intersection adds the 8 partials in a fixed order and writes the
//     slot once: the result does not depend on scheduling;
//   * the block stops once __syncthreads_count sees no live pixel; the
//     slots it never reaches keep the zeros the wrapper allocated.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kLogTEps = -9.210340371976182f;  // log(1e-4)

template <int CT, int PPT>
__global__ void __launch_bounds__(kThreads)
blend_backward_kernel(const float* __restrict__ slab, long long cap,
                      const int* __restrict__ tile_offsets,
                      const int* __restrict__ tile_heads,
                      const int* __restrict__ tile_counts,
                      int tile_size, int tiles_x,
                      const float* __restrict__ rgb, const float* __restrict__ tfin,
                      const float* __restrict__ grgb, const float* __restrict__ gt,
                      float* __restrict__ gout) {
  constexpr int NR = 6 + CT;  // sums per intersection: 5 geometry, opacity, colours
  __shared__ float q_s[6][kBatch];
  __shared__ float mloc_s[2][kBatch];
  __shared__ float op_s[kBatch];
  __shared__ float col_s[CT][kBatch];
  __shared__ float part_s[kWarps][NR][kBatch];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pix = tile_size * tile_size;
  const float ox = (float)((t % tiles_x) * tile_size);
  const float oy = (float)((t / tiles_x) * tile_size);
  const long long start = (long long)tile_offsets[t] + tile_heads[t];
  const int count = tile_counts[t];

  float fx[PPT], fy[PPT], fxx[PPT], fyy[PPT], fxy[PPT];
  float g_c[PPT][CT];
  float log_all[PPT], wg_cum[PPT], tdot[PPT], gtf[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * kThreads;
    fx[k] = (float)(p % tile_size) + 0.5f;
    fy[k] = (float)(p / tile_size) + 0.5f;
    fxx[k] = fx[k] * fx[k];
    fyy[k] = fy[k] * fy[k];
    fxy[k] = fx[k] * fy[k];
    float d = 0.0f;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const long long o = ((long long)t * CT + c) * pix + p;
      g_c[k][c] = grgb[o];
      d += g_c[k][c] * rgb[o];
    }
    tdot[k] = d;
    gtf[k] = gt[(long long)t * pix + p] * tfin[(long long)t * pix + p];
    log_all[k] = 0.0f;
    wg_cum[k] = 0.0f;
    done[k] = false;
  }

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int nb = min(kBatch, count - b0);
    __syncthreads();  // the previous batch is consumed and written
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
      mloc_s[0][tid] = mxl;
      mloc_s[1][tid] = myl;
      op_s[tid] = slab[5 * cap + idx];
#pragma unroll
      for (int c = 0; c < CT; ++c) col_s[c][tid] = slab[(6 + c) * cap + idx];
    }
    __syncthreads();

    for (int i = 0; i < nb; ++i) {
      const float q0 = q_s[0][i], q1 = q_s[1][i], q2 = q_s[2][i];
      const float q3 = q_s[3][i], q4 = q_s[4][i], q5 = q_s[5][i];
      const float op = op_s[i];
      const float mxl = mloc_s[0][i], myl = mloc_s[1][i];
      float v[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) v[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done[k]) continue;
        float s = __fmul_rn(fxx[k], q0);
        s = __fadd_rn(s, __fmul_rn(fyy[k], q1));
        s = __fadd_rn(s, __fmul_rn(fxy[k], q2));
        s = __fadd_rn(s, __fmul_rn(fx[k], q3));
        s = __fadd_rn(s, __fmul_rn(fy[k], q4));
        s = __fadd_rn(s, q5);
        const float e = expf(-s);
        const float raw = __fmul_rn(op, e);
        if (!(s >= 0.0f && raw >= kAlphaMin)) continue;
        const float alpha = fminf(raw, kAlphaMax);
        const float L = log1pf(-alpha);
        const float incl = __fadd_rn(log_all[k], L);
        if (!(incl > kLogTEps)) {
          done[k] = true;
          continue;
        }
        const float T = expf(log_all[k]);
        const float w = alpha * T;
        float gdot = 0.0f;
#pragma unroll
        for (int c = 0; c < CT; ++c) gdot += g_c[k][c] * col_s[c][i];
        wg_cum[k] += w * gdot;
        const float inv = 1.0f / (1.0f - alpha);
        const float ga = T * gdot - (tdot[k] - wg_cum[k]) * inv - gtf[k] * inv;
        if (raw <= kAlphaMax) {
          const float gs = -alpha * ga;
          const float dx = fx[k] - mxl;
          const float dy = fy[k] - myl;
          v[0] += gs * dx * dx;
          v[1] += gs * dy * dy;
          v[2] += gs * dx * dy;
          v[3] += gs * dx;
          v[4] += gs * dy;
          v[5] += e * ga;
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) v[6 + c] += g_c[k][c] * w;
        log_all[k] = incl;
        any = true;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[r] += __shfl_down_sync(0xffffffffu, v[r], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NR; ++r) part_s[warp][r][i] = v[r];
      }
    }
    __syncthreads();

    if (tid < nb) {
      float a[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part_s[w][r][tid];
        a[r] = sum;
      }
      const long long idx = start + b0 + tid;
      const float cA = slab[2 * cap + idx];
      const float cB = slab[3 * cap + idx];
      const float cC = slab[4 * cap + idx];
      gout[idx] = -(cA * a[3] + cB * a[4]);
      gout[cap + idx] = -(cC * a[4] + cB * a[3]);
      gout[2 * cap + idx] = 0.5f * a[0];
      gout[3 * cap + idx] = a[2];
      gout[4 * cap + idx] = 0.5f * a[1];
      gout[5 * cap + idx] = a[5];
#pragma unroll
      for (int c = 0; c < CT; ++c) gout[(6 + c) * cap + idx] = a[6 + c];
    }
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= done[k] ? 0 : 1;
    if (__syncthreads_count(live) == 0) break;
  }
}

template <int CT>
void launch_ct(const float* slab, long long cap, const int* offs, const int* heads,
               const int* counts, int num_tiles, int tile_size, int tiles_x,
               const float* rgb, const float* tfin, const float* grgb,
               const float* gt, float* gout, cudaStream_t stream) {
  if (tile_size == 32) {
    blend_backward_kernel<CT, 4><<<num_tiles, kThreads, 0, stream>>>(
        slab, cap, offs, heads, counts, tile_size, tiles_x, rgb, tfin, grgb, gt,
        gout);
  } else {
    blend_backward_kernel<CT, 1><<<num_tiles, kThreads, 0, stream>>>(
        slab, cap, offs, heads, counts, tile_size, tiles_x, rgb, tfin, grgb, gt,
        gout);
  }
}

}  // namespace

// Writes rows 0 .. 5 + c_total of the zero-initialised gradient slab gout
// [w_rows, cap]. Returns cudaGetLastError() after the launch (0 on
// success); 1 for a tile size, channel count or row count it does not take.
extern "C" int mtgs_blend_backward(const float* slab, long long cap, int w_rows,
                                   const int* tile_offsets, const int* tile_heads,
                                   const int* tile_counts, int num_tiles,
                                   int tile_size, int tiles_x, int c_total,
                                   const float* rgb, const float* tfin,
                                   const float* grgb, const float* gt, float* gout,
                                   void* stream) {
  if (tile_size != 16 && tile_size != 32) return 1;
  if (6 + c_total > w_rows) return 1;
  if (num_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define MTGS_CT_CASE(N)                                                          \
  case N:                                                                        \
    launch_ct<N>(slab, cap, tile_offsets, tile_heads, tile_counts, num_tiles,    \
                 tile_size, tiles_x, rgb, tfin, grgb, gt, gout, s);              \
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
