// Forward alpha blend of each tile's depth-ordered intersections.
//
// Replaces the TPU kernel mtgs_tpu/raster/blend_pallas.py::blend_forward_pallas
// (_fwd_kernel / _fwd_kernel_db; math in chunk_math.forward_chunk).
//
// What bounds it on an H100. The least time is set by the operations (14
// per evaluated pair inside the splat's 1/255 support, 6 + 2c per
// composited one) or by the bytes (the slab columns up to each tile's
// last evaluated one, the outputs); see chip_smoke.py's b_bytes / b_ops.
// What sets the time is the deepest tile's chain: each pixel walks the
// tile's intersections front to back. The earlier kernel held a tile's
// 1,024 pixels in one block of 256 threads on one SM, walked the tiles in
// index order, and evaluated sigma and an exp for every (pixel,
// intersection) pair it reached; on a faint scene (the start of training
// and the stretch after each opacity reset) that is every one of a deep
// tile's ~30k pairs, of which ~5% lie inside the splat's 1/255 support.
// Design (the backward's, csrc/blend_backward.cu, less its reductions):
//   * a tile's pixels are split across C = 4 independent blocks of 128
//     threads, two pixels a thread (tile 16 keeps its 256 pixels in one
//     block, C = 1). A warp's 64 pixels are an 8 x 8 block of the tile,
//     the tile's warps interleaved over its blocks. The forward needs no
//     sums across pixels, so the blocks share nothing: each walks the
//     tile's whole list front to back for its own pixels and leaves it
//     once they are all saturated;
//   * each pixel keeps the earlier kernel's arithmetic in its order: the
//     __fmul_rn/__fadd_rn sigma, expf, log1p_neg and the cut-offs of
//     blend_math.cuh, acc += col * w. So rgb and t_final are the earlier
//     kernel's bits, and the backward's replay of them through the same
//     header takes every decision on the same side;
//   * the wrapper launches the tiles deepest first (blend.tile_order), so
//     the deep chains do not wait for a free SM behind shallow tiles;
//   * batches of 128 intersections, one a thread: each block copies a
//     batch's slab columns into shared memory with cp.async two batches
//     ahead (a ring of three), and stages their conic coefficients Q,
//     opacity, colours and support box (blend_math.cuh's support_box). A
//     block whose pixels never all saturate walks its tile's whole list,
//     and on a bright scene, where a warp finds few hits in a batch, the
//     time per batch is that of the copy and the staging, so both are
//     kept off each other's path. A warp walks only the intersections
//     whose box meets its 8 x 8 pixels (two 64-bit ballot masks): the
//     others fail the 1/255 test at each of its pixels, so leaving them
//     out changes no bit;
//   * a warp carries two intersections at a time: the four sigmas, expfs
//     and (branch-free) logarithms are independent, only each pixel's
//     running sums are taken in order;
//   * launch bounds keep six blocks of 128 threads an SM resident.
// The kernel reads only [start, start + count) of each tile's run;
// tile_offsets + tile_heads give start (the TPU's 128-aligned window
// convention is kept at the Python boundary only).

#include <cuda_runtime.h>

#include "blend_math.cuh"

namespace {

using mtgs::kAlphaMax;
using mtgs::kAlphaMin;
using mtgs::kLogTEps;
using mtgs::log1p_neg;

constexpr int kCluster32 = 4;  // blocks per tile at tile 32 (tile 16: 1)
constexpr int kBatch = 128;    // intersections staged at once (one a thread)
constexpr int kStages = 3;     // batches in the shared-memory ring (two in flight)
constexpr int kPix = 2;        // pixels a thread
constexpr int kWarpW = 8;      // a warp's pixels: kWarpW x (32 kPix / kWarpW)
constexpr int kGroup = 2;      // intersections a warp carries at once
constexpr int kMinBlocks = 6;  // resident blocks of 128 threads an SM (at most 80 registers)
constexpr unsigned kFull = 0xffffffffu;

template <int CT, int C, int NT>
__global__ void __launch_bounds__(NT, kMinBlocks)
blend_forward_kernel(const float* __restrict__ slab, long long cap,
                     const int* __restrict__ tile_offsets,
                     const int* __restrict__ tile_heads,
                     const int* __restrict__ tile_counts,
                     const int* __restrict__ tile_order,
                     int tile_size, int tiles_x, int tile_base,
                     float* __restrict__ rgb_out, float* __restrict__ tfin_out) {
  static_assert(kWarpW <= 16 && 32 * kPix / kWarpW <= 16,
                "a warp's block fits a 16-pixel tile");
  // the slab columns of the batches (a ring: the next two are copied in
  // while this one runs) and what the batch's pixels need of each
  __shared__ float raw_s[kStages][6 + CT][kBatch];
  __shared__ __align__(16) float qv_s[kBatch][8];   // Q, opacity, 0: two float4 loads
  __shared__ __align__(16) float colv_s[kBatch][8];  // colours, 0-padded
  __shared__ float box_s[4][kBatch];                  // support_box of each intersection

  const int rank = (int)(blockIdx.x % C);
  const int t = tile_order[blockIdx.x / C];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pix = tile_size * tile_size;
  const int gt = tile_base + t;
  const float ox = (float)((gt % tiles_x) * tile_size);
  const float oy = (float)((gt / tiles_x) * tile_size);
  const long long start = (long long)tile_offsets[t] + tile_heads[t];
  const int count = tile_counts[t];

  // this warp's pixels: a kWarpW x (32 kPix / kWarpW) block of the tile,
  // lane l's at rows l / kWarpW + k 32 / kWarpW; the tile's warps are
  // interleaved over its blocks
  const int ww = kWarpW, wh = 32 * kPix / ww;
  const int g = warp * C + rank, bands = tile_size / ww;
  const float wx0 = (float)((g % bands) * ww) + 0.5f, wx1 = wx0 + (float)(ww - 1);
  const float wy0 = (float)((g / bands) * wh) + 0.5f, wy1 = wy0 + (float)(wh - 1);
  int p[kPix];
  float fx[kPix], fy[kPix], fxx[kPix], fyy[kPix], fxy[kPix];
  float acc[kPix][CT], log_all[kPix];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int px = (g % bands) * ww + lane % ww;
    const int py = (g / bands) * wh + lane / ww + k * (32 / ww);
    p[k] = py * tile_size + px;
    fx[k] = (float)px + 0.5f;
    fy[k] = (float)py + 0.5f;
    fxx[k] = fx[k] * fx[k];
    fyy[k] = fy[k] * fy[k];
    fxy[k] = fx[k] * fy[k];
    log_all[k] = 0.0f;  // the sum of log(1 - alpha) over the composited ones
    done[k] = false;
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[k][c] = 0.0f;
  }

  // copies batch b's slab columns into raw_s[into] without holding registers
  auto fetch = [&](int b, int into) {
    for (int j = tid; j < min(kBatch, count - b); j += NT) {
#pragma unroll
      for (int r = 0; r < 6 + CT; ++r) {
        const unsigned dst = (unsigned)__cvta_generic_to_shared(&raw_s[into][r][j]);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                     "l"(slab + r * cap + start + b + j));
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  // one commit group a batch (empty past the list), so that waiting for
  // all but the newest group waits for this batch's
  fetch(0, 0);
  fetch(kBatch, 1);
  for (int b0 = 0, buf = 0; b0 < count; b0 += kBatch, buf = buf == kStages - 1 ? 0 : buf + 1) {
    const int nb = min(kBatch, count - b0);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();  // the batch is in, and the previous one consumed
    fetch(b0 + 2 * kBatch, buf == 0 ? kStages - 1 : buf - 1);  // the ring slot consumed last
    const float(&cols)[6 + CT][kBatch] = raw_s[buf];
    for (int j = tid; j < nb; j += NT) {
      float q[6];
      mtgs::conic_q(__fsub_rn(cols[0][j], ox), __fsub_rn(cols[1][j], oy), cols[2][j],
                    cols[3][j], cols[4][j], q);
#pragma unroll
      for (int k = 0; k < 6; ++k) qv_s[j][k] = q[k];
      qv_s[j][6] = cols[5][j];
      qv_s[j][7] = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) colv_s[j][c] = c < CT ? cols[6 + c][j] : 0.0f;
      float box[4];
      mtgs::support_box(q, cols[5][j], box);
#pragma unroll
      for (int k = 0; k < 4; ++k) box_s[k][j] = box[k];
    }
    __syncthreads();

    // the batch's intersections whose support reaches this warp's pixels
    unsigned long long hitw[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < kBatch / 32; ++h) {
      const int j = lane + 32 * h;
      const bool hit = j < nb && !(wx1 < box_s[0][j] || wx0 > box_s[1][j] ||
                                   wy1 < box_s[2][j] || wy0 > box_s[3][j]);
      hitw[h / 2] |= (unsigned long long)__ballot_sync(kFull, hit) << (32 * (h % 2));
    }
    bool alldone = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) alldone = alldone && done[k];
    if (__all_sync(kFull, alldone)) hitw[0] = hitw[1] = 0;  // saturated: nothing more to do
    for (int hw = 0; hw < 2; ++hw) {
      for (unsigned long long hits = hitw[hw]; hits;) {
        // the next kGroup of them, carried together: each one's sigma,
        // alpha and log(1 - alpha) are independent of the others
        int ii[kGroup];
        bool ok[kGroup][kPix], okany = false;
        float alpha[kGroup][kPix];
  #pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const bool val = hits != 0;
          const int i = val ? 64 * hw + __ffsll((long long)hits) - 1 : 0;
          hits &= hits - 1;
          ii[u] = i;
          const float4 qa = *reinterpret_cast<const float4*>(&qv_s[i][0]);
          const float4 qb = *reinterpret_cast<const float4*>(&qv_s[i][4]);
  #pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const float s = mtgs::sigma_at(fxx[k], fyy[k], fxy[k], fx[k], fy[k], qa.x, qa.y,
                                           qa.z, qa.w, qb.x, qb.y);
            const float raw = __fmul_rn(qb.z, expf(-s));
            ok[u][k] = val && s >= 0.0f && raw >= kAlphaMin && !done[k];
            alpha[u][k] = fminf(raw, kAlphaMax);
            okany = okany || ok[u][k];
          }
        }
        if (!__any_sync(kFull, okany)) continue;
        float L[kGroup][kPix];
  #pragma unroll
        for (int u = 0; u < kGroup; ++u) {
  #pragma unroll
          for (int k = 0; k < kPix; ++k) L[u][k] = log1p_neg(alpha[u][k]);
        }
  #pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          float col[8];
          *reinterpret_cast<float4*>(&col[0]) = *reinterpret_cast<const float4*>(&colv_s[ii[u]][0]);
          *reinterpret_cast<float4*>(&col[4]) = *reinterpret_cast<const float4*>(&colv_s[ii[u]][4]);
  #pragma unroll
          for (int k = 0; k < kPix; ++k) {
            if (!ok[u][k] || done[k]) continue;
            const float incl = __fadd_rn(log_all[k], L[u][k]);
            if (incl > kLogTEps) {
              const float w = alpha[u][k] * expf(log_all[k]);
  #pragma unroll
              for (int c = 0; c < CT; ++c) acc[k][c] += col[c] * w;
              log_all[k] = incl;
            } else {
              done[k] = true;
            }
          }
        }
      }
    }
    int live = 0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) live |= done[k] ? 0 : 1;
    if (__syncthreads_count(live) == 0) break;  // every pixel of the block saturated
  }
  asm volatile("cp.async.wait_all;" ::: "memory");  // no copy lands after the block

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
#pragma unroll
    for (int c = 0; c < CT; ++c)
      rgb_out[((long long)t * CT + c) * pix + p[k]] = acc[k][c];
    tfin_out[(long long)t * pix + p[k]] = expf(log_all[k]);
  }
}

template <int CT, int PIX, int C>
cudaError_t launch_split(const float* slab, long long cap, const int* offs, const int* heads,
                         const int* counts, const int* order, int num_tiles, int tile_size,
                         int tiles_x, int tile_base, float* rgb, float* tfin,
                         cudaStream_t stream) {
  constexpr int NT = PIX / (C * kPix);  // kPix pixels a thread
  static_assert(NT % 32 == 0 && NT <= 1024, "a block holds whole warps");
  blend_forward_kernel<CT, C, NT><<<(unsigned)num_tiles * C, NT, 0, stream>>>(
      slab, cap, offs, heads, counts, order, tile_size, tiles_x, tile_base, rgb, tfin);
  return cudaGetLastError();
}

template <int CT>
cudaError_t launch_ct(const float* slab, long long cap, const int* offs, const int* heads,
                      const int* counts, const int* order, int num_tiles, int tile_size,
                      int tiles_x, int tile_base, float* rgb, float* tfin,
                      cudaStream_t stream) {
  if (tile_size == 32)
    return launch_split<CT, 1024, kCluster32>(slab, cap, offs, heads, counts, order,
                                              num_tiles, tile_size, tiles_x, tile_base, rgb,
                                              tfin, stream);
  return launch_split<CT, 256, 1>(slab, cap, offs, heads, counts, order, num_tiles,
                                  tile_size, tiles_x, tile_base, rgb, tfin, stream);
}

}  // namespace

// The version of mtgs_blend_forward's argument list: 2 since it takes
// tile_order (a library without this symbol takes the list without it).
// A measurement aid for comparing sources (chip_smoke.py --ab); nothing
// on the rasterizer's path reads it.
extern "C" int mtgs_blend_forward_abi(void) { return 2; }

// tile_order [num_tiles]: the tiles in the order their blocks launch (a
// permutation of 0 .. num_tiles - 1). Returns cudaGetLastError() after
// the launch (0 on success); 1 for a tile size or channel count the
// kernel does not take.
extern "C" int mtgs_blend_forward(const float* slab, long long cap,
                                  const int* tile_offsets, const int* tile_heads,
                                  const int* tile_counts, const int* tile_order,
                                  int num_tiles, int tile_size, int tiles_x, int tile_base,
                                  int c_total, float* rgb, float* tfin, void* stream) {
  if (tile_size != 16 && tile_size != 32) return 1;
  if (num_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define MTGS_CT_CASE(N)                                                        \
  case N:                                                                      \
    err = launch_ct<N>(slab, cap, tile_offsets, tile_heads, tile_counts,       \
                       tile_order, num_tiles, tile_size, tiles_x, tile_base,   \
                       rgb, tfin, s);                                          \
    break;
  switch (c_total) {
    MTGS_CT_CASE(1) MTGS_CT_CASE(2) MTGS_CT_CASE(3) MTGS_CT_CASE(4)
    MTGS_CT_CASE(5) MTGS_CT_CASE(6) MTGS_CT_CASE(7) MTGS_CT_CASE(8)
    default:
      return 1;
  }
#undef MTGS_CT_CASE
  return (int)err;
}
