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
// What bounds it on an H100. The least time is set by bytes (the slab
// columns up to each tile's last evaluated one, the forward's outputs,
// the cotangents, the [W, cap] gradient slab written once) or by the
// operations (14 per evaluated pair inside the splat's 1/255 support,
// 30 + 4c per composited one); see chip_smoke.py's bb_bytes / bb_ops.
// What sets the time is the deepest
// tile's chain: each pixel walks the tile's intersections in order, and
// the earlier kernel held all 1,024 pixels of a tile in one block of 256
// threads on one SM. It spent ~1,100 SM cycles per intersection of that
// chain: 8 warps x 13 sums x 5 shuffle steps = 520 shuffles (one warp
// shuffle per clock per SM) and the 1,024 pixels' arithmetic (~14 + 30 +
// 4c f32 operations, expf, log1pf, a second expf and a reciprocal). A
// faint scene (opacities near 0.01: the start of training and the stretch
// after each opacity reset) reaches every one of a deep tile's ~30-36k
// pairs, and that tile's one SM set the kernel's time. Design:
//   * a tile's pixels are split across a thread-block cluster of C = 4
//     blocks of 128 threads, two pixels a thread (tile 16 keeps its 256
//     pixels in one block, C = 1). A warp's 64 pixels are an 8 x 8 block
//     of the tile, and the tile's warps are interleaved over the
//     cluster's blocks. Every block walks the tile's whole list front to
//     back for its pixels, so each pixel's chain is the forward's: its
//     __fmul_rn/__fadd_rn sigma, expf, log1p_neg and cut-offs (shared
//     through blend_math.cuh), the running log_all and wg_cum, and every
//     1/255, sigma >= 0 and T = 1e-4 decision falls exactly as in
//     csrc/blend_forward.cu. No chunk start state is needed (splitting
//     the list instead would need each chunk's start transmittance, and
//     would evaluate the pairs the early exit skips);
//   * the wrapper launches the tiles deepest first, so the deep chains do
//     not wait for a free SM behind shallow tiles;
//   * batches of 64 intersections: each block copies a batch's slab
//     columns into shared memory with cp.async one batch ahead, and
//     stages their conic coefficients Q (in the forward kernel's order)
//     and each one's support box (blend_math.cuh's support_box, in double
//     precision, which the forward kernel shares): the
//     pixel rows and columns outside which its alpha cannot reach 1/255.
//     A warp walks only the intersections whose box meets its 8 x 8
//     pixels (a 64-bit ballot); a faint deep tile's splats each cover a
//     small part of it, so most (pixel, intersection) pairs are never
//     evaluated, and no decision changes;
//   * a warp carries two intersections at a time for its two pixels a
//     lane: the four sigmas and expfs, and, once a lane passes the 1/255
//     test, the logarithms (blend_math.cuh's log1p_neg, which the forward
//     also takes, with no branch) are independent, only each pixel's
//     running sums are taken in order; the gradient terms (T, the
//     weight, 1 / (1 - alpha)) use the fast exp and division, which
//     change rounding only;
//   * a lane adds its two pixels' terms first; the two intersections'
//     2 x (6 + c) sums, padded to 2 x 16, are then reduced across the
//     warp by a transpose-reduce: at each of the 5 butterfly steps a lane
//     sends half of its remaining sums and keeps the other half: 16 + 8 +
//     4 + 2 + 1 = 31 shuffles for two intersections of 64 pixels, where
//     the earlier kernel spent 13 x 5 = 65 on one intersection of 128;
//     lane l ends with sum l & 15 of intersection l >> 4. A warp where no
//     lane composited skips it;
//   * each warp leaves its totals in shared memory; at the end of the
//     batch the block adds, in warp order, the totals of the warps that
//     took each intersection; after one cluster.sync, block r adds the C
//     blocks' totals in rank order (distributed shared memory) for its
//     share of the batch and writes each gradient column once. The block
//     totals are double-buffered, so the one barrier also orders the next
//     batch's writes after the reads. No atomics: two launches give the
//     same bits;
//   * early exit across the cluster: each block publishes its live-pixel
//     count beside its totals and every block adds the C counts after the
//     batch's cluster.sync, so all leave after the same batch, through one
//     last cluster.sync (no block's shared memory goes while another may
//     read it). The slots never reached keep the zeros the wrapper
//     allocated;
//   * launch bounds keep five blocks of 128 threads an SM resident (at
//     most 102 registers a thread).

#include <cooperative_groups.h>
#include <math.h>
#include <cuda_runtime.h>

#include "blend_math.cuh"

namespace cg = cooperative_groups;

namespace {

using mtgs::kAlphaMax;
using mtgs::kAlphaMin;
using mtgs::kLogTEps;
using mtgs::log1p_neg;
using mtgs::support_box;

constexpr int kCluster32 = 4;  // cluster size at tile 32 (tile 16: 1)
constexpr int kBatch = 64;     // intersections staged at once (a warp's 64-bit mask)
constexpr int kSums = 16;      // sums per intersection, padded for the transpose-reduce
constexpr int kPix = 2;        // pixels a thread
constexpr int kWarpW = 8;      // a warp's pixels: kWarpW x (32 kPix / kWarpW)
constexpr int kGroup = 2;      // intersections a warp carries at once (even)
constexpr int kMinBlocks = 5;  // resident blocks of 128 threads an SM (at most 102 registers)
constexpr unsigned kFull = 0xffffffffu;

// One butterfly step of the transpose-reduce: lanes with `bit` set keep
// the upper half of their 2 H sums, the others the lower half; each adds
// the half its partner sent.
template <int H>
__device__ __forceinline__ void fold(float (&v)[2 * kSums], int lane, int bit) {
  const bool up = (lane & bit) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? v[j] : v[j + H];
    const float keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, bit);
  }
}

// Warp totals of the 16 sums of two intersections in 31 shuffles: returns
// sum (lane & 15) of intersection (lane >> 4).
__device__ __forceinline__ float transpose_reduce(float (&v)[2 * kSums], int lane) {
  fold<16>(v, lane, 16);
  fold<8>(v, lane, 8);
  fold<4>(v, lane, 4);
  fold<2>(v, lane, 2);
  fold<1>(v, lane, 1);
  return v[0];
}

template <int CT, int C, int NT>
__global__ void __launch_bounds__(NT, kMinBlocks)
blend_backward_kernel(const float* __restrict__ slab, long long cap,
                      const int* __restrict__ tile_offsets,
                      const int* __restrict__ tile_heads,
                      const int* __restrict__ tile_counts,
                      const int* __restrict__ tile_order,
                      int tile_size, int tiles_x, int tile_base,
                      const float* __restrict__ rgb, const float* __restrict__ tfin,
                      const float* __restrict__ grgb, const float* __restrict__ gt,
                      float* __restrict__ gout) {
  constexpr int NR = 6 + CT;  // sums per intersection: 5 geometry, opacity, colours
  constexpr int kWarps = NT / 32;
  static_assert(NR <= kSums, "too many sums for the transpose-reduce");
  static_assert(kGroup % 2 == 0, "the transpose-reduce takes intersections in pairs");
  static_assert(kWarpW <= 16 && 32 * kPix / kWarpW <= 16,
                "a warp's block fits a 16-pixel tile");
  // the slab columns of a batch (double-buffered: the next one is copied in
  // while this one runs) and what the batch's pixels need of each
  __shared__ float raw_s[2][6 + CT][kBatch];
  __shared__ __align__(16) float qv_s[kBatch][8];   // Q, opacity, 0: two float4 loads
  __shared__ __align__(16) float colv_s[kBatch][8];  // colours, 0-padded
  __shared__ float2 ml_s[kBatch];                     // the mean, tile-local
  __shared__ float box_s[4][kBatch];  // support_box of each intersection
  __shared__ float part_s[kWarps][NR][kBatch];
  __shared__ float blk_s[2][NR][kBatch];  // the block's totals, double-buffered
  __shared__ int live_s[2];
  __shared__ unsigned long long hit_s[kWarps];  // the batch's intersections each warp took

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = tile_order[blockIdx.x / C];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pix = tile_size * tile_size;
  // tile t of this launch is global tile tile_base + t (a tile-row band
  // of a sharded render starts past tile 0): it sets the pixel origin only
  const int tg = tile_base + t;
  const float ox = (float)((tg % tiles_x) * tile_size);
  const float oy = (float)((tg / tiles_x) * tile_size);
  const long long start = (long long)tile_offsets[t] + tile_heads[t];
  const int count = tile_counts[t];

  // this warp's pixels: a kWarpW x (32 kPix / kWarpW) block of the tile,
  // lane l's at rows l / kWarpW + k 32 / kWarpW; the cluster's warps are
  // interleaved over the tile's blocks
  const int ww = kWarpW, wh = 32 * kPix / ww;
  const int g = warp * C + rank, bands = tile_size / ww;
  const float wx0 = (float)((g % bands) * ww) + 0.5f, wx1 = wx0 + (float)(ww - 1);
  const float wy0 = (float)((g / bands) * wh) + 0.5f, wy1 = wy0 + (float)(wh - 1);
  float fx[kPix], fy[kPix], fxx[kPix], fyy[kPix], fxy[kPix];
  float g_c[kPix][CT], tdot[kPix], gtf[kPix], log_all[kPix], wg_cum[kPix];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int px = (g % bands) * ww + lane % ww;
    const int py = (g / bands) * wh + lane / ww + k * (32 / ww);
    const int p = py * tile_size + px;
    fx[k] = (float)px + 0.5f;
    fy[k] = (float)py + 0.5f;
    fxx[k] = fx[k] * fx[k];
    fyy[k] = fy[k] * fy[k];
    fxy[k] = fx[k] * fy[k];
    tdot[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const long long o = ((long long)t * CT + c) * pix + p;
      g_c[k][c] = grgb[o];
      tdot[k] += g_c[k][c] * rgb[o];
    }
    gtf[k] = gt[(long long)t * pix + p] * tfin[(long long)t * pix + p];
    log_all[k] = 0.0f;
    wg_cum[k] = 0.0f;
    done[k] = false;
  }

  const int share = (kBatch + C - 1) / C;  // intersections a block writes per batch
  // copies batch b's slab columns into raw_s[into] without holding registers
  auto fetch = [&](int b, int into) {
    if (tid < min(kBatch, count - b)) {
#pragma unroll
      for (int r = 0; r < 6 + CT; ++r) {
        const unsigned dst = (unsigned)__cvta_generic_to_shared(&raw_s[into][r][tid]);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                     "l"(slab + r * cap + start + b + tid));
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  fetch(0, 0);
  for (int b0 = 0, buf = 0; b0 < count; b0 += kBatch, buf ^= 1) {
    const int nb = min(kBatch, count - b0);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // the batch is in, and the previous one consumed
    if (b0 + kBatch < count) fetch(b0 + kBatch, buf ^ 1);  // in flight while this one runs
    const float(&cols)[6 + CT][kBatch] = raw_s[buf];  // this batch's slab columns
    if (tid < nb) {
      const float mxl = __fsub_rn(cols[0][tid], ox);
      const float myl = __fsub_rn(cols[1][tid], oy);
      const float cA = cols[2][tid], cB = cols[3][tid], cC = cols[4][tid];
      float q[6];
      mtgs::conic_q(mxl, myl, cA, cB, cC, q);
#pragma unroll
      for (int k = 0; k < 6; ++k) qv_s[tid][k] = q[k];
      qv_s[tid][6] = cols[5][tid];
      qv_s[tid][7] = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) colv_s[tid][c] = c < CT ? cols[6 + c][tid] : 0.0f;
      ml_s[tid] = make_float2(mxl, myl);
      float box[4];
      support_box(q, cols[5][tid], box);
#pragma unroll
      for (int k = 0; k < 4; ++k) box_s[k][tid] = box[k];
    }
    __syncthreads();

    // the batch's intersections whose support reaches this warp's rows
    unsigned long long hits = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      const bool hit = j < nb && !(wx1 < box_s[0][j] || wx0 > box_s[1][j] ||
                                   wy1 < box_s[2][j] || wy0 > box_s[3][j]);
      hits |= (unsigned long long)__ballot_sync(kFull, hit) << (32 * h);
    }
    bool alldone = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) alldone = alldone && done[k];
    if (__all_sync(kFull, alldone)) hits = 0;  // saturated pixels evaluate nothing more
    if (lane == 0) hit_s[warp] = hits;
    for (unsigned long long todo = hits; todo;) {
      // the next kGroup of them, carried together: each one's sigma,
      // alpha and log(1 - alpha) are independent of the others
      int ii[kGroup];
      bool val[kGroup], ok[kGroup][kPix], okany = false;
      float e[kGroup][kPix], raw[kGroup][kPix];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        val[u] = todo != 0;
        const int i = val[u] ? __ffsll((long long)todo) - 1 : 0;
        todo &= todo - 1;
        ii[u] = i;
        const float4 qa = *reinterpret_cast<const float4*>(&qv_s[i][0]);
        const float4 qb = *reinterpret_cast<const float4*>(&qv_s[i][4]);
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float s = mtgs::sigma_at(fxx[k], fyy[k], fxy[k], fx[k], fy[k], qa.x, qa.y,
                                         qa.z, qa.w, qb.x, qb.y);
          e[u][k] = expf(-s);
          raw[u][k] = __fmul_rn(qb.z, e[u][k]);
          ok[u][k] = val[u] && s >= 0.0f && raw[u][k] >= kAlphaMin;
          okany = okany || (ok[u][k] && !done[k]);
        }
      }
      bool comp[kGroup][kPix], any = false;
      float lb[kGroup][kPix], alpha[kGroup][kPix];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          comp[u][k] = false;
          lb[u][k] = log_all[k];
          alpha[u][k] = fminf(raw[u][k], kAlphaMax);
        }
      }
      if (__any_sync(kFull, okany)) {
        float L[kGroup][kPix];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
#pragma unroll
          for (int k = 0; k < kPix; ++k) L[u][k] = log1p_neg(alpha[u][k]);
        }
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const float incl = __fadd_rn(log_all[k], L[u][k]);
            const bool live = ok[u][k] && !done[k];
            const bool stop = live && !(incl > kLogTEps);
            comp[u][k] = live && !stop;
            done[k] = done[k] || stop;
            lb[u][k] = log_all[k];
            if (comp[u][k]) log_all[k] = incl;
            any = any || comp[u][k];
          }
        }
        any = __any_sync(kFull, any);
      }
      float v[kGroup][kSums];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
#pragma unroll
        for (int r = 0; r < kSums; ++r) v[u][r] = 0.0f;
      }
      if (any) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int i = ii[u];
          float col[8];
          *reinterpret_cast<float4*>(&col[0]) = *reinterpret_cast<const float4*>(&colv_s[i][0]);
          *reinterpret_cast<float4*>(&col[4]) = *reinterpret_cast<const float4*>(&colv_s[i][4]);
          const float2 ml = ml_s[i];
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const float T = __expf(lb[u][k]);
            const float w = alpha[u][k] * T;
            float gdot = 0.0f;
#pragma unroll
            for (int c = 0; c < CT; ++c) gdot += g_c[k][c] * col[c];
            if (comp[u][k]) wg_cum[k] += w * gdot;
            const float inv = __fdividef(1.0f, 1.0f - alpha[u][k]);
            const float ga = T * gdot - (tdot[k] - wg_cum[k]) * inv - gtf[k] * inv;
            const bool geo = comp[u][k] && raw[u][k] <= kAlphaMax;
            const float gs = geo ? -alpha[u][k] * ga : 0.0f;
            const float dx = fx[k] - ml.x;
            const float dy = fy[k] - ml.y;
            v[u][0] += gs * dx * dx;
            v[u][1] += gs * dy * dy;
            v[u][2] += gs * dx * dy;
            v[u][3] += gs * dx;
            v[u][4] += gs * dy;
            v[u][5] += geo ? e[u][k] * ga : 0.0f;
#pragma unroll
            for (int c = 0; c < CT; ++c) v[u][6 + c] += comp[u][k] ? g_c[k][c] * w : 0.0f;
          }
        }
      }
      // the warp's totals, two intersections a transpose
#pragma unroll
      for (int u = 0; u < kGroup; u += 2) {
        float total = 0.0f;
        if (any) {
          float t[2 * kSums];
#pragma unroll
          for (int r = 0; r < kSums; ++r) {
            t[r] = v[u][r];
            t[kSums + r] = v[u + 1][r];
          }
          total = transpose_reduce(t, lane);
        }
        const bool hi = lane >= 16;
        const int r = lane & 15;
        if ((hi ? val[u + 1] : val[u]) && r < NR) part_s[warp][r][hi ? ii[u + 1] : ii[u]] = total;
      }
    }
    // the block's live pixels, and the end of its warps' writes
    bool anylive = false;
#pragma unroll
    for (int k = 0; k < kPix; ++k) anylive = anylive || !done[k];
    const int live = __syncthreads_count(anylive ? 1 : 0);
    if (tid == 0) live_s[buf] = live;
    unsigned long long took[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) took[w] = hit_s[w];
    for (int k = tid; k < NR * nb; k += NT) {
      const int r = k / nb, i = k - r * nb;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float x = part_s[w][r][i];  // written only by the warps that took i
        sum += (took[w] >> i & 1) ? x : 0.0f;
      }
      blk_s[buf][r][i] = sum;
    }
    cluster.sync();  // every block's totals and count of this batch are in

    int live_all = 0;
#pragma unroll
    for (int q = 0; q < C; ++q) live_all += cluster.map_shared_rank(&live_s[0], q)[buf];
    const int i = rank * share + tid;
    if (tid < share && i < nb) {
      float a[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) a[r] = 0.0f;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float* rb = cluster.map_shared_rank(&blk_s[buf][0][0], q);
#pragma unroll
        for (int r = 0; r < NR; ++r) a[r] += rb[r * kBatch + i];
      }
      const long long idx = start + b0 + i;
      const float cA = cols[2][i], cB = cols[3][i], cC = cols[4][i];
      gout[idx] = -(cA * a[3] + cB * a[4]);
      gout[cap + idx] = -(cC * a[4] + cB * a[3]);
      gout[2 * cap + idx] = 0.5f * a[0];
      gout[3 * cap + idx] = a[2];
      gout[4 * cap + idx] = 0.5f * a[1];
      gout[5 * cap + idx] = a[5];
#pragma unroll
      for (int c = 0; c < CT; ++c) gout[(6 + c) * cap + idx] = a[6 + c];
    }
    if (live_all == 0) break;  // the same decision in every block of the cluster
  }
  asm volatile("cp.async.wait_all;" ::: "memory");  // no copy lands after the block
  cluster.sync();  // no block leaves while another may still read its shared memory
}

template <int CT, int PIX, int C>
cudaError_t launch_cluster(const float* slab, long long cap, const int* offs,
                           const int* heads, const int* counts, const int* order,
                           int num_tiles, int tile_size, int tiles_x, int tile_base,
                           const float* rgb, const float* tfin, const float* grgb,
                           const float* gt, float* gout, cudaStream_t stream) {
  constexpr int NT = PIX / (C * kPix);  // kPix pixels a thread
  static_assert(NT % 32 == 0 && NT <= 1024, "a block holds whole warps");
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)num_tiles * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, blend_backward_kernel<CT, C, NT>, slab, cap, offs, heads,
                            counts, order, tile_size, tiles_x, tile_base, rgb, tfin, grgb,
                            gt, gout);
}

template <int CT>
cudaError_t launch_ct(const float* slab, long long cap, const int* offs, const int* heads,
                      const int* counts, const int* order, int num_tiles, int tile_size,
                      int tiles_x, int tile_base, const float* rgb, const float* tfin,
                      const float* grgb, const float* gt, float* gout,
                      cudaStream_t stream) {
  if (tile_size == 32)
    return launch_cluster<CT, 1024, kCluster32>(slab, cap, offs, heads, counts, order,
                                                num_tiles, tile_size, tiles_x, tile_base,
                                                rgb, tfin, grgb, gt, gout, stream);
  return launch_cluster<CT, 256, 1>(slab, cap, offs, heads, counts, order, num_tiles,
                                    tile_size, tiles_x, tile_base, rgb, tfin, grgb, gt,
                                    gout, stream);
}

}  // namespace

// Writes rows 0 .. 5 + c_total of the zero-initialised gradient slab gout
// [w_rows, cap]. Tile t of the ranges is global tile tile_base + t (its
// pixel origin), as in mtgs_blend_forward. Returns the launch's cudaError_t, else cudaGetLastError()
// after it (0 on success); 1 for a tile size, channel count or row count
// it does not take.
extern "C" int mtgs_blend_backward(const float* slab, long long cap, int w_rows,
                                   const int* tile_offsets, const int* tile_heads,
                                   const int* tile_counts, const int* tile_order,
                                   int num_tiles, int tile_size, int tiles_x,
                                   int tile_base, int c_total,
                                   const float* rgb, const float* tfin,
                                   const float* grgb, const float* gt, float* gout,
                                   void* stream) {
  if (tile_size != 16 && tile_size != 32) return 1;
  if (6 + c_total > w_rows) return 1;
  if (num_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define MTGS_CT_CASE(N)                                                          \
  case N:                                                                        \
    err = launch_ct<N>(slab, cap, tile_offsets, tile_heads, tile_counts,         \
                       tile_order, num_tiles, tile_size, tiles_x, tile_base,     \
                       rgb, tfin, grgb, gt, gout, s);                            \
    break;
  switch (c_total) {
    MTGS_CT_CASE(1) MTGS_CT_CASE(2) MTGS_CT_CASE(3) MTGS_CT_CASE(4)
    MTGS_CT_CASE(5) MTGS_CT_CASE(6) MTGS_CT_CASE(7) MTGS_CT_CASE(8)
    default:
      return 1;
  }
#undef MTGS_CT_CASE
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The C interface's version: 2 since it takes tile_base (an earlier
// source, without this symbol, takes the argument list without it).
extern "C" int mtgs_blend_backward_abi(void) { return 2; }
