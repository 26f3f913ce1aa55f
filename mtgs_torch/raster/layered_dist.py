"""Depth-slab layered distributed rasterization; port of
`mtgs_tpu/raster/layered_dist.py`.

One view split over the n ranks of a mesh axis by camera depth:

* rank d is the home of the stride-interleaved rows d, d + n, ... of the
  input; it projects them and depth-sorts them;
* splitters come from depth quantiles: 64 samples of each home's sorted
  depths, gathered on every rank; slab d holds the depths in
  [q_d, q_{d+1});
* one `all_to_all` moves each home's rows (depth, global index, table
  row, absgrad sink row) to their slab in fixed blocks of N_blk rows;
* each slab merges its rows by (depth, global index) and runs the
  unchanged single-rank fused pipeline over the full image on them at
  I/n slots: `expand_fused` (kernel 2), the pair sort, the blend
  (kernel 1). Pairs never move between ranks;
* slab d's pairs lie in front of slab d+1's in every pixel, so the image
  is the ordered alpha-composite of the n partial layers: one `all_to_all`
  of tile-row image bands and an n-term composite per band, equal to the
  single-rank blend in real arithmetic and to f32 reassociation (~1e-5)
  in fact, since the blend's sums regroup at the slab boundaries;
* the band images are gathered on every rank.

The backward retraces it through autograd: the composite's closed form,
the reverse image `all_to_all`, the blend backward (kernel 3), the
segment sum per slab row (kernel 4), the merge undone, the reverse row
`all_to_all`, the home's sort undone. The inputs' cotangents are averaged
over the group (`parallel/collectives.py::replicated`).

Opt-in only (MTGS_LAYERED=1), as in JAX. Rows past a slab block's N_blk
(MTGS_ROW_SLACK, default 1.5, of the even share) are dropped and signalled
through `n_intersections` (above the capacity: growing I does not help,
raising MTGS_ROW_SLACK does).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mtgs_torch.parallel.collectives import all_gather, all_to_all, pmax, replicated
from mtgs_torch.raster.binning import padded_capacity, tile_spans, window_ranges
from mtgs_torch.raster.chunk_math import NUM_GEOM, round8
from mtgs_torch.raster.dist_fused import lexsort
from mtgs_torch.raster.expand_fused import B, expand_fused, fused_fits, slot_bits
from mtgs_torch.raster.projection import project_gaussians
from mtgs_torch.raster.rasterize import _Blend
from mtgs_torch.raster.segment_sum import dense_segment_sum


class LayerPlan(NamedTuple):
    n_dev: int
    rows_per: int      # tile rows per output band
    ntl: int           # tiles per band (rows_per * tiles_x)
    I_s: int           # per-slab pair capacity
    N_blk: int         # per (home, slab) row-exchange block
    n_local: int       # gaussians per home
    k_smp: int         # depth quantile samples per home


def layered_shard_plan(config, n_dev: int, n_gauss: int):
    """The plan of the layered pipeline (JAX `layered_shard_plan`), or None
    unless MTGS_LAYERED is "1" and the shapes divide."""
    if n_dev <= 1 or os.environ.get("MTGS_LAYERED", "0") != "1":
        return None
    I = config.max_intersections
    if n_gauss % n_dev or I % n_dev or n_gauss >= (1 << 24):
        return None
    I_s = I // n_dev
    if I_s % B:
        return None
    n_local = n_gauss // n_dev
    slack = float(os.environ.get("MTGS_ROW_SLACK", "1.5"))
    N_blk = max(128, ((int(n_local * slack) // n_dev + 127) // 128) * 128)
    L = n_dev * N_blk
    if L >= (1 << 24) or not fused_fits(I_s, config.tiles_x * config.tiles_y, max(L, 2)):
        return None
    rows_per = -(-config.tiles_y // n_dev)
    return LayerPlan(n_dev, rows_per, rows_per * config.tiles_x, I_s, N_blk, n_local,
                     k_smp=64)


class _SlabExpand(torch.autograd.Function):
    """A slab's expansion (JAX `_slab_expand`): its merged, depth-ordered
    rows (cols [nw, L] attribute-major, span words and pair counts) ->
    attrs [round8(nw), I_s], key [I_s] and the pair total. The sink rows
    are ignored forward; their cotangent is the absgrad signal."""

    @staticmethod
    def forward(ctx, I_s: int, tiles_x: int, num_tiles: int, cols, sink_cols, packed, counts):
        csum = torch.cumsum(counts, dim=0, dtype=torch.int64)
        offsets = (csum - counts).to(torch.int32)
        total = csum[-1:].to(torch.int32)
        key, src, attrs = expand_fused(cols.contiguous(), offsets, packed.contiguous(), total,
                                       I_s, tiles_x=tiles_x, num_tiles=num_tiles)
        ctx.nw, ctx.L = cols.shape
        ctx.save_for_backward(src, total)
        ctx.mark_non_differentiable(key, total)
        return attrs, key, total

    @staticmethod
    def backward(ctx, g_attrs, _k, _t):
        src, total = ctx.saved_tensors
        nw, L, I = ctx.nw, ctx.L, src.shape[0]
        rows = g_attrs.new_zeros((round8(nw + 2), I))
        rows[:nw] = g_attrs[:nw]
        rows[nw:nw + 2] = g_attrs[:2].abs()
        # dead slots (slot >= total) hold zero rows: keyed to the sentinel
        slot = torch.arange(I, dtype=torch.int32, device=src.device)
        src = torch.where(slot < total, src, torch.full_like(src, L))
        sums = dense_segment_sum(rows, src, L)
        return None, None, None, sums[:nw, :L], sums[nw:nw + 2, :L], None, None


class _Composite(torch.autograd.Function):
    """The ordered composite of n partial layers (JAX `_composite`):
    rgb = sum_d P_d rgb_d, t = prod_d T_d with P_d = prod_{e<d} T_e; its
    backward in closed form, with no division (safe where T = 0):
    d/d rgb_d = P_d g_rgb; d/d T_d = P_d V_d + g_t P_d S_{d+1}, S_d the
    suffix product and V_d = sum_c g_rgb rgb_{d+1} + T_{d+1} V_{d+1}."""

    @staticmethod
    def forward(ctx, rgb_bands, t_bands):
        rgb = torch.zeros_like(rgb_bands[0])
        t = torch.ones_like(t_bands[0])
        for d in range(t_bands.shape[0]):
            rgb = rgb + t[:, None, :] * rgb_bands[d]
            t = t * t_bands[d]
        ctx.save_for_backward(rgb_bands, t_bands)
        return rgb, t

    @staticmethod
    def backward(ctx, g_rgb, g_t):
        rgb_bands, t_bands = ctx.saved_tensors
        n = t_bands.shape[0]
        P = [torch.ones_like(t_bands[0])]
        for d in range(n - 1):
            P.append(P[-1] * t_bands[d])
        S = [torch.ones_like(t_bands[0])] * (n + 1)
        for d in range(n - 1, -1, -1):
            S[d] = t_bands[d] * S[d + 1]
        g_rgb_layers = [P[d][:, None, :] * g_rgb for d in range(n)]
        V = torch.zeros_like(t_bands[0])
        g_t_layers = [None] * n
        for d in range(n - 1, -1, -1):
            g_t_layers[d] = P[d] * V + g_t * P[d] * S[d + 1]
            if d > 0:
                V = (g_rgb * rgb_bands[d]).sum(dim=1) + t_bands[d] * V
        return torch.stack(g_rgb_layers), torch.stack(g_t_layers)


def _blocks(x, bounds, needed, n_blk: int, fill):
    """x [..., n] cut at `bounds` into [n_dev, ..., n_blk] blocks, lanes past
    each run's length (capped at n_blk) set to `fill`."""
    lanes = torch.arange(n_blk, device=x.device)
    idx = bounds[:-1, None].long() + lanes                      # [n_dev, n_blk]
    live = lanes < torch.clamp(needed, max=n_blk)[:, None]
    xb = F.pad(x, (0, n_blk))[..., idx]                          # [..., n_dev, n_blk]
    xb = torch.where(live, xb, fill)
    return xb.movedim(-2, 0).contiguous(), live


def rasterize_layered(config, mesh, shard_axis: str, plan: LayerPlan, c_total: int,
                      means, quats, scales, opacities, colors, viewmat, K, tap2d, sink):
    """The layered render on every rank of the axis (JAX
    `rasterize_layered`). Same return as `dist_fused.rasterize_fused_dist`:
    (img, t_img, n_intersections, means2d, radii, depths), the per-gaussian
    tensors in input order, all alike on every rank."""
    n_dev, rows_per, ntl, I_s, N_blk, n_local, k_smp = plan
    group, s = mesh.group(shard_axis), mesh.index(shard_axis)
    dev = means.device
    N = means.shape[0]
    nw = NUM_GEOM + c_total
    num_tiles = config.tiles_x * config.tiles_y
    L = n_dev * N_blk
    sb = slot_bits(I_s)

    # every rank holds the inputs alike: their cotangents (the camera's too)
    # are averaged over the group
    *inputs, viewmat, K = replicated(means, quats, scales, opacities, colors, tap2d, sink,
                                     viewmat, K, group=group)
    # home s holds the input rows s, s + n, ... (spatially well mixed)
    mns, qts, scl, opc, cls, tap, snk = (x[s::n_dev] for x in inputs)
    proj = project_gaussians(
        mns, qts, scl, viewmat, K, config.width, config.height,
        near_plane=config.near_plane, far_plane=config.far_plane,
        antialiased=(config.rasterize_mode == "antialiased"))
    m2d = proj.means2d + tap
    op_eff = opc * proj.compensations
    cols_full = cls
    if config.with_depth:
        cols_full = torch.cat([cols_full, proj.depths[:, None]], dim=-1)
    live = proj.valid & (op_eff.detach() > 0)
    with torch.no_grad():
        packed, counts = tile_spans(
            m2d.detach(), proj.radii, live, width=config.width, height=config.height,
            tile_size=config.tile_size, conics=proj.conics.detach(), op_eff=op_eff.detach())
    table = torch.cat([m2d, proj.conics, op_eff[:, None], cols_full], dim=-1)

    # ---- the home's depth sort (pair-less rows last) ----
    # local row i is global row i n + s, so local order is global order and
    # the stable sort reproduces the single-rank (depth, index) order
    depth_key = torch.where(counts > 0, proj.depths.detach(),
                            torch.full_like(proj.depths, float("inf")))
    gid = (torch.arange(n_local, device=dev) * n_dev + s).to(torch.float32)
    perm = torch.sort(depth_key, stable=True).indices
    dk_s = depth_key[perm]
    hc_s = torch.cat([dk_s[None], gid[perm][None], table[perm].T, snk[perm].T])  # [w_ex, n_local]
    packed_s, counts_s = packed[perm], counts[perm]

    # ---- the splitters: depth quantiles of every home ----
    n_live = torch.searchsorted(dk_s, torch.tensor([float("inf")], device=dev))
    pos = torch.clamp(torch.arange(k_smp, device=dev) * torch.clamp(n_live, min=1) // k_smp,
                      0, n_local - 1)
    smp = torch.where(n_live > 0, dk_s[pos], float("inf"))
    all_smp = torch.sort(all_gather(smp, group)).values                    # [n k]
    q = all_smp[torch.arange(1, n_dev, device=dev) * k_smp]
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.searchsorted(dk_s, q), n_live]).to(torch.int32)
    needed = bounds[1:] - bounds[:-1]
    row_over = torch.clamp(needed.max() - N_blk, min=0).reshape(1)

    # ---- fixed row blocks -> one all_to_all (dead lanes: depth +inf) ----
    send_f, live_b = _blocks(hc_s, bounds, needed, N_blk, 0.0)          # [n, w_ex, N_blk]
    send_f = torch.cat([torch.where(live_b, send_f[:, 0], float("inf"))[:, None],
                        send_f[:, 1:]], dim=1)
    send_p, _ = _blocks(packed_s, bounds, needed, N_blk, 0)
    send_c, _ = _blocks(counts_s, bounds, needed, N_blk, 0)
    recv_f = all_to_all(send_f, group)
    recv_p = all_to_all(send_p, group).reshape(L)
    recv_c = all_to_all(send_c, group).reshape(L)

    # ---- the slab's merge by (depth, global index) ----
    flat = recv_f.permute(1, 0, 2).reshape(-1, L)
    merge = lexsort(flat[0].detach(), flat[1].detach())
    cols_m = flat[2:, merge]
    packed_m, counts_m = recv_p[merge], recv_c[merge]

    # ---- the unchanged single-rank pipeline at I / n ----
    attrs, key, total_own = _SlabExpand.apply(
        I_s, config.tiles_x, num_tiles, cols_m[:nw], cols_m[nw:nw + 2], packed_m, counts_m)
    key_s, order = torch.sort(key)
    slab = attrs[:nw][:, order]
    q_t = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) << sb
    ranges = window_ranges(torch.searchsorted(key_s, q_t, out_int32=True))
    slab_t = F.pad(slab, (0, padded_capacity(I_s) - I_s, 0, round8(nw) - nw)).contiguous()
    rgb, tfin = _Blend.apply(config, slab_t, *ranges, c_total, 0)

    # ---- the ordered composite of the layers, a tile-row band a rank ----
    T_pad = n_dev * ntl
    PIX = config.tile_size * config.tile_size
    rgb_p = F.pad(rgb, (0, 0, 0, 0, 0, T_pad - num_tiles))
    t_p = F.pad(tfin, (0, 0, 0, T_pad - num_tiles), value=1.0)  # pad tiles: identity
    rgb_bands = all_to_all(rgb_p.reshape(n_dev, ntl, c_total, PIX), group)
    t_bands = all_to_all(t_p.reshape(n_dev, ntl, PIX), group)
    rgb_band, t_band = _Composite.apply(rgb_bands, t_bands)

    ts = config.tile_size
    img = rgb_band.reshape(rows_per, config.tiles_x, c_total, ts, ts).permute(0, 3, 1, 4, 2)
    img = img.reshape(rows_per * ts, config.tiles_x * ts, c_total)
    t_img = t_band.reshape(rows_per, config.tiles_x, ts, ts).permute(0, 2, 1, 3)
    t_img = t_img.reshape(rows_per * ts, config.tiles_x * ts)

    # capacity pressure: the slab's expansion (I_s), and the row blocks
    # (N_blk: an overflow there is signalled as saturated, I + 1)
    n_own, over = pmax([total_own, row_over.to(torch.int32)], group)
    I = config.max_intersections
    n_isect = torch.maximum(n_own * n_dev, torch.where(over > 0, I + 1, 0).to(torch.int32))

    def unstride(x):  # gathered home blocks [n, n_local, ...] -> input order
        g = all_gather(x, group)
        return g.reshape(n_dev, n_local, *x.shape[1:]).transpose(0, 1).reshape(N, *x.shape[1:])

    return (all_gather(img, group), all_gather(t_img, group), n_isect,
            unstride(m2d), unstride(proj.radii), unstride(proj.depths))
