"""Gaussian-ownership distributed rasterization; port of
`mtgs_tpu/raster/dist_fused.py`.

One view split over the n ranks of a mesh axis, with no table replicated
past projection:

* rank s owns the contiguous block of N/n gaussians [s N/n, (s+1) N/n):
  it projects them, computes their spans over the full image, depth-sorts
  them and expands their pairs with `expand_fused` (kernel 2), carrying
  two more attribute rows: the camera depth and the global input index;
* its pairs are grouped by destination tile-row band (one sort at I/n
  slots) into fixed blocks of I_blk pairs, and exchanged with one
  `all_to_all`;
* each band merges what it received by (tile, depth, global index) —
  the single-rank (tile, depth) order, ties broken as the stable sort
  breaks them — and blends its tiles (kernel 1) at its tile base;
* the band images are gathered on every rank.

The backward retraces the route through autograd: the blend's backward
(kernel 3), the merge's and the grouping's gathers undone, the reverse
`all_to_all`, and on the owner `dense_segment_sum` (kernel 4) per
gaussian and the depth order undone. The inputs' cotangents are averaged
over the group (`parallel/collectives.py::replicated`): every rank's
gradient is then the single-rank gradient.

Capacities (JAX's): I_s = I / n expansion slots per owner; I_blk =
roundup(I_s * slack / n, 128) per (owner, band) block, slack =
MTGS_BLK_SLACK (default 1.0: the n blocks of a band hold I_s pairs, the
band plan's capacity); I_recv = n I_blk merged per band. Overflow on any
leg shows in `n_intersections`, scaled to the global capacity, so the
trainer's growth reacts as on one rank. MTGS_DIST: "auto" (the default)
from 8 ranks, "1" forces the plan, "0" turns it off.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mtgs_torch.parallel.collectives import all_gather, all_to_all, pmax, replicated
from mtgs_torch.raster.binning import padded_capacity, tile_spans, window_ranges
from mtgs_torch.raster.chunk_math import NUM_GEOM, round8
from mtgs_torch.raster.expand_fused import expand_fused, fused_fits, slot_bits
from mtgs_torch.raster.projection import project_gaussians
from mtgs_torch.raster.rasterize import _Blend
from mtgs_torch.raster.segment_sum import dense_segment_sum


class DistPlan(NamedTuple):
    n_dev: int
    rows_per: int      # tile rows per band
    ntl: int           # tiles per band (rows_per * tiles_x)
    I_s: int           # per-owner expansion capacity
    I_blk: int         # per (owner, band) all_to_all block
    n_local: int       # gaussians per owner


def dist_shard_plan(config, n_dev: int, n_gauss: int):
    """The plan of the ownership pipeline (JAX `dist_shard_plan`), or None
    when it is off (MTGS_DIST "0", or "auto" below 8 ranks) or the shapes
    do not divide (N % n, I % n, (I / n) % 512, the fused gate)."""
    dist_env = os.environ.get("MTGS_DIST", "auto")
    if n_dev <= 1 or dist_env == "0":
        return None
    # "auto": the ownership plan carries two more capacity-sized sorts than
    # the band plan (the band grouping and the merge), which pays from
    # about 8 ranks; MTGS_DIST=1 forces it below
    if dist_env == "auto" and n_dev < 8:
        return None
    I = config.max_intersections
    if n_gauss % n_dev or I % n_dev or n_gauss >= (1 << 24):
        return None
    I_s = I // n_dev
    if I_s % 512:
        return None
    rows_per = -(-config.tiles_y // n_dev)
    ntl = rows_per * config.tiles_x
    n_local = n_gauss // n_dev
    if not fused_fits(I_s, n_dev * ntl, max(n_local, 2)):
        return None
    slack = float(os.environ.get("MTGS_BLK_SLACK", "1.0"))
    I_blk = min(I_s, ((int(I_s * slack) // n_dev + 127) // 128) * 128)
    if I_blk < 128:
        return None
    return DistPlan(n_dev, rows_per, ntl, I_s, I_blk, n_local)


class _DistExpand(torch.autograd.Function):
    """The owner's expansion (JAX `_dist_expand`): table [n, nw] ->
    attrs [round8(nw + 2), I_s] in depth-slot order (the table's rows, then
    the camera depth and the global input index gidx0 + i), key [I_s]
    (global tile << slot bits | slot), src [I_s] and the pair total.
    Differentiable in `table` and `sink` (absgrad)."""

    @staticmethod
    def forward(ctx, plan: DistPlan, ntp: int, tiles_x: int, table, packed, counts, depths,
                sink, gidx0: int):
        n, nw = table.shape
        depth_key = torch.where(counts > 0, depths, torch.full_like(depths, float("inf")))
        perm = torch.sort(depth_key, stable=True).indices
        packed_s, counts_s = packed[perm], counts[perm]
        csum = torch.cumsum(counts_s, dim=0, dtype=torch.int64)
        offsets = (csum - counts_s).to(torch.int32)
        total = csum[-1:].to(torch.int32)
        # two metadata rows ride the copy: the camera depth (0 where the
        # gaussian has no pair) and the global index (exact in f32: N < 2^24)
        tab = torch.cat([table[perm].T,
                         torch.where(counts_s > 0, depth_key[perm], 0.0)[None],
                         (gidx0 + perm).to(torch.float32)[None]]).contiguous()
        key, src, attrs = expand_fused(tab, offsets, packed_s, total, plan.I_s,
                                       tiles_x=tiles_x, num_tiles=ntp)
        ctx.nw = nw
        ctx.save_for_backward(perm, src, total)
        ctx.mark_non_differentiable(key, src, total)
        return attrs, key, src, total

    @staticmethod
    def backward(ctx, g_attrs, _k, _s, _t):
        perm, src, total = ctx.saved_tensors
        nw, n, I = ctx.nw, perm.shape[0], src.shape[0]
        rows = g_attrs.new_zeros((round8(nw + 2), I))
        rows[:nw] = g_attrs[:nw]
        rows[nw:nw + 2] = g_attrs[:2].abs()
        # dead slots (slot >= total) hold zero rows: keyed to the sentinel
        slot = torch.arange(I, dtype=torch.int32, device=src.device)
        src = torch.where(slot < total, src, torch.full_like(src, n))
        sums = dense_segment_sum(rows, src, n)[:nw + 2, :n]
        out = torch.empty((n, nw + 2), dtype=torch.float32, device=sums.device)
        out[perm] = sums.T
        return None, None, None, out[:, :nw], None, None, None, out[:, nw:], None


def lexsort(*keys) -> torch.Tensor:
    """The permutation that sorts by keys[0], then keys[1], ... (ties in
    index order): stable sorts from the last key to the first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def rasterize_fused_dist(config, mesh, shard_axis: str, plan: DistPlan, c_total: int,
                         means, quats, scales, opacities, colors, viewmat, K, tap2d, sink):
    """The ownership render on every rank of the axis (JAX
    `rasterize_fused_dist`, and `rasterize_fused_dist_inside` under a 2D
    mesh: here one body serves both). Returns (img [n rows_per ts,
    tiles_x ts, c_total], t_img, n_intersections, means2d, radii, depths),
    the per-gaussian tensors in input order, all alike on every rank."""
    n_dev, rows_per, ntl, I_s, I_blk, n_local = plan
    group, s = mesh.group(shard_axis), mesh.index(shard_axis)
    dev = means.device
    nw = NUM_GEOM + c_total
    nw_ext = nw + 2
    sb = slot_bits(I_s)
    ntp = n_dev * ntl
    I_recv = n_dev * I_blk
    sentinel = (ntp << sb) | (I_s - 1)

    # every rank holds the inputs alike: their cotangents (the camera's too)
    # are averaged over the group
    *inputs, viewmat, K = replicated(means, quats, scales, opacities, colors, tap2d, sink,
                                     viewmat, K, group=group)
    mns, qts, scl, opc, cls, tap, snk = (x[s * n_local:(s + 1) * n_local] for x in inputs)
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
    attrs, key, _, total_own = _DistExpand.apply(
        plan, ntp, config.tiles_x, table, packed, counts, proj.depths.detach(), snk,
        s * n_local)

    # ---- group the pairs by destination band (one I_s-sized sort) ----
    key_s, order = torch.sort(key)
    cols_sorted = attrs[:nw_ext][:, order]
    band_q = (torch.arange(n_dev + 1, dtype=torch.int32, device=dev) * ntl) << sb
    bounds = torch.searchsorted(key_s, band_q, out_int32=True)
    needed = bounds[1:] - bounds[:-1]
    # fixed blocks: band b's run from bounds[b], lanes past its length masked
    # (key -> sentinel, columns -> exact zero: no value forward, no cotangent)
    lanes = torch.arange(I_blk, dtype=torch.int32, device=dev)
    idx = (bounds[:-1, None] + lanes).long()                     # [n, I_blk]
    live_b = lanes < torch.clamp(needed, max=I_blk)[:, None]
    cols_pad = F.pad(cols_sorted, (0, I_blk))
    key_pad = F.pad(key_s, (0, I_blk), value=sentinel)
    send_cols = torch.where(live_b, cols_pad[:, idx], 0.0).permute(1, 0, 2).contiguous()
    send_keys = torch.where(live_b, key_pad[idx], sentinel)
    recv_cols = all_to_all(send_cols, group)                     # [n, nw_ext, I_blk]
    recv_keys = all_to_all(send_keys, group)

    # ---- the band's merge: (tile, depth, global index) ----
    flat_cols = recv_cols.permute(1, 0, 2).reshape(nw_ext, I_recv)
    tile_g = recv_keys.reshape(I_recv) >> sb
    merge = lexsort(tile_g, flat_cols[nw].detach(), flat_cols[nw + 1].detach())
    merged = flat_cols[:nw, merge]
    base_tile = s * ntl
    q = base_tile + torch.arange(ntl + 1, dtype=torch.int32, device=dev)
    ranges = window_ranges(torch.searchsorted(tile_g[merge].contiguous(), q, out_int32=True))
    slab_t = F.pad(merged, (0, padded_capacity(I_recv) - I_recv, 0, round8(nw) - nw))
    rgb, tfin = _Blend.apply(config, slab_t.contiguous(), *ranges, c_total, base_tile)

    # ---- this band's image rows, gathered on every rank ----
    ts = config.tile_size
    img = rgb.reshape(rows_per, config.tiles_x, c_total, ts, ts).permute(0, 3, 1, 4, 2)
    img = img.reshape(rows_per * ts, config.tiles_x * ts, c_total)
    t_img = tfin.reshape(rows_per, config.tiles_x, ts, ts).permute(0, 2, 1, 3)
    t_img = t_img.reshape(rows_per * ts, config.tiles_x * ts)
    # capacity pressure, scaled to the global capacity: the owner's
    # expansion (I_s) or an exchange block (I_blk), whichever fills first
    n_own, blk_max = pmax([total_own, needed.max().reshape(1)], group)
    I = config.max_intersections
    n_isect = torch.maximum(n_own * n_dev,
                            (blk_max.to(torch.float32) * (I / I_blk)).to(torch.int32))
    return (all_gather(img, group), all_gather(t_img, group), n_isect,
            all_gather(m2d, group), all_gather(proj.radii, group),
            all_gather(proj.depths, group))
