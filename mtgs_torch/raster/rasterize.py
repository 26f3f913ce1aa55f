"""Differentiable rasterization API: the fused and the classic branch.

Port of `mtgs_tpu/raster/rasterize.py::rasterize` (:673-702, :791-896).
Both branches run projection -> tile spans -> depth sort -> pair
expansion -> pair sort by (tile, depth) -> per-tile ranges -> forward
blend (`blend_forward`) -> image assembly and ED normalisation. They
differ in how the attributes reach the blend's slab:

* fused (:791-869, the default where `fused_fits` holds): `expand_fused`
  writes each slot's sort key, owner and attribute columns in one pass,
  and the tile-sorted slab is a column gather of them;
* classic (:870-896, where `config.fused` is False or the int32 key
  packing `((num_tiles + 1) << slot_bits(I)) + I < 2^31` fails, as at
  1920x1080 or past the trainer's second capacity growth at 960x540):
  `binning.bin_gaussians` (with `expand_pairs`) gives each tile-sorted
  slot its depth-sorted owner `gidx`, and the slab is the gathered
  table rows turned attribute-major (`rows_to_attr_major`).

The JAX package moves attributes through its sorts as payload operands
because random gathers are slow on a TPU; here the sorts are
`torch.sort` and the permutations are gathers.

Gradients. Fused: one `torch.autograd.Function` spans the depth sort,
the expansion, the pair sort and the blend; its backward is the JAX
`_gather_fused_bwd` (:473-511): the backward blend (`blend_backward`),
the gradient rows back to slot order, two |g_mx|, |g_my| rows appended
(the absgrad densify signal), a per-gaussian `dense_segment_sum` keyed by
the slot owners, and the depth permutation undone. Classic: two
Functions, `_Blend` (JAX `_blend`, :93-152) and `_GatherIntersections`
(JAX `_gather_intersections`, :168-253, its TPU branch): the slab
gradient's columns sorted stably by `gidx` (dead slots keyed to the
sentinel), the absgrad rows appended, `dense_segment_sum`,
`attr_major_to_rows` and the depth permutation undone. Binning and the
sorts are index math and run under `torch.no_grad()`, at the JAX
package's stop-gradient points. Extras beyond gsplat's signature, as in
JAX:

* `tap2d`: an [N, 2] tensor added to the projected 2D means; its
  gradient is the screen-space means2d gradient.
* `absgrad_sink`: an [N, 2] tensor the forward ignores; its gradient is
  the sum over tiles of |per-tile means2d gradient| (gsplat's `absgrad`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from mtgs_torch.raster.binning import bin_gaussians, padded_capacity, tile_spans, window_ranges
from mtgs_torch.raster.blend import (
    attr_major_to_rows, blend_backward, blend_forward, rows_to_attr_major,
)
from mtgs_torch.raster.chunk_math import MAX_CH, NUM_GEOM, round8
from mtgs_torch.raster.expand_fused import expand_fused, fused_fits, slot_bits
from mtgs_torch.raster.projection import project_gaussians
from mtgs_torch.raster.segment_sum import dense_segment_sum


@dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterization settings."""

    width: int
    height: int
    tile_size: int = 32
    near_plane: float = 0.01
    far_plane: float = 1e10
    rasterize_mode: str = "classic"      # "classic" | "antialiased"
    render_mode: str = "RGB"             # "RGB" | "RGB+D" | "RGB+ED" | "D" | "ED"
    max_intersections: int = 1 << 20
    fused: bool = True                   # False: the classic path everywhere

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size)

    @property
    def with_depth(self) -> bool:
        return "D" in self.render_mode


def _depth_sort(table, packed_in, counts_in, depths):
    """The fused gather's first stage: perm [n] (the depth order), the
    depth-sorted packed spans and exclusive pair offsets [n], the pair
    total (1-element, untruncated) and the depth-sorted attribute-major
    table [nw, n]."""
    # stable sort == the JAX (depth_key, iota) two-key sort; zero-pair
    # gaussians go last so every sorted index < n_live owns >= 1 pair
    depth_key = torch.where(counts_in > 0, depths, torch.full_like(depths, float("inf")))
    perm = torch.sort(depth_key, stable=True).indices
    packed = packed_in[perm]
    counts = counts_in[perm]
    csum = torch.cumsum(counts, dim=0, dtype=torch.int64)
    offsets = (csum - counts).to(torch.int32)
    total = csum[-1:].to(torch.int32)
    table_am = table[perm].T.contiguous()  # [nw, n] depth-sorted
    return perm, packed, offsets, total, table_am


def _pair_sort(key, attrs, max_intersections: int):
    """The fused gather's last stage: the expansion's slots sorted by key
    (tile, then depth). Returns key_s [I], order [I] (the slot of each
    sorted position) and the tile-sorted slab [round8(nw), cap]."""
    I = max_intersections
    # keys are unique (the slot is in the low bits): any sort is exact
    key_s, order = torch.sort(key)
    slab_t = torch.zeros((attrs.shape[0], padded_capacity(I)), dtype=torch.float32,
                         device=attrs.device)
    slab_t[:, :I] = attrs[:, order]
    return key_s, order, slab_t


def _gather_fused_fwd(config: RasterizeConfig, table, packed_in, counts_in, depths):
    """Depth sort, pair expansion and pair sort. Returns a dict: slab_t
    [W8, cap] tile-sorted, key_s [I] sorted keys, order [I] (the slot of
    each sorted position), src [I] (each slot's owner in depth order),
    perm [n] (the depth order) and total (1-element, untruncated)."""
    I = config.max_intersections
    perm, packed, offsets, total, table_am = _depth_sort(table, packed_in, counts_in, depths)
    key, src, attrs = expand_fused(table_am, offsets, packed, total, I,
                                   tiles_x=config.tiles_x,
                                   num_tiles=config.tiles_x * config.tiles_y)
    key_s, order, slab_t = _pair_sort(key, attrs, I)
    return dict(slab_t=slab_t, key_s=key_s, order=order, src=src, perm=perm, total=total)


def _tile_ranges(key_s, num_tiles: int, max_intersections: int):
    """Per-tile (offsets, heads, counts, nchunks) of the tile-sorted keys,
    in the JAX package's 128-aligned window convention."""
    q = torch.arange(num_tiles + 1, dtype=torch.int32, device=key_s.device)
    q = q << slot_bits(max_intersections)
    return window_ranges(torch.searchsorted(key_s, q, out_int32=True))


class _FusedRasterize(torch.autograd.Function):
    """table [n, 6 + c_total] (means2d, conic, opacity, colours) -> the
    tile-major blend (rgb_tiles [T, c_total, PIX], t_final [T, PIX]) and
    the pair count; differentiable in `table` and `sink` (absgrad)."""

    @staticmethod
    def forward(ctx, config, table, packed_in, counts_in, depths, sink):
        c_total = table.shape[1] - NUM_GEOM
        num_tiles = config.tiles_x * config.tiles_y
        g = _gather_fused_fwd(config, table, packed_in, counts_in, depths)
        ranges = _tile_ranges(g["key_s"], num_tiles, config.max_intersections)
        rgb_tiles, t_final = blend_forward(
            g["slab_t"], *ranges, tile_size=config.tile_size, tiles_x=config.tiles_x,
            c_total=c_total, tile_base=0)
        ctx.config = config
        ctx.save_for_backward(g["key_s"], g["order"], g["src"], g["perm"], g["slab_t"],
                              *ranges, rgb_tiles, t_final, g["total"])
        ctx.mark_non_differentiable(g["total"])
        return rgb_tiles, t_final, g["total"]

    @staticmethod
    def backward(ctx, g_rgb, g_t, _):
        config = ctx.config
        key_s, order, src, perm, slab_t, *rest = ctx.saved_tensors
        ranges, (rgb_tiles, t_final, total) = rest[:4], rest[4:]
        n = perm.shape[0]
        c_total = rgb_tiles.shape[1]
        nw = NUM_GEOM + c_total
        I = config.max_intersections
        g_slab = blend_backward(
            slab_t, *ranges, rgb_tiles, t_final, g_rgb.contiguous(), g_t.contiguous(),
            tile_size=config.tile_size, tiles_x=config.tiles_x, c_total=c_total)
        # back to depth-slot order (`order` is a permutation of the I slots,
        # so every column is written), plus the absgrad rows |g_mx|, |g_my|
        rows = torch.empty((nw + 2, I), dtype=torch.float32, device=slab_t.device)
        rows[:nw, order] = g_slab[:nw, :I]
        rows[nw:nw + 2] = rows[:2].abs()
        # dead slots (slot >= total) hold zero rows: key them to the sentinel
        slot = torch.arange(I, dtype=torch.int32, device=src.device)
        src = torch.where(slot < total, src, torch.full_like(src, n))
        sums = dense_segment_sum(rows, src, n)[:nw + 2, :n]
        # depth order -> input order
        out = torch.empty((n, nw + 2), dtype=torch.float32, device=sums.device)
        out[perm] = sums.T
        return None, out[:, :nw], None, None, None, out[:, nw:]


class _GatherIntersections(torch.autograd.Function):
    """table [n, nw] -> the classic slab [round8(nw), cap]: column s holds
    the table row of input gaussian perm[gidx[s]] (zeros for the sentinel
    n). Differentiable in `table` and `sink` (absgrad)."""

    @staticmethod
    def forward(ctx, table, perm, inv_perm, gidx, total, sink):
        table_pad = torch.cat([table[perm], table.new_zeros((1, table.shape[1]))])
        slab_t = rows_to_attr_major(table_pad[gidx])
        ctx.save_for_backward(inv_perm, gidx, total)
        ctx.nw = table.shape[1]
        return slab_t

    @staticmethod
    def backward(ctx, g_slab):
        inv_perm, gidx, total = ctx.saved_tensors
        nw, n = ctx.nw, inv_perm.shape[0]
        # dead slots (total <= s < I) own gaussian n-1 but hold zero rows,
        # outside every tile's range: keyed to the sentinel, whose column
        # the segment sum writes without reading them (keyed to n-1, their
        # run, most of the buffer, would fall to one thread)
        slot = torch.arange(gidx.shape[0], dtype=torch.int32, device=gidx.device)
        key = torch.where(slot < total, gidx, torch.full_like(gidx, n))
        # each gaussian's slots made contiguous, in tile order (the stable
        # sort keeps the f32 sums' order fixed)
        key_s, order = torch.sort(key, stable=True)
        rows = g_slab.new_zeros((round8(nw + 2), gidx.shape[0]))
        rows[:nw] = g_slab[:nw, order]
        rows[nw:nw + 2] = rows[:2].abs()
        seg = attr_major_to_rows(dense_segment_sum(rows, key_s, n))[inv_perm]
        return seg[:, :nw], None, None, None, None, seg[:, nw:nw + 2]


class _Blend(torch.autograd.Function):
    """The blend of a tile-sorted slab over per-tile ranges: (rgb_tiles
    [T, c_total, PIX], t_final [T, PIX]); differentiable in the slab."""

    @staticmethod
    def forward(ctx, config, slab_t, offsets, heads, counts, nchunks, c_total):
        rgb_tiles, t_final = blend_forward(
            slab_t, offsets, heads, counts, nchunks, tile_size=config.tile_size,
            tiles_x=config.tiles_x, c_total=c_total)
        ctx.config, ctx.c_total = config, c_total
        ctx.save_for_backward(slab_t, offsets, heads, counts, nchunks, rgb_tiles, t_final)
        return rgb_tiles, t_final

    @staticmethod
    def backward(ctx, g_rgb, g_t):
        config = ctx.config
        g_slab = blend_backward(
            *ctx.saved_tensors, g_rgb.contiguous(), g_t.contiguous(),
            tile_size=config.tile_size, tiles_x=config.tiles_x, c_total=ctx.c_total)
        return None, g_slab, None, None, None, None, None


def rasterize(means, quats, scales, opacities, colors, viewmat, K,
              config: RasterizeConfig, *, tap2d=None,
              absgrad_sink=None) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Render one view of a set of 3D gaussians.

    Args: means [N, 3], quats [N, 4] wxyz, scales [N, 3] linear,
    opacities [N] in [0, 1], colors [N, C] (C <= 7, SH already evaluated),
    viewmat [4, 4] cv world-to-camera, K [3, 3]; all on one device.
    tap2d / absgrad_sink: optional [N, 2] gradient taps (module docstring).

    Returns render [H, W, C(+1 with depth)] (ED mode's last channel is
    alpha-normalised expected depth), alpha [H, W, 1], and info with
    means2d (tapped), radii, depths, compensations (no gradient) and
    n_intersections (a 1-element int32 tensor; above
    config.max_intersections the farthest pairs were dropped).
    """
    N = means.shape[0]
    C = colors.shape[-1]
    if C + int(config.with_depth) > MAX_CH:
        raise ValueError(f"too many channels: {C} (+depth) > {MAX_CH}")
    num_tiles = config.tiles_x * config.tiles_y
    use_fused = config.fused and fused_fits(config.max_intersections, num_tiles, N)

    proj = project_gaussians(
        means, quats, scales, viewmat, K, config.width, config.height,
        near_plane=config.near_plane, far_plane=config.far_plane,
        antialiased=(config.rasterize_mode == "antialiased"),
    )
    means2d = proj.means2d if tap2d is None else proj.means2d + tap2d
    op_eff = opacities * proj.compensations
    cols = colors
    if config.with_depth:
        cols = torch.cat([cols, proj.depths[:, None]], dim=-1)
    c_total = cols.shape[-1]

    table = torch.cat([means2d, proj.conics, op_eff[:, None], cols], dim=-1)
    sink = absgrad_sink if absgrad_sink is not None else table.new_zeros((N, 2))
    span_args = (means2d.detach(), proj.radii)
    span_kw = dict(width=config.width, height=config.height, tile_size=config.tile_size,
                   conics=proj.conics.detach(), op_eff=op_eff.detach())
    # zero-opacity rows (gated-out nodes, padded capacity) never contribute
    live = proj.valid & (op_eff.detach() > 0)
    if use_fused:
        with torch.no_grad():
            packed_in, counts_in = tile_spans(*span_args, live, **span_kw)
        rgb_tiles, t_final, n_isect = _FusedRasterize.apply(
            config, table, packed_in, counts_in, proj.depths.detach(), sink)
    else:
        b = bin_gaussians(*span_args, proj.depths.detach(), live,
                          max_intersections=config.max_intersections, **span_kw)
        slab_t = _GatherIntersections.apply(table, b.perm, b.inv_perm, b.gidx,
                                            b.n_intersections, sink)
        rgb_tiles, t_final = _Blend.apply(config, slab_t, b.tile_offsets, b.tile_heads,
                                          b.tile_counts, b.tile_nchunks, c_total)
        n_isect = b.n_intersections

    render, alpha = _assemble_image(rgb_tiles, t_final, config, c_total)
    info = dict(
        means2d=means2d, radii=proj.radii, depths=proj.depths,
        n_intersections=n_isect, compensations=proj.compensations.detach(),
    )
    return render, alpha, info


def _assemble_image(rgb_tiles, t_final, config: RasterizeConfig, c_total: int):
    """Tile-major blend outputs -> (render [H, W, c], alpha [H, W, 1])."""
    ts = config.tile_size
    ty, tx = config.tiles_y, config.tiles_x
    img = rgb_tiles.reshape(ty, tx, c_total, ts, ts).permute(0, 3, 1, 4, 2)
    img = img.reshape(ty * ts, tx * ts, c_total)[: config.height, : config.width]
    t_img = t_final.reshape(ty, tx, ts, ts).permute(0, 2, 1, 3)
    t_img = t_img.reshape(ty * ts, tx * ts)[: config.height, : config.width]
    alpha = (1.0 - t_img)[..., None]
    return _finalize(img, alpha, config, c_total), alpha


def _finalize(accum, alpha, config: RasterizeConfig, c_total: int):
    """ED normalisation (gsplat: last channel / clamp(alpha, 1e-10))."""
    if config.render_mode.endswith("ED"):
        depth = accum[..., -1:] / torch.clamp(alpha, min=1e-10)
        return torch.cat([accum[..., : c_total - 1], depth], dim=-1)
    return accum[..., :c_total]
