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

Sharded rendering (`mesh=`, JAX :694-830, :897-923): one view's pipeline
split over the ranks of a mesh axis, each rank a process
(`mtgs_torch.parallel`). The pipeline is chosen as JAX chooses it, by the
same plan functions and environment variables: the depth-slab layered
plan (`layered_dist.py`, MTGS_LAYERED=1 only), the gaussian-ownership plan
(`dist_fused.py`, MTGS_DIST), the tile-row band plan (`_fused_shard_plan`:
each rank runs the fused pipeline on its band's pairs at I/n slots), and
on the classic path the blend alone sharded over tiles against a slab
every rank builds; else the view renders unsharded, with a warning once
per shape. Every rank returns the full image and info, alike. The
backward takes the loss as every rank computes it, alike, and gives every
rank the single-rank gradients (`parallel/collectives.py`: `replicated`).
"""

from __future__ import annotations

import logging
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

_LOG = logging.getLogger(__name__)
_UNSHARDED_WARNED: set = set()


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


@dataclass(frozen=True)
class FusedStatics:
    """The fused pipeline's static shape over one range of tiles (JAX
    `_FusedStatics` and `_BlendStatics`): the whole image, or one tile-row
    band of a sharded render, whose tiles start at global tile
    `tile_base`."""

    max_intersections: int
    num_tiles: int
    tiles_x: int
    tile_size: int
    tile_base: int = 0

    @classmethod
    def of(cls, config: RasterizeConfig) -> "FusedStatics":
        """The whole image of `config`."""
        return cls(config.max_intersections, config.tiles_x * config.tiles_y, config.tiles_x,
                   config.tile_size)


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


def _gather_fused_fwd(st: FusedStatics, table, packed_in, counts_in, depths):
    """Depth sort, pair expansion and pair sort. Returns a dict: slab_t
    [W8, cap] tile-sorted, key_s [I] sorted keys, order [I] (the slot of
    each sorted position), src [I] (each slot's owner in depth order),
    perm [n] (the depth order) and total (1-element, untruncated)."""
    I = st.max_intersections
    perm, packed, offsets, total, table_am = _depth_sort(table, packed_in, counts_in, depths)
    key, src, attrs = expand_fused(table_am, offsets, packed, total, I,
                                   tiles_x=st.tiles_x, num_tiles=st.num_tiles)
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
    tile-major blend of the statics' tiles (rgb_tiles [T, c_total, PIX],
    t_final [T, PIX]) and the pair count; differentiable in `table` and
    `sink` (absgrad)."""

    @staticmethod
    def forward(ctx, st: FusedStatics, table, packed_in, counts_in, depths, sink):
        c_total = table.shape[1] - NUM_GEOM
        g = _gather_fused_fwd(st, table, packed_in, counts_in, depths)
        ranges = _tile_ranges(g["key_s"], st.num_tiles, st.max_intersections)
        rgb_tiles, t_final = blend_forward(
            g["slab_t"], *ranges, tile_size=st.tile_size, tiles_x=st.tiles_x,
            c_total=c_total, tile_base=st.tile_base)
        ctx.st = st
        ctx.save_for_backward(g["key_s"], g["order"], g["src"], g["perm"], g["slab_t"],
                              *ranges, rgb_tiles, t_final, g["total"])
        ctx.mark_non_differentiable(g["total"])
        return rgb_tiles, t_final, g["total"]

    @staticmethod
    def backward(ctx, g_rgb, g_t, _):
        st = ctx.st
        key_s, order, src, perm, slab_t, *rest = ctx.saved_tensors
        ranges, (rgb_tiles, t_final, total) = rest[:4], rest[4:]
        n = perm.shape[0]
        c_total = rgb_tiles.shape[1]
        nw = NUM_GEOM + c_total
        I = st.max_intersections
        g_slab = blend_backward(
            slab_t, *ranges, rgb_tiles, t_final, g_rgb.contiguous(), g_t.contiguous(),
            tile_size=st.tile_size, tiles_x=st.tiles_x, c_total=c_total,
            tile_base=st.tile_base)
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
    def forward(ctx, config, slab_t, offsets, heads, counts, nchunks, c_total, tile_base=0):
        rgb_tiles, t_final = blend_forward(
            slab_t, offsets, heads, counts, nchunks, tile_size=config.tile_size,
            tiles_x=config.tiles_x, c_total=c_total, tile_base=tile_base)
        ctx.config, ctx.c_total, ctx.tile_base = config, c_total, tile_base
        ctx.save_for_backward(slab_t, offsets, heads, counts, nchunks, rgb_tiles, t_final)
        return rgb_tiles, t_final

    @staticmethod
    def backward(ctx, g_rgb, g_t):
        config = ctx.config
        g_slab = blend_backward(
            *ctx.saved_tensors, g_rgb.contiguous(), g_t.contiguous(),
            tile_size=config.tile_size, tiles_x=config.tiles_x, c_total=ctx.c_total,
            tile_base=ctx.tile_base)
        return None, g_slab, None, None, None, None, None, None


def _fused_shard_plan(config: RasterizeConfig, n_dev: int, n_gauss: int):
    """The band plan's static shape (JAX `_fused_shard_plan`, :542-556):
    (tile rows per band, tiles per band, pair slots per band), or None
    where the capacity does not split (I % n_dev, (I / n_dev) % 512, the
    fused gate at I / n_dev)."""
    I = config.max_intersections
    if n_dev <= 1 or I % n_dev:
        return None
    I_s = I // n_dev
    rows_per = -(-config.tiles_y // n_dev)
    ntl = rows_per * config.tiles_x
    if I_s % 512 or not fused_fits(I_s, ntl, n_gauss):
        return None
    return rows_per, ntl, I_s


def _rasterize_fused_sharded(config: RasterizeConfig, mesh, shard_axis: str, plan,
                             means2d_sg, radii, conics, op_eff_sg, live, table, depths, sink):
    """The band plan (JAX `_rasterize_fused_sharded`, :559-609): rank s
    takes the spans of every gaussian clipped to its tile rows [s * rows,
    (s + 1) * rows), and depth-sorts, expands, pair-sorts and blends only
    that band's pairs, at I / n_dev slots and tile base s * tiles per band.
    The bands are gathered on every rank. The backward's table and sink
    cotangents are averaged over the group (`replicated`); the gather's
    backward is a psum_scatter. Returns (rgb_tiles, t_final) of the image's
    tiles and n_intersections: the fullest band's count scaled to the
    global capacity (each band truncates at I / n_dev on its own)."""
    from mtgs_torch.parallel.collectives import all_gather, pmax, replicated

    rows_per, ntl, I_s = plan
    group, s = mesh.group(shard_axis), mesh.index(shard_axis)
    n_dev = mesh.size(shard_axis)
    table, sink = replicated(table, sink, group=group)
    r0 = s * rows_per
    with torch.no_grad():
        packed, counts = tile_spans(
            means2d_sg, radii, live, width=config.width, height=config.height,
            tile_size=config.tile_size, conics=conics, op_eff=op_eff_sg,
            row_range=(r0, min(r0 + rows_per, config.tiles_y)))
    st = FusedStatics(I_s, ntl, config.tiles_x, config.tile_size, tile_base=s * ntl)
    rgb, tfin, n_is = _FusedRasterize.apply(st, table, packed, counts, depths, sink)
    num_tiles = config.tiles_x * config.tiles_y
    rgb_tiles = all_gather(rgb, group)[:num_tiles]
    t_final = all_gather(tfin, group)[:num_tiles]
    (n_max,) = pmax([n_is], group)
    return rgb_tiles, t_final, n_max * n_dev


def _blend_sharded(config: RasterizeConfig, mesh, shard_axis: str, slab_t, ranges,
                   c_total: int):
    """The classic path's blend-only sharding (JAX :897-923): the tiles,
    padded to a multiple of n_dev, split into n_dev contiguous blocks; rank
    s blends block s (tile base s * block) against the slab every rank
    holds, and the blocks are gathered on every rank."""
    from mtgs_torch.parallel.collectives import all_gather

    group, s = mesh.group(shard_axis), mesh.index(shard_axis)
    n_dev = mesh.size(shard_axis)
    T = ranges[0].shape[0]
    T_l = -(-T // n_dev)
    local = [torch.nn.functional.pad(r, (0, T_l * n_dev - T))[s * T_l:(s + 1) * T_l]
             for r in ranges]
    rgb, tfin = _Blend.apply(config, slab_t, *local, c_total, s * T_l)
    return all_gather(rgb, group)[:T], all_gather(tfin, group)[:T]


def _warn_unsharded(config: RasterizeConfig, mesh, shard_axis: str, n: int, use_fused: bool):
    """A mesh was given but no sharded plan applies: warn once per shape, so
    that a scaling run cannot measure the single-rank path unawares."""
    key = (config.max_intersections, config.width, config.height, mesh.shape[shard_axis], n)
    if key not in _UNSHARDED_WARNED:
        _UNSHARDED_WARNED.add(key)
        _LOG.warning(
            "rasterize: mesh(%s=%d) given but fused shard plan inactive "
            "(max_intersections=%d, fused=%s) — rendering without whole-pipeline tile "
            "sharding", shard_axis, mesh.shape[shard_axis], config.max_intersections,
            use_fused)


def rasterize(means, quats, scales, opacities, colors, viewmat, K,
              config: RasterizeConfig, *, tap2d=None, absgrad_sink=None, mesh=None,
              shard_axis: str = "data",
              inside_shard_map: bool = False) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Render one view of a set of 3D gaussians.

    Args: means [N, 3], quats [N, 4] wxyz, scales [N, 3] linear,
    opacities [N] in [0, 1], colors [N, C] (C <= 7, SH already evaluated),
    viewmat [4, 4] cv world-to-camera, K [3, 3]; all on one device.
    tap2d / absgrad_sink: optional [N, 2] gradient taps (module docstring).
    mesh / shard_axis: a `mtgs_torch.parallel.Mesh`; this view's pipeline
    is split over the ranks of `shard_axis`, every rank calling with the
    same inputs (module docstring). inside_shard_map: the call is one
    row's render inside a step over a 2D (data, tile) mesh
    (`parallel/mesh2d.py`; JAX's name): only the ownership plan or
    unsharded, as in JAX (:709-715, :771-775).

    Returns render [H, W, C(+1 with depth)] (ED mode's last channel is
    alpha-normalised expected depth), alpha [H, W, 1], and info with
    means2d (tapped), radii, depths, compensations (no gradient) and
    n_intersections (a 1-element int32 tensor; above
    config.max_intersections the farthest pairs were dropped; sharded,
    the fullest rank's load scaled to the global capacity).
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

    if mesh is not None and config.fused:
        # the depth-slab and the gaussian-ownership pipelines: every stage
        # is per rank, from projection on (they fall through when shapes
        # do not divide)
        from mtgs_torch.raster.dist_fused import dist_shard_plan, rasterize_fused_dist
        from mtgs_torch.raster.layered_dist import layered_shard_plan, rasterize_layered

        n_dev = mesh.size(shard_axis)
        lplan = None if inside_shard_map else layered_shard_plan(config, n_dev, N)
        dplan = None if lplan is not None else dist_shard_plan(config, n_dev, N)
        if lplan is not None or dplan is not None:
            tap = tap2d if tap2d is not None else means.new_zeros((N, 2))
            sink = absgrad_sink if absgrad_sink is not None else means.new_zeros((N, 2))
            run = rasterize_layered if lplan is not None else rasterize_fused_dist
            img_f, t_f, n_isect, m2d, radii, depths = run(
                config, mesh, shard_axis, lplan or dplan, c_total,
                means, quats, scales, opacities, colors, viewmat, K, tap, sink)
            t_img = t_f[: config.height, : config.width]
            alpha = (1.0 - t_img)[..., None]
            render = _finalize(img_f[: config.height, : config.width], alpha, config, c_total)
            info = dict(means2d=m2d, radii=radii, depths=depths, n_intersections=n_isect,
                        compensations=proj.compensations.detach())
            return render, alpha, info
    if inside_shard_map:
        # no ownership plan inside a 2D step: the row renders unsharded
        mesh = None

    table = torch.cat([means2d, proj.conics, op_eff[:, None], cols], dim=-1)
    sink = absgrad_sink if absgrad_sink is not None else table.new_zeros((N, 2))
    span_args = (means2d.detach(), proj.radii)
    span_kw = dict(width=config.width, height=config.height, tile_size=config.tile_size,
                   conics=proj.conics.detach(), op_eff=op_eff.detach())
    # zero-opacity rows (gated-out nodes, padded capacity) never contribute
    live = proj.valid & (op_eff.detach() > 0)
    shard_plan = None
    if mesh is not None:
        if use_fused:
            shard_plan = _fused_shard_plan(config, mesh.size(shard_axis), N)
        if shard_plan is None:
            _warn_unsharded(config, mesh, shard_axis, N, use_fused)
    if shard_plan is not None:
        rgb_tiles, t_final, n_isect = _rasterize_fused_sharded(
            config, mesh, shard_axis, shard_plan, *span_args, span_kw["conics"],
            span_kw["op_eff"], live, table, proj.depths.detach(), sink)
    elif use_fused:
        # (a mesh whose capacity split fails _fused_shard_plan renders unsharded)
        with torch.no_grad():
            packed_in, counts_in = tile_spans(*span_args, live, **span_kw)
        rgb_tiles, t_final, n_isect = _FusedRasterize.apply(
            FusedStatics.of(config), table, packed_in, counts_in, proj.depths.detach(), sink)
    else:
        b = bin_gaussians(*span_args, proj.depths.detach(), live,
                          max_intersections=config.max_intersections, **span_kw)
        if mesh is not None:
            from mtgs_torch.parallel.collectives import replicated

            table, sink = replicated(table, sink, group=mesh.group(shard_axis))
        slab_t = _GatherIntersections.apply(table, b.perm, b.inv_perm, b.gidx,
                                            b.n_intersections, sink)
        ranges = (b.tile_offsets, b.tile_heads, b.tile_counts, b.tile_nchunks)
        if mesh is None:
            rgb_tiles, t_final = _Blend.apply(config, slab_t, *ranges, c_total)
        else:
            rgb_tiles, t_final = _blend_sharded(config, mesh, shard_axis, slab_t, ranges,
                                                c_total)
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
