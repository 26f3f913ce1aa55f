"""Tile binning; port of `mtgs_tpu/raster/binning.py`.

`tile_spans` packs each gaussian's tile rectangle into one int32 word
(tmin_x | tmin_y << 11 | span_x << 22) plus a pair count. It is integer
math over f32 floor/ceil, so given identical inputs it matches the JAX
function exactly.

`bin_gaussians` builds the classic path's tile-sorted intersection lists:
spans -> stable depth sort -> pair expansion (`expand_pairs`, kernel 5)
-> stable sort by tile (depth order within each tile) -> per-tile ranges
in the blend's 128-aligned window convention. All of it is index math
and runs without autograd, where the JAX package stops gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mtgs_torch.raster.chunk_math import CHUNK
from mtgs_torch.raster.expand_pairs import expand_pairs


class BinnedIntersections(NamedTuple):
    """The tile-sorted intersection lists (JAX `BinnedIntersections`).

    perm [N] depth order of the input gaussians; inv_perm [N] its
    inverse; gidx [cap] the depth-sorted owner of each tile-sorted slot
    (slots past `total` own gaussian N-1 and sort past every tile's
    range; the capacity pad [I, cap) holds the sentinel N); tile_offsets,
    tile_heads, tile_counts, tile_nchunks [num_tiles] the blend's window
    ranges; pair_offsets, pair_counts [N] the exclusive pair prefix and
    the pair count per depth-sorted gaussian; n_intersections [1] the
    untruncated pair count. All int32.
    """

    perm: torch.Tensor
    inv_perm: torch.Tensor
    gidx: torch.Tensor
    tile_offsets: torch.Tensor
    tile_heads: torch.Tensor
    tile_counts: torch.Tensor
    tile_nchunks: torch.Tensor
    pair_offsets: torch.Tensor
    pair_counts: torch.Tensor
    n_intersections: torch.Tensor


def tile_spans(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    valid: torch.Tensor,
    *,
    width: int,
    height: int,
    tile_size: int,
    conics: torch.Tensor = None,
    op_eff: torch.Tensor = None,
    row_range=None,
):
    """(packed, counts) per gaussian, in input order.

    `row_range=(r0, r1)` (ints) clips the spans to tile rows [r0, r1) and
    packs tmin_y band-local (tmin_y - r0): the spans of one tile-row band
    of a sharded render (JAX `binning.tile_spans(row_range=)`). A band
    past the last tile row (r1 <= r0) has no pairs.

    With `conics` and `op_eff`, the circle AABB is intersected with the
    AABB of the exact alpha support {S <= ln(255 * op_eff)} (0.5 px + 1%
    margin), and gaussians with op_eff < 1/255 are dropped: both cuts are
    exact because the blend's contrib test is op_eff * exp(-S) >= 1/255.
    """
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    rf = radii.to(torch.float32)
    rx = ry = rf
    if conics is not None and op_eff is not None:
        a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
        det = torch.clamp(a * c - b * b, min=1e-24)
        s_cut = torch.log(torch.clamp(op_eff, min=1e-12) * 255.0) * 1.01
        pos = s_cut > 0.0

        def ext(diag):
            e = torch.sqrt(torch.clamp(2.0 * s_cut * diag / det, min=0.0)) + 0.5
            return torch.where(pos, e, torch.zeros_like(e))

        rx = torch.minimum(rf, ext(c))
        ry = torch.minimum(rf, ext(a))
    tmin_x = torch.clamp(torch.floor((means2d[:, 0] - rx) / tile_size), 0, tiles_x).to(torch.int32)
    tmax_x = torch.clamp(torch.ceil((means2d[:, 0] + rx) / tile_size), 0, tiles_x).to(torch.int32)
    tmin_y = torch.clamp(torch.floor((means2d[:, 1] - ry) / tile_size), 0, tiles_y).to(torch.int32)
    tmax_y = torch.clamp(torch.ceil((means2d[:, 1] + ry) / tile_size), 0, tiles_y).to(torch.int32)
    y_base = 0
    if row_range is not None:
        r0, r1 = int(row_range[0]), int(row_range[1])
        r1 = max(r0, r1)
        tmin_y = torch.clamp(tmin_y, r0, r1)
        tmax_y = torch.clamp(tmax_y, r0, r1)
        y_base = r0
    span_x = torch.clamp(tmax_x - tmin_x, 0, 255)
    span_y = torch.clamp(tmax_y - tmin_y, min=0)
    live = valid & (radii > 0)
    if op_eff is not None:
        live = live & (op_eff >= 1.0 / 255.0)
    counts = torch.where(live, span_x * span_y, torch.zeros_like(span_x)).to(torch.int32)
    packed = tmin_x | ((tmin_y - y_base) << 11) | (span_x << 22)
    return packed.to(torch.int32), counts


def padded_capacity(max_intersections: int) -> int:
    """Slab capacity: max_intersections plus one CHUNK of spill slack,
    rounded to 512 (the JAX slab's layout, kept at the function boundary)."""
    return ((max_intersections + CHUNK + 511) // 512) * 512


def window_ranges(bounds: torch.Tensor):
    """Per-tile (offsets, heads, counts, nchunks) from the tile-run
    boundaries `bounds` [num_tiles + 1] of a tile-sorted pair list: the
    128-aligned window start of each run, the run's first lane in it, its
    length and its window count (0 for an empty tile)."""
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    offsets = (starts // CHUNK) * CHUNK
    heads = starts - offsets
    nchunks = torch.where(counts > 0, (heads + counts + CHUNK - 1) // CHUNK,
                          torch.zeros_like(counts))
    return offsets, heads, counts, nchunks.to(torch.int32)


def searchsorted_expand(offsets, packed, total, max_intersections: int, *,
                        tiles_x: int, num_tiles: int):
    """(tile, src) per depth-order pair slot: the plain version of
    `expand_pairs` (JAX `binning.searchsorted_expand`). The owner of slot
    s is the last gaussian whose offset is <= s, clamped to [0, N-1]; its
    span word gives the slot's tile. Slots >= total get tile num_tiles."""
    n = offsets.shape[0]
    slot = torch.arange(max_intersections, dtype=torch.int32, device=offsets.device)
    src = torch.searchsorted(offsets, slot, right=True, out_int32=True) - 1
    src = torch.clamp(src, 0, n - 1)
    pk = packed[src]
    local = slot - offsets[src]
    sx = torch.clamp(pk >> 22, min=1)
    ly = torch.div(local, sx, rounding_mode="floor")
    lx = local - ly * sx
    tile = (((pk >> 11) & 0x7FF) + ly) * tiles_x + ((pk & 0x7FF) + lx)
    tile = torch.where(slot < total.reshape(()), tile, torch.full_like(tile, num_tiles))
    return tile, src


@torch.no_grad()
def bin_gaussians(means2d, radii, depths, valid, *, width: int, height: int,
                  tile_size: int, max_intersections: int, conics=None,
                  op_eff=None) -> BinnedIntersections:
    """The tile-sorted per-tile intersection lists of N gaussians (JAX
    `binning.bin_gaussians`): means2d [N, 2], radii [N], depths [N],
    valid [N] bool; conics and op_eff as in `tile_spans`."""
    n = means2d.shape[0]
    if n < 1:
        raise ValueError("bin_gaussians needs at least one gaussian")
    dev = means2d.device
    tiles_x = -(-width // tile_size)
    num_tiles = tiles_x * -(-height // tile_size)
    I = max_intersections

    packed_in, counts_in = tile_spans(
        means2d, radii, valid, width=width, height=height, tile_size=tile_size,
        conics=conics, op_eff=op_eff)
    # stable sort == the JAX (depth_key, iota) two-key sort; zero-pair
    # gaussians go last so every sorted index < n_live owns >= 1 pair
    depth_key = torch.where(counts_in > 0, depths, torch.full_like(depths, float("inf")))
    perm = torch.sort(depth_key, stable=True).indices.to(torch.int32)
    packed = packed_in[perm]
    counts = counts_in[perm]
    csum = torch.cumsum(counts, dim=0, dtype=torch.int64)
    offsets = (csum - counts).to(torch.int32)
    total = csum[-1:].to(torch.int32)

    tile, src = expand_pairs(offsets, packed, total, I, tiles_x=tiles_x, num_tiles=num_tiles)
    # src is non-decreasing in slot order, so the stable sort by tile is
    # the JAX (tile, src) two-key sort: depth order within each tile
    tile_sorted, order = torch.sort(tile, stable=True)
    q = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(tile_sorted, q, out_int32=True)
    gidx = torch.full((padded_capacity(I),), n, dtype=torch.int32, device=dev)
    gidx[:I] = src[order]
    inv_perm = torch.empty_like(perm)
    inv_perm[perm.to(torch.int64)] = torch.arange(n, dtype=torch.int32, device=dev)
    return BinnedIntersections(
        perm, inv_perm, gidx, *window_ranges(bounds), offsets, counts, total)
