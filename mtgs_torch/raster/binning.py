"""Per-gaussian tile spans; port of `mtgs_tpu/raster/binning.py`.

`tile_spans` packs each gaussian's tile rectangle into one int32 word
(tmin_x | tmin_y << 11 | span_x << 22) plus a pair count. It is integer
math over f32 floor/ceil, so given identical inputs it matches the JAX
function exactly.
"""

from __future__ import annotations

import torch

from mtgs_torch.raster.chunk_math import CHUNK


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
):
    """(packed, counts) per gaussian, in input order.

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
    span_x = torch.clamp(tmax_x - tmin_x, 0, 255)
    span_y = torch.clamp(tmax_y - tmin_y, min=0)
    live = valid & (radii > 0)
    if op_eff is not None:
        live = live & (op_eff >= 1.0 / 255.0)
    counts = torch.where(live, span_x * span_y, torch.zeros_like(span_x)).to(torch.int32)
    packed = tmin_x | (tmin_y << 11) | (span_x << 22)
    return packed.to(torch.int32), counts


def padded_capacity(max_intersections: int) -> int:
    """Slab capacity: max_intersections plus one CHUNK of spill slack,
    rounded to 512 (the JAX slab's layout, kept at the function boundary)."""
    return ((max_intersections + CHUNK + 511) // 512) * 512
