"""The yardstick's arithmetic: the card's peaks, the least bytes and
operations a blend needs, and the float32 operations of a whole step or
view (for `mfu`).

The blend counts are copies of `mtgs_torch/raster/blend.py`'s
`blend_forward_work` / `blend_backward_work`, fed here with the
reference's own blend statistics (`reference.raster.blend_block`'s
`stats`), so they read the same work whatever implements the blend. Two
terms are counted from the inputs alone where the program's copy counts
its own buffers: the gaussians a tile must read are those some pixel of
it composites or terminates on, and the backward writes one gradient row
per such (tile, gaussian) pair.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores (the port runs TF32 off)
PEAK_HBM_BYTES = 3.35e12   # HBM3 bytes/s

NUM_GEOM = 6               # mx, my, conic a, b, c, opacity

# float32 operations a gaussian's forward needs before the blend: SH of
# degree 3 (16 bases ~30, 16 x 3 multiply-adds 96, the direction 9), the
# pose of an instance folded in, the projection (world to camera 15,
# R S and its covariance 60, the Jacobian and the 2D covariance 40, the
# blur, determinant, conic, compensation and radius 30): 280; the normal
# channel's axis, orientation and rotation 40 more.
GAUSS_FWD = 280
GAUSS_NORMALS = 40
GAUSS_BWD_FACTOR = 2       # a backward costs about twice its forward
PIXEL_FINAL = 20           # clamp, exposure affine, depth normalisation a pixel
# the losses a pixel, forward: masked L1 5; SSIM five separable 11-tap
# filters over 3 channels (2 x 11 x 2 x 3 x 5 = 660) and its map 30;
# inverse-L1 depth 8, NCC 12, normals from depth and their loss and TV 60
LOSS_PIXEL = {"l1_ssim": 695, "depth": 80}
ADAM_ELEM = 12             # two moments, bias corrections, sqrt, divide, update


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card needs: the larger of the byte and the
    operation bounds."""
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_F32_FLOPS)


def blend_forward_work(stats: dict, c_total: int, tiles: int, n_pix: int):
    """(bytes, operations) a forward blend needs at least: read the needed
    gaussians' rows and the ranges, write the colour and transmittance
    once; per evaluated pair inside the 1/255 support sigma 11, exp and
    scale 3, per composited one clamp, log1p, sum, exp, weight and
    c_total multiply-adds."""
    nbytes = 4 * ((NUM_GEOM + c_total) * stats["pairs_read"] + 3 * tiles
                  + (c_total + 1) * n_pix)
    ops = 14 * stats["pair_support"] + (6 + 2 * c_total) * stats["pair_blends"]
    return nbytes, ops


def blend_backward_work(stats: dict, c_total: int, tiles: int, n_pix: int):
    """(bytes, operations) the backward blend's replay needs at least: read
    the needed rows, the ranges, colour, transmittance and both cotangents,
    write a gradient row per needed pair; the forward's 14 per evaluated
    pair, and per composited one 30 + 4 c_total, less 15 where alpha was
    clamped (no sigma or opacity gradient)."""
    nw = NUM_GEOM + c_total
    nbytes = 4 * (2 * nw * stats["pairs_read"] + 3 * tiles + (2 * c_total + 2) * n_pix)
    ops = (14 * stats["pair_support"] + (30 + 4 * c_total) * stats["pair_blends"]
           - 15 * stats["pair_clamped"])
    return nbytes, ops


def view_flops(n_gauss: int, normals: bool, blend_fwd_ops: float, n_pix: int) -> float:
    """A served view's float32 operations."""
    per = GAUSS_FWD + (GAUSS_NORMALS if normals else 0)
    return n_gauss * per + blend_fwd_ops + PIXEL_FINAL * n_pix


def step_flops(n_gauss: int, normals: bool, depth_losses: bool, blend_fwd_ops: float,
               blend_bwd_ops: float, n_pix: int, n_params: int) -> float:
    """A training step's float32 operations: the view forward, its losses
    and their backward, the gaussians' backward and Adam."""
    per = GAUSS_FWD + (GAUSS_NORMALS if normals else 0)
    loss = LOSS_PIXEL["l1_ssim"] + (LOSS_PIXEL["depth"] if depth_losses else 0)
    return (n_gauss * per * (1 + GAUSS_BWD_FACTOR) + blend_fwd_ops + blend_bwd_ops
            + n_pix * (PIXEL_FINAL + loss) * (1 + GAUSS_BWD_FACTOR) + ADAM_ELEM * n_params)
