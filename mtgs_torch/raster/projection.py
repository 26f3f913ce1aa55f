"""EWA perspective projection; port of `mtgs_tpu/raster/projection.py`.

gsplat v1.4 `fully_fused_projection` semantics: FOV-clamped perspective
Jacobian, +0.3 px blur, `antialiased` opacity compensation, 3-sigma
radius, near/far culling. All f32, the same elementwise formulas as the
JAX function.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ProjectedGaussians:
    """Per-gaussian screen-space quantities, in input order."""

    means2d: torch.Tensor        # [N, 2] pixel coordinates
    conics: torch.Tensor         # [N, 3] inverse 2D covariance (cxx, cxy, cyy)
    depths: torch.Tensor         # [N] camera-frame z
    radii: torch.Tensor          # [N] int32 3-sigma radius (0 => culled)
    compensations: torch.Tensor  # [N] antialiasing compensation (1 if classic)
    valid: torch.Tensor          # [N] bool


def _camera_covar_entries(quats, scales, R_cw):
    """Upper-triangle entries of A diag(s^2) A^T with A = R_cw @ R(quat)."""
    q = quats / torch.sqrt(torch.sum(quats * quats, -1, keepdim=True) + 1e-24)
    w, x, y, z = q.unbind(-1)
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    A = [
        [
            R_cw[i, 0] * r[0][k] + R_cw[i, 1] * r[1][k] + R_cw[i, 2] * r[2][k]
            for k in range(3)
        ]
        for i in range(3)
    ]
    s2 = scales * scales
    s2k = [s2[:, 0], s2[:, 1], s2[:, 2]]

    def cov(i, j):
        return s2k[0] * A[i][0] * A[j][0] + s2k[1] * A[i][1] * A[j][1] \
            + s2k[2] * A[i][2] * A[j][2]

    return cov(0, 0), cov(0, 1), cov(0, 2), cov(1, 1), cov(1, 2), cov(2, 2)


def project_gaussians(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    *,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    antialiased: bool = False,
    radius_clip: float = 0.0,
) -> ProjectedGaussians:
    """Project 3D gaussians (world frame) through a cv-frame viewmat."""
    R_cw = viewmat[:3, :3]
    t_cw = viewmat[:3, 3]
    mean_c = means @ R_cw.T + t_cw
    z = mean_c[:, 2]

    c00, c01, c02, c11, c12, c22 = _camera_covar_entries(quats, scales, R_cw)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy

    z_ok = z > near_plane
    z_safe = torch.where(z_ok, z, torch.ones_like(z))
    rz = 1.0 / z_safe
    tx = z_safe * torch.minimum(torch.maximum(mean_c[:, 0] * rz, -lim_x_neg), lim_x_pos)
    ty = z_safe * torch.minimum(torch.maximum(mean_c[:, 1] * rz, -lim_y_neg), lim_y_pos)

    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2

    v00 = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    v01 = j11 * (j00 * c01 + j02 * c12) + j12 * (j00 * c02 + j02 * c22)
    v11 = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = v00 * v11 - v01 * v01
    v00b = v00 + eps2d
    v11b = v11 + eps2d
    det_blur = v00b * v11b - v01 * v01

    if antialiased:
        ratio = det_orig / torch.clamp(det_blur, min=1e-32)
        pos = ratio > 0.0
        compensations = torch.where(
            pos, torch.sqrt(torch.where(pos, ratio, torch.ones_like(ratio))),
            torch.zeros_like(ratio))
    else:
        compensations = torch.ones_like(det_blur)

    det_ok = det_blur > 1e-16
    det_safe = torch.where(det_ok, det_blur, torch.ones_like(det_blur))
    inv_det = 1.0 / det_safe
    conics = torch.stack([v11b * inv_det, -v01 * inv_det, v00b * inv_det], dim=-1)

    b = 0.5 * (v00b + v11b)
    v1 = b + torch.sqrt(torch.clamp(b * b - det_blur, min=0.01))
    radius_f = torch.ceil(3.0 * torch.sqrt(v1))

    means2d = torch.stack(
        [fx * mean_c[:, 0] * rz + cx, fy * mean_c[:, 1] * rz + cy], dim=-1)

    valid = z_ok & (z < far_plane) & det_ok
    valid &= radius_f > radius_clip
    valid &= (means2d[:, 0] + radius_f > 0) & (means2d[:, 0] - radius_f < width)
    valid &= (means2d[:, 1] + radius_f > 0) & (means2d[:, 1] - radius_f < height)

    radii = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    return ProjectedGaussians(
        means2d=means2d, conics=conics, depths=z, radii=radii,
        compensations=compensations, valid=valid,
    )
