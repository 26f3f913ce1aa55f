"""Camera pose optimisation: SO3xR3 tangent-space deltas; port of
`mtgs_tpu/train/camera_opt.py`.

A per-image 6-vector [tangent rotation | translation] is exponentiated
to an adjustment right-multiplied onto the camera-to-world matrix
(nerfstudio's `CameraOptimizer`, mode SO3xR3).
"""

from __future__ import annotations

import torch


def exp_map_so3xr3(tangent: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 4] (R | t): the SO(3) exponential of
    tangent[..., :3] and tangent[..., 3:] as the translation.

    The angle is epsilon-safe with a double `where`: the small-angle
    branch must not see theta ~ 0 even unselected, or the NaN gradient of
    the norm at exactly 0 (every pose delta's initial value) leaks
    through."""
    w = tangent[..., :3]
    t = tangent[..., 3:]
    sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = sq < 1e-14
    one = torch.ones_like(sq)
    theta = torch.sqrt(torch.where(small, one, sq))
    a = torch.where(small, one, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 * one, (1.0 - torch.cos(theta)) / torch.where(small, one, sq))
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(K.shape)
    R = eye + a[..., None] * K + b[..., None] * (K @ K)
    return torch.cat([R, t[..., None]], dim=-1)


def apply_camera_opt(c2w: torch.Tensor, tangent: torch.Tensor) -> torch.Tensor:
    """Right-multiply the pose adjustment onto a [..., 4, 4] c2w."""
    adj34 = exp_map_so3xr3(tangent)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w.dtype, device=c2w.device)
    bottom = bottom.expand(adj34.shape[:-2] + (1, 4))
    return c2w @ torch.cat([adj34, bottom], dim=-2)


def camera_opt_penalty(camera_opt: torch.Tensor, trans_weight: float,
                       rot_weight: float) -> torch.Tensor:
    """Mean norms of the translation and rotation tangents, with an
    epsilon-safe norm (its gradient at the zero initialisation is 0, not
    NaN)."""
    def safe_norm(x):
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-12)

    rot = safe_norm(camera_opt[..., :3]).mean()
    trans = safe_norm(camera_opt[..., 3:]).mean()
    return trans_weight * trans + rot_weight * rot
