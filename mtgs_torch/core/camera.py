"""Camera frames; port of `mtgs_tpu/core/camera.py::camera_to_gsplat_viewmat`
and `backproject_depth`.

Scene frame (camera-to-world): x right, y up, z backward. cv frame
(gsplat): x right, y down, z forward. The flip is diag(1, -1, -1).
"""

from __future__ import annotations

from typing import Optional

import torch


def camera_to_gsplat_viewmat(c2w_scene: torch.Tensor) -> torch.Tensor:
    """Scene-frame camera-to-world [..., 4, 4] -> cv-frame world-to-camera:
    R <- R @ diag(1,-1,-1), then viewmat = [[R^T, -R^T t], [0, 1]]."""
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=c2w_scene.dtype,
                        device=c2w_scene.device)
    R = c2w_scene[..., :3, :3] * flip  # == R @ diag(flip), exactly
    t = c2w_scene[..., :3, 3:4]
    R_inv = R.transpose(-1, -2)
    t_inv = -R_inv @ t
    top = torch.cat([R_inv, t_inv], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=c2w_scene.dtype,
                         device=c2w_scene.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def backproject_depth(depth: torch.Tensor, K: torch.Tensor,
                      c2w_scene: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[H, W] or [H, W, 1] cv-frame z-depth -> [H, W, 3] points at the
    pixel centres: cv camera frame, or world frame given a scene-frame
    camera-to-world [4, 4]."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    H, W = depth.shape
    xs = (torch.arange(W, dtype=depth.dtype, device=depth.device) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (torch.arange(H, dtype=depth.dtype, device=depth.device) + 0.5 - K[1, 2]) / K[1, 1]
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([grid_x * depth, grid_y * depth, depth], dim=-1)
    if c2w_scene is None:
        return pts
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=c2w_scene.dtype, device=c2w_scene.device)
    R = c2w_scene[:3, :3] * flip  # the scene -> cv frame flip of the camera axes
    return pts @ R.T + c2w_scene[:3, 3]
