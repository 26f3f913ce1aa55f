"""View-matrix build; port of `mtgs_tpu/core/camera.py::camera_to_gsplat_viewmat`.

Scene frame (camera-to-world): x right, y up, z backward. cv frame
(gsplat): x right, y down, z forward. The flip is diag(1, -1, -1).
"""

from __future__ import annotations

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
