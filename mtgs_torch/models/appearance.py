"""Per-camera exposure affine; port of `mtgs_tpu/models/appearance.py`."""

from __future__ import annotations

import torch

from mtgs_torch import resolve_device


def init_exposure(num_cameras: int, device="cuda") -> torch.Tensor:
    """[num_cameras, 3, 4] identity affines, on the card unless `device`
    says otherwise."""
    device = resolve_device(device)
    eye = torch.cat([torch.eye(3), torch.zeros(3, 1)], dim=1)
    return eye.expand(num_cameras, 3, 4).clone().to(device)


def apply_exposure(appearance: torch.Tensor, rgb: torch.Tensor, cam_idx) -> torch.Tensor:
    """Apply one camera's affine to an [H, W, 3] image; clamp to [0, 1]."""
    M = appearance[cam_idx]
    return torch.clamp(rgb @ M[:, :3].T + M[:, 3], 0.0, 1.0)
