"""Render/eval-path pieces of `mtgs_tpu/train/losses.py`: masked mean,
separable-window SSIM as shifted adds, and per-gaussian camera normals."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over mask-true elements (mask broadcasts)."""
    m = torch.broadcast_to(mask.to(x.dtype), x.shape)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


@functools.lru_cache(maxsize=None)
def _gauss_win(win_size: int, sigma: float) -> tuple:
    x = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return tuple((g / g.sum()).astype(np.float32).tolist())


def _filter2d_separable(img: torch.Tensor, win) -> torch.Tensor:
    """Valid-mode separable filtering of [H, W, C] along H then W, as k
    shifted multiply-adds per axis: exact f32 whatever the conv/TF32
    settings, as in the JAX package."""
    H, W, C = img.shape
    k = len(win)
    out = torch.zeros((H - k + 1, W, C), dtype=img.dtype, device=img.device)
    for i in range(k):
        out = out + win[i] * img[i:i + H - k + 1]
    out2 = torch.zeros((H - k + 1, W - k + 1, C), dtype=img.dtype, device=img.device)
    for i in range(k):
        out2 = out2 + win[i] * out[:, i:i + W - k + 1]
    return out2


def ssim(x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
         win_size: int = 11, sigma: float = 1.5, data_range: float = 1.0) -> torch.Tensor:
    """Masked SSIM between [H, W, C] images (valid window; the mask is
    cropped by the window margin before the masked mean)."""
    win = _gauss_win(win_size, sigma)  # f32-exact values as Python floats
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    f = lambda im: _filter2d_separable(im, win)
    mu1, mu2 = f(x), f(y)
    s11 = f(x * x) - mu1 * mu1
    s22 = f(y * y) - mu2 * mu2
    s12 = f(x * y) - mu1 * mu2
    cs = (2 * s12 + C2) / (s11 + s22 + C2)
    ssim_map = ((2 * mu1 * mu2 + C1) / (mu1 * mu1 + mu2 * mu2 + C1)) * cs
    if mask is None:
        return ssim_map.mean()
    margin = win_size // 2
    return masked_mean(ssim_map, mask[margin:-margin, margin:-margin])


def gaussian_camera_normals(scales, quats_rotmat, means, cam_pos, c2w_rot):
    """Per-gaussian camera-space normals: the min-scale axis of each
    gaussian, oriented toward the camera, rotated into the camera frame."""
    idx = torch.argmin(scales, dim=-1)
    axis = torch.nn.functional.one_hot(idx, 3).to(scales.dtype)
    n = (quats_rotmat * axis[:, None, :]).sum(-1)
    n = n / torch.sqrt(torch.sum(n * n, -1, keepdim=True) + 1e-24)
    view = cam_pos - means
    view = view / torch.sqrt(torch.sum(view * view, -1, keepdim=True) + 1e-24)
    sign = torch.where((n * view).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return (n * sign) @ c2w_rot
