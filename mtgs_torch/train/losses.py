"""Training losses; port of `mtgs_tpu/train/losses.py`.

Photometric (masked L1, separable-window SSIM), depth (InverseL1 and
the rest of the LiDAR family, patch NCC against pseudo depth), normals
(from depth, with TV) and the shape/opacity regularisers, with the JAX
package's mask semantics `sum(x * m) / max(sum(m), 1)`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from mtgs_torch.core.camera import backproject_depth


@dataclass(frozen=True)
class LossConfig:
    """Loss weights (the JAX `LossConfig`, same defaults)."""

    ssim_lambda: float = 0.2
    use_ssim_on_raw_rgb: bool = False
    depth_lambda: float = 0.5
    depth_loss_type: str = "InverseL1"
    depth_source: str = "lidar"
    ncc_lambda: float = 0.1
    ncc_patch_size: int = 32
    ncc_stride: int = 16
    normal_lambda: float = 0.1
    use_normal_loss: bool = False
    use_normal_tv_loss: bool = False
    two_d_gaussians: bool = True
    adapter_lambda: float = 0.0
    oob_lambda: float = 1.0
    oob_tolerance: float = 1.5
    sharp_shape_reg_lambda: float = 1.0
    sharp_shape_reg_step_interval: int = 10
    sharp_shape_max_ratio: float = 10.0
    camera_opt_trans_penalty: float = 1e-2
    camera_opt_rot_penalty: float = 1e-3


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


# ------------------------------------------------------------ depth losses

def depth_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
               kind: str) -> torch.Tensor:
    """LiDAR depth loss, [H, W, 1] each. InverseL1 clamps the prediction
    to the 0.01 near plane: below it the depth is an artifact of the ED
    normalisation at vanishing alpha, whose 1/depth gradient overflows."""
    if kind == "InverseL1":
        pred = torch.clamp(pred, min=0.01)
        err = torch.abs(1.0 / (gt + 1e-5) - 1.0 / (pred + 1e-5))
    elif kind == "L1":
        err = torch.abs(gt - pred)
    elif kind == "MSE":
        err = (gt - pred) ** 2
    elif kind == "LogL1":
        err = torch.log(1.0 + torch.abs(gt - pred))
    elif kind == "HuberL1":
        a = torch.abs(gt - pred)
        err = torch.where(a < 1.0, 0.5 * a * a, a - 0.5)
    else:
        raise ValueError(f"unknown depth loss {kind}")
    return masked_mean(err, mask)


def edge_aware_logl1(pred, gt, rgb, mask) -> torch.Tensor:
    """log(1 + |pred - gt|) damped by exp(-image gradient) along x and y,
    masked means summed. pred/gt/mask [H, W, 1]; rgb [H, W, 3]."""
    logl1 = torch.log(1.0 + torch.abs(pred - gt))
    grad_x = torch.abs(rgb[:, :-1] - rgb[:, 1:]).mean(-1, keepdim=True)
    grad_y = torch.abs(rgb[:-1] - rgb[1:]).mean(-1, keepdim=True)
    loss_x = torch.exp(-grad_x) * logl1[:, :-1]
    loss_y = torch.exp(-grad_y) * logl1[:-1]
    return masked_mean(loss_x, mask[:, :-1]) + masked_mean(loss_y, mask[:-1])


def edge_aware_tv(depth, rgb) -> torch.Tensor:
    """|d depth| damped by exp(-|d rgb|), x + y means."""
    gdx = torch.abs(depth[:, :-1] - depth[:, 1:])
    gdy = torch.abs(depth[:-1] - depth[1:])
    gix = torch.abs(rgb[:, :-1] - rgb[:, 1:]).mean(-1, keepdim=True)
    giy = torch.abs(rgb[:-1] - rgb[1:]).mean(-1, keepdim=True)
    return (gdx * torch.exp(-gix)).mean() + (gdy * torch.exp(-giy)).mean()


def mean_angular_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-pixel angular error (radians) between normal maps
    (`geometric_loss.py:305-320`): [H, W, 3] each (unit vectors) -> [H, W],
    arccos of the clamped channel dot product."""
    return torch.arccos(torch.clamp((pred * gt).sum(dim=-1), -1.0, 1.0))


def _extract_patches(img: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """[H, W] -> [n_patches, patch * patch]: F.unfold with SAME padding.
    The JAX function stacks patch * patch strided slices; `unfold` is the
    same strided view of the padded image, in the same (row, column)
    order, without the copies."""
    pad = patch // 2
    H, W = img.shape
    oh = (H + 2 * pad - patch) // stride + 1
    ow = (W + 2 * pad - patch) // stride + 1
    need_h = (oh - 1) * stride + patch
    need_w = (ow - 1) * stride + patch
    x = torch.nn.functional.pad(img, (pad, need_w - W - pad, pad, need_h - H - pad))
    return x.unfold(0, patch, stride).unfold(1, patch, stride).reshape(oh * ow, patch * patch)


def ncc_depth_loss(pred, gt, mask, patch: int = 7, stride: int = 7) -> torch.Tensor:
    """1 - mean patch-normalised cross-correlation of depth over the
    patches that lie fully inside the mask."""
    pd = _extract_patches(pred[..., 0], patch, stride)
    gd = _extract_patches(gt[..., 0], patch, stride)
    md = _extract_patches(mask[..., 0].to(pred.dtype), patch, stride)
    valid = (md.amin(dim=1) > 0.5).to(pred.dtype)

    def norm(p):
        c = p - p.mean(dim=1, keepdim=True)
        return c / torch.sqrt((c * c).mean(dim=1, keepdim=True) + 1e-8)

    ncc = (norm(pd) * norm(gd)).mean(dim=1)
    return 1.0 - (ncc * valid).sum() / torch.clamp(valid.sum(), min=1.0)


# ------------------------------------------------------------ normal losses

def normals_from_depth(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-space normal map of a depth image, flipped by diag(1, -1, -1)
    and encoded as (1 + n) / 2, zero-normal border."""
    pts = backproject_depth(depth, K)
    l2r = pts[1:-1, 2:, :] - pts[1:-1, :-2, :]
    b2t = pts[:-2, 1:-1, :] - pts[2:, 1:-1, :]
    n = torch.cross(l2r, b2t, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    n = torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
    n = n * torch.tensor([1.0, -1.0, -1.0], dtype=n.dtype, device=n.device)
    return (1.0 + n) / 2.0


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Total variation of [H, W, C]."""
    return torch.abs(img[:, :-1] - img[:, 1:]).mean() + torch.abs(img[:-1] - img[1:]).mean()


# ------------------------------------------------------------- regularisers

def two_d_reg(scales: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Mean smallest linear scale over alive gaussians (flattening)."""
    return masked_mean(scales.amin(dim=-1), alive)


def sharp_shape_reg(scales, alive, max_ratio: float, two_d: bool) -> torch.Tensor:
    """Penalty on the largest-to-second (2D) or -third scale ratio above
    max_ratio."""
    s = torch.sort(scales, dim=-1, descending=True).values
    other = s[..., 1] if two_d else s[..., 2]
    ratio = s[..., 0] / torch.clamp(other, min=1e-12)
    return masked_mean(torch.clamp(ratio, min=max_ratio) - max_ratio, alive)


def oob_loss(means_local, opacities_logit, alive, sizes, tolerance: float) -> torch.Tensor:
    """Rigid-instance out-of-box opacity penalty: -log(1 - opacity) of the
    alive gaussians outside their box (+ tolerance). means_local [I, cap,
    3], opacities_logit [I, cap, 1], alive [I, cap], sizes [I, 3]."""
    bound = sizes[:, None, :] / 2.0 + tolerance
    oob = torch.any(torch.abs(means_local.detach()) > bound, dim=-1)
    oob = oob.to(means_local.dtype) * alive
    op = torch.sigmoid(opacities_logit[..., 0])
    pen = -torch.log(1.0 - op + 1e-6)
    return (pen * oob).sum() / torch.clamp(oob.sum(), min=1.0)


def gaussian_camera_normals(scales, quats_rotmat, means, cam_pos, c2w_rot):
    """Per-gaussian camera-space normals: the min-scale axis of each
    gaussian, oriented toward the camera, rotated into the camera frame.
    The orientation test sees no gradient (the JAX package's
    stop_gradient on the means)."""
    idx = torch.argmin(scales, dim=-1)
    axis = torch.nn.functional.one_hot(idx, 3).to(scales.dtype)
    n = (quats_rotmat * axis[:, None, :]).sum(-1)
    n = n / torch.sqrt(torch.sum(n * n, -1, keepdim=True) + 1e-24)
    view = cam_pos - means.detach()
    view = view / torch.sqrt(torch.sum(view * view, -1, keepdim=True) + 1e-24)
    sign = torch.where((n * view).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return (n * sign) @ c2w_rot


# --------------------------------------------------------------- assembly

def compute_losses(cfg: LossConfig, *, gt_img, pred_img, pred_img_appearance, mask,
                   pred_depth=None, gt_lidar_depth=None, gt_pseudo_depth=None,
                   pred_normal=None, K=None) -> Dict[str, torch.Tensor]:
    """The image-space losses (scene regularisers are the trainer's)."""
    losses: Dict[str, torch.Tensor] = {}
    l1 = masked_mean(torch.abs(gt_img - pred_img_appearance), mask)
    losses["l1"] = (1.0 - cfg.ssim_lambda) * l1
    if cfg.ssim_lambda > 0:
        img_for_ssim = pred_img if cfg.use_ssim_on_raw_rgb else pred_img_appearance
        losses["ssim"] = cfg.ssim_lambda * (1.0 - ssim(gt_img, img_for_ssim, mask))

    if pred_depth is not None and gt_lidar_depth is not None and cfg.depth_lambda > 0:
        dm = (gt_lidar_depth > 0.1) & (gt_lidar_depth < 80.0) & (mask > 0)
        if cfg.depth_loss_type == "EdgeAwareLogL1":
            dl = edge_aware_logl1(pred_depth, gt_lidar_depth, gt_img, dm)
        elif cfg.depth_loss_type == "EdgeAwareTV":
            dl = edge_aware_tv(pred_depth, gt_img)
        elif cfg.depth_loss_type == "TV":
            dl = tv_loss(pred_depth)
        else:
            dl = depth_loss(pred_depth, gt_lidar_depth, dm, cfg.depth_loss_type)
        losses["depth"] = cfg.depth_lambda * dl

    if pred_depth is not None and gt_pseudo_depth is not None and cfg.ncc_lambda > 0:
        dm = (gt_pseudo_depth > 0.1) & (gt_pseudo_depth < 80.0) & (mask > 0)
        losses["ncc"] = cfg.ncc_lambda * ncc_depth_loss(
            pred_depth, gt_pseudo_depth, dm, cfg.ncc_patch_size, cfg.ncc_stride)

    if cfg.use_normal_loss and pred_normal is not None and K is not None:
        depth_for_normal = gt_pseudo_depth if gt_pseudo_depth is not None else gt_lidar_depth
        if depth_for_normal is not None:
            nm = (depth_for_normal > 0.1) & (depth_for_normal < 50.0) & (mask > 0)
            gt_n = normals_from_depth(depth_for_normal.detach(), K)
            nl = masked_mean(torch.abs(gt_n - pred_normal), nm)
            if cfg.use_normal_tv_loss:
                nl = nl + tv_loss(pred_normal)
            losses["normal"] = cfg.normal_lambda * nl
    return losses
