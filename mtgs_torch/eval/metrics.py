"""Evaluation metrics; port of `mtgs_tpu/eval/metrics.py`: masked PSNR,
iterative quadratic colour correction for cc_psnr, masked SSIM and LiDAR
depth metrics."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mtgs_torch.train.losses import masked_mean, ssim


def masked_psnr(pred, gt, mask=None) -> torch.Tensor:
    """PSNR over mask-selected pixels (data range 1.0, capped at 100 dB)."""
    mse = torch.mean((pred - gt) ** 2) if mask is None else masked_mean((pred - gt) ** 2, mask)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _is_unclipped(z, eps: float):
    return (z >= eps) & (z <= 1.0 - eps)


def color_correct(img, ref, num_iters: int = 5, eps: float = 0.5 / 255):
    """Warp `img`'s colours onto `ref` by iterative masked least squares
    (quadratic per-channel expansion, Tikhonov 1e-6 normal equations)."""
    C = img.shape[-1]
    img_mat = img.reshape(-1, C)
    ref_mat = ref.reshape(-1, C)
    mask0 = _is_unclipped(img_mat, eps)
    for _ in range(num_iters):
        terms = [img_mat[:, c:c + 1] * img_mat[:, c:] for c in range(C)]
        a = torch.cat(terms + [img_mat, torch.ones_like(img_mat[:, :1])], dim=-1)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        cols = []
        for c in range(C):
            b = ref_mat[:, c]
            mask = (mask0[:, c] & _is_unclipped(img_mat[:, c], eps)
                    & _is_unclipped(b, eps)).to(img_mat.dtype)
            ma = a * mask[:, None]
            mb = b * mask
            cols.append(torch.linalg.solve(ma.T @ ma + 1e-6 * eye, ma.T @ mb))
        img_mat = torch.clamp(a @ torch.stack(cols, dim=-1), 0.0, 1.0)
    return img_mat.reshape(img.shape)


def depth_metrics(pred, gt, mask) -> Dict[str, torch.Tensor]:
    """LiDAR depth metrics over the valid range 0.1-80 m."""
    valid = ((gt > 0.1) & (gt < 80.0) & (mask > 0)).to(pred.dtype)
    n = torch.clamp(valid.sum(), min=1.0)
    err = (gt - pred) * valid
    rmse = torch.sqrt((err ** 2).sum() / n)
    abs_rel = (torch.abs(err) / torch.clamp(gt, min=1e-6)).sum() / n
    ratio = torch.maximum(pred / torch.clamp(gt, min=1e-6), gt / torch.clamp(pred, min=1e-6))
    delta1 = ((ratio < 1.25).to(pred.dtype) * valid).sum() / n
    return dict(depth_RMSE=rmse, depth_absRel=abs_rel, depth_delta1=delta1)


def image_metrics(pred, pred_appearance, gt, mask, *,
                  pred_depth: Optional[torch.Tensor] = None,
                  gt_depth: Optional[torch.Tensor] = None,
                  color_corrected: bool = True) -> Dict[str, torch.Tensor]:
    """psnr, ssim (on the appearance-corrected render), cc_psnr + depth."""
    out = dict(
        psnr=masked_psnr(pred_appearance, gt, mask),
        ssim=ssim(gt, pred_appearance, mask),
    )
    if color_corrected:
        m = mask.to(pred.dtype)
        out["cc_psnr"] = masked_psnr(color_correct(pred_appearance * m, gt * m), gt, mask)
    if pred_depth is not None and gt_depth is not None:
        out.update(depth_metrics(pred_depth, gt_depth, mask))
    return out
