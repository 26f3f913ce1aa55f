"""Stage 7: dense metric pseudo-depth (UniDepth) + 2-channel PNG codec;
port of `mtgs_tpu/preprocess/dense_depth.py`.

Counterpart of `nuplan_scripts/generate_dense_depth.py`
(OpenDriveLab/MTGS). The codec IS the data contract — depth in meters,
clipped to [0.1, 80], stored as two uint8 channels of round(depth*100)
(low byte = value % 256, high byte = value // 256) — and is shared with
the training-side reader (`mtgs_torch/data/dataset.py`). The UniDepth
model itself is an external torch checkpoint; `unidepth_available()`
probes for it and the driver fails with an explanation; nothing is
downloaded. The gated writer reads
images with `data/image_io.read_image` and writes the depth PNGs with
`tools/render.write_png` (no PIL).

Also provides the LiDAR-vs-pseudo-depth error report the reference
prints after generation (`generate_dense_depth.py:258-281`) — the
sanity gate that catches garbage depth before training consumes it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np

DEPTH_MIN = 0.1
DEPTH_MAX = 80.0


def encode_depth_png(depth_m: np.ndarray) -> np.ndarray:
    """[H, W] float meters -> [H, W, 2] uint8 (low, high) channels."""
    d = np.clip(depth_m, DEPTH_MIN, DEPTH_MAX)
    q = np.round(d * 100.0).astype(np.int32)
    return np.stack([(q % 256), (q // 256)], axis=-1).astype(np.uint8)


def decode_depth_png(channels: np.ndarray) -> np.ndarray:
    """[H, W, >=2] uint8 -> [H, W] float meters (inverse of encode)."""
    c = channels.astype(np.int32)
    return (c[..., 0] + 256 * c[..., 1]).astype(np.float32) * 0.01


def unidepth_available() -> bool:
    try:
        import unidepth  # noqa: F401

        return True
    except ImportError:
        return False


def generate_dense_depth(
    image_paths: Iterable[str | Path],
    out_dir: str | Path,
    *,
    intrinsics: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
    suffix: str = ".png",
) -> List[Path]:
    """UniDepth-v2 metric depth for each image -> 2-channel PNGs, on
    `device` (the card unless the caller asks for the CPU)."""
    if not unidepth_available():
        raise RuntimeError(
            "UniDepth is not installed (external torch model, see the "
            "reference's docs/install.md); the dense-depth stage needs it. "
            "Training runs fine without pseudo-depth (ncc_lambda=0)."
        )
    import torch
    from unidepth.models import UniDepthV2

    from mtgs_torch.data.image_io import read_image, to_rgb
    from mtgs_torch.tools.render import write_png

    from mtgs_torch import resolve_device

    device = resolve_device(device)
    model = UniDepthV2.from_pretrained("lpiccinelli/unidepth-v2-vitl14")
    model = model.to(device).eval()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for p in map(Path, image_paths):
        rgb = to_rgb(read_image(p))
        t = torch.from_numpy(rgb).permute(2, 0, 1).to(device)
        K = None
        if intrinsics and p.name in intrinsics:
            K = torch.from_numpy(np.asarray(intrinsics[p.name], np.float32)).to(device)
        with torch.no_grad():
            pred = model.infer(t, K) if K is not None else model.infer(t)
        depth = pred["depth"].squeeze().cpu().numpy()
        out = out_dir / (p.stem + suffix)
        write_png(out, encode_depth_png(depth))
        written.append(out)
    return written


def depth_error_report(
    pseudo_depth: np.ndarray,
    lidar_depth: np.ndarray,
    *,
    max_range: float = DEPTH_MAX,
) -> Dict[str, float]:
    """Per-image LiDAR-vs-pseudo-depth errors on valid LiDAR pixels
    (ref `generate_dense_depth.py:258-281`)."""
    valid = (lidar_depth > DEPTH_MIN) & (lidar_depth < max_range)
    n = int(valid.sum())
    if n == 0:
        return dict(n=0, abs_rel=float("nan"), rmse=float("nan"), delta1=float("nan"))
    p = pseudo_depth[valid]
    g = lidar_depth[valid]
    abs_rel = float(np.mean(np.abs(p - g) / g))
    rmse = float(np.sqrt(np.mean((p - g) ** 2)))
    delta1 = float(np.mean(np.maximum(p / g, g / p) < 1.25))
    return dict(n=n, abs_rel=abs_rel, rmse=rmse, delta1=delta1)
