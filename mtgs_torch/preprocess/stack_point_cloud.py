"""RGB point-cloud stacking (stage 8 of the data factory), on the card;
port of `mtgs_tpu/preprocess/stack_point_cloud.py`.

Torch rewrite of the reference's seed-cloud builder
(`nuplan_scripts/stack_RGB_point_cloud.py` +
`utils/stack_point_cloud_utils.py` + `utils/nuplan_utils_custom.py` in
OpenDriveLab/MTGS): per frame, split the LiDAR scan into background vs
per-instance boxes, paint points with colors from the (undistorted)
cameras, align per-camera brightness (`v_adjust`), and accumulate a
global background cloud plus per-track instance clouds in box-local
frames. Semantic filtering (dropping sky/person/vehicle points from the
background) applies when semantic maps exist.

The per-point work runs on `device` (the card unless the caller asks for
the CPU): every point against every box and projected into every camera,
the colour and semantic gathers from images and masks that stay tensors on
the device, and the voxel average of `finalize`. Its results are the JAX
package's numpy ones: the box tests and the projection are float64 as
there (float32 points times float64 matrices; a float32 projection moves
points across pixel edges), the few per-box and per-camera constants
(`cos`/`sin` of a heading, `inv(cam2ego)`) are computed by numpy on the
host, and the first camera that sees a point colours it.

Outputs: `stacked_point_cloud/background.pcd.npz` and
`instance_point_cloud/<track>.pcd.npz` (the npz twin of the reference's
.pcd files, readable by `mtgs_torch.utils.pointcloud.load_pcd`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.utils.pointcloud import save_pcd_npz, voxel_downsample_tensor

# cityscapes ids kept in the background cloud (ref: semantic classes < 10,
# i.e. static structure — drops sky(10), person(11+), vehicles(13+))
BACKGROUND_MAX_CLASS = 10
BOX_MARGIN = 0.1  # metres added to each half extent


def _on(x, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _box_frames(pts: torch.Tensor, boxes: np.ndarray):
    """Each point in each box's frame: (lx, ly, lz) [B, n] float64, and the
    masks [B, n] of points inside each box (ref
    `stack_point_cloud_utils.py:84-155`)."""
    dev = pts.device
    # numpy's cos and sin, box by box as the JAX package takes them
    cs = np.asarray([(np.cos(-b[6]), np.sin(-b[6])) for b in boxes], np.float64).reshape(-1, 2)
    half = np.stack([boxes[:, 3] / 2 + BOX_MARGIN, boxes[:, 4] / 2 + BOX_MARGIN,
                     boxes[:, 5] / 2 + BOX_MARGIN], -1)
    b = _on(boxes, dev, torch.float64)
    c, s = _on(cs[:, :1], dev), _on(cs[:, 1:], dev)
    p = pts[:, :3].to(torch.float64)
    x = p[None, :, 0] - b[:, 0:1]
    y = p[None, :, 1] - b[:, 1:2]
    lz = p[None, :, 2] - b[:, 2:3]
    lx = x * c - y * s
    ly = x * s + y * c
    half = _on(half, dev)
    inside = ((lx.abs() <= half[:, 0:1]) & (ly.abs() <= half[:, 1:2])
              & (lz.abs() <= half[:, 2:3]))
    return (lx, ly, lz), inside


def points_in_boxes(
    pts, boxes, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ego-frame points into background vs per-box masks.

    boxes: [B, 7] (x, y, z, l, w, h, heading) — ref
    `stack_point_cloud_utils.py:84-155`.
    Returns (background_mask [n], per-box masks [B, n]) on `device`.
    """
    dev = resolve_device(device)
    pts = _on(pts, dev)
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    _, inside = _box_frames(pts, boxes)
    return ~inside.any(dim=0), inside


def paint_points(
    pts_ego,
    images: Sequence,                 # undistorted [H, W, 3]: uint8, or float 0..1
    cam2egos: Sequence[np.ndarray],   # [4, 4] cv-frame cam2ego
    Ks: Sequence[np.ndarray],
    semantics: Optional[Sequence] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Color each ego-frame point from the first camera that sees it.

    Ref `get_rgb_point_cloud` (`nuplan_utils_custom.py:174-266`). A uint8
    image is taken as the JAX stage takes it (float32 / 255, then * 255 at
    the gathered pixels). Returns (rgb [n,3] 0..255 float32, seen_mask [n],
    semantic_label [n] int32 or -1) on `device`.
    """
    dev = resolve_device(device)
    pts = _on(pts_ego, dev)[:, :3].to(torch.float64)
    n = pts.shape[0]
    rgb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    sem = torch.full((n,), -1, dtype=torch.int32, device=dev)
    # a divisor on the device: CUDA divides by a Python scalar as a product
    # with its reciprocal, which is not numpy's quotient
    u8_scale = torch.tensor(255.0, device=dev)
    for i, (img, c2e, K) in enumerate(zip(images, cam2egos, Ks)):
        img = _on(img, dev)
        h, w = img.shape[:2]
        e2c = np.linalg.inv(np.asarray(c2e, np.float64))
        # the product row by row, in float64 as numpy's (host scalars: no copies)
        cam = [pts[:, 0] * e2c[k, 0] + pts[:, 1] * e2c[k, 1] + pts[:, 2] * e2c[k, 2] + e2c[k, 3]
               for k in range(3)]
        z = cam[2]
        ok = z > 0.1
        K = np.asarray(K, np.float64)
        # truncation toward zero, as numpy's astype(np.int32)
        u = torch.where(ok, cam[0] / z * K[0, 0] + K[0, 2], 0.0).to(torch.int64)
        v = torch.where(ok, cam[1] / z * K[1, 1] + K[1, 2], 0.0).to(torch.int64)
        ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
        new = ok & ~seen
        at = v.clamp(0, h - 1) * w + u.clamp(0, w - 1)
        pix = img.reshape(h * w, -1)[at]
        if img.dtype == torch.uint8:
            pix = pix.to(torch.float32) / u8_scale
        rgb = torch.where(new[:, None], (pix * 255.0).to(torch.float32), rgb)
        if semantics is not None and semantics[i] is not None:
            labels = _on(semantics[i], dev).reshape(h * w)[at].to(torch.int32)
            sem = torch.where(new, labels, sem)
        seen |= new
    return rgb, seen, sem


def brightness_adjust_factors(
    images: Sequence, reference_idx: int = 0, device="cuda"
) -> List[float]:
    """Per-camera V-channel gain aligning brightness to a reference camera
    (ref `adjust_brightness_single_frame`, `nuplan_utils_custom.py:334-424`).
    The mean is taken in float64 (numpy's is a float32 pairwise sum)."""
    dev = resolve_device(device)

    def value(img):
        return float(_on(img, dev).amax(dim=-1).to(torch.float64).mean())  # HSV V = max(R,G,B)

    ref = max(value(images[reference_idx]), 1e-6)
    return [ref / max(value(im), 1e-6) for im in images]


@dataclasses.dataclass
class StackAccumulator:
    """Accumulates background + per-instance clouds across frames on
    `device` (ref `stack_point_cloud_utils.py:157-241`)."""

    voxel: float = 0.15
    device: str | torch.device = "cuda"
    background_xyz: List[torch.Tensor] = dataclasses.field(default_factory=list)
    background_rgb: List[torch.Tensor] = dataclasses.field(default_factory=list)
    instances: Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def add_frame(
        self,
        pts_ego,
        rgb: torch.Tensor,
        seen: torch.Tensor,
        sem: Optional[torch.Tensor],
        ego2global: np.ndarray,
        boxes,
        track_tokens: Sequence[str],
    ):
        dev = self.device
        pts = _on(pts_ego, dev)
        rgb, seen = _on(rgb, dev), _on(seen, dev)
        boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
        (lx, ly, lz), inside = _box_frames(pts, boxes)
        keep = ~inside.any(dim=0) & seen
        if sem is not None:
            sem = _on(sem, dev)
            keep &= (sem < BACKGROUND_MAX_CLASS) | (sem < 0)
        p = pts[keep][:, :3].to(torch.float64)
        e2g = np.asarray(ego2global, np.float64)
        world = [p[:, 0] * e2g[k, 0] + p[:, 1] * e2g[k, 1] + p[:, 2] * e2g[k, 2] + e2g[k, 3]
                 for k in range(3)]
        self.background_xyz.append(torch.stack(world, -1).to(torch.float32))
        self.background_rgb.append(rgb[keep])

        tracked = inside[: len(track_tokens)] & seen
        counts = tracked.sum(dim=1).tolist()
        big = [b for b, c in enumerate(counts) if c >= 5]
        if not big:
            return
        tracked = tracked[big]
        rows, cols = tracked.nonzero(as_tuple=True)  # box by box, points in order
        at = torch.as_tensor(big, device=dev)[rows]
        local = torch.stack([lx[at, cols], ly[at, cols], lz[at, cols]], -1).to(torch.float32)
        sizes = [counts[b] for b in big]
        for b, xyz, col in zip(big, local.split(sizes), rgb[cols].split(sizes)):
            self.instances.setdefault(track_tokens[b], []).append((xyz, col))

    def finalize(self, out_dir: str | Path) -> List[Path]:
        """Voxel-average the clouds on the device and write them; returns
        the files written."""
        out = Path(out_dir)
        (out / "stacked_point_cloud").mkdir(parents=True, exist_ok=True)
        (out / "instance_point_cloud").mkdir(parents=True, exist_ok=True)
        written = []
        if self.background_xyz:
            xyz, rgb = voxel_downsample_tensor(torch.cat(self.background_xyz),
                                               torch.cat(self.background_rgb), self.voxel)
            path = out / "stacked_point_cloud" / "background.pcd.npz"
            save_pcd_npz(path, xyz.cpu().numpy(), rgb.cpu().numpy())
            written.append(path)
        for tok, chunks in self.instances.items():
            xyz, rgb = voxel_downsample_tensor(torch.cat([c[0] for c in chunks]),
                                               torch.cat([c[1] for c in chunks]),
                                               self.voxel / 2)
            path = out / "instance_point_cloud" / f"{tok}.pcd.npz"
            save_pcd_npz(path, xyz.cpu().numpy(), rgb.cpu().numpy())
            written.append(path)
        return written
