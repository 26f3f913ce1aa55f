"""Per-view sample loading: images, undistortion, masks, LiDAR depth; port
of `mtgs_tpu/data/dataset.py`.

numpy/scipy rewrite of the reference's `CustomInputDataset`
(`mtgs/dataset/custom_dataset.py` in OpenDriveLab/MTGS) without the cv2
dependency. Where the JAX package decodes and resizes with PIL, the port
calls its own `image_io` (`read_image`, `to_luma`, `resize`), which gives
PIL's arrays:

  * `optimal` / `keep_focal_length` undistortion with intrinsics rewrite
    and valid-region mask (ref `_undistort_image`, :99-152) — the
    `optimal` new camera matrix reproduces cv2.getOptimalNewCameraMatrix
    (alpha=1) from the undistorted border-grid rectangles;
  * semantic-class masks from cityscapes-id PNG maps (ref :257-274);
  * sparse LiDAR z-buffer depth via lidar2cam + K projection
    (ref `_get_depth_from_lidar`, :175-201);
  * 2-channel pseudo-depth PNG decode (depth*100 split into two bytes,
    ref :162-173).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from mtgs_torch.data.image_io import read_image, resize, to_luma
from mtgs_torch.data.nuplan import ImageRecord
from mtgs_torch.utils.pointcloud import load_pcd

# cityscapes train ids used by the reference's mask classes
# (nuplan_scripts/utils/constants.py:23-43)
CITYSCAPE_IDS = {
    "road": 0, "sidewalk": 1, "building": 2, "wall": 3, "fence": 4,
    "pole": 5, "traffic_light": 6, "traffic_sign": 7, "vegetation": 8,
    "terrain": 9, "sky": 10, "person": 11, "rider": 12, "car": 13,
    "truck": 14, "bus": 15, "train": 16, "motorcycle": 17, "bicycle": 18,
}
CLASS_TO_IDS = {
    "pedestrian": (11, 12),
    "bicycle": (17, 18),
    "vehicle": (13, 14, 15, 16),
    "sky": (10,),
}


def _distort_normalized(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if len(dist) > 4 else 0.0
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], -1)


def _undistort_normalized(xy_d: np.ndarray, dist: np.ndarray, iters: int = 10):
    x = xy_d.copy()
    for _ in range(iters):
        x = xy_d - (_distort_normalized(x, dist) - x)
    return x


def optimal_new_K(
    K: np.ndarray, dist: np.ndarray, size: Tuple[int, int], alpha: float = 1.0,
    grid_n: int = 9,
) -> np.ndarray:
    """cv2.getOptimalNewCameraMatrix equivalent (inner/outer rectangles of
    the undistorted border grid, interpolated by alpha)."""
    w, h = size
    us = np.linspace(0, w - 1, grid_n)
    vs = np.linspace(0, h - 1, grid_n)
    gu, gv = np.meshgrid(us, vs)
    pts = np.stack([gu, gv], -1).reshape(-1, 2)
    norm = (pts - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    und = _undistort_normalized(norm, dist).reshape(grid_n, grid_n, 2)

    outer_x0, outer_y0 = und[..., 0].min(), und[..., 1].min()
    outer_x1, outer_y1 = und[..., 0].max(), und[..., 1].max()
    inner_x0 = und[:, 0, 0].max()
    inner_x1 = und[:, -1, 0].min()
    inner_y0 = und[0, :, 1].max()
    inner_y1 = und[-1, :, 1].min()

    def rect_to_K(x0, y0, x1, y1):
        fx = (w - 1) / (x1 - x0)
        fy = (h - 1) / (y1 - y0)
        return np.array([[fx, 0, -x0 * fx], [0, fy, -y0 * fy], [0, 0, 1.0]])

    K_inner = rect_to_K(inner_x0, inner_y0, inner_x1, inner_y1)
    K_outer = rect_to_K(outer_x0, outer_y0, outer_x1, outer_y1)
    return K_inner * (1 - alpha) + K_outer * alpha


@functools.lru_cache(maxsize=64)
def _undistort_map_cached(K_bytes, dist_bytes, size, mode):
    K = np.frombuffer(K_bytes).reshape(3, 3)
    dist = np.frombuffer(dist_bytes)
    w, h = size
    # pixel-corner convention shift, as the reference does (:108-110,131-133)
    K_adj = K.copy()
    K_adj[0, 2] -= 0.5
    K_adj[1, 2] -= 0.5
    if mode == "optimal":
        newK = optimal_new_K(K_adj, dist, size, alpha=1.0)
    else:  # keep_focal_length
        newK = K_adj.copy()
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    norm = np.stack(
        [(us - newK[0, 2]) / newK[0, 0], (vs - newK[1, 2]) / newK[1, 1]], -1
    )
    dn = _distort_normalized(norm, dist)
    src_u = dn[..., 0] * K_adj[0, 0] + K_adj[0, 2]
    src_v = dn[..., 1] * K_adj[1, 1] + K_adj[1, 2]
    newK_out = newK.copy()
    newK_out[0, 2] += 0.5
    newK_out[1, 2] += 0.5
    return src_u.astype(np.float32), src_v.astype(np.float32), newK_out


def undistort_image(
    image: np.ndarray, K: np.ndarray, dist: np.ndarray,
    mode: str = "optimal", nearest: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undistort -> (image, new_K, valid_mask[h,w])."""
    h, w = image.shape[:2]
    su, sv, newK = _undistort_map_cached(
        np.ascontiguousarray(K, np.float64).tobytes(),
        np.ascontiguousarray(dist, np.float64).tobytes(),
        (w, h), mode,
    )
    from scipy.ndimage import map_coordinates

    coords = np.stack([sv.ravel(), su.ravel()])
    order = 0 if nearest else 1
    if image.ndim == 2:
        out = map_coordinates(image.astype(np.float32), coords, order=order,
                              mode="constant", cval=0).reshape(h, w)
    else:
        out = np.stack([
            map_coordinates(image[..., c].astype(np.float32), coords, order=order,
                            mode="constant", cval=0).reshape(h, w)
            for c in range(image.shape[-1])
        ], -1)
    valid = (
        (su >= 0) & (su <= w - 1) & (sv >= 0) & (sv <= h - 1)
    )
    return out.astype(image.dtype if image.dtype == np.uint8 and order == 0 else np.float32), newK, valid


def lidar_depth_image(
    points_lidar: np.ndarray, lidar2cam: np.ndarray, K: np.ndarray,
    size: Tuple[int, int],
) -> np.ndarray:
    """Sparse z-buffer depth [h, w, 1] from LiDAR points
    (ref `_get_depth_from_lidar`, :175-201; nearest-point-wins)."""
    w, h = size
    p = points_lidar @ lidar2cam[:3, :3].T + lidar2cam[:3, 3]
    z = p[:, 2]
    keep = z > 0.1
    p, z = p[keep], z[keep]
    u = (p[:, 0] / z * K[0, 0] + K[0, 2]).astype(np.int32)
    v = (p[:, 1] / z * K[1, 1] + K[1, 2]).astype(np.int32)
    inb = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    u, v, z = u[inb], v[inb], z[inb]
    depth = np.full((h, w), np.inf, np.float32)
    np.minimum.at(depth, (v, u), z.astype(np.float32))
    depth[~np.isfinite(depth)] = 0.0
    return depth[..., None]


def decode_pseudo_depth(png: np.ndarray) -> np.ndarray:
    """2-channel pseudo-depth PNG -> meters (ref :162-173 and
    `generate_dense_depth.py:179-282`: depth*100 = ch0 + 256*ch1)."""
    d = (png[..., 0].astype(np.float32) + 256.0 * png[..., 1].astype(np.float32)) * 0.01
    return d[..., None]


def semantic_class_mask(
    semantic: np.ndarray, classes: Sequence[str]
) -> np.ndarray:
    """True where the pixel belongs to any of the given classes."""
    ids = [i for c in classes for i in CLASS_TO_IDS[c]]
    return np.isin(semantic, ids)


@dataclasses.dataclass
class SampleConfig:
    scale_factor: float = 0.5
    undistort: str = "optimal"
    load_lidar_depth: bool = True
    load_pseudo_depth: bool = True
    mask_classes: Tuple[str, ...] = ("pedestrian", "bicycle")
    mask_all_foreground: bool = False  # eval-only traversals
    load_panoptic: bool = False
    # render/inference mode: zero image of the camera's geometry, no
    # file reads (ref `custom_dataset.py:306-316` get_fake_data)
    fake_data: bool = False


def adjust_brightness(image_u8: np.ndarray, factor: float) -> np.ndarray:
    """Per-camera exposure alignment applied at load (ref
    `custom_dataset.py:24-31,89-91`: RGB->HSV, scale + clip the V
    channel, back to RGB). For fixed hue/saturation, RGB is linear in V,
    so the cv2 HSV round-trip is equivalent to scaling each pixel's RGB
    by min(factor, 255/V) with V = max(R, G, B) — computed here directly
    in numpy (no cv2 dependency), preserving hue/saturation under clip
    exactly where the uint8 HSV path does."""
    if factor == 1.0:
        return image_u8
    v = image_u8.max(axis=-1, keepdims=True).astype(np.float64)
    scale = np.where(
        v > 0, np.minimum(v * factor, 255.0) / np.maximum(v, 1e-9), 1.0
    )
    return np.clip(np.round(image_u8 * scale), 0, 255).astype(np.uint8)


def load_sample(
    rec: ImageRecord, cfg: SampleConfig
) -> Dict[str, np.ndarray]:
    """Load + undistort + derive all layers for one view (host-side)."""
    if cfg.fake_data:
        # inference mode (ref `custom_dataset.py:306-316`): a zero image
        # with the camera's undistorted geometry, no file reads
        img = np.zeros((rec.height, rec.width, 3), np.float32)
    else:
        img_u8 = read_image(rec.image_path)
        if img_u8.ndim == 2:
            img_u8 = np.repeat(img_u8[:, :, None], 3, axis=2)
        img_u8 = adjust_brightness(img_u8[..., :3], rec.v_adjust)
        img = img_u8.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    und, newK, valid = undistort_image(img, rec.intrinsic, rec.distortion, cfg.undistort)
    mask = valid.astype(np.float32)[..., None]

    if (not cfg.fake_data and rec.ego_mask_path
            and Path(rec.ego_mask_path).exists()):
        # static per-camera ego-vehicle mask: nonzero pixels are the ego
        # body -> excluded from supervision (ref custom_dataset.py:154-160)
        ego_raw = to_luma(rec.ego_mask_path)
        ego_valid = (ego_raw == 0).astype(np.float32)
        ego_und, _, _ = undistort_image(
            ego_valid, rec.intrinsic, rec.distortion, cfg.undistort,
            nearest=True)
        mask = mask * ego_und[..., None]

    sem = None
    if cfg.fake_data:
        pass
    elif rec.semantic_mask_path and Path(rec.semantic_mask_path).exists():
        sem_raw = read_image(rec.semantic_mask_path)
        sem, _, _ = undistort_image(sem_raw, rec.intrinsic, rec.distortion,
                                    cfg.undistort, nearest=True)
        sem = sem.astype(np.int32)
        classes = ("pedestrian", "bicycle", "vehicle") if cfg.mask_all_foreground \
            else cfg.mask_classes
        if classes:
            mask = mask * (~semantic_class_mask(sem, classes))[..., None]

    pan_inst = pan_sem = None
    if (cfg.load_panoptic and rec.panoptic_mask_path
            and Path(rec.panoptic_mask_path).exists()):
        pan_inst, pan_sem = load_panoptic_map(
            rec.panoptic_mask_path, rec.intrinsic, rec.distortion,
            cfg.undistort, valid_mask=valid)

    out: Dict[str, np.ndarray] = {}
    depth = None
    if (not cfg.fake_data and cfg.load_lidar_depth and rec.lidar_path
            and Path(rec.lidar_path).exists()):
        pts, _ = load_pcd(rec.lidar_path)
        if pts is not None:
            depth = lidar_depth_image(pts, rec.lidar2cam, newK, (w, h))
    pseudo = None
    if (not cfg.fake_data and cfg.load_pseudo_depth and rec.depth_image_path
            and Path(rec.depth_image_path).exists()):
        png = read_image(rec.depth_image_path)
        if png.ndim == 3 and png.shape[2] >= 2:
            pseudo = decode_pseudo_depth(png)

    s = cfg.scale_factor
    out["image"] = resize(und.astype(np.float32), s)
    out["mask"] = resize(mask, s, nearest=True).astype(np.float32)
    if out["mask"].ndim == 2:
        out["mask"] = out["mask"][..., None]
    K_s = newK.copy()
    K_s[:2] *= s
    out["K"] = K_s.astype(np.float32)
    if depth is not None:
        out["lidar_depth"] = resize(depth, s, nearest=True).reshape(
            out["image"].shape[0], out["image"].shape[1], 1
        )
    if pseudo is not None:
        out["pseudo_depth"] = resize(pseudo, s, nearest=True).reshape(
            out["image"].shape[0], out["image"].shape[1], 1
        )
    if pan_inst is not None:
        out["instance_map"] = resize(pan_inst[..., 0], s, nearest=True)[
            ..., None].astype(np.int32)
        out["semantic_map"] = resize(pan_sem[..., 0], s, nearest=True)[
            ..., None].astype(np.int32)
    return out


def load_panoptic_map(
    path: str,
    intrinsic: np.ndarray,
    distortion: np.ndarray,
    undistort: str,
    *,
    valid_mask: Optional[np.ndarray] = None,
):
    """Panoptic map decode (ref `custom_dataset.py:203-232`): .npy or a
    3-channel PNG where instance id = ch0 + 256*ch1 and semantic class =
    ch2; undistorted with nearest resampling; pixels outside the valid
    undistortion region get instance 0 / semantic 255 (the reference's
    invalid markers). Returns (instance_map [h,w,1] int32,
    semantic_map [h,w,1] int32)."""
    if str(path).endswith(".npy"):
        pan = np.load(path)
    else:
        pan = read_image(path).astype(np.uint8)
    pan_u, _, _ = undistort_image(pan, intrinsic, distortion, undistort,
                                  nearest=True)
    pan_u = pan_u.astype(np.int32)
    inst = (pan_u[..., 0] + pan_u[..., 1] * 256)[..., None]
    sem = pan_u[..., 2:3]
    if valid_mask is not None:
        bad = ~valid_mask.astype(bool)
        inst[bad] = 0
        sem[bad] = 255
    return inst, sem
