"""Camera models and frames; port of `mtgs_tpu/core/camera.py`.

Scene frame (camera-to-world): x right, y up, z backward. cv frame
(gsplat): x right, y down, z forward. The flip is diag(1, -1, -1). OpenCV
radial-tangential distortion is computed in torch (no cv2).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class PinholeCamera:
    """One pinhole camera: intrinsics (scalars or batched tensors), the
    scene-frame camera-to-world [..., 4, 4], and the image size."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    c2w: torch.Tensor
    width: int = 0
    height: int = 0

    @property
    def K(self) -> torch.Tensor:
        """[..., 3, 3] intrinsics matrix."""
        fx = torch.as_tensor(self.fx)
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        rows = [torch.stack([fx, z, torch.as_tensor(self.cx)], -1),
                torch.stack([z, torch.as_tensor(self.fy), torch.as_tensor(self.cy)], -1),
                torch.stack([z, z, o], -1)]
        return torch.stack(rows, -2)

    def rescale(self, scale: float) -> "PinholeCamera":
        """The camera at another output resolution (the reference's
        `rescale_output_resolution`)."""
        return dataclasses.replace(
            self, fx=self.fx * scale, fy=self.fy * scale, cx=self.cx * scale,
            cy=self.cy * scale, width=int(round(self.width * scale)),
            height=int(round(self.height * scale)))


def opencv_to_scene_frame(c2w_cv: torch.Tensor) -> torch.Tensor:
    """OpenCV-convention camera-to-world [..., 4, 4] -> the scene frame:
    the rotation's y and z columns negated (a new tensor)."""
    out = c2w_cv.clone()
    out[..., :3, 1:3] *= -1.0
    return out


def scene_to_opencv_frame(c2w_scene: torch.Tensor) -> torch.Tensor:
    """Inverse of `opencv_to_scene_frame` (the flip is an involution)."""
    return opencv_to_scene_frame(c2w_scene)


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


def world_to_camera(points: torch.Tensor, viewmat: torch.Tensor) -> torch.Tensor:
    """World points [N, 3] into the cv camera frame of a viewmat [4, 4]."""
    return points @ viewmat[:3, :3].T + viewmat[:3, 3]


def project_points(points_cam: torch.Tensor, K: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pinhole projection of cv-frame camera points [N, 3] to pixels [N, 2]."""
    z = torch.clamp(points_cam[..., 2:3], min=eps)
    xy = points_cam[..., :2] / z
    return xy * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])


def distort_opencv(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """OpenCV radial-tangential distortion of normalized coordinates
    [..., 2]; dist holds (k1, k2, p1, p2[, k3])."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if dist.shape[0] > 4 else torch.zeros((), dtype=dist.dtype, device=dist.device)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(xy_d: torch.Tensor, dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Inverse of `distort_opencv` by fixed-point iteration (cv2-style)."""
    x = xy_d
    for _ in range(iters):
        x = xy_d - (distort_opencv(x, dist) - x)
    return x


def redistort_image(image: torch.Tensor, K_raw: torch.Tensor, dist: torch.Tensor,
                    K_und: torch.Tensor,
                    out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Warp an undistorted render [H, W, C] back onto the raw camera's
    geometry (the reference's `invert_distortion`,
    `mtgs/utils/camera_utils.py:340-356`): each raw pixel is normalized with
    `K_raw`, distorted, projected with `K_und` (the render's intrinsics) and
    sampled bilinearly, zero outside the render. `out_hw` is the raw
    (height, width), by default the render's."""
    H, W = image.shape[:2]
    oh, ow = out_hw if out_hw is not None else (H, W)
    dev = image.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    K_raw, dist, K_und = f32(K_raw), f32(dist), f32(K_und)
    vv, uu = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    x = (uu - K_raw[0, 2]) / K_raw[0, 0]
    y = (vv - K_raw[1, 2]) / K_raw[1, 1]
    xy_d = distort_opencv(torch.stack([x, y], dim=-1), dist)
    us = xy_d[..., 0] * K_und[0, 0] + K_und[0, 2]
    vs = xy_d[..., 1] * K_und[1, 1] + K_und[1, 2]

    u0, v0 = torch.floor(us), torch.floor(vs)
    fu, fv = us - u0, vs - v0
    u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)

    def tap(vi, ui):
        ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        val = image[vi.clamp(0, H - 1), ui.clamp(0, W - 1)]
        return torch.where(ok[..., None], val, torch.zeros((), dtype=image.dtype, device=dev))

    return (tap(v0i, u0i) * ((1 - fu) * (1 - fv))[..., None]
            + tap(v0i, u0i + 1) * (fu * (1 - fv))[..., None]
            + tap(v0i + 1, u0i) * ((1 - fu) * fv)[..., None]
            + tap(v0i + 1, u0i + 1) * (fu * fv)[..., None])


def camera_velocity_in_world(ego_linear_velocity, ego_angular_velocity, cam2ego,
                             ego2global) -> Tuple[torch.Tensor, torch.Tensor]:
    """The camera's linear and angular velocity in the world frame from the
    ego body's rates [3] (the reference's
    `calculate_camera_velocity_in_world`, `camera_utils.py:295-338`): the
    camera rides the rigid body, so v_cam = v_ego + omega x r_cam, both
    rotated to the world."""
    dev = torch.as_tensor(cam2ego).device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    v, w = f32(ego_linear_velocity), f32(ego_angular_velocity)
    R = f32(ego2global)[:3, :3]
    v_cam_ego = v + torch.linalg.cross(w, f32(cam2ego)[:3, 3])
    return R @ v_cam_ego, R @ w
