"""A synthetic nuPlan road block in the reference's folder format.

The block is analytic: a textured street (carriageway with lane markings,
pavements, verges), box buildings with window grids, poles, a pedestrian
and one parked rigid vehicle (a track token per traversal), lit by a fixed
sun and seen by a forward camera (`CAM_F0`) with OpenCV distortion over
3 traversals x 4 frames at 2 Hz. One numpy ray caster makes everything
from one seed, so the camera images, the masks, the depth, the LiDAR
sweeps and the seed clouds agree:

* committed (`tests/fixtures/nuplan_block/`, written with PIL by running
  this script): the 1920x1080 camera JPEGs (quality 90, PIL's default
  4:2:0 sampling), the ego mask, a semantic mask (cityscapes train ids)
  and a pseudo-depth PNG (depth * 100 = ch0 + 256 * ch1, on the camera's
  `optimal_new_K` undistorted grid) per frame, and `manifest.json`: for
  each JPEG the SHA-256 of PIL's decode and its 1/32-scale block means;
* written at run time by `write_runtime_files` (numpy only, no imaging
  package): `video_scene_dict.pkl` (poses, intrinsics, distortion,
  `gt_boxes` with track tokens), `stacked_point_cloud/background.pcd`
  (binary PCD with packed rgb, ~100k points),
  `instance_point_cloud/<token>.pcd` and `raw_lidars/*.npz`.

Regenerate the committed files (a few minutes on a CPU):
    python tests/make_nuplan_fixture.py
A smaller block (the CPU tests' 96x64) is `write_images(root, block, 96,
64)` followed by `write_runtime_files(root, block, 96, 64, n_seed=...)`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pickle
import shutil
from pathlib import Path
from typing import Dict, List

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "nuplan_block"
SEED = 0
WIDTH, HEIGHT = 1920, 1080
CAM = "CAM_F0"
N_TRAVELS, N_FRAMES = 3, 4
QUALITY = 90
BLOCK = 32          # the manifest's block means: 1/32 scale
SUN = np.array([0.3, 0.5, 0.8]) / np.linalg.norm([0.3, 0.5, 0.8])
# cityscapes train ids (nuplan_scripts/utils/constants.py)
ROAD, SIDEWALK, BUILDING, POLE, TERRAIN, SKY, PERSON, CAR = 0, 1, 2, 5, 9, 10, 11, 13


@dataclasses.dataclass
class Block:
    """The analytic road block: boxes, camera, ego poses, the vehicle."""

    seed: int
    centers: np.ndarray        # [B, 3] box centres
    halves: np.ndarray         # [B, 3] half extents (box frame)
    yaws: np.ndarray           # [B]
    colors: np.ndarray         # [B, 3] base colour 0..1
    labels: np.ndarray         # [B] cityscapes train id
    windows: np.ndarray        # [B] bool: facade window grid
    ground_phase: np.ndarray   # [6] texture phases
    ego2global: np.ndarray     # [T, F, 4, 4]
    timestamps: np.ndarray     # [T, F] int microseconds
    gains: np.ndarray          # [T, 3] per-traversal colour gain
    vehicle: np.ndarray        # [T, F, 4] (x, y, z, yaw) of the vehicle's box centre
    vehicle_half: np.ndarray   # [3]
    K: np.ndarray              # [3, 3] at 1920x1080
    dist: np.ndarray           # [5] OpenCV k1, k2, p1, p2, k3
    cam2ego_t: np.ndarray      # [3]
    cam2ego_R: np.ndarray      # [3, 3] OpenCV camera -> ego

    @property
    def n_travels(self) -> int:
        return self.ego2global.shape[0]

    @property
    def n_frames(self) -> int:
        return self.ego2global.shape[1]


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _quat_wxyz(R: np.ndarray) -> List[float]:
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    return [w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
            (R[1, 0] - R[0, 1]) / (4 * w)]


def make_block(seed: int = SEED, moving_vehicle: bool = False) -> Block:
    """The block of `seed`: buildings on both sides of x in [-10, 120],
    poles, a pedestrian on the pavement, the vehicle parked on the right
    (jittered a few cm per frame: a static track) or, with
    `moving_vehicle`, driving towards the camera in the left lane."""
    rng = np.random.default_rng(seed)
    centers, halves, yaws, colors, labels, windows = [], [], [], [], [], []
    for side in (-1.0, 1.0):
        x = -12.0
        while x < 120.0:
            hx = rng.uniform(4.0, 9.0)
            hy = rng.uniform(3.0, 6.0)
            hz = rng.uniform(3.0, 9.0)
            y = side * (7.5 + hy + rng.uniform(0.0, 3.0))
            centers.append([x + hx, y, hz])
            halves.append([hx, hy, hz])
            yaws.append(rng.uniform(-0.03, 0.03))
            colors.append(rng.uniform(0.3, 0.85, 3))
            labels.append(BUILDING)
            windows.append(True)
            x += 2 * hx + rng.uniform(0.5, 3.0)
    for px in np.arange(0.0, 120.0, 15.0):
        for side in (-1.0, 1.0):
            centers.append([px + rng.uniform(-1, 1), side * 5.6, 2.5])
            halves.append([0.08, 0.08, 2.5])
            yaws.append(0.0)
            colors.append([0.45, 0.45, 0.47])
            labels.append(POLE)
            windows.append(False)
    centers.append([14.0, 4.9, 0.875])
    halves.append([0.25, 0.25, 0.875])
    yaws.append(0.0)
    colors.append([0.2, 0.3, 0.65])
    labels.append(PERSON)
    windows.append(False)

    K = np.array([[1545.0, 0.0, 960.0], [0.0, 1545.0, 560.0], [0.0, 0.0, 1.0]])
    dist = np.array([-0.12, 0.035, 0.0009, -0.0007, 0.0])
    pitch = np.deg2rad(2.0)   # camera pitched down
    R_cv = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    c, s = np.cos(pitch), np.sin(pitch)
    R_pitch = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])  # about ego y
    cam2ego_R = R_pitch @ R_cv

    lanes = np.array([-1.8, -1.5, -2.1])
    ego = np.zeros((N_TRAVELS, N_FRAMES, 4, 4))
    ts = np.zeros((N_TRAVELS, N_FRAMES), np.int64)
    veh = np.zeros((N_TRAVELS, N_FRAMES, 4))
    vehicle_half = np.array([2.2, 0.95, 0.75])
    for t in range(N_TRAVELS):
        x0 = rng.uniform(-2.0, 0.0)
        yaw = rng.uniform(-0.015, 0.015)
        for f in range(N_FRAMES):
            m = np.eye(4)
            m[:3, :3] = _rot_z(yaw)
            m[:3, 3] = [x0 + 2.5 * f, lanes[t], 0.0]
            ego[t, f] = m
            ts[t, f] = 1_620_000_000_000_000 + t * 86_400_000_000 + f * 500_000
            if moving_vehicle:
                veh[t, f] = [40.0 - 3.0 * f, 1.9, vehicle_half[2], np.pi]
            else:
                veh[t, f] = [18.0 + rng.normal(0, 0.03), -3.0 + rng.normal(0, 0.03),
                             vehicle_half[2], 0.02 + rng.normal(0, 0.002)]
    gains = np.array([[1.0, 1.0, 1.0], [0.9, 0.92, 0.97], [1.05, 1.03, 1.0]])
    return Block(
        seed=seed, centers=np.array(centers), halves=np.array(halves), yaws=np.array(yaws),
        colors=np.array(colors), labels=np.array(labels), windows=np.array(windows),
        ground_phase=rng.uniform(0, 2 * np.pi, 6), ego2global=ego, timestamps=ts,
        gains=gains, vehicle=veh, vehicle_half=vehicle_half, K=K, dist=dist,
        cam2ego_t=np.array([1.5, 0.0, 1.6]), cam2ego_R=cam2ego_R)


def _noise(a: np.ndarray, b: np.ndarray, phase: np.ndarray) -> np.ndarray:
    """A smooth value in [-1, 1] over two surface coordinates."""
    return (np.sin(0.31 * a + phase[0]) * np.cos(0.23 * b + phase[1])
            + 0.5 * np.sin(1.7 * a + 0.9 * b + phase[2])
            + 0.25 * np.cos(3.1 * b - 2.3 * a + phase[3])) / 1.75


def ground_color(block: Block, x: np.ndarray, y: np.ndarray):
    """(rgb [n, 3] 0..1, label [n]) of the ground at (x, y)."""
    ay = np.abs(y)
    n = _noise(x, y, block.ground_phase)[:, None]
    rgb = np.where((ay < 4.0)[:, None], np.array([0.36, 0.36, 0.38]) + 0.04 * n,
                   np.where((ay < 6.5)[:, None], np.array([0.62, 0.6, 0.56]) + 0.03 * n,
                            np.array([0.32, 0.47, 0.22]) + 0.06 * n))
    # lane markings: dashed centre line, solid edge lines; pavement joints
    centre = (ay < 0.12) & (np.mod(x, 6.0) < 3.0)
    edge = np.abs(ay - 3.7) < 0.1
    rgb = np.where((centre | edge)[:, None], np.array([0.88, 0.88, 0.85]), rgb)
    joint = (ay >= 4.0) & (ay < 6.5) & ((np.mod(x, 1.5) < 0.05) | (np.mod(ay, 1.25) < 0.05))
    rgb = np.where(joint[:, None], rgb * 0.8, rgb)
    label = np.where(ay < 4.0, ROAD, np.where(ay < 6.5, SIDEWALK, TERRAIN))
    return rgb, label


def _box_color(block: Block, b: np.ndarray, local: np.ndarray, axis: np.ndarray,
               world_z: np.ndarray) -> np.ndarray:
    """Surface colour of boxes `b` at box-frame points `local` on face axis."""
    rgb = block.colors[b].copy()
    win = block.windows[b] & (axis != 2)
    u = np.where(axis == 0, local[:, 1], local[:, 0])
    in_win = (np.mod(u, 3.0) > 0.8) & (np.mod(u, 3.0) < 2.2) & \
        (np.mod(world_z, 3.2) > 1.0) & (np.mod(world_z, 3.2) < 2.4) & (world_z > 0.8)
    rgb = np.where((win & in_win)[:, None], np.array([0.16, 0.21, 0.3]), rgb)
    rgb = np.where((axis == 2)[:, None], rgb * 0.85, rgb)
    return rgb


def _vehicle_color(local: np.ndarray, half: np.ndarray) -> np.ndarray:
    rgb = np.tile(np.array([0.72, 0.1, 0.08]), (len(local), 1))
    glass = (local[:, 2] > 0.15 * half[2]) & (np.abs(local[:, 0]) < 0.7 * half[0])
    rgb = np.where(glass[:, None], np.array([0.12, 0.14, 0.18]), rgb)
    wheel = (local[:, 2] < -0.55 * half[2]) & (np.abs(np.abs(local[:, 0]) - 0.6 * half[0]) < 0.35)
    return np.where(wheel[:, None], np.array([0.05, 0.05, 0.05]), rgb)


def _boxes(block: Block, t: int, f: int):
    """The boxes of frame (t, f): the static ones plus the vehicle (last)."""
    v = block.vehicle[t, f]
    centers = np.vstack([block.centers, v[None, :3]])
    halves = np.vstack([block.halves, block.vehicle_half[None]])
    yaws = np.append(block.yaws, v[3])
    return centers, halves, yaws


def cast(block: Block, t: int, f: int, origin: np.ndarray, dirs: np.ndarray,
         chunk: int = 1 << 17):
    """Ray cast [n] unit rays from one point (world frame): (distance along
    the ray [n], inf where the sky; rgb [n, 3] 0..1, shaded, before the
    traversal gain; label [n])."""
    centers, halves, yaws = _boxes(block, t, f)
    rots = [_rot_z(y) for y in yaws]
    # the box-frame origin is one point per box
    o_loc = [(origin - c) @ R for c, R in zip(centers, rots)]
    n = len(dirs)
    depth = np.full(n, np.inf)
    rgb = np.zeros((n, 3))
    label = np.full(n, SKY, np.int64)
    n_static = len(block.centers)
    for s in range(0, n, chunk):
        d = dirs[s:s + chunk]
        m = len(d)
        best = np.full(m, np.inf)
        hit = np.full(m, -2, np.int64)   # -2 sky, -1 ground, else box index
        with np.errstate(divide="ignore", invalid="ignore"):
            tg = np.where(d[:, 2] < -1e-9, -origin[2] / d[:, 2], np.inf)
        gmask = tg < best
        best[gmask], hit[gmask] = tg[gmask], -1
        face = np.zeros(m, np.int64)
        for b in range(len(centers)):
            dl = (d @ rots[b]).astype(np.float32)
            dl[np.abs(dl) < 1e-12] = 1e-12
            inv = 1.0 / dl
            t1 = (-halves[b] - o_loc[b]).astype(np.float32) * inv
            t2 = (halves[b] - o_loc[b]).astype(np.float32) * inv
            lo, hi = np.minimum(t1, t2), np.maximum(t1, t2)
            tmin = np.maximum(np.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
            tmax = np.minimum(np.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
            ok = (tmax >= tmin) & (tmin > 1e-6) & (tmin < best)
            if ok.any():
                best[ok], hit[ok] = tmin[ok], b
                face[ok] = lo[ok].argmax(1)
        p = origin + best[:, None] * d
        out_rgb = np.tile(np.array([0.55, 0.7, 0.92]), (m, 1))
        out_rgb += (np.clip(d[:, 2:3], 0, 1) * np.array([-0.2, -0.15, -0.05]))
        out_lab = np.full(m, SKY, np.int64)
        g = hit == -1
        if g.any():
            c, lab = ground_color(block, p[g, 0], p[g, 1])
            out_rgb[g] = c * (0.6 + 0.4 * SUN[2])
            out_lab[g] = lab
        for b in np.unique(hit[hit >= 0]):
            sel = hit == b
            R = rots[b]
            local = (p[sel] - centers[b]) @ R
            ax = face[sel]
            k = np.arange(sel.sum())
            normal_l = np.zeros((sel.sum(), 3))
            normal_l[k, ax] = -np.sign(d[sel] @ R)[k, ax]
            shade = 0.6 + 0.4 * np.clip((normal_l @ R.T) @ SUN, 0, 1)
            if b < n_static:
                c = _box_color(block, np.full(sel.sum(), b), local, ax, p[sel, 2])
                out_lab[sel] = block.labels[b]
            else:
                c = _vehicle_color(local, halves[b])
                out_lab[sel] = CAR
            out_rgb[sel] = c * shade[:, None]
        depth[s:s + chunk] = best
        rgb[s:s + chunk] = out_rgb
        label[s:s + chunk] = out_lab
    return depth, rgb, label


def intrinsics(block: Block, width: int, height: int) -> np.ndarray:
    """The camera's K at a render size (the 1920x1080 K scaled)."""
    K = block.K.copy()
    K[0] *= width / WIDTH
    K[1] *= height / HEIGHT
    return K


def _undistort_normalized(xy_d: np.ndarray, dist: np.ndarray, iters: int = 20) -> np.ndarray:
    k1, k2, p1, p2, k3 = dist
    x = xy_d.copy()
    for _ in range(iters):
        r2 = (x ** 2).sum(-1)
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x[:, 0] * x[:, 1] + p2 * (r2 + 2 * x[:, 0] ** 2)
        dy = p1 * (r2 + 2 * x[:, 1] ** 2) + 2 * p2 * x[:, 0] * x[:, 1]
        x = np.stack([(xy_d[:, 0] - dx) / radial, (xy_d[:, 1] - dy) / radial], -1)
    return x


def camera_pose(block: Block, t: int, f: int):
    """(OpenCV camera-to-world rotation [3, 3], camera centre [3])."""
    e = block.ego2global[t, f]
    return e[:3, :3] @ block.cam2ego_R, e[:3, :3] @ block.cam2ego_t + e[:3, 3]


def optimal_K(block: Block, width: int, height: int) -> np.ndarray:
    """The undistorted camera the data layer makes (dataset.py's
    `optimal` mode: `optimal_new_K` of the pixel-corner K, shifted back)."""
    from mtgs_torch.data.dataset import optimal_new_K

    K = intrinsics(block, width, height)
    K_adj = K.copy()
    K_adj[:2, 2] -= 0.5
    newK = optimal_new_K(K_adj, block.dist, (width, height), alpha=1.0)
    newK[:2, 2] += 0.5
    return newK


def render_frame(block: Block, t: int, f: int, width: int, height: int) -> Dict[str, np.ndarray]:
    """The raw (distorted) camera image uint8 [H, W, 3], its semantic mask
    uint8 [H, W], and the z-depth [H, W] on the `optimal_K` grid."""
    K = intrinsics(block, width, height)
    R, C = camera_pose(block, t, f)
    u, v = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    xy_d = np.stack([(u.ravel() - K[0, 2]) / K[0, 0], (v.ravel() - K[1, 2]) / K[1, 1]], -1)
    xy = _undistort_normalized(xy_d, block.dist)
    dirs = np.concatenate([xy, np.ones((len(xy), 1))], -1) @ R.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    _, rgb, label = cast(block, t, f, C, dirs)
    img = np.clip(rgb * block.gains[t], 0, 1).reshape(height, width, 3)

    Kn = optimal_K(block, width, height)
    cam = np.stack([(u.ravel() - Kn[0, 2]) / Kn[0, 0], (v.ravel() - Kn[1, 2]) / Kn[1, 1],
                    np.ones(u.size)], -1)
    dirs_n = cam @ R.T
    norm = np.linalg.norm(dirs_n, axis=-1)
    dist_along, _, _ = cast(block, t, f, C, dirs_n / norm[:, None])
    z = dist_along / norm   # z-depth: the ray's length over its z = 1 scale
    return dict(rgb=np.round(img * 255).astype(np.uint8),
                semantic=label.reshape(height, width).astype(np.uint8),
                depth=z.reshape(height, width))


def frame_token(t: int, f: int) -> str:
    return f"lidarpc{t:02d}{f:03d}"


def image_rel(t: int, f: int) -> str:
    return f"travel{t}/{CAM}/{frame_token(t, f)}cam.jpg"


def ego_mask(width: int, height: int) -> np.ndarray:
    """The static CAM_F0 ego mask: the bonnet, 255, at the bottom."""
    x = (np.arange(width) + 0.5) / width - 0.5
    top = height * (0.93 + 0.05 * (2 * x) ** 2)
    rows = np.arange(height)[:, None] + 0.5
    return np.where(rows >= top[None, :], 255, 0).astype(np.uint8)


def block_means(img: np.ndarray, block: int = BLOCK) -> np.ndarray:
    """Per-channel means over block x block tiles (the last row and column
    of tiles partial), in 0..1: [ceil(H / block), ceil(W / block), C]."""
    h, w = img.shape[:2]
    x = img.astype(np.float64) / 255.0
    rows = np.add.reduceat(x, np.arange(0, h, block), axis=0)
    sums = np.add.reduceat(rows, np.arange(0, w, block), axis=1)
    ch = np.minimum(block, h - np.arange(0, h, block))
    cw = np.minimum(block, w - np.arange(0, w, block))
    return sums / (ch[:, None, None] * cw[None, :, None])


def write_images(root: Path, block: Block, width: int = WIDTH,
                 height: int = HEIGHT) -> Dict[str, dict]:
    """The PIL-written files: camera JPEGs, the ego mask, semantic masks and
    pseudo-depth PNGs. Returns the manifest entry of each JPEG."""
    from PIL import Image

    root = Path(root)
    (root / "ego_masks").mkdir(parents=True, exist_ok=True)
    Image.fromarray(ego_mask(width, height)).save(root / "ego_masks" / f"{CAM}.png")
    manifest = {}
    for t in range(block.n_travels):
        for f in range(block.n_frames):
            fr = render_frame(block, t, f, width, height)
            rel = image_rel(t, f)
            for sub in ("raw_images", "semantic_masks", "optimal_undistorted_depth"):
                (root / sub / rel).parent.mkdir(parents=True, exist_ok=True)
            jpg = root / "raw_images" / rel
            Image.fromarray(fr["rgb"]).save(jpg, quality=QUALITY)
            png = rel.replace(".jpg", ".png")
            Image.fromarray(fr["semantic"]).save(root / "semantic_masks" / png)
            cm = np.round(np.where(np.isfinite(fr["depth"]), fr["depth"], 0.0) * 100.0)
            cm = np.clip(cm, 0, 65535).astype(np.uint16)
            depth_png = np.stack([cm & 0xFF, cm >> 8, np.zeros_like(cm)], -1).astype(np.uint8)
            Image.fromarray(depth_png).save(root / "optimal_undistorted_depth" / png)
            decoded = np.asarray(Image.open(jpg))
            manifest[f"raw_images/{rel}"] = dict(
                sha256=hashlib.sha256(decoded.tobytes()).hexdigest(),
                block_means=np.round(block_means(decoded), 5).tolist())
    return manifest


def _write_pcd(path: Path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary PCD v0.7: x y z float32 and rgb packed into a float32."""
    rgb8 = np.clip(np.round(rgb), 0, 255).astype(np.uint32)
    packed = ((rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]).view(np.float32)
    rec = np.empty(len(xyz), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<f4")])
    rec["x"], rec["y"], rec["z"] = (xyz[:, i].astype(np.float32) for i in range(3))
    rec["rgb"] = packed
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\nFIELDS x y z rgb\n"
              "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {len(xyz)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(xyz)}\n"
              "DATA binary\n")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(header.encode("ascii") + rec.tobytes())


def _surface_points(block: Block, rng: np.random.Generator, n: int):
    """Background seeds: points on the ground and on the box faces that
    face the road (and roofs), with their shaded colours 0..255."""
    n_ground = n // 2
    x = rng.uniform(-12.0, 120.0, n_ground)
    y = rng.uniform(-30.0, 30.0, n_ground)
    g_rgb, _ = ground_color(block, x, y)
    pts = [np.stack([x, y, np.zeros_like(x)], -1)]
    cols = [g_rgb * (0.6 + 0.4 * SUN[2])]
    # box faces by area: the face towards the road (local -y side for boxes
    # at y > 0), the road-end faces and the roof
    areas = []
    faces = []
    for b in range(len(block.centers)):
        hx, hy, hz = block.halves[b]
        toward = -np.sign(block.centers[b, 1]) or 1.0
        for axis, sign, area in ((1, toward, 4 * hx * hz), (0, -1.0, 4 * hy * hz),
                                 (0, 1.0, 4 * hy * hz), (2, 1.0, 4 * hx * hy)):
            faces.append((b, axis, sign))
            areas.append(area)
    areas = np.asarray(areas)
    pick = rng.choice(len(faces), n - n_ground, p=areas / areas.sum())
    uv = rng.uniform(-1.0, 1.0, (n - n_ground, 3))
    for k in np.unique(pick):
        sel = pick == k
        b, axis, sign = faces[k]
        local = uv[sel] * block.halves[b]
        local[:, axis] = sign * block.halves[b][axis]
        R = _rot_z(block.yaws[b])
        world = local @ R.T + block.centers[b]
        normal = np.zeros(3)
        normal[axis] = sign
        shade = 0.6 + 0.4 * np.clip((R @ normal) @ SUN, 0, 1)
        c = _box_color(block, np.full(sel.sum(), b), local, np.full(sel.sum(), axis),
                       world[:, 2])
        pts.append(world)
        cols.append(c * shade)
    return np.concatenate(pts), np.concatenate(cols) * 255.0


def _vehicle_points(block: Block, rng: np.random.Generator, n: int):
    """The vehicle's points in its box frame, on its faces, colours 0..255."""
    half = block.vehicle_half
    areas = np.array([half[1] * half[2], half[1] * half[2], half[0] * half[2],
                      half[0] * half[2], half[0] * half[1]])
    face = rng.choice(5, n, p=areas / areas.sum())
    local = rng.uniform(-1.0, 1.0, (n, 3)) * half
    axis = np.array([0, 0, 1, 1, 2])[face]
    sign = np.array([-1.0, 1.0, -1.0, 1.0, 1.0])[face]
    local[np.arange(n), axis] = sign * half[axis]
    return local, _vehicle_color(local, half) * 255.0 * (0.6 + 0.4 * SUN[2])


def write_runtime_files(root: Path, block: Block, width: int = WIDTH, height: int = HEIGHT, *,
                        n_seed: int = 100_000, n_vehicle: int = 3000, beams: int = 32,
                        azimuths: int = 1024) -> None:
    """Everything of the road block that needs no imaging package, from the
    block's seed: video_scene_dict.pkl (the camera's intrinsics at the
    images' size), the background seed cloud, the vehicle's point cloud
    (one file per track token) and a LiDAR sweep per frame
    (`raw_lidars/<token>.npz`, points in the LiDAR frame)."""
    root = Path(root)
    rng = np.random.default_rng(block.seed + 1)
    xyz, rgb = _surface_points(block, rng, n_seed)
    _write_pcd(root / "stacked_point_cloud" / "background.pcd", xyz, rgb)
    v_xyz, v_rgb = _vehicle_points(block, rng, n_vehicle)

    lidar2ego = np.eye(4)
    lidar2ego[2, 3] = 1.8
    elev = np.deg2rad(np.linspace(-25.0, 5.0, beams))
    azim = np.linspace(-np.pi, np.pi, azimuths, endpoint=False)
    ee, aa = np.meshgrid(elev, azim, indexing="ij")
    beam_dirs = np.stack([np.cos(ee) * np.cos(aa), np.cos(ee) * np.sin(aa),
                          np.sin(ee)], -1).reshape(-1, 3)
    K = intrinsics(block, width, height)
    q_cam = _quat_wxyz(block.cam2ego_R)
    vsd = {}
    for t in range(block.n_travels):
        token = f"track-vehicle-{t}"
        _write_pcd(root / "instance_point_cloud" / f"{token}.pcd", v_xyz, v_rgb)
        infos = []
        for f in range(block.n_frames):
            e = block.ego2global[t, f]
            l2w = e @ lidar2ego
            depth, _, _ = cast(block, t, f, l2w[:3, 3], beam_dirs @ l2w[:3, :3].T)
            keep = np.isfinite(depth) & (depth < 80.0)
            pts = beam_dirs[keep] * depth[keep, None]
            lidar_rel = f"travel{t}/{frame_token(t, f)}.npz"
            (root / "raw_lidars" / lidar_rel).parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(root / "raw_lidars" / lidar_rel, xyz=pts.astype(np.float32))
            # the vehicle's box in the ego frame (x, y, z, l, w, h, heading)
            vx, vy, vz, vyaw = block.vehicle[t, f]
            centre = e[:3, :3].T @ (np.array([vx, vy, vz]) - e[:3, 3])
            heading = vyaw - np.arctan2(e[1, 0], e[0, 0])
            infos.append(dict(
                token=frame_token(t, f), frame_idx=f, skipped=False,
                timestamp=int(block.timestamps[t, f]), ego2global=e, lidar2ego=lidar2ego,
                lidar_path=lidar_rel,
                cams={CAM: dict(
                    data_path=image_rel(t, f), sensor2ego_rotation=q_cam,
                    sensor2ego_translation=block.cam2ego_t.tolist(), cam_intrinsic=K,
                    distortion=block.dist, token=f"{frame_token(t, f)}cam",
                    timestamp=int(block.timestamps[t, f]) + 10_000)},
                gt_boxes=np.array([[*centre, *(2 * block.vehicle_half), heading]]),
                gt_names=["vehicle"], track_tokens=[token]))
        vsd[f"roadblock-{t}"] = dict(
            video_token=f"roadblock-{t}",
            trajectory=block.ego2global[t, :, :3, 3].copy(), frame_infos=infos)
    with open(root / "video_scene_dict.pkl", "wb") as fh:
        pickle.dump(vsd, fh)


def write_stage_inputs(root: Path) -> dict:
    """The data factory's inputs for stages 5-8 (`preprocess/pipeline.py`)
    from a written block: each camera JPEG undistorted by the port's
    `undistort_image` ("optimal" K) to `images/undistorted/<name>.jpg`, its
    semantic mask (nearest) to `masks/undistorted/<stem>_cityscape.png`,
    and the raw-stage `video_scene_dict` the stages read (nuPlan's raw
    schema: `ego2global_translation` / `_rotation` (wxyz), `can_bus`,
    `lidar_path` relative to the block, the undistorted intrinsics), which
    is returned for the caller to save as the "raw" stage. Uses the port's
    decoders and encoders, not PIL."""
    from mtgs_torch.data.dataset import undistort_image
    from mtgs_torch.data.image_io import read_image, write_jpeg
    from mtgs_torch.tools.render import write_png

    root = Path(root)
    with open(root / "video_scene_dict.pkl", "rb") as fh:
        vsd = pickle.load(fh)
    (root / "images" / "undistorted").mkdir(parents=True, exist_ok=True)
    (root / "masks" / "undistorted").mkdir(parents=True, exist_ok=True)
    raw = {}
    for token, info in vsd.items():
        frames = []
        for fr in info["frame_infos"]:
            e = np.asarray(fr["ego2global"], np.float64)
            q = _quat_wxyz(e[:3, :3])
            cams = {}
            for cam, ci in fr["cams"].items():
                img = read_image(root / "raw_images" / ci["data_path"])
                und, K, _ = undistort_image(img, ci["cam_intrinsic"], ci["distortion"])
                name = Path(ci["data_path"]).name
                write_jpeg(root / "images" / "undistorted" / name,
                           np.clip(np.round(und), 0, 255).astype(np.uint8))
                mask = read_image(root / "semantic_masks" / ci["data_path"].replace(".jpg", ".png"))
                mask_u, _, _ = undistort_image(mask, ci["cam_intrinsic"], ci["distortion"],
                                               nearest=True)
                write_png(root / "masks" / "undistorted" / (Path(name).stem + "_cityscape.png"),
                          mask_u.astype(np.uint8))
                cams[cam] = dict(ci, cam_intrinsic=K, distortion=np.zeros(5))
            frames.append(dict(
                token=fr["token"], frame_idx=fr["frame_idx"], timestamp=fr["timestamp"],
                lidar_path="raw_lidars/" + fr["lidar_path"],
                ego2global_translation=e[:3, 3].tolist(), ego2global_rotation=q,
                can_bus=np.concatenate([e[:3, 3], q, np.zeros(11)]),
                cams=cams, gt_boxes=fr["gt_boxes"], gt_names=fr["gt_names"],
                track_tokens=fr["track_tokens"]))
        raw[token] = dict(video_token=token, trajectory=info["trajectory"], frame_infos=frames)
    return raw


def materialize(dest: Path) -> Path:
    """The full road block at `dest`: the committed images copied in, the
    rest written from the seed. Needs no imaging package."""
    dest = Path(dest)
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(FIXTURE, dest)
    write_runtime_files(dest, make_block(SEED))
    return dest


def main() -> None:
    if FIXTURE.exists():
        shutil.rmtree(FIXTURE)
    FIXTURE.mkdir(parents=True)
    block = make_block(SEED)
    images = write_images(FIXTURE, block)
    (FIXTURE / "manifest.json").write_text(json.dumps(dict(
        seed=SEED, width=WIDTH, height=HEIGHT, camera=CAM, jpeg_quality=QUALITY,
        subsampling="4:2:0", block=BLOCK, images=images), separators=(",", ":")))
    total = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    print(f"wrote {FIXTURE} ({total / 1e6:.2f} MB)")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # mtgs_torch
    main()
