"""Stage 6: COLMAP interop — binary model IO, database, triangulation;
port of `mtgs_tpu/preprocess/colmap.py`.

Counterpart of the reference's `nuplan_scripts/utils/colmap_utils/`
(OpenDriveLab/MTGS: database.py, read_write_model.py,
point_triangulator.py, bundle_adjustment.py, align_model.py). COLMAP
itself stays an external binary (as in the reference); everything around
it is implemented here from the public COLMAP formats:

  * binary sparse-model read/write (cameras.bin / images.bin /
    points3D.bin) — needed to hand COLMAP a fixed-pose model of all
    traversals and to read back refined intrinsics + the SfM seed cloud;
  * the feature/match sqlite database (stdlib sqlite3);
  * `point_triangulator` / `bundle_adjuster` subprocess wrappers, gated
    on the `colmap` binary being present;
  * `umeyama_sim3` — similarity alignment of the COLMAP model back to
    the world frame (ref `align_model.py`; poses are scaled to ~10 m
    scene scale before BA and de-scaled after).

Quaternions go through `mtgs_torch/core/quat.py` in float32 on the CPU, as
the JAX package converts them in float32 (host code: nothing here runs on
the card).
"""

from __future__ import annotations

import shutil
import sqlite3
import struct
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mtgs_torch.core.quat import quat_to_rotmat, rotmat_to_quat

CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "FULL_OPENCV": (6, 12),
}
MODEL_BY_ID = {mid: (name, n) for name, (mid, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    image_id: int
    qvec: np.ndarray      # wxyz, world->cam
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


# ----------------------------------------------------------- binary IO


def write_cameras_bin(cameras: Dict[int, Camera], path: str | Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, n = CAMERA_MODELS[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{n}d", *np.asarray(cam.params, np.float64)))


def read_cameras_bin(path: str | Path) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n = MODEL_BY_ID[mid]
            params = np.array(struct.unpack(f"<{n}d", f.read(8 * n)))
            out[cid] = Camera(cid, name, w, h, params)
    return out


def write_images_bin(images: Dict[int, Image], path: str | Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<I", im.image_id))
            f.write(struct.pack("<4d", *np.asarray(im.qvec, np.float64)))
            f.write(struct.pack("<3d", *np.asarray(im.tvec, np.float64)))
            f.write(struct.pack("<I", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))


def read_images_bin(path: str | Path) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            (iid,) = struct.unpack("<I", f.read(4))
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            (cid,) = struct.unpack("<I", f.read(4))
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (npts,) = struct.unpack("<Q", f.read(8))
            xys = np.zeros((npts, 2))
            pids = np.zeros((npts,), np.int64)
            for i in range(npts):
                x, y, pid = struct.unpack("<ddq", f.read(24))
                xys[i] = (x, y)
                pids[i] = pid
            out[iid] = Image(iid, qvec, tvec, cid, name.decode(), xys, pids)
    return out


def write_points3D_bin(points: Dict[int, Point3D], path: str | Path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<3d", *np.asarray(p.xyz, np.float64)))
            f.write(struct.pack("<3B", *np.asarray(p.rgb, np.uint8)))
            f.write(struct.pack("<d", float(p.error)))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, pidx in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<II", int(iid), int(pidx)))


def read_points3D_bin(path: str | Path) -> Dict[int, Point3D]:
    out = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            (pid,) = struct.unpack("<Q", f.read(8))
            xyz = np.array(struct.unpack("<3d", f.read(24)))
            rgb = np.array(struct.unpack("<3B", f.read(3)), np.uint8)
            (err,) = struct.unpack("<d", f.read(8))
            (tlen,) = struct.unpack("<Q", f.read(8))
            iids = np.zeros((tlen,), np.uint32)
            pidxs = np.zeros((tlen,), np.uint32)
            for i in range(tlen):
                iids[i], pidxs[i] = struct.unpack("<II", f.read(8))
            out[pid] = Point3D(pid, xyz, rgb, float(err), iids, pidxs)
    return out


def write_model(cameras, images, points, model_dir: str | Path) -> None:
    d = Path(model_dir)
    d.mkdir(parents=True, exist_ok=True)
    write_cameras_bin(cameras, d / "cameras.bin")
    write_images_bin(images, d / "images.bin")
    write_points3D_bin(points, d / "points3D.bin")


def read_model(model_dir: str | Path):
    d = Path(model_dir)
    return (
        read_cameras_bin(d / "cameras.bin"),
        read_images_bin(d / "images.bin"),
        read_points3D_bin(d / "points3D.bin"),
    )


# ----------------------------------------------------------- database


def image_ids_to_pair_id(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * 2147483647 + id2


class ColmapDatabase:
    """Minimal COLMAP sqlite database writer (features/matches import)."""

    SCHEMA = """
    CREATE TABLE IF NOT EXISTS cameras (
        camera_id INTEGER PRIMARY KEY, model INTEGER NOT NULL,
        width INTEGER NOT NULL, height INTEGER NOT NULL,
        params BLOB, prior_focal_length INTEGER NOT NULL);
    CREATE TABLE IF NOT EXISTS images (
        image_id INTEGER PRIMARY KEY, name TEXT NOT NULL UNIQUE,
        camera_id INTEGER NOT NULL,
        prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
        prior_tx REAL, prior_ty REAL, prior_tz REAL);
    CREATE TABLE IF NOT EXISTS keypoints (
        image_id INTEGER PRIMARY KEY, rows INTEGER NOT NULL,
        cols INTEGER NOT NULL, data BLOB);
    CREATE TABLE IF NOT EXISTS descriptors (
        image_id INTEGER PRIMARY KEY, rows INTEGER NOT NULL,
        cols INTEGER NOT NULL, data BLOB);
    CREATE TABLE IF NOT EXISTS matches (
        pair_id INTEGER PRIMARY KEY, rows INTEGER NOT NULL,
        cols INTEGER NOT NULL, data BLOB);
    CREATE TABLE IF NOT EXISTS two_view_geometries (
        pair_id INTEGER PRIMARY KEY, rows INTEGER NOT NULL,
        cols INTEGER NOT NULL, data BLOB, config INTEGER NOT NULL,
        F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
    """

    def __init__(self, path: str | Path):
        self.conn = sqlite3.connect(str(path))
        self.conn.executescript(self.SCHEMA)

    def add_camera(self, camera: Camera, prior_focal: bool = True) -> None:
        model_id, _ = CAMERA_MODELS[camera.model]
        self.conn.execute(
            "INSERT OR REPLACE INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera.camera_id, model_id, camera.width, camera.height,
                np.asarray(camera.params, np.float64).tobytes(), int(prior_focal),
            ),
        )

    def add_image(self, image: Image) -> None:
        q, t = image.qvec, image.tvec
        self.conn.execute(
            "INSERT OR REPLACE INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image.image_id, image.name, image.camera_id,
             q[0], q[1], q[2], q[3], t[0], t[1], t[2]),
        )

    def add_keypoints(self, image_id: int, xys: np.ndarray) -> None:
        kp = np.zeros((len(xys), 6), np.float32)
        kp[:, :2] = xys
        kp[:, 2] = 1.0
        kp[:, 5] = 1.0
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], kp.tobytes()),
        )

    def add_matches(self, id1: int, id2: int, matches: np.ndarray) -> None:
        pair = image_ids_to_pair_id(id1, id2)
        m = np.asarray(matches, np.uint32)
        if id1 > id2:
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (pair, m.shape[0], m.shape[1], np.ascontiguousarray(m).tobytes()),
        )

    def commit(self) -> None:
        self.conn.commit()

    def close(self) -> None:
        self.conn.commit()
        self.conn.close()


# ------------------------------------------------------- binary driver


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def run_point_triangulator(
    database: str | Path, image_path: str | Path,
    input_model: str | Path, output_model: str | Path,
    extra_args: Optional[List[str]] = None,
) -> None:
    """Triangulate 3D points against FIXED input poses (the reference's
    default path, `point_triangulator.py`)."""
    if not colmap_available():
        raise RuntimeError("the `colmap` binary is not on PATH")
    Path(output_model).mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["colmap", "point_triangulator",
         "--database_path", str(database), "--image_path", str(image_path),
         "--input_path", str(input_model), "--output_path", str(output_model)]
        + (extra_args or []),
        check=True,
    )


def run_bundle_adjuster(
    input_model: str | Path, output_model: str | Path,
    refine_intrinsics: bool = True,
    extra_args: Optional[List[str]] = None,
) -> None:
    if not colmap_available():
        raise RuntimeError("the `colmap` binary is not on PATH")
    Path(output_model).mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["colmap", "bundle_adjuster",
         "--input_path", str(input_model), "--output_path", str(output_model),
         "--BundleAdjustment.refine_focal_length", str(int(refine_intrinsics)),
         "--BundleAdjustment.refine_extra_params", str(int(refine_intrinsics))]
        + (extra_args or []),
        check=True,
    )


# ------------------------------------------------------------ alignment


def _rotmat_f32(q) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation, in float32 as the JAX package."""
    return quat_to_rotmat(torch.as_tensor(np.asarray(q, np.float32))).numpy()


def _quat_f32(R) -> np.ndarray:
    """3x3 rotation -> wxyz quaternion (w >= 0), in float32 as the JAX package."""
    return rotmat_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def umeyama_sim3(src: np.ndarray, dst: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Similarity (s, R, t) minimizing ||s R src + t - dst||^2 (Umeyama).

    Used to map the scaled COLMAP frame back to world after BA
    (ref `align_model.py`). src/dst: [N, 3].
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s)
    t = mu_d - s * R @ mu_s
    return s, R, t


def apply_sim3_to_model(cameras, images, points, s: float, R: np.ndarray, t: np.ndarray):
    """Transform a COLMAP model in place by x' = s R x + t."""
    for p in points.values():
        p.xyz = s * R @ p.xyz + t
    for im in images.values():
        R_wc = _rotmat_f32(im.qvec)
        # world->cam under x' = sRx + t:  R' = R_wc R^T, t' = t_wc - R' t / s...
        # projection uses (R_wc x + t_wc); substituting x = R^T (x' - t) / s:
        # R'_wc = R_wc R^T / s * s = R_wc R^T (rotation), t'_wc = t_wc - R'_wc t,
        # with the camera center scaling absorbed: c' = s R c + t.
        c = -R_wc.T @ np.asarray(im.tvec)       # camera center (world)
        c_new = s * R @ c + t
        R_new = R_wc @ R.T
        im.qvec = _quat_f32(R_new).astype(np.float64)
        im.tvec = -R_new @ c_new
    return cameras, images, points


# ------------------------------------------------- fixed-pose model build
def fov_triangle(intrinsic: np.ndarray, cam2global: np.ndarray,
                 scale: float = 30.0) -> np.ndarray:
    """Camera view field as a 2D ground-plane triangle [3, 2]
    (ref `field_of_view_intrinsic`, `nuplan_scripts/utils/camera_utils.py:
    12-37`): apex at the camera, two corners `scale` out along the
    horizontal FOV edges, all transformed by cam2global and projected
    to xy."""
    half = intrinsic[0, 2] / intrinsic[0, 0]
    pts = np.asarray(
        [[0, 0, 0], [half, 0, 1], [-half, 0, 1]], np.float64) * scale
    pts = pts @ cam2global[:3, :3].T + cam2global[:3, 3]
    return pts[:, :2]


def _clip_polygon(poly: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman clip of `poly` by the half-plane left of a->b."""
    out = []
    n = len(poly)
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        d, dp, dq = b - a, p - a, q - a
        side_p = d[0] * dp[1] - d[1] * dp[0]
        side_q = d[0] * dq[1] - d[1] * dq[0]
        if side_p >= 0:
            out.append(p)
        if (side_p >= 0) != (side_q >= 0):
            t = side_p / (side_p - side_q)
            out.append(p + t * (q - p))
    return np.asarray(out) if out else np.zeros((0, 2))


def convex_overlap_area(p1: np.ndarray, p2: np.ndarray) -> float:
    """Intersection area of two convex 2D polygons (CCW or CW)."""

    def ccw(p):
        u, v = p[1] - p[0], p[2] - p[0]
        return p if u[0] * v[1] - u[1] * v[0] >= 0 else p[::-1]

    poly = ccw(np.asarray(p1, np.float64))
    p2 = ccw(np.asarray(p2, np.float64))
    for i in range(len(p2)):
        if len(poly) < 3:
            return 0.0
        poly = _clip_polygon(poly, p2[i], p2[(i + 1) % len(p2)])
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def build_fixed_pose_model(
    video_scene_dict: dict,
    out_dir: str | Path,
    block_size: float,
    *,
    valid_fn=None,
    image_size: Tuple[int, int] = (1920, 1080),
    fov_scale: float = 30.0,
) -> Tuple[Dict[int, Camera], Dict[int, Image], List[Tuple[str, str]], float]:
    """Build the fixed-pose COLMAP model of all traversals (ref
    `create_colmap_model` + `create_cameras_per_vehicle`,
    `nuplan_scripts/ba_multi_traversal.py:57-213`): one OPENCV camera
    per (vehicle, cam), camera poses scaled so the road block spans
    ~10 COLMAP units, world->cam quaternions, per-image dedup, and the
    match pair list = image pairs whose ground-plane FOV triangles
    overlap. Writes sparse_model/*.bin, image_pairs.txt, and a database
    with cameras+images (keypoints/matches are COLMAP's job).

    Args:
        valid_fn: optional (frame_info, cam_name, cam_info) -> bool to
            drop images (the reference drops >80%-masked ones).
    Returns (cameras, images, pairs, scale_factor).
    """
    out_dir = Path(out_dir)
    (out_dir / "sparse_model").mkdir(parents=True, exist_ok=True)
    scale = 10.0 / max(float(block_size), 1e-6)

    cameras: Dict[int, Camera] = {}
    cam_id_of: Dict[Tuple[str, str], int] = {}
    images: Dict[int, Image] = {}
    views = []   # (name, triangle)
    seen_names = set()
    next_cam, next_img = 1, 1

    for token, info in video_scene_dict.items():
        veh = info.get("vehicle_name", "veh0")
        frames = [f for f in info.get("frame_infos", [])
                  if not f.get("skipped", False)]
        for f in frames:
            ego2global = np.asarray(f["ego2global"], np.float64)
            for cam_name, ci in f.get("cams", {}).items():
                key = (veh, cam_name)
                if key not in cam_id_of:
                    K = np.asarray(ci["cam_intrinsic"], np.float64)
                    d = np.asarray(ci.get("distortion", np.zeros(4)),
                                   np.float64)
                    cameras[next_cam] = Camera(
                        camera_id=next_cam, model="OPENCV",
                        width=image_size[0], height=image_size[1],
                        params=np.asarray(
                            [K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                             d[0], d[1], d[2], d[3]]),
                    )
                    cam_id_of[key] = next_cam
                    next_cam += 1
                if valid_fn is not None and not valid_fn(f, cam_name, ci):
                    continue
                name = f"{veh}_{cam_name}/{Path(ci['data_path']).name}"
                if name in seen_names:
                    continue
                seen_names.add(name)

                cam2ego = np.eye(4)
                cam2ego[:3, :3] = _rotmat_f32(ci["sensor2ego_rotation"])
                cam2ego[:3, 3] = ci["sensor2ego_translation"]
                cam2global = ego2global @ cam2ego
                views.append((name, fov_triangle(
                    np.asarray(ci["cam_intrinsic"], np.float64),
                    cam2global, scale=fov_scale)))
                cam2global = cam2global.copy()
                cam2global[:3, 3] *= scale

                R_w2c = cam2global[:3, :3].T
                t_w2c = -R_w2c @ cam2global[:3, 3]
                q = _quat_f32(R_w2c)
                images[next_img] = Image(
                    image_id=next_img, qvec=q.astype(np.float64),
                    tvec=t_w2c, camera_id=cam_id_of[key], name=name)
                next_img += 1

    # distance prefilter: each FOV triangle fits in a circle around its
    # apex of radius max corner distance, so apexes farther apart than
    # r_i + r_j cannot overlap — drops the exact polygon clip from
    # O(n^2) full pairs to the near neighbors only
    pairs: List[Tuple[str, str]] = []
    if views:
        apexes = np.stack([v[1][0] for v in views])  # [n, 2]
        radii = np.stack([
            np.linalg.norm(v[1][1:] - v[1][0], axis=1).max() for v in views
        ])
        d2 = ((apexes[:, None] - apexes[None, :]) ** 2).sum(-1)
        thresh2 = (radii[:, None] + radii[None, :]) ** 2
        cand = np.argwhere(np.triu(d2 <= thresh2, k=1))
        for i, j in cand:
            if convex_overlap_area(views[i][1], views[j][1]) > 0.0:
                pairs.append((views[i][0], views[j][0]))

    write_model(cameras, images, {}, out_dir / "sparse_model")
    with open(out_dir / "image_pairs.txt", "w") as fh:
        for a, b in pairs:
            fh.write(f"{a} {b}\n")
    db = ColmapDatabase(out_dir / "database.db")
    for cam in cameras.values():
        db.add_camera(cam)
    for img in images.values():
        db.add_image(img)
    db.commit()
    db.close()
    return cameras, images, pairs, scale
