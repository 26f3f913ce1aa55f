"""Trajectory, camera-path and dataset rendering; port of
`mtgs_tpu/tools/render.py`.

Counterpart of `mtgs/tools/render.py` (OpenDriveLab/MTGS): a pose path
(slerp-upsampled with `interpolate_poses`, or a viewer-authored camera
path JSON, 1920x1080 unless it says otherwise) is rendered frame by frame
to PNG files plus an mp4 when ffmpeg exists; `render_dataset` renders
every view of a split with the trained camera-pose deltas re-applied,
one folder per layer (rgb, ground truth, colormapped depth).

Each frame is one `render_view(training=False)` without autograd on the
given device ("cuda" unless the caller passes another); at 1920x1080 the
rasterizer takes its classic path. PNGs are written by `write_png`
(zlib + struct), so the tool needs no imaging package.
`render_interpolated` writes per-camera mosaics along a parsed nuPlan
traversal (`data.nuplan.ParsedScene`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
import subprocess
import zlib
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.core.quat import quat_to_rotmat, rotmat_to_quat, slerp
from mtgs_torch.models.scene_graph import SceneAux, SceneParams
from mtgs_torch.train.trainer import Batch, TrainerConfig, render_view


def write_png(path, img: np.ndarray) -> None:
    """Write a uint8 [H, W] (grey), [H, W, 2] (grey + alpha), [H, W, 3]
    (RGB) or [H, W, 4] (RGBA) image as an 8-bit PNG: one IDAT of unfiltered
    rows."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # level 1: frames are a video's intermediates, written once per render
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                           + chunk(b"IEND", b""))


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    return (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()


def frames_to_mp4(frame_dir, fps: int, out_name: str = "render.mp4") -> Optional[Path]:
    """Encode `frame_%05d.png` under `frame_dir` with ffmpeg; returns the
    mp4 path, or None when ffmpeg is unavailable (frames remain)."""
    frame_dir = Path(frame_dir)
    out = frame_dir / out_name
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
             "-i", str(frame_dir / "frame_%05d.png"), "-pix_fmt", "yuv420p", str(out)],
            check=True)
        return out
    except (FileNotFoundError, subprocess.CalledProcessError):
        return None


def interpolate_poses(c2ws: np.ndarray, timestamps: np.ndarray, target_hz: float = 60.0,
                      source_hz: float = 2.0) -> tuple[np.ndarray, np.ndarray]:
    """Slerp-upsample a pose trajectory (ref `_get_interpolated_camera_path`,
    `render.py:261-301`). Returns (poses [M, 4, 4], times [M])."""
    n = len(c2ws)
    factor = max(int(round(target_hz / source_hz)), 1)
    quats = rotmat_to_quat(torch.as_tensor(np.asarray(c2ws)[:, :3, :3], dtype=torch.float32))
    out_poses, out_ts = [], []
    for i in range(n - 1):
        for k in range(factor):
            t = k / factor
            q = slerp(quats[i], quats[i + 1], torch.tensor(t, dtype=torch.float32))
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = quat_to_rotmat(q).numpy()
            m[:3, 3] = c2ws[i, :3, 3] * (1 - t) + c2ws[i + 1, :3, 3] * t
            out_poses.append(m)
            out_ts.append(timestamps[i] * (1 - t) + timestamps[i + 1] * t)
    out_poses.append(c2ws[-1])
    out_ts.append(timestamps[-1])
    return np.stack(out_poses), np.asarray(out_ts, np.float32)


def render_trajectory(params: SceneParams, aux: SceneAux, cfg: TrainerConfig,
                      poses: np.ndarray, timestamps: np.ndarray, K: np.ndarray,
                      travel_index: int, out_dir, *, frame_rows: Optional[np.ndarray] = None,
                      fps: int = 30, make_video: bool = True, device="cuda") -> List[Path]:
    """Render a pose path (scene-frame c2w [M, 4, 4], normalised times
    [M]) to PNG frames (+ mp4 if ffmpeg is available) at cfg's size."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    interp_cfg = cfg.replace(scene=dataclasses.replace(cfg.scene, interp_poses=True))
    paths = []
    for i, (pose, ts) in enumerate(zip(poses, timestamps)):
        # render_view reads no image, mask or depth maps when not training
        batch = Batch(
            image=np.zeros((1, 1, 3), np.float32), mask=np.ones((1, 1, 1), np.float32),
            c2w=np.asarray(pose, np.float32), K=np.asarray(K, np.float32), cam_idx=0,
            image_idx=0, travel_index=travel_index,
            frame_idx=int(frame_rows[i]) if frame_rows is not None else 0,
            timestamp=float(ts))
        out = render_view(params, aux, interp_cfg, batch, 10**6, training=False, device=dev)
        p = out_dir / f"frame_{i:05d}.png"
        write_png(p, _to_uint8(out["rgb_appearance"]))
        paths.append(p)
    if make_video and paths:
        frames_to_mp4(out_dir, fps)
    return paths


def load_camera_path_json(path) -> dict:
    """Parse a viewer camera-path JSON (the `camera-path` render mode,
    ref `RenderCameraPath` in `mtgs/tools/render.py`: nerfstudio's
    keyframed path format, per-frame `camera_to_world` (row-major 16
    floats) and vertical `fov` in degrees, plus render size, fps and
    seconds). Returns dict(poses [M, 4, 4], Ks [M, 3, 3], width, height, fps)."""
    spec = json.loads(Path(path).read_text())
    W = int(spec.get("render_width", 1920))
    H = int(spec.get("render_height", 1080))
    frames = spec.get("camera_path", [])
    n = len(frames)
    fps = float(spec.get("fps", n / max(float(spec.get("seconds", n / 30.0)), 1e-6)))
    poses = np.zeros((n, 4, 4), np.float32)
    Ks = np.zeros((n, 3, 3), np.float32)
    for i, f in enumerate(frames):
        poses[i] = np.asarray(f["camera_to_world"], np.float32).reshape(4, 4)
        fov = float(f.get("fov", 50.0))
        fy = 0.5 * H / np.tan(0.5 * np.deg2rad(fov))
        Ks[i] = [[fy, 0, W / 2], [0, fy, H / 2], [0, 0, 1]]
    return dict(poses=poses, Ks=Ks, width=W, height=H, fps=fps)


def render_camera_path(params: SceneParams, aux: SceneAux, cfg: TrainerConfig,
                       camera_path_json, out_dir, *, travel_index: int = 0,
                       make_video: bool = True, device="cuda") -> List[Path]:
    """Render a viewer-authored camera path (`camera-path` subcommand) at
    the size the path gives."""
    spec = load_camera_path_json(camera_path_json)
    cfg = cfg.replace(width=spec["width"], height=spec["height"])
    ts = np.linspace(0.0, 1.0, len(spec["poses"]), dtype=np.float32)
    return render_trajectory(
        params, aux, cfg, spec["poses"], ts, spec["Ks"][0], travel_index, out_dir,
        fps=int(round(spec["fps"])), make_video=make_video, device=device)


def depth_colormap(depth: np.ndarray, *, near: float = 0.0,
                   far: Optional[float] = None) -> np.ndarray:
    """Turbo-style colormap for metric depth -> uint8 RGB (the
    reference's nerfstudio `colormaps.apply_depth_colormap` role)."""
    d = np.asarray(depth, np.float32).squeeze()
    if far is None:
        valid = d[np.isfinite(d) & (d > 0)]
        far = float(np.percentile(valid, 95.0)) if valid.size else 1.0
    x = np.clip((d - near) / max(far - near, 1e-6), 0.0, 1.0)
    # compact turbo polynomial fit (Google turbo colormap endpoints)
    r = np.clip(1.61 * x ** 0.8 - 0.55 * x ** 3, 0, 1)
    g = np.clip(np.sin(np.pi * x), 0, 1) ** 1.2
    b = np.clip(1.0 - 1.35 * x + 0.45 * np.sin(3 * np.pi * x) * (1 - x), 0, 1)
    rgb = np.nan_to_num(np.stack([r, g, b], -1), nan=0.0)
    return (rgb * 255).astype(np.uint8)


def render_dataset(params: SceneParams, aux: SceneAux, cfg: TrainerConfig,
                   batches: Iterable[Batch], out_dir, *,
                   outputs: Sequence[str] = ("rgb", "gt", "depth"),
                   apply_cam_opt: bool = True, step: int = 10**9,
                   device="cuda") -> List[Path]:
    """Render every dataset view with the requested layers (the `dataset`
    subcommand, ref `DatasetRender`, `mtgs/tools/render.py:569-746`): rgb
    render, ground truth and turbo-colormapped depth, one subfolder per
    layer. Trained camera-pose deltas are re-applied (the reference's
    `load_cam_optim_from` path)."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    written: List[Path] = []
    for i, batch in enumerate(batches):
        out = render_view(params, aux, cfg, batch, step, training=False,
                          apply_cam_opt=apply_cam_opt, device=dev)
        layers = {}
        if "rgb" in outputs:
            layers["rgb"] = _to_uint8(out["rgb_appearance"])
        if "gt" in outputs:
            layers["gt"] = _to_uint8(torch.as_tensor(batch.image, dtype=torch.float32))
        if "depth" in outputs:
            layers["depth"] = depth_colormap(out["depth"].cpu().numpy())
        for name, img in layers.items():
            p = out_dir / name / f"{i:05d}.png"
            p.parent.mkdir(parents=True, exist_ok=True)
            write_png(p, img)
            written.append(p)
    return written


def render_interpolated(params: SceneParams, aux: SceneAux, cfg: TrainerConfig, scene,
                        travel_index: int, out_dir, *,
                        cameras: Sequence[str] = ("CAM_L0", "CAM_F0", "CAM_R0"),
                        target_hz: float = 60.0, source_hz: float = 2.0, fps: int = 60,
                        make_video: bool = True, device="cuda") -> List[Path]:
    """`interpolate` mode (ref `RenderInterpolated`, `mtgs/tools/
    render.py:439-552`): slerp-upsample one traversal's per-camera pose
    path of a ParsedScene to `target_hz` and write side-by-side camera
    mosaics at cfg's size (the reference concatenates the front and back
    three-camera sets)."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    recs = [r for r in scene.records if r.travel_index == travel_index]
    per_cam = {}
    for name in cameras:
        cam_recs = sorted((r for r in recs if r.cam_name == name), key=lambda r: r.frame_idx)
        if not cam_recs:
            continue
        c2ws = np.stack([r.c2w for r in cam_recs])
        ts = np.asarray([r.timestamp for r in cam_recs], np.float64)
        poses, tsi = interpolate_poses(c2ws, ts, target_hz=target_hz, source_hz=source_hz)
        K = cam_recs[0].intrinsic.copy()
        # the raw intrinsics rescaled onto the render size
        K[0] *= cfg.width / cam_recs[0].width
        K[1] *= cfg.height / cam_recs[0].height
        frame_rows = np.repeat([r.frame_idx for r in cam_recs],
                               math.ceil(len(poses) / max(len(cam_recs), 1)))[: len(poses)]
        per_cam[name] = (poses, tsi, K, frame_rows)
    if not per_cam:
        raise ValueError(f"traversal {travel_index} has none of {cameras}")

    n = min(len(v[0]) for v in per_cam.values())
    interp_cfg = cfg.replace(scene=dataclasses.replace(cfg.scene, interp_poses=True))
    paths: List[Path] = []
    for i in range(n):
        tiles = []
        for name in cameras:
            if name not in per_cam:
                continue
            poses, tsi, K, frame_rows = per_cam[name]
            # render_view reads no image, mask or depth maps when not training
            batch = Batch(
                image=np.zeros((1, 1, 3), np.float32), mask=np.ones((1, 1, 1), np.float32),
                c2w=np.asarray(poses[i], np.float32), K=np.asarray(K, np.float32), cam_idx=0,
                image_idx=0, travel_index=travel_index, frame_idx=int(frame_rows[i]),
                timestamp=float(np.float32(tsi[i])))
            out = render_view(params, aux, interp_cfg, batch, 10**6, training=False, device=dev)
            tiles.append(_to_uint8(out["rgb_appearance"]))
        p = out_dir / f"frame_{i:05d}.png"
        write_png(p, np.concatenate(tiles, axis=1))
        paths.append(p)
    if make_video and paths:
        frames_to_mp4(out_dir, fps)
    return paths
