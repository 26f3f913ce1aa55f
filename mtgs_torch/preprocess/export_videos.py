"""Stage 2: per-traversal preview mosaics (+ BEV trajectory inset); port of
`mtgs_tpu/preprocess/export_videos.py`.

Equivalent of `nuplan_scripts/export_videos.py` (OpenDriveLab/MTGS):
for every traversal, render a camera-mosaic preview video — each frame
is a grid of that frame's camera images plus a bird's-eye-view inset
showing all traversals' trajectories (gray), the current traversal
(colored), and the current ego position (dot). The reference overlays
the nuPlan map; the map API is not available, so the inset shows
trajectories only. Frames are written as PNGs and an mp4 per traversal
when ffmpeg exists (same convention as `mtgs_torch/tools/render.py`).

Host code, without PIL: the camera images are decoded by
`data/image_io.read_image` and scaled by `image_io.resize_u8(...,
bicubic=True)`, PIL's fixed-point bicubic (`Image.resize`'s default filter),
so the camera tiles are the JAX package's, bit for bit. The inset is the
port's own raster of what `ImageDraw` draws there: one-pixel polylines by
PIL's Bresenham walk (the same pixels), the current traversal's two-pixel
line as that walk and its neighbour along the minor axis, and the radius-4
dot as a disc; where those differ from `ImageDraw`'s pixels, they differ
within two pixels of a segment or the dot.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mtgs_torch.data.image_io import read_image, resize_u8, to_rgb
from mtgs_torch.preprocess.video_scene import VideoScene
from mtgs_torch.tools.preview import _COLORS, trajectory_xy

INSET_BACKGROUND = (24, 24, 24)
EMPTY_TILE = (8, 8, 8)
DOT_RADIUS = 4


def _hex_rgb(color: str) -> np.ndarray:
    return np.asarray([int(color[i: i + 2], 16) for i in (1, 3, 5)], np.uint8)


def _bresenham(img: np.ndarray, p0, p1, color: np.ndarray) -> None:
    """ImageDraw's one-pixel segment: the endpoints truncated to ints, both
    drawn, the Bresenham walk between them; pixels off the image dropped."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1])
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    xs, ys = (1 if x1 >= x0 else -1), (1 if y1 >= y0 else -1)
    major, minor = (dx, dy) if dx >= dy else (dy, dx)
    e = 2 * minor - major
    for _ in range(major + 1):
        if 0 <= x0 < w and 0 <= y0 < h:
            img[y0, x0] = color
        if e >= 0:
            if dx >= dy:
                y0 += ys
            else:
                x0 += xs
            e -= 2 * major
        e += 2 * minor
        if dx >= dy:
            x0 += xs
        else:
            y0 += ys


def _polyline(img: np.ndarray, px: np.ndarray, color: np.ndarray, width: int) -> None:
    for p0, p1 in zip(px[:-1], px[1:]):
        _bresenham(img, p0, p1, color)
        if width > 1:
            step = (0, 1) if abs(p1[0] - p0[0]) >= abs(p1[1] - p0[1]) else (1, 0)
            _bresenham(img, p0 + step, p1 + step, color)


def _disc(img: np.ndarray, centre, color: np.ndarray) -> None:
    """ImageDraw's filled ellipse in the box centre +- DOT_RADIUS."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = (DOT_RADIUS + 0.5) ** 2 - 1
    img[(xx - centre[0]) ** 2 + (yy - centre[1]) ** 2 <= r2] = color


def bev_inset(trajs: Dict[int, np.ndarray], current: int, pos: np.ndarray,
              size: int) -> np.ndarray:
    """uint8 [size, size, 3]: all trajectories gray, `current` colored, dot
    at pos (the JAX package's `_bev_inset`, as an array)."""
    img = np.empty((size, size, 3), np.uint8)
    img[:] = INSET_BACKGROUND
    allxy = np.concatenate(list(trajs.values()))
    lo, hi = allxy.min(0), allxy.max(0)
    span = float(np.maximum(hi - lo, 1e-6).max())
    pad = 10

    def to_px(xy):
        u = pad + (xy[..., 0] - lo[0]) / span * (size - 2 * pad)
        v = size - pad - (xy[..., 1] - lo[1]) / span * (size - 2 * pad)
        return np.stack([u, v], -1)

    for idx, xy in trajs.items():
        color = _COLORS[idx % len(_COLORS)] if idx == current else "#666666"
        _polyline(img, to_px(xy), _hex_rgb(color), 2 if idx == current else 1)
    _disc(img, to_px(pos[None])[0], _hex_rgb("#ffffff"))
    return img


def export_traversal_videos(
    vs: VideoScene,
    *,
    cameras: Optional[Sequence[str]] = None,
    fps: int = 10,
    tile_width: int = 320,
    out_dir: Optional[str | Path] = None,
    make_video: bool = True,
    max_frames: Optional[int] = None,
) -> List[Path]:
    """Write one preview mosaic per traversal; returns written paths."""
    from mtgs_torch.tools.render import frames_to_mp4, write_png

    vsd = vs.load()
    out_root = Path(out_dir) if out_dir is not None else vs.root / "preview_videos"
    trajs = {
        int(str(t).split("-")[-1]): trajectory_xy(info)
        for t, info in vsd.items()
    }
    trajs = {k: v for k, v in trajs.items() if len(v)}
    written: List[Path] = []

    for token, info in vsd.items():
        idx = int(str(token).split("-")[-1])
        frames = info.get("frame_infos", [])
        if max_frames is not None:
            frames = frames[:max_frames]
        if not frames:
            continue
        cams = list(cameras) if cameras is not None else sorted(
            frames[0].get("cams", {}).keys())
        ncols = math.ceil(math.sqrt(len(cams) + 1))
        nrows = math.ceil((len(cams) + 1) / ncols)
        vid_dir = out_root / f"traversal_{idx}"
        vid_dir.mkdir(parents=True, exist_ok=True)

        th = None
        for fi, frame in enumerate(frames):
            tiles = []
            for cam in cams:
                ci = frame.get("cams", {}).get(cam)
                tile = None
                if ci is not None:
                    p = vs.root / "raw_images" / ci["data_path"]
                    if p.exists():
                        tile = to_rgb(read_image(p))
                if tile is None:
                    tile = np.empty((tile_width * 9 // 16, tile_width, 3), np.uint8)
                    tile[:] = EMPTY_TILE
                h, w = tile.shape[:2]
                th = tile_width * h // w if th is None else th
                tiles.append(resize_u8(tile, (tile_width, th), bicubic=True))
            if "ego2global" in frame:
                pos = np.asarray(frame["ego2global"], np.float64)[:2, 3]
            else:
                pos = np.asarray(
                    frame.get("ego2global_translation",
                              frame.get("can_bus", [0, 0, 0])[:3]),
                    np.float64)[:2]
            bev = bev_inset(trajs, idx, pos, min(tile_width, th or tile_width))
            tiles.append(resize_u8(bev, (tile_width, th or tile_width), bicubic=True))

            tile_h = th or tile_width
            mosaic = np.zeros((nrows * tile_h, ncols * tile_width, 3), np.uint8)
            for k, tile in enumerate(tiles):
                r, c = (k // ncols) * tile_h, (k % ncols) * tile_width
                mosaic[r: r + tile.shape[0], c: c + tile.shape[1]] = tile
            fp = vid_dir / f"frame_{fi:05d}.png"
            write_png(fp, mosaic)
            written.append(fp)

        if make_video and written:
            mp4 = frames_to_mp4(vid_dir, fps, out_name="preview.mp4")
            if mp4 is not None:
                written.append(mp4)
    return written
