"""The 8-stage preprocessing pipeline driver (`preprocess.sh` equivalent);
port of `mtgs_tpu/preprocess/pipeline.py`.

Mirrors `nuplan_scripts/preprocess.sh:26-45` (OpenDriveLab/MTGS) as a
resumable Python runner over the road-block staged store:

  1 video_split       — DB/log-cache scan -> traversal split -> raw dict
  2 export_videos     — preview mosaics (optional; needs mediapy/ffmpeg)
  3 collect_raw       — copy referenced sensor files into the block dir
  4 semantic_masks    — Mask2Former cityscapes labels
  5 lidar_registration — multi-traversal ICP (C++ core) + error gates
  6 colmap            — fixed-pose triangulation / optional BA
  7 dense_depth       — UniDepth pseudo-depth PNGs
  8 stack_point_cloud — RGB/instance seed clouds -> final dict

Each stage is a named function taking (VideoScene, config dict); stages
whose external dependencies are absent (nuplan-devkit, HF weights,
UniDepth, the colmap binary) raise a descriptive RuntimeError —
`run_pipeline(..., skip_unavailable=True)` records them as skipped and
continues, matching the reference's ability to run any stage subset
(`preprocess.sh STEP` resume argument). Statuses and skip reasons are the
JAX package's.

`run_pipeline(..., device=)` runs on the card unless the caller asks for
the CPU: the point-cloud stacking (stage 8) runs there, with the images and
masks read by `data/image_io.read_image` (no PIL) and moved to the device;
the gated model stages (4, 7) would run there too. The other stages are
host code.
"""

from __future__ import annotations

import shutil
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from mtgs_torch import resolve_device
from mtgs_torch.preprocess.video_scene import VideoScene, apply_filters

StageFn = Callable[[VideoScene, dict, torch.device], None]
STAGE_ORDER: List[Tuple[str, str]] = [
    ("video_split", "raw"),
    ("export_videos", None),
    ("collect_raw", None),
    ("semantic_masks", None),
    ("lidar_registration", "registered"),
    ("colmap", "colmap"),
    ("dense_depth", None),
    ("stack_point_cloud", "final"),
]

STAGES: Dict[str, StageFn] = {}


def stage(name: str):
    def deco(fn):
        STAGES[name] = fn
        return fn

    return deco


@stage("video_split")
def stage_video_split(vs: VideoScene, cfg: dict, device: torch.device) -> None:
    import numpy as np

    from mtgs_torch.preprocess import video_split as sp

    cache = cfg.get("log_info_cache")
    if cache is None or not Path(cache).exists():
        raise RuntimeError(
            "video_split needs the nuPlan log-info cache jsonl "
            "(cfg['log_info_cache']); generating frame records further "
            "requires nuplan-devkit + the sensor release."
        )
    road_block = cfg["road_block"]
    logs = sp.scan_log_cache_for_block(cache, road_block)
    videos = []
    for row in logs:
        traj = np.asarray(row["trajectory"])
        for idx in sp.split_in_region_videos(
            traj, road_block,
            interval=cfg.get("interval", 1),
            expand_buffer=cfg.get("expand_buffer", 30.0),
        ):
            videos.append(
                dict(
                    log_name=row["log_name"],
                    trajectory=traj[idx],
                    lidar_pc_tokens=[row["lidar_pc_tokens"][i] for i in idx]
                    if "lidar_pc_tokens" in row
                    else [],
                    frame_indices=idx,
                )
            )
    videos = sp.sort_and_dedupe_videos(
        videos, central_token=cfg.get("central_token")
    )
    raw = {}
    for v in videos:
        token = f"{v['log_name']}-{v['video_idx']}"
        v["video_token"] = token
        v["frame_infos"] = sp.build_frame_infos_nuplan(v, cfg) if cfg.get(
            "build_frame_infos", False
        ) else []
        raw[token] = v
    vs.save(raw, "raw")


@stage("export_videos")
def stage_export_videos(vs: VideoScene, cfg: dict, device: torch.device) -> None:
    from mtgs_torch.preprocess.export_videos import export_traversal_videos

    if not (vs.root / "raw_images").is_dir():
        raise RuntimeError(
            "export_videos: no raw_images/ under the road block (needs the "
            "nuPlan sensor release or collect_raw) — skipping previews."
        )
    export_traversal_videos(
        vs,
        cameras=cfg.get("cameras"),
        fps=cfg.get("fps", 10),
        max_frames=cfg.get("max_frames"),
    )


@stage("collect_raw")
def stage_collect_raw(vs: VideoScene, cfg: dict, device: torch.device) -> None:
    """Copy referenced lidar/image files into the block dir
    (ref `collect_raw_data.py`)."""
    sensor_root = cfg.get("sensor_root")
    if sensor_root is None or not Path(sensor_root).exists():
        raise RuntimeError("collect_raw needs cfg['sensor_root'] (nuPlan blobs)")
    vsd = vs.load()
    n = 0
    for info in vsd.values():
        for f in info["frame_infos"]:
            rels = [f.get("lidar_path")] + [
                c.get("data_path") for c in f.get("cams", {}).values()
            ]
            for rel in filter(None, rels):
                src = Path(sensor_root) / rel
                dst = vs.root / rel
                if src.exists() and not dst.exists():
                    dst.parent.mkdir(parents=True, exist_ok=True)
                    shutil.copy2(src, dst)
                    n += 1
    print(f"collect_raw: copied {n} files")


@stage("semantic_masks")
def stage_semantic_masks(vs: VideoScene, cfg: dict, device: torch.device) -> None:
    from mtgs_torch.preprocess.semantic_masks import generate_semantic_masks

    images = sorted(vs.undistorted_image_path.rglob("*.jpg")) + sorted(
        vs.undistorted_image_path.rglob("*.png")
    )
    if not images:
        raise RuntimeError("semantic_masks: no undistorted images found")
    generate_semantic_masks(images, vs.undistorted_mask_path, device=device)


@stage("lidar_registration")
def stage_lidar_registration(vs: VideoScene, cfg: dict, device: torch.device) -> None:
    import numpy as np

    from mtgs_torch.data.nuplan import matrix_from_translation_quaternion
    from mtgs_torch.preprocess.lidar_registration import register_traversals
    from mtgs_torch.utils.pointcloud import load_pcd

    lidar_root = Path(cfg.get("lidar_root", vs.root))
    vsd = vs.load()
    scans: Dict[int, list] = {}
    poses: Dict[int, "np.ndarray"] = {}
    tokens = sorted(vsd)
    for tid, token in enumerate(tokens):
        frames = vsd[token]["frame_infos"]
        if not frames:
            raise RuntimeError(
                "lidar_registration: empty frame_infos (run the nuPlan "
                "frame-record build first)"
            )
        svals, pvals = [], []
        for f in frames:
            path = lidar_root / f["lidar_path"]
            if not path.exists():
                raise RuntimeError(f"lidar_registration: missing scan {path}")
            svals.append(load_pcd(path)[0])
            pvals.append(
                matrix_from_translation_quaternion(
                    f["ego2global_translation"], f["ego2global_rotation"]
                )
            )
        scans[tid] = svals
        poses[tid] = np.stack(pvals)
    refined, errors, excluded = register_traversals(
        scans, poses, max_range=cfg.get("max_range", 100.0)
    )
    for tid, token in enumerate(tokens):
        frames = vsd[token]["frame_infos"]
        for i, f in enumerate(frames):
            f["ego2global_original"] = (
                f["ego2global_translation"], f["ego2global_rotation"]
            )
            f["ego2global"] = refined[tid][i]
        vsd[token]["registration_errors"] = errors[tid]
        vsd[token]["registration_excluded"] = tid in excluded
    vsd = apply_filters(vsd, ["filter_low_velocity"])
    vs.save(vsd, "registered")


@stage("colmap")
def stage_colmap(vs: VideoScene, cfg: dict, device: torch.device) -> None:
    from mtgs_torch.preprocess import colmap as cm

    vsd = vs.load()
    block_size = cfg.get("block_size", 200.0)
    cams, imgs, pairs, scale = cm.build_fixed_pose_model(
        vsd, vs.colmap_path, block_size,
        image_size=cfg.get("image_size", (1920, 1080)),
    )
    if not cm.colmap_available():
        raise RuntimeError(
            f"fixed-pose model written ({len(imgs)} images, {len(pairs)} "
            "pairs) but the `colmap` binary is not on PATH to run feature "
            "extraction + point_triangulator"
        )
    cm.run_point_triangulator(
        vs.colmap_path / "database.db",
        cfg.get("colmap_image_root", vs.root / "raw_images"),
        vs.colmap_path / "sparse_model",
        vs.colmap_path / "triangulated",
    )


@stage("dense_depth")
def stage_dense_depth(vs: VideoScene, cfg: dict, device: torch.device) -> None:
    from mtgs_torch.preprocess.dense_depth import generate_dense_depth

    images = sorted(vs.undistorted_image_path.rglob("*.jpg"))
    if not images:
        raise RuntimeError("dense_depth: no undistorted images found")
    generate_dense_depth(images, vs.undistorted_depth_path, device=device)


@stage("stack_point_cloud")
def stage_stack_point_cloud(vs: VideoScene, cfg: dict, device: torch.device) -> None:
    """Drive the StackAccumulator over every kept frame on `device`; its
    inputs (painted points/semantics per frame) come from the per-frame
    loader in `mtgs_torch/preprocess/stack_point_cloud.py` — which needs
    the sensor files on disk."""
    import numpy as np

    from mtgs_torch.data.image_io import read_image
    from mtgs_torch.data.nuplan import matrix_from_translation_quaternion
    from mtgs_torch.preprocess.stack_point_cloud import StackAccumulator, paint_points
    from mtgs_torch.utils.pointcloud import load_pcd

    lidar_root = Path(cfg.get("lidar_root", vs.root))
    vsd = vs.load()
    acc = StackAccumulator(voxel=cfg.get("voxel", 0.15), device=device)
    for info in vsd.values():
        for f in info["frame_infos"]:
            path = lidar_root / f["lidar_path"]
            if not path.exists():
                raise RuntimeError(f"stack_point_cloud: missing scan {path}")
            pts, _ = load_pcd(path)
            e2g = f.get("ego2global")
            if e2g is None or np.ndim(e2g) != 2:
                e2g = matrix_from_translation_quaternion(
                    f["ego2global_translation"], f["ego2global_rotation"]
                )
            images, cam2egos, Ks, sems = [], [], [], []
            for cam in f.get("cams", {}).values():
                img_path = vs.undistorted_image_path / Path(cam["data_path"]).name
                if not img_path.exists():
                    continue
                # uint8 on the device; paint_points takes it as float32 / 255
                images.append(torch.as_tensor(read_image(img_path), device=device))
                cam2egos.append(
                    matrix_from_translation_quaternion(
                        cam["sensor2ego_translation"], cam["sensor2ego_rotation"]
                    )
                )
                Ks.append(np.asarray(cam["cam_intrinsic"]))
                mask_path = vs.undistorted_mask_path / (
                    Path(cam["data_path"]).stem + "_cityscape.png"
                )
                sems.append(torch.as_tensor(read_image(mask_path), device=device)
                            if mask_path.exists() else None)
            if not images:
                raise RuntimeError(
                    "stack_point_cloud: no undistorted images for frame"
                )
            rgb, seen, sem = paint_points(pts, images, cam2egos, Ks, sems, device=device)
            boxes = np.asarray(f.get("gt_boxes", np.zeros((0, 7))))
            acc.add_frame(
                pts, rgb, seen, sem, np.asarray(e2g), boxes,
                f.get("track_tokens", []),
            )
    acc.finalize(vs.root)
    vs.save(vsd, "final")


def run_pipeline(
    data_root: str | Path,
    name: str,
    config: Optional[dict] = None,
    *,
    start: int = 1,
    stop: int = 8,
    skip_unavailable: bool = True,
    device="cuda",
) -> Dict[str, str]:
    """Run stages [start, stop] (1-based, the reference's STEP argument) on
    `device` (the card unless the caller asks for the CPU; raises before
    any stage runs when there is no card).

    Returns {stage_name: "ok" | "skipped: <reason>" | "failed: <err>"}.
    """
    dev = resolve_device(device)
    vs = VideoScene(data_root, name)
    config = config or {}
    status: Dict[str, str] = {}
    for i, (sname, _) in enumerate(STAGE_ORDER, start=1):
        if i < start or i > stop:
            continue
        try:
            STAGES[sname](vs, config.get(sname, config), dev)
            status[sname] = "ok"
        except RuntimeError as e:
            if not skip_unavailable:
                raise
            status[sname] = f"skipped: {e}"
        except Exception as e:  # noqa: BLE001 — per-stage isolation
            if not skip_unavailable:
                raise
            status[sname] = f"failed: {e}"
            traceback.print_exc()
    return status


def main(argv=None):
    """CLI: `python -m mtgs_torch.preprocess.pipeline DATA_ROOT SCENE_NAME
    [--start N] [--stop N] [--config FILE] [--strict] [--device cpu]` (the
    reference's `preprocess.sh CONFIG ... STEP` entry)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_root", nargs="?", default=None)
    ap.add_argument("scene_name", nargs="?", default=None)
    ap.add_argument("--start", type=int, default=1)
    ap.add_argument("--stop", type=int, default=len(STAGE_ORDER))
    ap.add_argument("--config", default=None,
                    help="JSON file with per-stage config dicts, or a "
                    "RoadBlockConfig .yaml/.yml/.py (the reference's "
                    "scene data-config layer) which also supplies "
                    "data_root/scene_name")
    ap.add_argument("--strict", action="store_true",
                    help="abort on unavailable stages instead of skipping")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the stacking stage (cpu only when asked for)")
    args = ap.parse_args(argv)
    config = None
    if args.config:
        if args.config.endswith((".yml", ".yaml", ".py")):
            from mtgs_torch.preprocess.roadblock_config import load_road_block_config

            rb = load_road_block_config(args.config)
            config = rb.to_stage_config()
            args.data_root = args.data_root or rb.data_root
            args.scene_name = args.scene_name or rb.road_block_name
        else:
            with open(args.config) as f:
                config = json.load(f)
    if not args.data_root or not args.scene_name:
        ap.error("data_root and scene_name required (positionally or via "
                 "a RoadBlockConfig --config)")
    status = run_pipeline(
        args.data_root, args.scene_name, start=args.start, stop=args.stop,
        config=config, skip_unavailable=not args.strict, device=args.device)
    for stage_name, st in status.items():
        print(f"{stage_name:24s} {st}")
    return 0 if all(v == "ok" or v.startswith("skipped") for v in status.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
