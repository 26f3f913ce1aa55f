"""Stage 1: road-block scan + traversal ("video") splitting; port of
`mtgs_tpu/preprocess/video_split.py`.

Rewrite of the reference's `nuplan_scripts/nuplan_video_processing.py`
core (OpenDriveLab/MTGS) on plain numpy trajectories:

  * `trajectory_intersects_block` — the cheap prefilter that selects
    candidate logs from the one-time log-info cache (ref
    `get_filtered_sensor_data_from_db:398-414`, cache built by
    `misc/generate_nuplan_log_info.py` as jsonl rows
    {log_name, trajectory, lidar_pc_tokens}).
  * `split_in_region_videos` — cut a log's frame sequence into contiguous
    in-region runs at `interval` subsampling (10 Hz / interval), each
    expanded by `expand_buffer` meters of travel beyond the block
    (ref `split_scenes_from_log:56-143`).
  * `sort_and_dedupe_videos` — FrameCentral ordering: the traversal
    containing the central token first, then dedupe traversals whose
    trajectories are within `dedupe_chamfer` m one-directional chamfer
    distance (ref `sort_video_infos:169-234`, threshold 4 m).

The nuPlan-devkit ORM part (building per-frame `frame_info` records with
camera/LiDAR paths from the 20 TB sensor DB) requires the dataset
release and stays behind `build_frame_infos_nuplan` which imports
nuplan-devkit lazily.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from mtgs_torch.data.nuplan import chamfer_distance


def generate_log_info_cache(
    openscene_root: str | Path,
    output_path: str | Path,
    *,
    splits: Sequence[str] = ("trainval", "test"),
) -> int:
    """Build the log→(trajectory, lidar-pc tokens) jsonl cache from
    OpenScene per-log metadata pickles (ref
    `nuplan_scripts/misc/generate_nuplan_log_info.py`): one row per log
    with log/city/split identifiers, the lidar-pc token sequence, and the
    2-dp-rounded 2D ego trajectory — the index that lets stage 1 find
    road-block traversals without scanning 20 TB of nuPlan DBs.
    Returns the number of rows written."""
    import pickle

    rows = []
    for split in splits:
        folder = Path(openscene_root) / "meta_datas" / split
        if not folder.is_dir():
            continue
        for file in sorted(folder.glob("*.pkl")):
            if not file.is_file():
                continue
            with file.open("rb") as f:
                infos = pickle.load(f)
            if not infos:
                continue
            traj = np.asarray(
                [i["ego2global_translation"] for i in infos], np.float64
            )[:, :2]
            rows.append({
                "log_name": file.stem,
                "log_token": infos[0]["log_token"],
                "city": infos[0]["map_location"],
                "split": split,
                "lidar_pc_tokens": [i["token"] for i in infos],
                "trajectory": np.round(traj, 2).tolist(),
            })
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return len(rows)


def iter_log_info_cache(path: str | Path) -> Iterator[dict]:
    """Yield rows of the log-info jsonl cache."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def trajectory_intersects_block(
    trajectory: np.ndarray, road_block: Sequence[float]
) -> bool:
    """Any point of [N, >=2] trajectory inside (x_min, y_min, x_max, y_max)."""
    t = np.asarray(trajectory)[:, :2]
    x0, y0, x1, y1 = road_block
    inside = (t[:, 0] >= x0) & (t[:, 0] <= x1) & (t[:, 1] >= y0) & (t[:, 1] <= y1)
    return bool(inside.any())


def split_in_region_videos(
    positions: np.ndarray,
    road_block: Sequence[float],
    *,
    interval: int = 1,
    expand_buffer: float = 30.0,
    min_frames: int = 10,
) -> List[np.ndarray]:
    """Split one log's frame positions into in-region traversal index runs.

    Args:
        positions: [N, >=2] ego positions at base rate (10 Hz).
        road_block: (x_min, y_min, x_max, y_max).
        interval: keep every `interval`-th frame (10 Hz / interval).
        expand_buffer: extend each run while cumulative travel distance
            beyond the region stays under this many meters.
        min_frames: drop runs shorter than this (after subsampling).

    Returns list of int index arrays into `positions`.
    """
    pos = np.asarray(positions, np.float64)
    x0, y0, x1, y1 = road_block
    inside = (
        (pos[:, 0] >= x0) & (pos[:, 0] <= x1) & (pos[:, 1] >= y0) & (pos[:, 1] <= y1)
    )
    runs: List[Tuple[int, int]] = []
    i = 0
    n = len(pos)
    while i < n:
        if not inside[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and inside[j + 1]:
            j += 1
        runs.append((i, j))
        i = j + 1

    videos: List[np.ndarray] = []
    for s, e in runs:
        # expand both directions by travel distance
        a = s
        dist = 0.0
        while a > 0 and dist < expand_buffer:
            dist += float(np.linalg.norm(pos[a, :2] - pos[a - 1, :2]))
            a -= 1
        b = e
        dist = 0.0
        while b + 1 < n and dist < expand_buffer:
            dist += float(np.linalg.norm(pos[b + 1, :2] - pos[b, :2]))
            b += 1
        idx = np.arange(a, b + 1)[::interval]
        if len(idx) >= min_frames:
            videos.append(idx)
    return videos


def sort_and_dedupe_videos(
    video_infos: List[dict],
    *,
    central_token: str | None = None,
    dedupe_chamfer: float = 4.0,
) -> List[dict]:
    """FrameCentral traversal ordering + chamfer dedup.

    Each video_info needs `trajectory` [N, 3] and optionally
    `lidar_pc_tokens`. The traversal containing `central_token` sorts
    first; later traversals whose trajectory lies within
    `dedupe_chamfer` m (one-directional chamfer to an earlier kept
    traversal) are dropped (ref `sort_video_infos:169-234`).
    """

    def has_central(v):
        return central_token is not None and central_token in v.get(
            "lidar_pc_tokens", ()
        )

    ordered = sorted(video_infos, key=lambda v: (not has_central(v)))
    kept: List[dict] = []
    for v in ordered:
        traj = np.asarray(v["trajectory"])[:, :2]
        dup = False
        for k in kept:
            ktraj = np.asarray(k["trajectory"])[:, :2]
            if chamfer_distance(traj, ktraj) < dedupe_chamfer:
                dup = True
                break
        if not dup:
            kept.append(v)
    for i, v in enumerate(kept):
        v["video_idx"] = i
    return kept


def scan_log_cache_for_block(
    cache_path: str | Path, road_block: Sequence[float]
) -> List[dict]:
    """All cached logs whose trajectory touches the road block."""
    return [
        row
        for row in iter_log_info_cache(cache_path)
        if trajectory_intersects_block(np.asarray(row["trajectory"]), road_block)
    ]


# --------------------------------------------------------------------------
# Frame-record assembly (the pure-logic half of the reference's
# `ProduceVideoSceneDict` + `get_cam_info_from_lidar_pc`,
# `nuplan_video_processing.py:236-371` / `utils/nuplan_utils_custom.py:
# 117-172`). The nuPlan-devkit ORM supplies raw records; everything below
# operates on plain dicts/arrays so it is testable on fixtures and the
# devkit-gated entry only does record extraction.
# --------------------------------------------------------------------------

def _quat_wxyz_to_mat(q: Sequence[float]) -> np.ndarray:
    w, x, y, z = [float(v) for v in q]
    n = max((w * w + x * x + y * y + z * z) ** 0.5, 1e-12)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def pose_matrix(translation: Sequence[float], quat_wxyz: Sequence[float]) -> np.ndarray:
    """4x4 SE(3) from translation + wxyz quaternion."""
    m = np.eye(4)
    m[:3, :3] = _quat_wxyz_to_mat(quat_wxyz)
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def nearest_ego_pose(
    timestamps: np.ndarray, poses: np.ndarray, query_ts: float
) -> np.ndarray:
    """Ego pose (4x4) whose timestamp is closest to `query_ts` (the
    reference's `order_by(abs(EgoPose.timestamp - t)).first()` query,
    `nuplan_utils_custom.py:152`). `timestamps` must be sorted."""
    ts = np.asarray(timestamps)
    i = int(np.searchsorted(ts, query_ts))
    if i == 0:
        j = 0
    elif i >= len(ts):
        j = len(ts) - 1
    else:
        j = i if ts[i] - query_ts < query_ts - ts[i - 1] else i - 1
    return np.asarray(poses[j])


def rolling_shutter_cam_to_ego(
    img_timestamp: float,
    lidar_ego2global: np.ndarray,       # [4, 4] pose at the lidar sweep
    ego_pose_timestamps: np.ndarray,    # [M] sorted log ego-pose timestamps (us)
    ego_pose_matrices: np.ndarray,      # [M, 4, 4]
    cam2ego_calib: np.ndarray,          # [4, 4] camera extrinsic calibration
    *,
    rolling_shutter_s: float = 1 / 60,
) -> np.ndarray:
    """cam -> (lidar-frame) ego transform with rolling-shutter compensation.

    The reference (`get_cam_info_from_lidar_pc`,
    `nuplan_utils_custom.py:150-156`) looks up the ego pose nearest to
    `image timestamp + rolling_shutter` and chains
    c2e = inv(lidar_e2g) @ img_e2g @ c2img_e — the camera extrinsic is
    re-expressed in the LiDAR sweep's ego frame, correcting for ego
    motion during the shutter interval.
    """
    ts = img_timestamp + rolling_shutter_s * 1e6
    img_e2g = nearest_ego_pose(ego_pose_timestamps, ego_pose_matrices, ts)
    g2e = np.linalg.inv(np.asarray(lidar_ego2global, np.float64))
    return g2e @ img_e2g @ np.asarray(cam2ego_calib, np.float64)


def assemble_frame_info(
    frame: dict,
    cams: Dict[str, dict],
    *,
    road_block_center: np.ndarray,
    buffered_block: Sequence[float],
    video_token: str,
    frame_idx: int,
    expect_cams: int = 8,
) -> dict | None:
    """One `frame_info` record (`nuplan_video_processing.py:277-347`).

    Args:
        frame: {token, timestamp, log_name, log_token, lidar_path,
            can_bus [18], ego2global_translation [3],
            ego2global_rotation [4 wxyz], lidar2ego_translation,
            lidar2ego_rotation}.
        cams: channel -> cam info dict (see `rolling_shutter_cam_to_ego`
            callers); None / short dicts mark the frame broken.
        road_block_center: [3] world coordinate subtracted from all
            translations ('global' = road-block-local frame).
        buffered_block: (x0, y0, x1, y1) incl. reconstruct_buffer;
            out-of-buffer frames get skipped='out_of_region'.

    Returns the record, or None when camera info is broken (reference
    drops the frame, :341-343).
    """
    if cams is None or len(cams) != expect_cams:
        return None
    center = np.asarray(road_block_center, np.float64)
    can_bus = np.asarray(frame["can_bus"], np.float64).copy()
    can_bus[:3] -= center
    trans = can_bus[:3]
    rot = can_bus[3:7]
    xy = trans[:2] + center[:2]
    x0, y0, x1, y1 = buffered_block
    in_region = (x0 < xy[0] < x1) and (y0 < xy[1] < y1)

    ego2global = pose_matrix(trans, rot)
    lidar2ego = pose_matrix(
        frame["lidar2ego_translation"], frame["lidar2ego_rotation"]
    )
    info = {
        "skipped": False if in_region else "out_of_region",
        "token": frame["token"],
        "video_token": video_token,
        "frame_idx": frame_idx,
        "timestamp": frame["timestamp"],
        "log_name": frame.get("log_name"),
        "log_token": frame.get("log_token"),
        "can_bus": can_bus,
        "ego2global_translation": trans,
        "ego2global_rotation": rot,
        "ego2global": ego2global,
        "lidar_path": frame["lidar_path"],
        "lidar2ego_translation": np.asarray(frame["lidar2ego_translation"]),
        "lidar2ego_rotation": np.asarray(frame["lidar2ego_rotation"]),
        "lidar2ego": lidar2ego,
        "lidar2global": ego2global @ lidar2ego,
        "cams": cams,
    }
    return info


def build_video_record(
    video: dict,
    frames: List[dict],
    cams_per_frame: List[Dict[str, dict] | None],
    *,
    road_block: Sequence[float],
    reconstruct_buffer: float = 0.0,
    baseline_z: float = 0.0,
    timezone=None,
) -> dict:
    """One `video_scene_dict` entry from extracted records
    (`nuplan_video_processing.py:260-347`): header fields + the
    road-block-local frame, with broken-camera frames dropped."""
    from datetime import datetime, timezone as _tz

    x0, y0, x1, y1 = road_block
    center = np.array([(x0 + x1) / 2.0, (y0 + y1) / 2.0, baseline_z])
    buffered = (
        x0 - reconstruct_buffer, y0 - reconstruct_buffer,
        x1 + reconstruct_buffer, y1 + reconstruct_buffer,
    )
    start_ts = frames[0]["timestamp"]
    tz = timezone or _tz.utc
    rec = {
        "video_token": video["video_token"],
        "log_token": video.get("log_token"),
        "log_name": video.get("log_name"),
        "map_location": video.get("map_location"),
        "vehicle_name": video.get("vehicle_name"),
        "start_ts": start_ts,
        "end_ts": frames[-1]["timestamp"],
        "date": datetime.fromtimestamp(start_ts / 1e6, tz).date(),
        "hour": datetime.fromtimestamp(start_ts / 1e6, tz).hour,
        "global2world_translation": center,
        "frame_infos": [],
    }
    for idx, (frame, cams) in enumerate(zip(frames, cams_per_frame)):
        info = assemble_frame_info(
            frame, cams,
            road_block_center=center, buffered_block=buffered,
            video_token=video["video_token"], frame_idx=idx,
        )
        if info is not None:
            rec["frame_infos"].append(info)
    return rec


def build_frame_infos_nuplan(*args, **kwargs):
    """Build full per-frame records from the nuPlan DBs. The record
    EXTRACTION needs nuplan-devkit + the sensor release (absent here);
    the assembly logic lives in `build_video_record` /
    `rolling_shutter_cam_to_ego` above and is fixture-tested."""
    try:
        import nuplan  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "build_frame_infos_nuplan needs nuplan-devkit and the nuPlan "
            "sensor release; this environment has neither. Use "
            "build_video_record on extracted records instead."
        ) from e
    raise NotImplementedError
