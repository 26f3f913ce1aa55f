"""nuPlan road-block dataset parser; port of `mtgs_tpu/data/nuplan.py`.

Reads the reference data factory's *unchanged* on-disk format — the
`video_scene_dict.pkl` + per-road-block folder produced by
`nuplan_scripts/preprocess.sh` (schema: `docs/prepare_dataset.md:104-187`
in OpenDriveLab/MTGS) — and builds flat per-image records plus scene
seeds, mirroring `NuplanDataParser._generate_dataparser_outputs`
(`mtgs/dataset/nuplan_dataparser.py:107-577`):

  * per-(frame, camera) lists: image paths, intrinsics + distortion
    (COLMAP-refined when present), scene-frame camera-to-world poses
    (ego2global @ cam2ego with the OpenCV->scene flip), lidar2cam,
    traversal ids, normalized timestamps, tokens, mask/depth paths;
  * split handling: skipped-frame filtering, `eval_2hz` ([::5] + last),
    interleaved `manual_split`;
  * nearest-train-traversal mapping for eval fallback (trajectory
    chamfer distance, ref :148-165);
  * background seed points (stacked RGB LiDAR pcd + optional SfM points,
    outlier-removed + voxel-downsampled — numpy replacements for the
    reference's open3d calls, ref :460-500);
  * per-instance infos from gt tracks: per-frame pose arrays, in-frame
    masks, >=100-point filter, <3 m-displacement static detection
    (ref `_generate_instance_infos` :502-577).

All torch/open3d dependencies of the reference are replaced with
numpy/scipy, as in the JAX package; nothing here runs on the card
(host-side, once per run). The port keeps its own copies of the
dataclasses `ImageRecord`, `InstanceInfo` and `ParsedScene`.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mtgs_torch.utils.pointcloud import (
    load_pcd,
    statistical_outlier_removal,
    voxel_downsample,
)

CAMERAS_DEFAULT = (
    "CAM_F0", "CAM_L0", "CAM_R0", "CAM_L1", "CAM_R1", "CAM_L2", "CAM_R2", "CAM_B0",
)


def _quat_to_mat(q: Sequence[float]) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def matrix_from_translation_quaternion(
    translation, quaternion, opencv_to_scene: bool = True
) -> np.ndarray:
    """4x4 pose from (t, q_wxyz); optionally flip cv->scene camera frame
    (ref `mtgs/utils/camera_utils.py:276-293`)."""
    m = np.eye(4)
    m[:3, :3] = _quat_to_mat(quaternion)
    m[:3, 3] = np.asarray(translation)
    if opencv_to_scene:
        m[:3, 1:3] *= -1.0
    return m


def chamfer_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric trajectory chamfer (ref `mtgs/utils/__init__.py:4-33`)."""
    from scipy.spatial import cKDTree

    if len(a) == 0 or len(b) == 0:
        return float("inf")
    da, _ = cKDTree(b[:, :2]).query(a[:, :2])
    db, _ = cKDTree(a[:, :2]).query(b[:, :2])
    return float(da.mean() + db.mean())


@dataclasses.dataclass
class ImageRecord:
    """One (frame, camera) sample."""

    image_path: str
    intrinsic: np.ndarray          # [3, 3]
    distortion: np.ndarray         # [5]
    c2w: np.ndarray                # [4, 4] scene frame, road-block-local
    lidar2cam: np.ndarray          # [4, 4]
    lidar_path: Optional[str]
    travel_id: int
    travel_index: int              # dense embedding index
    frame_idx: int                 # global frame row (across traversals)
    frame_token: str
    cam_token: str
    cam_name: str
    cam_idx: int
    timestamp: float               # normalized [0, 1] within traversal
    raw_timestamp: int
    semantic_mask_path: Optional[str] = None
    depth_image_path: Optional[str] = None
    panoptic_mask_path: Optional[str] = None
    width: int = 1920
    height: int = 1080
    # per-image brightness factor from the preprocess exposure alignment
    # (ref `nuplan_dataparser.py:358-359` reads cam_info['v_adjust'];
    # applied at load, `custom_dataset.py:78-97`)
    v_adjust: float = 1.0
    # static per-camera ego-vehicle mask (ref `custom_dataset.py:154-160`,
    # path scheme `nuplan_dataparser.py:320-326`)
    ego_mask_path: Optional[str] = None


@dataclasses.dataclass
class InstanceInfo:
    """One tracked object (ref `_generate_instance_infos`)."""

    track_token: str
    class_name: str
    points: np.ndarray             # [n, 3] box-local
    colors: np.ndarray             # [n, 3] 0..255
    size: np.ndarray               # [3] l, w, h
    travel_id: int
    quats: np.ndarray              # [F_travel, 4] per-frame global pose
    trans: np.ndarray              # [F_travel, 3]
    in_frame_mask: np.ndarray      # [F_travel] bool
    is_static: bool
    # lidar-pc token per pose row — aligns poses onto the SPLIT's frame
    # rows (eval_2hz / manual_split subsample them)
    frame_tokens: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ParsedScene:
    records: List[ImageRecord]
    train_travel_ids: List[int]
    eval_travel_ids: List[int]
    nearest_train_travel_of_eval: Dict[int, int]
    travel_index_of_id: Dict[int, int]
    frame_timestamps: np.ndarray   # [F_total] normalized
    travel_of_frame: np.ndarray    # [F_total] travel_index per frame row
    seed_xyz: Optional[np.ndarray] = None
    seed_rgb: Optional[np.ndarray] = None
    instances: List[InstanceInfo] = dataclasses.field(default_factory=list)
    num_frame_rows: int = 0
    # (travel_id, frame token) -> global frame row of THIS split
    frame_row_of_token: Dict = dataclasses.field(default_factory=dict)


def load_video_scene_dict(path: str | Path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _filter_skipped(frame_infos: List[dict]) -> List[dict]:
    return [fi for fi in frame_infos if not fi.get("skipped", False)]


def openscene_tokens_for_log(openscene_root: str | Path, log_name: str) -> set:
    """Lidar-pc token set of one log from the OpenScene meta pkls
    (consumed by `parse_scene(eval_tokens=...)` for token-split eval)."""
    import pickle as _pickle

    for split_name in ("trainval", "test"):
        p = Path(openscene_root) / "meta_datas" / split_name / f"{log_name}.pkl"
        if p.exists():
            with open(p, "rb") as f:
                return {info["token"] for info in _pickle.load(f)}
    raise FileNotFoundError(f"no OpenScene meta pkl for log {log_name}")


def parse_scene(
    data_root: str | Path,
    *,
    cameras: Sequence[str] = CAMERAS_DEFAULT,
    split: str = "train",
    train_travels: Optional[Sequence[int]] = None,
    eval_travels: Optional[Sequence[int]] = None,
    eval_2hz: bool = True,
    manual_split: bool = False,
    use_colmap_intrinsics: bool = True,
    use_colmap_pose: bool = True,
    load_points: bool = True,
    voxel_size: float = 0.15,
    pickle_name: str = "video_scene_dict.pkl",
    eval_tokens: Optional[set] = None,
    use_exposure_alignment: bool = True,
) -> ParsedScene:
    """Parse one road block folder into flat records + seeds."""
    data_root = Path(data_root)
    vsd = load_video_scene_dict(data_root / pickle_name)

    all_travels = sorted(int(tok.split("-")[-1]) for tok in vsd)
    train_ids = list(train_travels) if train_travels else all_travels
    eval_ids = list(eval_travels) if eval_travels else all_travels

    # nearest train traversal per eval traversal (chamfer; ref :148-165)
    trajs = {int(t.split("-")[-1]): np.asarray(v["trajectory"]) for t, v in vsd.items()}
    nearest = {}
    for e in eval_ids:
        if e in train_ids:
            nearest[e] = e
            continue
        best, bd = None, float("inf")
        for t in train_ids:
            d = chamfer_distance(trajs[e], trajs[t])
            if d < bd:
                best, bd = t, d
        nearest[e] = best

    travel_index_of_id = {tid: i for i, tid in enumerate(train_ids)}

    use_ids = train_ids if split == "train" else eval_ids
    records: List[ImageRecord] = []
    frame_ts_rows: List[float] = []
    travel_of_frame: List[int] = []
    row_of = {}

    for video_token in sorted(vsd, key=lambda t: int(t.split("-")[-1])):
        travel_id = int(video_token.split("-")[-1])
        if travel_id not in use_ids:
            continue
        infos = vsd[video_token]["frame_infos"]

        # normalized timestamps over the unfiltered traversal
        all_ts = [fi["timestamp"] for fi in infos]
        for fi in infos:
            for ci in fi["cams"].values():
                all_ts.append(ci["timestamp"])
        min_ts, max_ts = min(all_ts), max(all_ts)
        span = max(max_ts - min_ts, 1)

        infos = _filter_skipped(infos)
        if split != "train" and eval_tokens is not None:
            # OpenScene-token eval: keep only frames whose lidar-pc token
            # appears in the provided set (ref `eval_openscene`,
            # `nuplan_dataparser.py:209-217`)
            infos = [fi for fi in infos if fi["token"] in eval_tokens]
        elif manual_split:
            infos = (infos[:-1][::2] + infos[-1:]) if split == "train" else infos[:-1][1::2]
        elif split != "train" and eval_2hz:
            infos = infos[:-1][::5] + infos[-1:]

        # unseen traversal -> chamfer-nearest train traversal's embedding
        # (the reference's default `nearest_travel` eval fallback,
        # `multi_color_gaussian_splatting.py:103-117` + mapping built at
        # `nuplan_dataparser.py:148-165`)
        tindex = travel_index_of_id.get(
            travel_id, travel_index_of_id.get(nearest.get(travel_id), 0))
        for fi in infos:
            row = len(frame_ts_rows)
            row_of[(travel_id, fi["token"])] = row
            frame_ts_rows.append(
                float(np.clip((fi["timestamp"] - min_ts) / span, 0, 1))
            )
            travel_of_frame.append(tindex)
            ego2global = np.asarray(fi["ego2global"], np.float64)
            lidar2ego = np.asarray(fi["lidar2ego"], np.float64)

            for cam_idx, cam in enumerate(cameras):
                if cam not in fi["cams"]:
                    continue
                ci = fi["cams"][cam]
                if split == "train" and use_colmap_pose and not ci.get("valid", True):
                    continue
                colmap = ci.get("colmap_param") if use_colmap_intrinsics else None
                K = np.asarray(
                    (colmap or ci)["cam_intrinsic"], np.float64
                )
                dist = np.asarray((colmap or ci)["distortion"], np.float64)
                if use_colmap_pose and split != "test" and colmap is not None \
                        and "sensor2global_translation" in colmap:
                    c2w = matrix_from_translation_quaternion(
                        colmap["sensor2global_translation"],
                        colmap["sensor2global_rotation"],
                    )
                else:
                    cam2ego = matrix_from_translation_quaternion(
                        ci["sensor2ego_translation"], ci["sensor2ego_rotation"]
                    )
                    c2w = ego2global @ cam2ego

                cam2ego_cv = matrix_from_translation_quaternion(
                    ci["sensor2ego_translation"], ci["sensor2ego_rotation"],
                    opencv_to_scene=False,
                )
                lidar2cam = np.linalg.inv(cam2ego_cv) @ lidar2ego

                ts_n = float(np.clip((ci["timestamp"] - min_ts) / span, 0, 1))
                records.append(ImageRecord(
                    image_path=str(data_root / "raw_images" / ci["data_path"]),
                    intrinsic=K.astype(np.float32),
                    distortion=dist.astype(np.float32),
                    c2w=c2w.astype(np.float32),
                    lidar2cam=lidar2cam.astype(np.float32),
                    lidar_path=(
                        str(data_root / "raw_lidars" / fi["lidar_path"])
                        if fi.get("lidar_path") else None
                    ),
                    travel_id=travel_id,
                    travel_index=tindex,
                    frame_idx=row,
                    frame_token=fi["token"],
                    cam_token=os.path.basename(ci["data_path"]).split(".")[0],
                    cam_name=cam,
                    cam_idx=cam_idx,
                    timestamp=ts_n,
                    raw_timestamp=int(ci["timestamp"]),
                    semantic_mask_path=str(
                        data_root / "semantic_masks" / ci["data_path"].replace(".jpg", ".png")
                    ),
                    depth_image_path=str(
                        data_root / "optimal_undistorted_depth" / ci["data_path"].replace(".jpg", ".png")
                    ),
                    v_adjust=float(ci.get("v_adjust", 1.0))
                    if use_exposure_alignment else 1.0,
                    ego_mask_path=str(data_root / "ego_masks" / f"{cam}.png"),
                ))

    scene = ParsedScene(
        records=records,
        train_travel_ids=train_ids,
        eval_travel_ids=eval_ids,
        nearest_train_travel_of_eval=nearest,
        travel_index_of_id=travel_index_of_id,
        frame_timestamps=np.asarray(frame_ts_rows, np.float32),
        travel_of_frame=np.asarray(travel_of_frame, np.int32),
        num_frame_rows=len(frame_ts_rows),
    )

    if load_points:
        scene.seed_xyz, scene.seed_rgb = load_seed_points(
            data_root, voxel_size=voxel_size
        )
        scene.instances = load_instances(data_root, vsd, train_ids, row_of)
    scene.frame_row_of_token = dict(row_of)
    return scene


def load_seed_points(
    data_root: Path, *, voxel_size: float = 0.15
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Stacked RGB LiDAR pcd (+SfM points) with outlier removal + voxel
    downsample (ref `_load_3D_points`, :460-500; open3d -> numpy)."""
    candidates = [
        data_root / "stacked_point_cloud" / "background.pcd",
        data_root / "background.pcd",
        data_root / "colmap" / "sfm_points.pcd",
    ]
    xyz_list, rgb_list = [], []
    for p in candidates:
        if p.exists():
            xyz, rgb = load_pcd(p)
            if xyz is not None and len(xyz):
                xyz_list.append(xyz)
                rgb_list.append(rgb if rgb is not None else np.full_like(xyz, 127.0))
    if not xyz_list:
        return None, None
    xyz = np.concatenate(xyz_list)
    rgb = np.concatenate(rgb_list)
    keep = statistical_outlier_removal(xyz, k=20, std_ratio=2.0)
    xyz, rgb = xyz[keep], rgb[keep]
    xyz, rgb = voxel_downsample(xyz, rgb, voxel_size)
    return xyz.astype(np.float32), rgb.astype(np.float32)


def load_instances(
    data_root: Path, vsd: dict, train_ids: Sequence[int], row_of: dict,
    min_points: int = 100, static_thresh: float = 3.0,
) -> List[InstanceInfo]:
    """Per-track instance seeds + per-frame poses from gt boxes
    (ref `_generate_instance_infos`, :502-577)."""
    out: List[InstanceInfo] = []
    pc_dir = data_root / "instance_point_cloud"
    if not pc_dir.exists():
        return out
    for video_token in sorted(vsd, key=lambda t: int(t.split("-")[-1])):
        travel_id = int(video_token.split("-")[-1])
        if travel_id not in train_ids:
            continue
        infos = [fi for fi in vsd[video_token]["frame_infos"] if not fi.get("skipped", False)]
        F = len(infos)
        tracks: Dict[str, dict] = {}
        for f, fi in enumerate(infos):
            boxes = np.asarray(fi.get("gt_boxes", np.zeros((0, 7))))
            names = fi.get("gt_names", [])
            tokens = fi.get("track_tokens", [])
            ego2global = np.asarray(fi["ego2global"], np.float64)
            for b, name, tok in zip(boxes, names, tokens):
                t = tracks.setdefault(tok, dict(
                    name=name, quats=np.zeros((F, 4), np.float32),
                    trans=np.zeros((F, 3), np.float32),
                    mask=np.zeros((F,), bool), size=b[3:6],
                ))
                heading = b[6]
                # ego-frame box -> global
                c, s = np.cos(heading), np.sin(heading)
                R_box = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                R = ego2global[:3, :3] @ R_box
                tr = ego2global[:3, :3] @ b[:3] + ego2global[:3, 3]
                # rotmat -> quat (w x y z)
                qw = np.sqrt(max(1 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
                qx = (R[2, 1] - R[1, 2]) / (4 * qw)
                qy = (R[0, 2] - R[2, 0]) / (4 * qw)
                qz = (R[1, 0] - R[0, 1]) / (4 * qw)
                t["quats"][f] = [qw, qx, qy, qz]
                t["trans"][f] = tr
                t["mask"][f] = True
        for tok, t in tracks.items():
            pcd_path = pc_dir / f"{tok}.pcd"
            if not pcd_path.exists():
                continue
            xyz, rgb = load_pcd(pcd_path)
            if xyz is None or len(xyz) < min_points:
                continue
            pos = t["trans"][t["mask"]]
            disp = np.linalg.norm(pos.max(0) - pos.min(0)) if len(pos) else 0.0
            out.append(InstanceInfo(
                track_token=tok, class_name=t["name"],
                points=xyz.astype(np.float32),
                colors=(rgb if rgb is not None else np.full_like(xyz, 127)).astype(np.float32),
                size=np.asarray(t["size"], np.float32),
                travel_id=travel_id,
                quats=t["quats"], trans=t["trans"], in_frame_mask=t["mask"],
                is_static=bool(disp < static_thresh),
                frame_tokens=[fi["token"] for fi in infos],
            ))
    return out
