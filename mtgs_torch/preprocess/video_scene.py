"""Staged `video_scene_dict` store + filter registry (data-factory spine);
port of `mtgs_tpu/preprocess/video_scene.py`.

Re-provides the reference's `VideoScene` pickle protocol
(`nuplan_scripts/utils/video_scene_dict_tools.py:90-280` in
OpenDriveLab/MTGS): each preprocessing stage writes its own
`video_scene_dict_<stage>.pkl` and re-points the canonical
`video_scene_dict.pkl` symlink at it, so any stage can be re-run and the
training reader (`mtgs_torch/data/nuplan.py`) always loads the newest
completed stage. The filter registry mirrors `SCENE_DICT_FACTORY`:
select/trim videos, mark low-velocity frames skipped, drop skipped
frames, inject trajectories.

The dict schema is the reference's (documented in
`docs/prepare_dataset.md:104-187`): {video_token: {video_token,
frame_infos: [{lidar_path, ego2global_translation/rotation, can_bus,
cams: {CAM_X: {...}}, ...}], ...}}.

A stage pickle holds numpy arrays and plain Python only, never tensors, so
a stage that either package writes, the other reads.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

STAGES = ("raw", "filtered", "registered", "colmap", "final")


class VideoScene:
    """Path registry + staged pickle IO for one road block."""

    def __init__(self, data_root: str | Path, name: str):
        self.data_root = Path(data_root)
        self.name = name

    # ------------------------------------------------------------ paths

    @property
    def root(self) -> Path:
        return self.data_root / self.name

    @property
    def pickle_path(self) -> Path:
        return self.root / "video_scene_dict.pkl"

    def stage_path(self, stage: str) -> Path:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; expected one of {STAGES}")
        return self.root / f"video_scene_dict_{stage}.pkl"

    # artifact directories (the training reader's expectations)
    @property
    def undistorted_image_path(self) -> Path:
        return self.root / "images" / "undistorted"

    @property
    def raw_mask_path(self) -> Path:
        return self.root / "masks" / "raw"

    @property
    def undistorted_mask_path(self) -> Path:
        return self.root / "masks" / "undistorted"

    @property
    def undistorted_depth_path(self) -> Path:
        return self.root / "depth" / "undistorted"

    @property
    def rgb_point_cloud_path(self) -> Path:
        return self.root / "rgb_point_cloud"

    @property
    def sfm_point_cloud_path(self) -> Path:
        return self.root / "sfm_point_cloud"

    @property
    def instance_point_cloud_path(self) -> Path:
        return self.root / "instance_point_cloud"

    @property
    def colmap_path(self) -> Path:
        return self.root / "colmap"

    @property
    def registration_path(self) -> Path:
        return self.root / "registration_results"

    # --------------------------------------------------------------- IO

    def save(self, video_scene_dict: dict, stage: str, link: bool = True) -> Path:
        """Write the stage pickle; re-point the canonical symlink at it.
        Raises TypeError, writing nothing, if the dict holds a tensor."""
        _refuse_tensors(video_scene_dict, "video_scene_dict")
        path = self.stage_path(stage)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(video_scene_dict, f)
        if link:
            if self.pickle_path.is_symlink() or self.pickle_path.exists():
                self.pickle_path.unlink()
            os.symlink(path.name, self.pickle_path)
        return path

    def load(self, stage: str | None = None) -> dict:
        """Load a stage pickle (or the canonical symlink when None)."""
        path = self.pickle_path if stage is None else self.stage_path(stage)
        with open(path, "rb") as f:
            return pickle.load(f)

    def latest_stage(self) -> str | None:
        """Name of the newest existing stage, in pipeline order."""
        have = [s for s in STAGES if self.stage_path(s).exists()]
        return have[-1] if have else None


def _refuse_tensors(obj, where: str) -> None:
    if isinstance(obj, torch.Tensor):
        raise TypeError(f"{where} is a torch.Tensor: stage pickles hold numpy arrays and "
                        "plain Python only")
    if isinstance(obj, dict):
        for k, v in obj.items():
            _refuse_tensors(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _refuse_tensors(v, f"{where}[{i}]")


# ------------------------------------------------------------ filters

FILTERS: Dict[str, Callable] = {}


def register_filter(name: str):
    def deco(fn):
        FILTERS[name] = fn
        return fn

    return deco


def apply_filters(video_scene_dict: dict, names: Sequence, **kwargs) -> dict:
    for name in names:
        video_scene_dict = FILTERS[name](video_scene_dict, **kwargs.get(name, {}))
    return video_scene_dict


@register_filter("filter_by_video_idx")
def filter_by_video_idx(video_scene_dict: dict, video_idxs: Sequence = ()) -> dict:
    """Keep the selected videos (by trailing index of the token); entries
    may be {idx, start_frame, end_frame} dicts to trim frame ranges
    (ref `filter_by_video_idx`)."""
    if not video_idxs:
        return video_scene_dict
    by_idx = {
        int(token.split("-")[-1]): info for token, info in video_scene_dict.items()
    }
    out = {}
    for sel in video_idxs:
        if isinstance(sel, dict):
            info = dict(by_idx[sel["idx"]])
            info["frame_infos"] = info["frame_infos"][
                sel.get("start_frame", 0): sel.get("end_frame", len(info["frame_infos"]))
            ]
        else:
            info = by_idx[sel]
        out[info["video_token"]] = info
    return out


@register_filter("filter_low_velocity")
def filter_low_velocity(
    video_scene_dict: dict, min_displacement: float = 0.3, max_consecutive: int = 10
) -> dict:
    """Mark frames moving < `min_displacement` m since the last kept frame
    as skipped, at most `max_consecutive` in a row (ref
    `filter_low_velocity`: parked ego produces hundreds of near-identical
    frames; a run of skips is broken every 10 frames)."""
    for info in video_scene_dict.values():
        frames = info["frame_infos"]
        if not frames:
            continue
        last = np.asarray(frames[0]["can_bus"][0:3], np.float64)
        run = max_consecutive
        for f in frames:
            pos = np.asarray(f["can_bus"][0:3], np.float64)
            if np.linalg.norm(pos - last) < min_displacement and run < max_consecutive:
                f["skipped"] = "low_velocity"
                run += 1
                continue
            run = 0
            last = pos
    return video_scene_dict


@register_filter("filter_skipped_frames")
def filter_skipped_frames(video_scene_dict: dict) -> dict:
    for info in video_scene_dict.values():
        info["frame_infos"] = [
            f for f in info["frame_infos"] if not f.get("skipped", False)
        ]
    return video_scene_dict


@register_filter("inject_trajectory")
def inject_trajectory(video_scene_dict: dict) -> dict:
    for info in video_scene_dict.values():
        info["trajectory"] = np.asarray(
            [f["ego2global_translation"] for f in info["frame_infos"]]
        )
    return video_scene_dict
