"""The program under test, reached through its public entry points: the
method presets (`mtgs_torch.configs`), the scene containers
(`models.gaussians`, `models.scene_graph`), `train.trainer.render_view`
and `Trainer`. The benchmark's raw tensors go in as copies, so nothing the
program updates in place reaches the benchmark's own inputs.
"""

from __future__ import annotations

import dataclasses

import torch

from mtgs_torch.configs import method_config, optimizer_table
from mtgs_torch.models.gaussians import GaussianNodeParams, NodeAux
from mtgs_torch.models.scene_graph import (
    InstanceAux, InstanceParams, SceneAux, SceneParams,
)
from mtgs_torch.train.trainer import Batch, Trainer, TrainerConfig, render_view

__all__ = ["Batch", "Trainer", "render_view", "optimizer_table", "scene_params",
           "trainer_config"]


def _node(raw: dict):
    t = {k: v.clone() for k, v in raw.items()}
    alive = t.pop("alive")
    params = GaussianNodeParams(fourier_dc=t["means"].new_zeros(
        tuple(t["means"].shape[:-1]) + (0, 3)), **t)
    num = alive.sum(-1).to(torch.int32)
    return params, alive, num


def scene_params(raw: dict):
    """(SceneParams, SceneAux) of the raw scene, every tensor a copy."""
    bg, bg_alive, bg_num = _node(raw["background"])
    sky, sky_aux = None, None
    if raw["skybox"] is not None:
        sky, alive, num = _node(raw["skybox"])
        sky_aux = NodeAux(alive=alive, num_alive=num)
    inst, inst_aux = None, None
    if raw["instances"] is not None:
        r = raw["instances"]
        node, alive, num = _node(r["node"])
        inst = InstanceParams(node=node, quats=r["quats"].clone(), trans=r["trans"].clone())
        inst_aux = InstanceAux(alive=alive, num_alive=num, present=r["present"].clone(),
                               is_static=r["is_static"].clone(),
                               frame_timestamps=r["frame_timestamps"].clone(),
                               travel_of_frame=r["travel_of_frame"].clone(),
                               sizes=r["sizes"].clone())
    params = SceneParams(background=bg, skybox=sky, instances=inst, deformables=None,
                         appearance=raw["appearance"].clone(),
                         camera_opt=raw["camera_opt"].clone())
    aux = SceneAux(background=NodeAux(alive=bg_alive, num_alive=bg_num), skybox=sky_aux,
                   instances=inst_aux)
    return params, aux


def trainer_config(cfg: dict, width: int, height: int,
                   max_intersections: int) -> TrainerConfig:
    """The method preset at the cell's size, its pair buffer set; raises
    where the preset departs from what the configuration file states."""
    tc = method_config(cfg["method"], width=width, height=height, max_steps=cfg["max_steps"])
    stated = cfg["preset"]
    seen = dict(rasterize_mode=tc.rasterize_mode, predict_normals=tc.predict_normals,
                tile_size=tc.tile_size, sh_degree=tc.scene.sh_degree,
                background_color=tc.background_color, fused=tc.fused,
                loss=dataclasses.asdict(tc.loss))
    for key, want in stated.items():
        have = seen[key]
        if key == "loss":
            diff = {k: (have[k], v) for k, v in want.items() if have[k] != v}
            if diff:
                raise ValueError(f"{cfg['name']}: the preset's losses differ: {diff}")
        elif have != want:
            raise ValueError(f"{cfg['name']}: the preset's {key} is {have!r}, the "
                             f"configuration states {want!r}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise ValueError("the program runs with TF32 on; the configurations state f32")
    return tc.replace(max_intersections=max_intersections)


def batch(view: dict, targets: dict, device) -> Batch:
    """The program's Batch of one view (targets None for a render)."""
    dev = torch.device(device)
    t = targets or {}
    return Batch(image=t.get("image"), mask=t.get("mask"), c2w=view["c2w"].to(dev),
                 K=view["K"].to(dev), cam_idx=view["cam_idx"], image_idx=view["image_idx"],
                 travel_index=view["travel_index"], frame_idx=view["frame_idx"],
                 timestamp=view["timestamp"], lidar_depth=t.get("lidar_depth"),
                 pseudo_depth=t.get("pseudo_depth"))
