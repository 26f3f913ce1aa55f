"""The render half of `mtgs_tpu/train/trainer.py`: `TrainerConfig` (its
render fields), `Batch`, and `render_view` with training=False — the
forward every serving caller (eval, trajectory render, viewer) goes
through: scene-graph collect -> normals -> rasterize -> background ->
exposure."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from mtgs_torch import resolve_device
from mtgs_torch.core.camera import camera_to_gsplat_viewmat
from mtgs_torch.core.quat import quat_to_rotmat
from mtgs_torch.models.appearance import apply_exposure
from mtgs_torch.models.scene_graph import (
    SceneAux, SceneConfig, SceneParams, ViewInputs, collect_gaussians,
)
from mtgs_torch.raster import RasterizeConfig, rasterize
from mtgs_torch.train.control import ControlConfig, sh_degree_mask
from mtgs_torch.train.losses import gaussian_camera_normals


@dataclass(frozen=True)
class TrainerConfig:
    """Render-relevant fields of the JAX TrainerConfig (same defaults)."""

    width: int = 960
    height: int = 540
    tile_size: int = 32
    max_intersections: int = 1 << 21
    rasterize_mode: str = "antialiased"
    max_steps: int = 30001
    predict_normals: bool = True
    background_color: float = 0.0
    control: ControlConfig = field(default_factory=ControlConfig)
    scene: SceneConfig = field(default_factory=SceneConfig)

    def raster_config(self) -> RasterizeConfig:
        return RasterizeConfig(
            width=self.width, height=self.height, tile_size=self.tile_size,
            max_intersections=self.max_intersections,
            rasterize_mode=self.rasterize_mode, render_mode="RGB+ED",
        )

    def replace(self, **kw) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class Batch:
    """One camera view. Arrays may be tensors or numpy arrays."""

    image: torch.Tensor                 # [H, W, 3] in [0, 1]
    mask: torch.Tensor                  # [H, W, 1] 0/1
    c2w: torch.Tensor                   # [4, 4] scene-frame camera-to-world
    K: torch.Tensor                     # [3, 3]
    cam_idx: int                        # physical camera id
    image_idx: int                      # image row (camera_opt index)
    travel_index: int
    frame_idx: int
    timestamp: float
    lidar_depth: Optional[torch.Tensor] = None   # [H, W, 1]


def _on(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _check_scene_device(params: SceneParams, dev: torch.device) -> None:
    d = params.background.means.device
    if d.type != dev.type or (dev.index is not None and d.index != dev.index):
        raise ValueError(f"scene lives on {d} but render device is {dev}")


def render_view(
    params: SceneParams,
    aux: SceneAux,
    cfg: TrainerConfig,
    batch: Batch,
    step: int,
    *,
    training: bool = False,
    travel_mode: Optional[str] = None,
    apply_cam_opt: Optional[bool] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Full forward pass for one camera (serving path, training=False)."""
    dev = resolve_device(device)
    if training:
        raise NotImplementedError("render_view(training=True) comes with the "
                                  "training slice of the port")
    if apply_cam_opt:
        raise NotImplementedError("camera-pose optimisation is not ported yet")
    _check_scene_device(params, dev)
    c2w = _on(batch.c2w, dev)
    K = _on(batch.K, dev)
    scene_cfg = cfg.scene
    if travel_mode is not None:
        scene_cfg = dataclasses.replace(scene_cfg, travel_mode=travel_mode)

    view = ViewInputs(
        travel_index=int(batch.travel_index),
        frame_idx=int(batch.frame_idx),
        timestamp=_on(batch.timestamp, dev),
        cam_pos=c2w[:3, 3],
        sh_mask=sh_degree_mask(step, cfg.control, dev),
        image_idx=int(batch.image_idx),
    )
    g = collect_gaussians(params, aux, scene_cfg, view)

    colors = g["colors"]
    if cfg.predict_normals:
        normals = gaussian_camera_normals(
            g["scales"], quat_to_rotmat(g["quats"]), g["means"], c2w[:3, 3], c2w[:3, :3])
        colors = torch.cat([colors, normals], dim=-1)

    viewmat = camera_to_gsplat_viewmat(c2w)
    render, alpha, info = rasterize(
        g["means"], g["quats"], g["scales"], g["opacities"], colors,
        viewmat, K, cfg.raster_config())

    bg = torch.full((3,), cfg.background_color, dtype=render.dtype, device=dev)
    rgb = torch.clamp(render[..., :3] + (1.0 - alpha) * bg, 0.0, 1.0)
    rgb_appearance = apply_exposure(params.appearance, rgb, int(batch.cam_idx))

    depth = render[..., -1:]
    # threshold 1e-6 (not 0): below it the ED normalisation divided by the
    # 1e-10 clamp, not alpha; such pixels are treated like empty ones
    depth = torch.where(alpha > 1e-6, depth, depth.max())

    out = dict(
        rgb=rgb, rgb_appearance=rgb_appearance, depth=depth, accumulation=alpha,
        background=bg, radii=info["radii"], means2d=info["means2d"],
        compensations=info["compensations"],
        n_intersections=info["n_intersections"], gaussians=g,
    )
    if cfg.predict_normals:
        n = render[..., 3:6]
        # epsilon-safe normalise: empty pixels have exactly-zero normals
        n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
        out["normal"] = (n + 1.0) / 2.0
    return out
