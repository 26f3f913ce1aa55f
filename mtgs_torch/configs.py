"""Method presets; port of `mtgs_tpu/configs.py`: `mtgs_config`,
`gs3d_config`, `mtgs_deformable_config`, `wild_gaussians_config`,
`optimizer_table`, `METHODS` and `method_config`."""

from __future__ import annotations

import dataclasses

from mtgs_torch.models.scene_graph import SceneConfig
from mtgs_torch.train.control import ControlConfig
from mtgs_torch.train.losses import LossConfig
from mtgs_torch.train.optim import OptimConfig, default_groups
from mtgs_torch.train.trainer import TrainerConfig

ITERS = 30001


def mtgs_config(width: int = 960, height: int = 540, max_steps: int = ITERS) -> TrainerConfig:
    """The full MTGS method (`mtgs/config/MTGS.py:25-213`): antialiased,
    RGB+ED with predicted normals, LiDAR InverseL1 depth, NCC, normal and
    shape losses. The reference's schedule is written in absolute steps
    for 30001 iterations; the step-valued fields scale by
    max_steps / 30001 so each event keeps its place in the run (the
    reset interval keeps the last reset at ~40%)."""
    s = max_steps / ITERS

    def st(v: int) -> int:  # scale a step-valued schedule field
        return max(int(round(v * s)), 1)

    return TrainerConfig(
        width=width,
        height=height,
        max_steps=max_steps,
        rasterize_mode="antialiased",
        predict_normals=True,
        control=ControlConfig(
            densify_from_iter=st(500),
            refine_every=100,
            stop_split_at=st(15000),
            reset_alpha_every=max(int(round(30 * s)), 2),
            continue_cull_post_densification=False,
            cull_alpha_thresh=0.005,
            cull_scale_thresh=0.5,
            densify_size_thresh=0.2,
            densify_grad_thresh=0.001,
            n_split_samples=2,
            clone_sample_means=True,
            stop_screen_size_at=st(15000),
            cull_screen_size=150.0,
            split_screen_size=100.0,
            sh_degree=3,
            sh_degree_interval=st(1000),
            use_abs_grad=True,
        ),
        loss=LossConfig(
            ssim_lambda=0.2,
            depth_lambda=0.5,
            depth_loss_type="InverseL1",
            depth_source="lidar",
            ncc_lambda=0.1,
            normal_lambda=0.1,
            use_normal_loss=True,
            use_normal_tv_loss=True,
            two_d_gaussians=True,
            oob_lambda=1.0,
            sharp_shape_reg_lambda=1.0,
        ),
        scene=SceneConfig(sh_degree=3, travel_mode="index"),
    )


def gs3d_config(width: int = 960, height: int = 540, max_steps: int = ITERS) -> TrainerConfig:
    """Single-traversal vanilla 3DGS baseline (`mtgs/config/3DGS.py`):
    classic rasterization, no depth/normal supervision, mono colour."""
    cfg = mtgs_config(width, height, max_steps)
    return cfg.replace(
        rasterize_mode="classic",
        predict_normals=False,
        loss=LossConfig(
            ssim_lambda=0.2,
            depth_lambda=0.0,
            ncc_lambda=0.0,
            use_normal_loss=False,
            two_d_gaussians=False,
            sharp_shape_reg_lambda=0.0,
            oob_lambda=0.0,
        ),
    )


DEFORM_ENABLE_STEP = 3000  # reference use_deformgs_after (deformable_node.py)


def mtgs_deformable_config(width: int = 960, height: int = 540,
                           max_steps: int = ITERS) -> TrainerConfig:
    """MTGS with deformable pedestrian nodes (`mtgs/config/MTGS_deformable.py`):
    the Trainer turns `scene.deform_enabled` on at DEFORM_ENABLE_STEP, an
    absolute step that max_steps does not scale, and freezes the
    canonical xyz from then on."""
    cfg = mtgs_config(width, height, max_steps)
    return cfg.replace(scene=dataclasses.replace(cfg.scene, deform_enabled=False),
                       deform_enable_step=DEFORM_ENABLE_STEP)


def wild_gaussians_config(width: int = 960, height: int = 540,
                          max_steps: int = ITERS) -> TrainerConfig:
    """The WildGaussians appearance baseline (`mtgs/config/WildGaussians.py`):
    the `mtgs` preset; the appearance MLP comes with the scene
    (`init_scene(..., wild_appearance=True)`,
    `build_scene_model(..., wild_appearance=True)`)."""
    return mtgs_config(width, height, max_steps)


def optimizer_table(max_steps: int = ITERS) -> OptimConfig:
    """The per-group optimizer table (`mtgs/config/MTGS.py:121-187`)."""
    return OptimConfig(groups=default_groups(max_steps))


METHODS = {
    "mtgs": mtgs_config,
    "3dgs": gs3d_config,
    "mtgs_deformable": mtgs_deformable_config,
    "wild_gaussians": wild_gaussians_config,
}


def method_config(name: str, **kwargs) -> TrainerConfig:
    """The preset of a method by name, with its factory's keyword
    arguments (width, height, max_steps)."""
    if name not in METHODS:
        raise KeyError(f"unknown method {name!r}; have {sorted(METHODS)}")
    return METHODS[name](**kwargs)
