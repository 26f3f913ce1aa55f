"""Method presets; port of `mtgs_tpu/configs.py::mtgs_config` (render
fields only: densify, loss and optimizer settings come with training)."""

from __future__ import annotations

from mtgs_torch.models.scene_graph import SceneConfig
from mtgs_torch.train.control import ControlConfig
from mtgs_torch.train.trainer import TrainerConfig

ITERS = 30001


def mtgs_config(width: int = 960, height: int = 540, max_steps: int = ITERS) -> TrainerConfig:
    """The full MTGS method (`mtgs/config/MTGS.py:25-213`): antialiased,
    RGB+ED with predicted normals, SH degree 3 ramped over the first 13%
    of the run (step-valued fields scale by max_steps / 30001)."""
    s = max_steps / ITERS
    return TrainerConfig(
        width=width,
        height=height,
        max_steps=max_steps,
        rasterize_mode="antialiased",
        predict_normals=True,
        control=ControlConfig(sh_degree=3,
                              sh_degree_interval=max(int(round(1000 * s)), 1)),
        scene=SceneConfig(sh_degree=3, travel_mode="index"),
    )
