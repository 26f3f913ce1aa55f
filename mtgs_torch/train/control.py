"""Render-path part of `mtgs_tpu/train/control.py`: the SH degree ramp."""

from __future__ import annotations

from dataclasses import dataclass

import torch

_SH_DEGREE_OF_BASIS = (0,) + (1,) * 3 + (2,) * 5 + (3,) * 7


@dataclass(frozen=True)
class ControlConfig:
    """The densify-control fields the render path reads."""

    sh_degree: int = 3
    sh_degree_interval: int = 1000


def sh_degree_mask(step: int, cfg: ControlConfig, device="cpu") -> torch.Tensor:
    """[16] 0/1 mask enabling SH bases up to min(step // interval, sh_degree)."""
    n = min(int(step) // cfg.sh_degree_interval, cfg.sh_degree)
    degs = torch.tensor(_SH_DEGREE_OF_BASIS, device=device)
    return (degs <= n).to(torch.float32)
