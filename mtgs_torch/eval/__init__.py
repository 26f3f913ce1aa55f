"""Metric suite and the per-traversal evaluation pipeline."""

from mtgs_torch.eval.metrics import (
    masked_psnr,
    color_correct,
    depth_metrics,
    image_metrics,
)
from mtgs_torch.eval.pipeline import evaluate_scene, EvalConfig
