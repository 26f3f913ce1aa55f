"""Full-evaluation pipeline; port of `mtgs_tpu/eval/pipeline.py::evaluate_scene`.

Renders every eval view, computes the metric set, tags each metric with
its traversal (`trv{t}_*`) and returns nan-filtered means plus fps and
num_images — the `eval_result.json` schema of the JAX package.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.eval.metrics import image_metrics
from mtgs_torch.models.scene_graph import SceneAux, SceneParams
from mtgs_torch.train.trainer import Batch, TrainerConfig, render_view


@dataclass(frozen=True)
class EvalConfig:
    """Metric options. LPIPS and DINOv2 need pretrained weights the repo
    does not carry and are not ported yet."""

    color_corrected: bool = True


def evaluate_scene(
    params: SceneParams,
    aux: SceneAux,
    cfg: TrainerConfig,
    eval_batches: Iterable[Batch],
    *,
    eval_cfg: EvalConfig = EvalConfig(),
    step: int = 10**9,
    travel_modes: Optional[Dict[int, str]] = None,
    output_path: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    """Render + score all eval views; aggregate overall and per traversal.

    travel_modes: optional map travel_index -> scene travel_mode for the
    unseen-traversal fallback ("index"/"mean"/"null").
    """
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    rows: List[Dict[str, float]] = []
    fps = []
    seen_modes: set = set()
    for batch in eval_batches:
        mode = "index"
        if travel_modes is not None:
            mode = travel_modes.get(int(batch.travel_index), "index")
        t0 = time.perf_counter()
        out = render_view(params, aux, cfg, batch, step, training=False,
                          travel_mode=mode, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        # a mode's first render includes one-time set-up (the kernel build
        # and load): keep it out of fps, as the JAX pipeline keeps compiles out
        if mode in seen_modes:
            fps.append(1.0 / max(dt, 1e-9))
        seen_modes.add(mode)

        gt_depth = None if batch.lidar_depth is None else f32(batch.lidar_depth)
        m = image_metrics(
            out["rgb"], out["rgb_appearance"], f32(batch.image), f32(batch.mask),
            pred_depth=out["depth"] if gt_depth is not None else None,
            gt_depth=gt_depth, color_corrected=eval_cfg.color_corrected,
        )
        row = {k: float(v) for k, v in m.items()}
        trv = int(batch.travel_index)
        rows.append({**row, **{f"trv{trv}_{k}": v for k, v in row.items()}})

    keys = sorted({k for r in rows for k in r})
    result: Dict[str, float] = {}
    for k in keys:
        vals = np.array([r[k] for r in rows if k in r and np.isfinite(r[k])])
        result[k] = float(vals.mean()) if len(vals) else float("nan")
    result["fps"] = float(np.mean(fps)) if fps else float("nan")
    result["num_images"] = len(rows)
    if output_path is not None:
        with open(output_path, "w") as f:
            json.dump(result, f, indent=2)
    return result
