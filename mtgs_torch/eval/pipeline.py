"""Full-evaluation pipeline and image export; port of
`mtgs_tpu/eval/pipeline.py`.

`evaluate_scene` renders every eval view, computes the metric set (with
`lpips` and `dinov2_sim` where their weight files exist), tags each metric
with its traversal (`trv{t}_*`) and returns nan-filtered means plus fps and
num_images — the `eval_result.json` schema of the JAX package.
`export_eval_images` writes the renders in the reference's layouts.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.core.camera import redistort_image
from mtgs_torch.data.image_io import write_jpeg
from mtgs_torch.eval.dinov2 import get_dinov2
from mtgs_torch.eval.lpips import get_lpips
from mtgs_torch.eval.metrics import image_metrics
from mtgs_torch.models.scene_graph import SceneAux, SceneParams
from mtgs_torch.train.trainer import Batch, TrainerConfig, render_view


@dataclass(frozen=True)
class EvalConfig:
    """Metric options. `lpips` and `dinov2` add those metrics when their
    weight files exist (`eval/lpips.py`, `eval/dinov2.py`); without one the
    metric is omitted."""

    color_corrected: bool = True
    lpips: bool = True
    dinov2: bool = True


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

    lpips_fn = get_lpips(device=dev) if eval_cfg.lpips else None
    dinov2_fn = get_dinov2(device=dev) if eval_cfg.dinov2 else None

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
        if lpips_fn is not None:
            mval = f32(batch.mask)
            row["lpips"] = lpips_fn(out["rgb_appearance"] * mval, f32(batch.image) * mval)
        if dinov2_fn is not None:
            dv = dinov2_fn(out["rgb_appearance"], batch.image, f32(batch.mask).squeeze())
            if dv is not None:
                row["dinov2_sim"] = dv
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


EXPORT_MODES = ("sequential", "sequential_with_gt", "nuplan")


def _to_u8(x: torch.Tensor) -> np.ndarray:
    """[0, 1] floats -> uint8: clipped, scaled by 255 and truncated."""
    return (torch.clamp(x, 0, 1) * 255).to(torch.uint8).cpu().numpy()


def export_eval_images(
    params: SceneParams,
    aux: SceneAux,
    cfg: TrainerConfig,
    eval_batches: Iterable[Batch],
    output_path,
    *,
    mode: str = "sequential",
    view_metas: Optional[List[Dict]] = None,
    step: int = 10**9,
    device="cuda",
) -> List[str]:
    """Render eval views to JPEG files in the reference's export layouts
    (`_save_images`, `custom_pipeline.py:91-143`):

      * ``sequential``          traversal_{t}/{cam}/{i}_rendered.jpg
      * ``sequential_with_gt``  + {i}_gt_processed.jpg (+ a symlink {i}_gt.jpg
                                to the raw ground truth when the meta
                                carries `raw_path`)
      * ``nuplan``              {log}/{cam}/{token}.jpg re-distorted to the
                                raw camera's geometry by `redistort_image`
                                (needs `K_raw`/`dist`/`K_und` in the meta)

    view_metas: per-batch dicts with optional keys travel_id, cam_name,
    view_idx (the file index, not the physical camera id), raw_path,
    rel_path, K_raw, dist, K_und (the render's intrinsics), raw_hw (the raw
    (height, width)); defaults come from the batch. Returns the written
    paths.
    """
    dev = resolve_device(device)
    if mode not in EXPORT_MODES:
        raise ValueError(f"unknown image_saving_mode {mode!r}")
    out_root = Path(output_path)
    written: List[str] = []
    for i, batch in enumerate(eval_batches):
        meta = (view_metas[i] if view_metas is not None else {}) or {}
        if mode == "nuplan":
            missing = [k for k in ("K_raw", "dist", "K_und") if k not in meta]
            if missing:
                raise ValueError(
                    f"nuplan export mode needs {missing} in view_metas[{i}] "
                    "to re-distort the render to raw camera geometry")
        out = render_view(params, aux, cfg, batch, step, training=False, device=dev)
        img = _to_u8(out["rgb_appearance"])
        travel = meta.get("travel_id", int(batch.travel_index))
        cam = meta.get("cam_name", f"cam{int(batch.cam_idx)}")
        idx = meta.get("view_idx", int(batch.image_idx))

        if mode == "nuplan":
            warped = redistort_image(
                torch.as_tensor(img, dtype=torch.float32, device=dev) / 255.0,
                meta["K_raw"], meta["dist"], meta["K_und"],
                tuple(meta["raw_hw"]) if "raw_hw" in meta else None)
            p = out_root / meta.get("rel_path", f"log/{cam}/{idx}.jpg")
            p.parent.mkdir(parents=True, exist_ok=True)
            written.append(str(write_jpeg(p, _to_u8(warped))))
            continue
        p = out_root / f"traversal_{travel}" / cam / f"{idx}_rendered.jpg"
        p.parent.mkdir(parents=True, exist_ok=True)
        written.append(str(write_jpeg(p, img)))
        if mode == "sequential_with_gt":
            gt = torch.as_tensor(batch.image, dtype=torch.float32, device=dev)
            written.append(str(write_jpeg(p.with_name(f"{idx}_gt_processed.jpg"), _to_u8(gt))))
            raw = meta.get("raw_path")
            if raw:
                link = p.with_name(f"{idx}_gt.jpg")
                if link.is_symlink() or link.exists():
                    os.remove(link)
                os.symlink(os.path.abspath(raw), link)
                written.append(str(link))
    return written
