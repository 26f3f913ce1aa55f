"""Eval / render / viewer smoke on the card; port of
`mtgs_tpu/tools/onchip_smoke.py`.

Exercises the three serving paths beyond training on whatever device it
runs on (the card by default): short training on a small synthetic scene,
then

  1. `evaluate_scene`  -> finite metric set (the eval_result.json schema,
     ref `custom_pipeline.py:145-198`),
  2. `render_interpolated` -> 60 Hz-style mosaic frames from
     slerp-upsampled poses (ref `RenderInterpolated`,
     `mtgs/tools/render.py:439-552`), read back with the port's PNG
     decoder (`data/image_io.py::read_image`),
  3. `ViewerServer.render` -> one JPEG frame per output type (rgb / depth /
     accumulation) through the viewer's own request path, decoded by the
     port's JPEG decoder.

Exit 0 iff every stage produced finite output. One JSON line to stdout
(the JAX tool's keys; `backend` is the torch device's type).

Run (on the card):  python -m mtgs_torch.tools.onchip_smoke
Smoke (CPU):        --device cpu --width 96 --height 64 --n-bg 800 --steps 4
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from mtgs_torch import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--n-bg", type=int, default=30_000)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--max-isect", type=int, default=1 << 18)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from mtgs_torch.data.image_io import _decode_jpeg, read_image
    from mtgs_torch.data.nuplan import ImageRecord, ParsedScene
    from mtgs_torch.data.synthetic import (
        batch_iterator, build_scene_model, make_synthetic_scene,
    )
    from mtgs_torch.eval.pipeline import evaluate_scene
    from mtgs_torch.tools.render import render_interpolated
    from mtgs_torch.train import control as ctrl
    from mtgs_torch.train.trainer import Trainer, TrainerConfig
    from mtgs_torch.viewer.server import ViewerServer

    out_dir = Path(args.out or tempfile.mkdtemp(prefix="mtgs_smoke_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()

    scene = make_synthetic_scene(
        seed=0, width=args.width, height=args.height, n_travels=2,
        n_frames=3, n_bg=args.n_bg, n_instance=min(args.n_bg // 10, 2000),
        extent=30.0, n_seed=args.n_bg,
        gt_max_intersections=max(args.max_isect, 1 << 17), device=dev,
    )
    params, aux = build_scene_model(scene, with_instances=True, device=dev)
    cfg = TrainerConfig(
        width=args.width, height=args.height,
        max_intersections=args.max_isect,
        predict_normals=True,
        control=ctrl.ControlConfig(densify_from_iter=10**9),
    )
    trainer = Trainer(cfg, params, aux, batch_iterator(scene, device=dev), device=dev)
    trainer.train(args.steps)
    print(f"# trained {args.steps} steps in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # --- 1. full eval ----------------------------------------------------
    it = batch_iterator(scene, device=dev)
    batches = [next(it) for _ in range(4)]
    result = evaluate_scene(
        trainer.state.params, trainer.aux, trainer.cfg, batches,
        output_path=str(out_dir / "eval_result.json"), device=dev,
    )
    eval_keys = ("psnr", "ssim", "cc_psnr", "depth_RMSE", "fps")
    eval_ok = all(np.isfinite(result.get(k, np.nan)) for k in eval_keys)
    print(f"# eval: " + " ".join(f"{k}={result.get(k, float('nan')):.3f}"
                                 for k in eval_keys), file=sys.stderr)

    # --- 2. interpolated-trajectory mosaic -------------------------------
    # minimal ImageRecords over the synthetic cameras (the tool consumes
    # c2w/intrinsic/timestamp/frame_idx per camera name)
    recs = []
    for f in range(scene.n_frames):
        K = scene.K.copy()
        recs.append(ImageRecord(
            image_path="", intrinsic=K, distortion=np.zeros(5, np.float32),
            c2w=scene.c2ws[0, f], lidar2cam=np.eye(4, dtype=np.float32),
            lidar_path=None, travel_id=0, travel_index=0,
            frame_idx=scene.frame_row(0, f), frame_token=f"f{f}",
            cam_token=f"c{f}", cam_name="CAM_F0", cam_idx=0,
            timestamp=float(scene.timestamps[0, f]),
            raw_timestamp=f, width=scene.width, height=scene.height,
        ))
    pscene = ParsedScene(
        records=recs, train_travel_ids=[0], eval_travel_ids=[0],
        nearest_train_travel_of_eval={}, travel_index_of_id={0: 0},
        frame_timestamps=scene.timestamps.reshape(-1),
        travel_of_frame=np.repeat(np.arange(scene.n_travels, dtype=np.int32),
                                  scene.n_frames),
        num_frame_rows=scene.frame_rows,
    )
    frames = render_interpolated(
        trainer.state.params, trainer.aux, trainer.cfg, pscene, 0,
        out_dir / "interp", cameras=("CAM_F0",), target_hz=12.0,
        source_hz=2.0, make_video=False, device=dev,
    )
    interp_ok = len(frames) >= 4 and all(Path(p).exists() for p in frames)
    if interp_ok:
        arr = read_image(frames[0])
        interp_ok = arr.size > 0 and int(arr.max()) > 0
    print(f"# interp: {len(frames)} frames", file=sys.stderr)

    # --- 3. viewer render path -------------------------------------------
    srv = ViewerServer(trainer.state.params, trainer.aux, trainer.cfg,
                       travels=[0, 1], device=dev)
    viewer_ok = True
    for output in ("rgb", "depth", "accumulation"):
        jpg = srv.render({"px": "-8", "py": "0", "pz": "1.6",
                          "yaw": "0", "pitch": "0", "travel": "0",
                          "t": "0.5", "output": output})
        img = _decode_jpeg(jpg, f"viewer {output}")
        viewer_ok = viewer_ok and img.shape == (args.height, args.width, 3)
    print(f"# viewer: 3 outputs rendered", file=sys.stderr)

    ok = eval_ok and interp_ok and viewer_ok
    print(json.dumps(dict(
        metric="on-card eval/render/viewer smoke",
        value=float(result.get("psnr", float("nan"))),
        unit="eval psnr (dB)",
        vs_baseline=1.0 if ok else 0.0,
        eval_ok=bool(eval_ok), interp_ok=bool(interp_ok), viewer_ok=bool(viewer_ok),
        backend=dev.type,
        elapsed_s=round(time.perf_counter() - t0, 1),
    )))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
