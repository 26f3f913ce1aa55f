"""Full-train-step throughput benchmark (one card); port of
`mtgs_tpu/tools/bench_train.py`.

The rasterizer alone is not what a user trains; this tool measures the
COMPLETE MTGS training iteration — scene-graph gather (multicolor
background + skybox + rigid instance), normals as extra color channels,
rasterize forward, photometric/SSIM/depth/NCC/normal/reg losses, full
backward, per-group Adam update, densify-statistics accumulation — the
per-step work of the reference
(`mtgs/scene_model/mtgs_scene_graph.py:710-981` forward+losses,
`custom_trainer.py:23` optimizer step, `vanilla_gaussian_splatting.py:448`
stats accumulation in OpenDriveLab/MTGS).

Scene: the synthetic multi-traversal fixture at flagship scale (defaults
~1M padded gaussians, 960x540, antialiased RGB+ED). The ground truth is
rendered with a buffer scaled to the image (`gt_capacity`): the port raises
where a ground-truth render would truncate. The default runs the classic
rasterizer path (kernels 1 and 3-7), `--fused` the fused one (kernels 1-4).

Run (on the card):  python -m mtgs_torch.tools.bench_train [--fused]
Smoke (CPU tests):  --device cpu --n-bg 400 --width 64 --height 64 --iters 2

Prints setup and timing lines to stderr and ONE summary JSON line to
stdout: iterations per second over `--iters` steps after one first step,
on the host clock ending in a synchronize.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mtgs_torch import resolve_device

# gsplat-based full-image 3DGS trainers run ~3 iters/s at 960x540 on
# A100-class GPUs: an estimate carried from the JAX tool (BASELINE.md:
# parity-defined), not a measurement
BASELINE_ITERS_PER_S = 3.0


def gt_capacity(width: int, height: int) -> int:
    """The ground-truth renders' intersection buffer: the campaign's 6 << 20
    at 960x540 scaled to the image, at least 1 << 17 (the default)."""
    return max(1 << 17, (6 << 20) * width * height // (960 * 540))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--n-bg", type=int, default=780_000)
    ap.add_argument("--n-instance", type=int, default=20_000)
    ap.add_argument("--skybox", action="store_true", default=True)
    ap.add_argument("--no-skybox", dest="skybox", action="store_false")
    ap.add_argument("--max-isect", type=int, default=3 << 20)
    ap.add_argument("--skybox-points", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from mtgs_torch.data.synthetic import (
        batch_iterator, build_scene_model, make_synthetic_scene,
    )
    from mtgs_torch.train import control as ctrl
    from mtgs_torch.train import losses as loss_lib
    from mtgs_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    scene = make_synthetic_scene(
        seed=0, width=args.width, height=args.height,
        n_travels=2, n_frames=3,
        n_bg=args.n_bg, n_instance=args.n_instance,
        extent=60.0, n_seed=args.n_bg,
        gt_max_intersections=gt_capacity(args.width, args.height), device=dev,
    )
    print(f"# scene built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    params, aux = build_scene_model(
        scene, with_instances=True, with_skybox=args.skybox,
        skybox_points=args.skybox_points, device=dev,
    )
    print(f"# model init in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    cfg = TrainerConfig(
        width=args.width, height=args.height,
        max_intersections=args.max_isect,
        rasterize_mode="antialiased",
        fused=args.fused,
        predict_normals=True,
        control=ctrl.ControlConfig(),
        loss=loss_lib.LossConfig(
            ssim_lambda=0.2, depth_lambda=0.5, ncc_lambda=0.1,
            normal_lambda=0.1, use_normal_loss=True, use_normal_tv_loss=True,
        ),
    )
    trainer = Trainer(cfg, params, aux, batch_iterator(scene, device=dev), device=dev)

    it = trainer.data
    batches = [next(it) for _ in range(4)]

    t0 = time.perf_counter()
    metrics = trainer.step(batches[0])
    sync(dev)
    print(f"# first step in {time.perf_counter() - t0:.1f}s; "
          f"n_isect={int(metrics['n_intersections'])} "
          f"gaussians={int(metrics['gaussian_count'])}", file=sys.stderr)

    iters = args.iters
    t0 = time.perf_counter()
    for i in range(iters):
        metrics = trainer.step(batches[i % len(batches)])
    sync(dev)
    dt = (time.perf_counter() - t0) / iters
    iters_per_s = 1.0 / dt
    print(f"# train step: {dt * 1e3:.2f} ms  ({iters_per_s:.2f} iters/s, "
          f"psnr {float(metrics['psnr']):.2f})", file=sys.stderr)

    print(json.dumps({
        "metric": "full MTGS train iters/s (scene graph + losses + adam, "
                  f"{args.width}x{args.height})",
        "value": round(iters_per_s, 3),
        "unit": "iters/s",
        "vs_baseline": round(iters_per_s / BASELINE_ITERS_PER_S, 3),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "fused": args.fused,
    }))


if __name__ == "__main__":
    main()
