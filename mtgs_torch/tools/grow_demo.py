"""Densification growth demo: 100k seeds -> >= 1M alive gaussians; port of
`mtgs_tpu/tools/grow_demo.py`.

A road-block-scale synthetic scene seeded well below the reference's final
size must GROW past its seed capacity through the Trainer's host-side
capacity growth (`train/trainer.py::Trainer._plan_growth` / `refine`:
params, Adam moments and densify statistics re-padded together; the
intersection buffer grown at the refine cadence, past the fused gate when
it must) with zero dropped split/dup candidates (overflow == 0), mirroring
the reference's free tensor reallocation
(`vanilla_gaussian_splatting.py:635-699` in OpenDriveLab/MTGS).

The densify criteria are driven hard (tiny grad threshold) so the
population multiplies every refine pass; the point is the MACHINERY
(growth, optimizer-state continuity, buffer growth), not the schedule.
Success, as JAX's: no overflow, the capacity and the alive population both
at least twice the seed's, and the background's Adam moments and densify
statistics at the grown capacity.

Run (on the card):  python -m mtgs_torch.tools.grow_demo
Smoke (CPU):        --device cpu --n-bg 2000 --target 20000 --width 128 --height 128
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from mtgs_torch import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--n-bg", type=int, default=100_000)
    ap.add_argument("--target", type=int, default=1_000_000)
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--refine-every", type=int, default=50)
    ap.add_argument("--max-isect", type=int, default=1 << 21)
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
    # the ground truth at make_synthetic_scene's default 1 << 17 pairs, as
    # JAX's tool renders it (seed 0's six views at 960x540 fit; where a view
    # would not, the port raises and JAX's truncates)
    scene = make_synthetic_scene(
        seed=0, width=args.width, height=args.height, n_travels=2,
        n_frames=3, n_bg=args.n_bg, n_instance=0, extent=60.0,
        n_seed=args.n_bg, device=dev,
    )
    params, aux = build_scene_model(scene, with_instances=False, device=dev)
    print(f"# scene+model in {time.perf_counter() - t0:.1f}s; "
          f"seed={int(aux.background.num_alive)} "
          f"capacity={params.background.capacity}", file=sys.stderr)
    cap0 = params.background.capacity

    cfg = TrainerConfig(
        width=args.width, height=args.height,
        max_intersections=args.max_isect,
        rasterize_mode="antialiased",
        predict_normals=False,
        control=ctrl.ControlConfig(
            densify_from_iter=10,
            refine_every=args.refine_every,
            stop_split_at=10**9,
            reset_alpha_every=10**9,
            densify_grad_thresh=1e-9,   # duplicate everything visible
            densify_size_thresh=1e9,    # dup (not split): population x2
        ),
        loss=loss_lib.LossConfig(ssim_lambda=0.2, depth_lambda=0.0,
                                 ncc_lambda=0.0),
    )
    trainer = Trainer(cfg, params, aux, batch_iterator(scene, device=dev), device=dev)

    t_start = time.perf_counter()
    steps_done = 0
    while steps_done < args.max_steps:
        span = min(args.refine_every, args.max_steps - steps_done)
        n_refines = len(trainer.refine_events)
        trainer.train(span)
        steps_done += span
        for e in trainer.refine_events[n_refines:]:
            print(f"# refine {e['step']}: n_split={e['n_split']} n_dup={e['n_dup']} "
                  f"n_cull={e['n_cull']}", file=sys.stderr)
        alive = int(trainer.aux.background.num_alive)
        cap = trainer.state.params.background.capacity
        print(f"# step {steps_done}: alive={alive} capacity={cap} "
              f"overflow={trainer.refine_overflow} "
              f"max_isect={trainer.cfg.max_intersections}", file=sys.stderr)
        if alive >= args.target:
            break

    alive = int(trainer.aux.background.num_alive)
    capf = trainer.state.params.background.capacity
    ok_shapes = (
        trainer.state.adam.mu.background.means.shape
        == trainer.state.params.background.means.shape
        and trainer.state.densify["background"].xys_grad_norm.shape[0] == capf
    )
    elapsed = time.perf_counter() - t_start
    growth_events = trainer.growth_events
    print(f"# growth events: {growth_events}", file=sys.stderr)
    result = {
        "metric": f"densify growth demo ({args.n_bg} seeds -> target "
                  f"{args.target} alive)",
        "value": alive,
        "unit": "alive gaussians",
        "vs_baseline": round(alive / args.target, 3),
        "seed_capacity": cap0,
        "final_capacity": capf,
        "overflow": trainer.refine_overflow,
        "n_growth_events": len(growth_events),
        "optimizer_state_consistent": bool(ok_shapes),
        "steps": steps_done,
        "elapsed_s": round(elapsed, 1),
    }
    print(json.dumps(result))
    # Success = the growth MACHINERY demonstrably works: population and
    # capacity both grew well past the seed allocation, nothing was ever
    # dropped, and the optimizer state followed every reallocation. The
    # absolute `--target` stays in the JSON as the aspirational scale
    # (reaching it depends on the scene and on its ground truth: duplication
    # is visibility-gated).
    ok = (trainer.refine_overflow == 0 and ok_shapes
          and capf >= 2 * cap0 and alive >= 2 * args.n_bg)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
