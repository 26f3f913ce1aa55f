"""Sustained training campaign: the full MTGS recipe end to end; port of
`mtgs_tpu/tools/campaign.py`.

At 960x540 with the `mtgs` method config on a road-block-scale synthetic
scene: growth from ~100k seeds through the host growth loop, opacity
resets, the SH ramp, the multi-resolution ladder, rigid instance and
skybox nodes, rotating checkpoints, a mid-run teardown and rebuild (a
fresh Trainer restored from disk into grown capacities through
`pad_scene_to_caps`), and a final `evaluate_scene` writing
`eval_result.json` with per-traversal seen/unseen metrics
(`run_single_road_block.py:63-94`, `run_base_benchmarking.py:111-183`).

Dataset protocol: T traversals x F frames; traversals 0..T-2 train on the
frames f % 4 != 2 and are evaluated on the held-out f % 4 == 2 frames
(seen split, the reference's `manual_split` interleave); the last
traversal is held out whole and evaluated with the "mean" multicolour
fallback (unseen split, `multi_color_gaussian_splatting.py:103-117`).

Run (on the card):
    python -m mtgs_torch.tools.campaign --out results/campaign
Smoke (CPU, about a minute):
    python -m mtgs_torch.tools.campaign --device cpu --out /tmp/campaign \\
        --steps 40 --save-every 10 --width 64 --height 48 --n-bg 600 \\
        --n-seed 300 --n-instance 60 --skybox-points 64 --n-travels 2 \\
        --n-frames 4 --extent 12 --max-isect 16384 --gt-max-isect 65536

Crash-tolerant: re-running with the same --out resumes from the latest
rotating checkpoint (capacities restored from resume_meta.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.configs import method_config, optimizer_table
from mtgs_torch.data.synthetic import (
    SyntheticScene, build_scene_model, make_batch, make_synthetic_scene,
)
from mtgs_torch.eval.pipeline import evaluate_scene
from mtgs_torch.tools.render import write_png
from mtgs_torch.train.checkpoint import (
    load_checkpoint, pad_scene_to_caps, save_checkpoint, save_checkpoint_rotating,
)
from mtgs_torch.train.optim import named_leaves
from mtgs_torch.train.trainer import Trainer, render_view


def _scene_cache_roundtrip(path: Path, build):
    """Cache the synthetic scene (the ground-truth renders) in an npz, so a
    rerun skips the build; the JAX package's layout (non-array fields as
    `_name`), so either package reads the other's cache."""
    if path.exists():
        z = np.load(path)
        return SyntheticScene(**{
            f.name: (z[f.name] if f.name in z.files else int(z[f"_{f.name}"]))
            for f in dataclasses.fields(SyntheticScene)
        })
    scene = build()
    payload = {}
    for f in dataclasses.fields(SyntheticScene):
        v = getattr(scene, f.name)
        if isinstance(v, np.ndarray):
            payload[f.name] = v
        else:
            payload[f"_{f.name}"] = np.asarray(v)
    np.savez_compressed(path, **payload)
    return scene


def _nan_report(trainer, metrics, log) -> int:
    """First-NaN diagnostics: every metric plus a per-leaf census of the
    parameters. Returns the number of non-finite parameter leaves (0: the
    parameters are intact, the step's gradient guard held)."""
    log("NaN DIAGNOSTIC — all step metrics:")
    for k in sorted(metrics):
        log(f"  {k} = {float(metrics[k]):.6g}")
    n_bad = 0
    for name, leaf in named_leaves(trainer.state.params):
        a = leaf.detach()
        finite = torch.isfinite(a)
        bad = int(a.numel() - finite.sum())
        if bad:
            n_bad += 1
            big = float(a[finite].abs().max()) if finite.any() else 0.0
            log(f"  param {name}: {bad}/{a.numel()} non-finite (|max finite|={big:.3g})")
    return n_bad


def _stages_for(steps: int):
    """Resolution ladder (ref `custom_datamanager.py:143-152`): coarse
    warm-up, then half, then full resolution."""
    return [(0, 0.25), (max(steps // 10, 1), 0.5), (max(3 * steps // 10, 2), 1.0)]


def splits(n_travels: int, n_frames: int):
    """(seen traversals, unseen traversals, train (t, f) pairs, eval (t, f)
    pairs) of the campaign's protocol."""
    seen = list(range(n_travels - 1))
    unseen = [n_travels - 1]
    train_pairs = [(t, f) for t in seen for f in range(n_frames) if f % 4 != 2]
    eval_pairs = [(t, f) for t in seen for f in range(n_frames) if f % 4 == 2]
    eval_pairs += [(t, f) for t in unseen for f in range(n_frames)]
    return seen, unseen, train_pairs, eval_pairs


def travel_modes_for(n_travels: int):
    """Eval travel modes: "index" for the seen traversals, "mean" for the
    unseen last one."""
    return {t: "mean" if t == n_travels - 1 else "index" for t in range(n_travels)}


def make_factory(scene, pairs, seed: int = 123, device="cuda"):
    """The ladder's data factory: scale -> a shuffled endless iterator over
    the views `pairs` at that scale (each stage's batches made once)."""
    dev = resolve_device(device)
    cache = {}

    def factory(scale):
        if scale not in cache:
            cache[scale] = [make_batch(scene, t, f, scale, dev) for t, f in pairs]
        batches = cache[scale]

        def it():
            rng = np.random.default_rng(seed)
            while True:
                for i in rng.permutation(len(batches)):
                    yield batches[i]

        return it()

    return factory


def node_caps(params):
    return dict(
        background=params.background.capacity,
        skybox=None if params.skybox is None else params.skybox.capacity,
        instances=None if params.instances is None
        else int(params.instances.node.means.shape[1]),
        deformables=None if params.deformables is None
        else int(params.deformables.node.means.shape[1]),
    )


def build_trainer(args, scene, train_pairs, *, caps=None, base_max_isect=None) -> Trainer:
    """The campaign's Trainer on `args.device`: the `mtgs` preset for
    args.steps with the fused path, the JAX campaign's growth settings
    (grow_granule, factor 2.0: fewer, bigger growth events), the ladder of
    `_stages_for`; the scene padded to `caps` (a resume's capacities)."""
    cfg = method_config("mtgs", width=args.width, height=args.height, max_steps=args.steps)
    cfg = cfg.replace(fused=True, max_intersections=base_max_isect or args.max_isect,
                      grow_granule=args.grow_granule, grow_factor=2.0)
    params, aux = build_scene_model(
        scene, with_instances=args.n_instance > 0, with_skybox=True,
        skybox_points=args.skybox_points, device=args.device,
    )
    if caps:
        params, aux = pad_scene_to_caps(params, aux, caps)
    return Trainer(
        cfg, params, aux, None, optim_config=optimizer_table(args.steps),
        data_factory=make_factory(scene, train_pairs, device=args.device),
        resolution_stages=_stages_for(args.steps), device=args.device,
    )


def save_leg(out: Path, trainer, step: int, seed_alive: int) -> None:
    """A rotating checkpoint (the newest 2 kept) and resume_meta.json."""
    save_checkpoint_rotating(out, trainer.state, trainer.aux, step, keep=2)
    (out / "resume_meta.json").write_text(json.dumps(dict(
        step=step,
        caps=node_caps(trainer.state.params),
        base_max_intersections=trainer._base_cfg.max_intersections,
        growth_events=trainer.growth_events,
        refine_overflow=trainer.refine_overflow,
        seed_alive=seed_alive,
    )))


def try_resume(out: Path, trainer) -> int:
    """Restore the latest rotating checkpoint into a freshly built (and
    capacity-padded) trainer. Returns the restored step (0: nothing)."""
    meta_p = out / "resume_meta.json"
    if not meta_p.exists():
        return 0
    meta = json.loads(meta_p.read_text())
    path = out / f"step-{meta['step']:09d}"
    if not path.exists():
        return 0
    st = trainer.state
    template = {"params": st.params, "densify": st.densify, "step": st.step,
                "aux": trainer.aux, "opt_state": st.adam}
    restored = load_checkpoint(path, template)
    st.params, st.densify = restored["params"], restored["densify"]
    st.step, st.adam = restored["step"], restored["opt_state"]
    trainer.aux = restored["aux"]
    trainer.growth_events = list(meta.get("growth_events", []))
    trainer.refine_overflow = int(meta.get("refine_overflow", 0))
    return int(meta["step"])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu only when asked for)")
    ap.add_argument("--steps", type=int, default=10001)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--n-bg", type=int, default=600_000)
    ap.add_argument("--n-seed", type=int, default=100_000)
    ap.add_argument("--n-instance", type=int, default=5000)
    ap.add_argument("--n-travels", type=int, default=3)
    ap.add_argument("--n-frames", type=int, default=8)
    ap.add_argument("--skybox-points", type=int, default=100_000)
    ap.add_argument("--max-isect", type=int, default=1 << 21)
    ap.add_argument("--gt-max-isect", type=int, default=6 << 20)
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--grow-granule", type=int, default=32768)
    ap.add_argument("--extent", type=float, default=60.0)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints in --out")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--paranoid", action="store_true",
                    help="log every loss component at each log step (divergence diagnosis)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def log(msg):
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, file=sys.stderr, flush=True)
        with open(out / "campaign.log", "a") as f:
            print(line, file=f)

    t0 = time.time()
    log(f"building synthetic road block: {args.n_bg} GT gaussians, "
        f"{args.n_travels}x{args.n_frames} views at {args.width}x{args.height} on {dev}")
    scene = _scene_cache_roundtrip(
        out / "scene_cache.npz",
        lambda: make_synthetic_scene(
            seed=0, width=args.width, height=args.height,
            n_travels=args.n_travels, n_frames=args.n_frames,
            n_bg=args.n_bg, n_instance=args.n_instance, extent=args.extent,
            n_seed=args.n_seed, ground_scale=0.18, color_noise=0.25,
            gt_max_intersections=args.gt_max_isect, device=dev,
        ))
    log(f"scene ready in {time.time() - t0:.0f}s")

    seen_travels, unseen_travels, train_pairs, eval_pairs = splits(args.n_travels,
                                                                   args.n_frames)
    log(f"{len(train_pairs)} train views, {len(eval_pairs)} eval views "
        f"(seen travels {seen_travels}, unseen {unseen_travels})")

    meta = {}
    if not args.fresh and (out / "resume_meta.json").exists():
        meta = json.loads((out / "resume_meta.json").read_text())
    trainer = build_trainer(args, scene, train_pairs, caps=meta.get("caps"),
                            base_max_isect=meta.get("base_max_intersections"))
    # the seed's live count: read before a resume restores a grown scene,
    # and carried across restarts in resume_meta.json
    seed_alive = int(meta.get("seed_alive", int(trainer.aux.background.num_alive)))
    done = 0 if args.fresh else try_resume(out, trainer)
    if done:
        log(f"resumed from step {done} (caps={node_caps(trainer.state.params)})")

    def cb(step, metrics):
        ls = trainer.loop_stats
        acct = ""
        if ls["steps"]:
            acct = (f" [disp={ls['dispatch_s']:.1f}s refine={ls['refine_s']:.1f}s "
                    f"sync={ls['sync_s']:.1f}s / {ls['steps']} steps]")
        log(f"step {step:6d}  loss={metrics.get('total_loss', 0):.4f} "
            f"psnr={metrics.get('psnr', 0):.2f} "
            f"gaussians={int(metrics.get('gaussian_count', 0))} "
            f"n_isect={int(metrics.get('n_intersections', 0))}" + acct)
        if args.paranoid:
            log("  " + " ".join(
                f"{k}={float(v):.4g}" for k, v in sorted(metrics.items())
                if k not in ("gaussian_count", "n_intersections")))
        if metrics.get("nonfinite_grad_step", 0.0) > 0:
            log(f"WARNING: non-finite gradient at step {step} — update "
                "skipped by the trainer's gradient guard")
        if not np.isfinite(metrics.get("total_loss", 0.0)):
            if _nan_report(trainer, metrics, log) > 0:
                raise SystemExit(3)   # params actually poisoned
            log("non-finite loss but parameters intact (gradient-skip guard held) "
                "— continuing")

    resume_at = (args.steps // 2 // args.save_every) * args.save_every
    resume_done = (out / "RESUME_DEMO_DONE").exists() or done > resume_at
    legs = []
    while done < args.steps:
        nxt = min(((done // args.save_every) + 1) * args.save_every, args.steps)
        t_leg = time.time()
        n_leg = nxt - done
        trainer.train(n_leg, log_every=args.log_every, callback=cb)
        done = int(trainer.state.step)
        dt = time.time() - t_leg
        legs.append(dict(to_step=done, seconds=round(dt, 1),
                         iters_per_s=round(n_leg / max(dt, 1e-9), 3),
                         loop_stats=dict(trainer.loop_stats)))
        save_leg(out, trainer, done, seed_alive)
        log(f"checkpoint at step {done} ({dt:.0f}s leg, "
            f"alive={int(trainer.aux.background.num_alive)}, "
            f"caps={node_caps(trainer.state.params)}, "
            f"overflow={trainer.refine_overflow})")
        if done == resume_at and not resume_done:
            # the mid-run resume demonstration: throw the trainer away and
            # rebuild it cold from disk, grown capacities and all
            log("tearing down trainer for mid-run resume demo")
            meta = json.loads((out / "resume_meta.json").read_text())
            del trainer
            trainer = build_trainer(args, scene, train_pairs, caps=meta["caps"],
                                    base_max_isect=meta["base_max_intersections"])
            r = try_resume(out, trainer)
            if r != done:
                raise RuntimeError(f"resumed at step {r}, expected {done}")
            (out / "RESUME_DEMO_DONE").write_text(str(done))
            resume_done = True
            log(f"rebuilt + resumed at step {r}")

    train_wall = time.time() - t0
    log(f"training complete: {done} steps, {train_wall:.0f}s total wall")

    # final checkpoint with the optimizer state stripped (ref custom_trainer.py)
    save_checkpoint(out / f"final-step-{done:09d}", trainer.state, trainer.aux,
                    keep_optimizer=False)

    # full eval at the final resolution
    travel_modes = travel_modes_for(args.n_travels)
    eval_batches = [make_batch(scene, t, f, 1.0, dev) for t, f in eval_pairs]
    result = evaluate_scene(
        trainer.state.params, trainer.aux, trainer.cfg, eval_batches,
        travel_modes=travel_modes, output_path=str(out / "eval_result.json"), device=dev,
    )
    log("eval: " + json.dumps({k: round(v, 4) for k, v in result.items()
                               if not k.startswith("trv")}))

    # preview renders (render | ground truth) for visual inspection
    prev = out / "preview"
    prev.mkdir(exist_ok=True)
    for (t, f), b in ((eval_pairs[0], eval_batches[0]), (eval_pairs[-1], eval_batches[-1])):
        o = render_view(trainer.state.params, trainer.aux, trainer.cfg, b, 10**9,
                        training=False, travel_mode=travel_modes[t], device=dev)
        pair = np.concatenate([o["rgb_appearance"].cpu().numpy(), scene.images[t, f]], axis=1)
        write_png(prev / f"trv{t}_f{f}.png", (np.clip(pair, 0, 1) * 255).astype(np.uint8))

    alive = int(trainer.aux.background.num_alive)
    seen_psnr = float(np.mean([result[f"trv{t}_psnr"] for t in seen_travels
                               if f"trv{t}_psnr" in result]))
    summary = dict(
        steps=done,
        wall_s=round(train_wall, 1),
        seed_alive=seed_alive,
        final_alive=alive,
        growth_ratio=round(alive / max(seed_alive, 1), 2),
        caps=node_caps(trainer.state.params),
        growth_events=trainer.growth_events,
        refine_overflow=trainer.refine_overflow,
        max_intersections=trainer.cfg.max_intersections,
        legs=legs,
        resume_demo=resume_done,
        psnr_seen=round(seen_psnr, 3),
        psnr_overall=round(result.get("psnr", float("nan")), 3),
        eval=result,
    )
    (out / "campaign_summary.json").write_text(json.dumps(summary, indent=2))
    ok = (seen_psnr >= 27.0 and alive >= 5 * seed_alive
          and trainer.refine_overflow == 0 and resume_done)
    print(json.dumps(dict(
        metric=f"{done}-step MTGS campaign (seen-split PSNR)",
        value=round(seen_psnr, 3), unit="dB",
        vs_baseline=round(seen_psnr / 27.0, 3),
        growth_ratio=summary["growth_ratio"], ok=ok,
    )))
    # a finished run (eval written) exits 0, so a crash stays distinguishable;
    # the quality gate lives in the JSON line and campaign_summary.json
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
