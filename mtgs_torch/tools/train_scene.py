"""Train one road block end to end (the `ns-train mtgs` equivalent); port of
`mtgs_tpu/tools/train_scene.py`.

Counterpart of the reference's per-scene runner
(`mtgs/tools/batch_exp/run_single_road_block.py` + the nerfstudio train
loop in OpenDriveLab/MTGS): parse the road block, build the scene model
from its seed clouds, train, checkpoint, and evaluate the `val` split into
`eval_result.json`. Training runs on the card unless `--device` says
otherwise.

Usage:
    python -m mtgs_torch.tools.train_scene --data /path/road_block --out runs/x \\
        [--method mtgs] [--steps 30001] [--travels 0 1 2] [--eval-travels 3] \\
        [--device cpu]
    python -m mtgs_torch.tools.train_scene --data-config road_block.yaml --out runs/x

`--data-config` takes a RoadBlockConfig .yaml/.yml/.py (the reference's
data-config layer, `preprocess/roadblock_config.py`): its `scene_dir`
(data_root / road_block_name) is the road block unless `--data` is given
too. `--resume` restores the newest `step-*` checkpoint in --out (padded to
its node capacities first; a final checkpoint without optimizer state
restarts Adam).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mtgs_torch import resolve_device


def build_model_from_parsed(scene, method_cfg, sample_cfg, device="cuda"):
    """(SceneParams, SceneAux) on `device` from a ParsedScene's seeds and
    instances: a multicolour background from the seed cloud, a 100k
    skybox, and the rigid instances (pedestrians and bicycles dropped)
    stacked, their poses mapped onto the split's frame rows by token; a
    static instance takes its mean in-frame pose over its whole traversal."""
    from mtgs_torch.models.gaussians import (
        init_node_from_points, init_skybox_node, node_capacity, stack_nodes,
    )
    from mtgs_torch.models.scene_graph import InstanceAux, InstanceParams, init_scene

    dev = resolve_device(device)
    n_travels = len(scene.train_travel_ids)
    if scene.seed_xyz is None:
        raise ValueError("road block has no seed point cloud")
    bg = init_node_from_points(scene.seed_xyz, scene.seed_rgb, num_traversals=n_travels,
                               multi_feature_rest=True, device=dev)
    extent = float(np.abs(scene.seed_xyz).max())
    sky = init_skybox_node(num_points=100_000, radius=1000.0, scene_extent=extent,
                           num_traversals=n_travels, multi_feature_rest=True, device=dev)

    inst = None
    rigid = [i for i in scene.instances if i.class_name not in ("pedestrian", "bicycle")]
    if rigid:
        F = scene.num_frame_rows
        cap = max(node_capacity(max(len(i.points) for i in rigid), granule=1024), 1024)
        nodes, quats, trans, present, static, alive, num_alive, sizes = ([] for _ in range(8))
        for info in rigid:
            node, naux = init_node_from_points(info.points, info.colors, capacity=cap,
                                               device=dev)
            nodes.append(node)
            q = np.zeros((F, 4), np.float32)
            q[:, 0] = 1.0
            t = np.zeros((F, 3), np.float32)
            pr = np.zeros((F,), np.float32)
            # poses onto THIS split's frame rows by token: a positional
            # mapping breaks under eval_2hz / manual_split subsampling
            if info.frame_tokens and scene.frame_row_of_token:
                for f, tok in enumerate(info.frame_tokens):
                    row = scene.frame_row_of_token.get((info.travel_id, tok))
                    if row is not None:
                        q[row] = info.quats[f]
                        t[row] = info.trans[f]
                        pr[row] = float(info.in_frame_mask[f])
            else:  # positional fallback for records without tokens
                rows = np.where(scene.travel_of_frame
                                == scene.travel_index_of_id[info.travel_id])[0]
                m = min(len(rows), len(info.quats))
                q[rows[:m]] = info.quats[:m]
                t[rows[:m]] = info.trans[:m]
                pr[rows[:m]] = info.in_frame_mask[:m].astype(np.float32)
            if info.is_static and info.in_frame_mask.any():
                # single-pose mode (ref rigid_node.py:100-104): the mean
                # in-frame pose, visible across its WHOLE traversal
                mask = info.in_frame_mask
                qs = info.quats[mask]
                qs = qs * np.sign(np.sum(qs * qs[:1], axis=1, keepdims=True))
                mq = qs.mean(0)
                mq /= max(np.linalg.norm(mq), 1e-9)
                mt = info.trans[mask].mean(0)
                trav_rows = np.where(scene.travel_of_frame
                                     == scene.travel_index_of_id[info.travel_id])[0]
                q[trav_rows] = mq
                t[trav_rows] = mt
                pr[trav_rows] = 1.0
            quats.append(q)
            trans.append(t)
            present.append(pr)
            static.append(float(info.is_static))
            alive.append(naux.alive)
            num_alive.append(naux.num_alive)
            sizes.append(info.size[:3])
        on = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        params = InstanceParams(node=stack_nodes(nodes), quats=on(np.stack(quats)),
                                trans=on(np.stack(trans)))
        iaux = InstanceAux(
            alive=torch.stack(alive), num_alive=torch.stack(num_alive),
            present=on(np.stack(present)), is_static=on(static),
            frame_timestamps=on(scene.frame_timestamps),
            travel_of_frame=on(scene.travel_of_frame, torch.int32),
            sizes=on(np.stack(sizes)),
        )
        inst = (params, iaux)

    num_cams = max(r.cam_idx for r in scene.records) + 1
    return init_scene(bg, sky, inst, num_cameras=num_cams,
                      num_images=scene.num_frame_rows * 16, device=dev)


def _latest_checkpoint(run_dir: Path, step=None) -> Path:
    ckpts = sorted(run_dir.glob("step-*"))
    if not ckpts:
        raise FileNotFoundError(f"no step-* checkpoints under {run_dir}")
    return (run_dir / f"step-{step:09d}") if step is not None else ckpts[-1]


def eval_setup(run_dir, *, data=None, step=None, cameras=None, device="cuda"):
    """Reload a trained run for eval, rendering or the viewer — the
    reference's `eval_setup` (`mtgs/tools/render.py:222-259`: config,
    checkpoint and the re-applied camera-pose optimization; render with
    `apply_cam_opt=True` to reproduce the latter).

    Args:
        run_dir: directory written by `main` (run_config.json + checkpoints).
        data: override the dataset root recorded in run_config.json.
        step: checkpoint step (default: the newest `step-*` in run_dir).
        device: where the scene is rebuilt ("cuda" unless asked).

    Returns (params, aux, cfg, scene, run_cfg_dict).
    """
    from mtgs_torch.configs import method_config
    from mtgs_torch.data.dataset import SampleConfig
    from mtgs_torch.data.nuplan import parse_scene
    from mtgs_torch.train.checkpoint import (
        checkpoint_layout, load_checkpoint_partial, pad_scene_to_caps,
    )

    dev = resolve_device(device)
    run_dir = Path(run_dir)
    rc = json.loads((run_dir / "run_config.json").read_text())
    cfg = method_config(rc["method"], width=rc["width"], height=rc["height"],
                        max_steps=rc["steps"])
    parse_kw = {}
    cams = cameras if cameras is not None else rc.get("cameras")
    if cams is not None:
        parse_kw["cameras"] = tuple(cams)
    scene = parse_scene(data or rc["data"], split="train", train_travels=rc.get("travels"),
                        eval_travels=rc.get("eval_travels"), **parse_kw)
    params, aux = build_model_from_parsed(
        scene, cfg, SampleConfig(scale_factor=rc.get("scale", 0.5)), device=dev)
    path = _latest_checkpoint(run_dir, step)
    params, aux = pad_scene_to_caps(params, aux, checkpoint_layout(path)["caps"])
    restored = load_checkpoint_partial(path, {"params": params, "aux": aux})
    return restored["params"], restored["aux"], cfg, scene, rc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None, help="road block folder (or use --data-config)")
    ap.add_argument("--data-config", default=None,
                    help="RoadBlockConfig .yaml/.yml/.py (the reference's data-config layer, "
                         "nuplan_scripts/utils/config.py:38-108): supplies the road block "
                         "folder when --data is not given")
    ap.add_argument("--out", required=True)
    ap.add_argument("--method", default="mtgs")
    ap.add_argument("--steps", type=int, default=30001)
    ap.add_argument("--travels", type=int, nargs="*", default=None)
    ap.add_argument("--eval-travels", type=int, nargs="*", default=None)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--balanced-sampler", action="store_true")
    ap.add_argument("--save-every", type=int, default=0,
                    help="periodic checkpoint interval (0 = final only)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest step-* checkpoint in --out")
    ap.add_argument("--stage-scales", type=float, nargs="*", default=None,
                    help="multi-resolution ladder: equal step spans per scale, e.g. 0.25 0.5 1.0")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu only when asked for)")
    args = ap.parse_args(argv)
    if args.data_config:
        from mtgs_torch.preprocess.roadblock_config import load_road_block_config

        args.data = args.data or str(load_road_block_config(args.data_config).scene_dir)
    if not args.data:
        ap.error("--data or --data-config required")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    from mtgs_torch.configs import method_config, optimizer_table
    from mtgs_torch.data.dataset import SampleConfig
    from mtgs_torch.data.loader import (
        SampleCache, batch_from_sample, data_iterator, staged_iterator_factory,
    )
    from mtgs_torch.data.nuplan import parse_scene
    from mtgs_torch.eval.pipeline import evaluate_scene
    from mtgs_torch.train.checkpoint import (
        checkpoint_layout, load_checkpoint, pad_scene_to_caps, save_checkpoint,
        save_checkpoint_rotating,
    )
    from mtgs_torch.train.trainer import Trainer

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = method_config(args.method, width=args.width, height=args.height,
                        max_steps=args.steps)
    sample_cfg = SampleConfig(scale_factor=args.scale)

    print(f"[train_scene] parsing {args.data}", flush=True)
    scene = parse_scene(args.data, split="train", train_travels=args.travels,
                        eval_travels=args.eval_travels)
    params, aux = build_model_from_parsed(scene, cfg, sample_cfg, device=dev)

    resume_from = layout = None
    if args.resume and sorted(out.glob("step-*")):
        resume_from = _latest_checkpoint(out)
        layout = checkpoint_layout(resume_from)
        # a checkpoint taken after a capacity growth loads into a scene
        # padded to its capacities
        params, aux = pad_scene_to_caps(params, aux, layout["caps"])

    stages = factory = data = cache = None
    if args.stage_scales:
        span = args.steps // len(args.stage_scales)
        stages = [(k * span, s) for k, s in enumerate(args.stage_scales)]
        # the trainer installs factory(stages[0]) before the first step: no
        # full-resolution cache is prefetched to be discarded
        factory = staged_iterator_factory(scene, sample_cfg, balanced=args.balanced_sampler,
                                          device=dev)
    else:
        cache = SampleCache(scene.records, sample_cfg)
        data = data_iterator(scene, sample_cfg, balanced=args.balanced_sampler, cache=cache,
                             device=dev)
    trainer = Trainer(cfg, params, aux, data, optim_config=optimizer_table(args.steps),
                      data_factory=factory, resolution_stages=stages, device=dev)

    done_steps = 0
    if resume_from is not None:
        st = trainer.state
        template = {"params": st.params, "densify": st.densify, "step": st.step,
                    "aux": trainer.aux}
        if layout["has_optimizer"]:
            template["opt_state"] = st.adam
        restored = load_checkpoint(resume_from, template)
        # final (stripped) checkpoints carry no optimizer state: Adam restarts
        st.params, st.densify = restored["params"], restored["densify"]
        st.step, st.adam = restored["step"], restored.get("opt_state", st.adam)
        trainer.aux = restored["aux"]
        done_steps = int(restored["step"])
        print(f"[train_scene] resumed from {resume_from.name} (step {done_steps})", flush=True)

    t0 = time.time()

    def log(step, metrics):
        print(f"[{step:6d}] {time.time() - t0:7.1f}s " +
              " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())
                       if k in ("total_loss", "psnr", "gaussian_count")), flush=True)
        if args.save_every and step and step % args.save_every == 0:
            save_checkpoint_rotating(out, trainer.state, trainer.aux, step)

    trainer.train(max(args.steps - done_steps, 0), log_every=(args.save_every or 100),
                  callback=log)
    if cache is not None:
        cache.close()
    # the final checkpoint: optimizer state stripped (ref custom_trainer.py)
    save_checkpoint(out / f"step-{args.steps:09d}", trainer.state, trainer.aux,
                    keep_optimizer=False)
    # run metadata so eval_setup and the render tools reload this run on
    # their own (the reference's config.yml, `render.py:229`)
    (out / "run_config.json").write_text(json.dumps(dict(
        method=args.method, data=str(Path(args.data).absolute()), steps=args.steps,
        width=args.width, height=args.height, scale=args.scale, travels=args.travels,
        eval_travels=args.eval_travels,
    ), indent=2))

    # the full eval on the eval split
    eval_scene = parse_scene(args.data, split="val", train_travels=args.travels,
                             eval_travels=args.eval_travels, load_points=False)
    eval_cache = SampleCache(eval_scene.records, sample_cfg, strategy="on_demand")
    batches = (batch_from_sample(r, eval_cache.get(i), device=dev)
               for i, r in enumerate(eval_scene.records))
    result = evaluate_scene(trainer.state.params, trainer.aux, cfg, batches,
                            output_path=str(out / "eval_result.json"), device=dev)
    # this process's kernel launches, training and eval: what a farm's log shows
    from mtgs_torch.raster.cuda_build import LAUNCHES

    print(f"[train_scene] kernel launches {json.dumps(LAUNCHES)}", flush=True)
    print(json.dumps({k: round(v, 4) for k, v in result.items()}, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
