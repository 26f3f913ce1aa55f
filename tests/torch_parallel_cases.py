"""The sharded cases of `tests/test_torch_parallel*.py`, as run by each rank.

Rank functions for `mtgs_torch.parallel.mesh.launch` (one gloo world per
test module, ranks on the CPU) and the single-rank runs they are held
against. This module imports torch, numpy and the port only: each rank
imports it by name, and JAX stays out of the rank processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
from pathlib import Path

import numpy as np
import torch

from mtgs_torch.core.camera import camera_to_gsplat_viewmat
from mtgs_torch.data.synthetic import batch_iterator, build_scene_model, make_synthetic_scene
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.parallel.data_parallel import DPTrainer, make_dp_train_step, shard_batch
from mtgs_torch.parallel.mesh import make_mesh
from mtgs_torch.parallel.mesh2d import make_2d_train_step
from mtgs_torch.parallel.collectives import pmean
from mtgs_torch.raster import RasterizeConfig, rasterize
from mtgs_torch.raster.dist_fused import dist_shard_plan
from mtgs_torch.raster.layered_dist import layered_shard_plan
from mtgs_torch.train import control as ctrl
from mtgs_torch.train.optim import OptimConfig, default_groups, named_leaves
from mtgs_torch.train.trainer import (
    Batch, Trainer, TrainerConfig, _total_capacity, init_train_state, loss_and_grads, train_step,
)

rasterize_mod = importlib.import_module("mtgs_torch.raster.rasterize")
dist_mod = importlib.import_module("mtgs_torch.raster.dist_fused")
layered_mod = importlib.import_module("mtgs_torch.raster.layered_dist")

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "parallel_ref.npz"
RASTER = dict(width=160, height=128, tile_size=32, max_intersections=512 * 8 * 2,
              render_mode="RGB+ED", rasterize_mode="antialiased")
RASTER_K = [[120.0, 0, 80], [0, 120.0, 64], [0, 0, 1]]
PLAN_ENV = dict(band=dict(MTGS_DIST="0"), dist=dict(MTGS_DIST="1", MTGS_BLK_SLACK="2.0"),
                layered=dict(MTGS_LAYERED="1"), classic={})
PLAN_VARS = ("MTGS_DIST", "MTGS_BLK_SLACK", "MTGS_LAYERED", "MTGS_ROW_SLACK")
GRAD_NAMES = ("means", "quats", "scales", "opacities", "colors", "tap", "sink")
BATCH_FIELDS = ("image", "mask", "c2w", "K", "cam_idx", "image_idx", "travel_index",
                "frame_idx", "timestamp", "lidar_depth", "pseudo_depth")
# the pipeline functions of rasterize(mesh=...): which one ran is recorded
PIPELINES = dict(layered=(layered_mod, "rasterize_layered"),
                 dist=(dist_mod, "rasterize_fused_dist"),
                 band=(rasterize_mod, "_rasterize_fused_sharded"),
                 classic=(rasterize_mod, "_blend_sharded"))


@contextlib.contextmanager
def threads(n: int):
    """torch's intra-op threads set to n inside the block: the ranks and the
    test process share the CPU, and oversubscribed threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@contextlib.contextmanager
def plan_env(env: dict):
    """The plan variables set to `env` alone inside the block."""
    saved = {k: os.environ.pop(k, None) for k in PLAN_VARS}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in PLAN_VARS:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


@contextlib.contextmanager
def pipelines_run(ran: list):
    """Appends to `ran` the name of each sharded pipeline that runs."""
    saved = {name: getattr(mod, fn) for name, (mod, fn) in PIPELINES.items()}

    def rec(name, f):
        def call(*a, **kw):
            ran.append(name)
            return f(*a, **kw)
        return call

    for name, (mod, fn) in PIPELINES.items():
        setattr(mod, fn, rec(name, saved[name]))
    try:
        yield
    finally:
        for name, (mod, fn) in PIPELINES.items():
            setattr(mod, fn, saved[name])


def raster_scene(n: int = 600, seed: int = 0, height: int = 128):
    """test_parallel.py's `_tiny_scene` (numpy-seeded: the JAX fixture's
    inputs) and the loss target."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(-9, -4, (n, 1))], 1)
    quats = rng.normal(size=(n, 4))
    scales = rng.uniform(0.05, 0.3, (n, 3))
    opac = rng.uniform(0.2, 0.9, n)
    colors = rng.uniform(0, 1, (n, 3))
    target = np.random.default_rng(1).uniform(0, 1, (height, RASTER["width"], 4))
    return [a.astype(np.float32) for a in (means, quats, scales, opac, colors)], \
        target.astype(np.float32)


def raster_run(plan: str, mesh, *, n: int = 600, seed: int = 0, height: int = 128,
               max_intersections: int = RASTER["max_intersections"], env=None,
               render_mode: str = "RGB+ED", loss: str = "target") -> dict:
    """One render and its gradients: loss mean|render - target| + 0.1
    mean(alpha) (or mean(render^2) + mean(alpha)) with respect to the five
    inputs, the means2d tap and the absgrad sink; the pipeline that ran."""
    arrays, target = raster_scene(n, seed, height)
    params = [torch.tensor(a, requires_grad=True) for a in arrays]
    tap = torch.zeros((n, 2), requires_grad=True)
    sink = torch.zeros((n, 2), requires_grad=True)
    cfg = RasterizeConfig(**{**RASTER, "height": height, "max_intersections": max_intersections,
                             "render_mode": render_mode, "fused": plan != "classic"})
    ran = []
    with plan_env(PLAN_ENV[plan] if env is None else env), pipelines_run(ran):
        r, a, info = rasterize(*params, camera_to_gsplat_viewmat(torch.eye(4)),
                               torch.tensor(RASTER_K), cfg, tap2d=tap, absgrad_sink=sink,
                               mesh=mesh)
    if loss == "target":
        value = (r - torch.tensor(target)).abs().mean() + 0.1 * a.mean()
    else:
        value = (r ** 2).mean() + a.mean()
    grads = torch.autograd.grad(value, params + [tap, sink])
    return dict(render=r.detach().numpy(), alpha=a.detach().numpy(), ran=ran,
                n_intersections=int(info["n_intersections"]), loss=float(value.detach()),
                radii=info["radii"].numpy(), depths=info["depths"].detach().numpy(),
                **{f"grad_{k}": g.numpy() for k, g in zip(GRAD_NAMES, grads)})


# ----------------------------------------------------------- steps

def unflat(fx, prefix: str):
    """The nested state dict stored under `prefix.` in the fixture."""
    out = {}
    for key in fx.files:
        if key.startswith(prefix + "."):
            node = out
            parts = key[len(prefix) + 1:].split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = fx[key]
    return out


def fixture_scene(fx, prefix: str):
    """The port's scene and the two batches of a fixture's step records."""
    sd = unflat(fx, f"{prefix}_scene")
    params, aux = scene_from_state_dict(sd["params"], sd["aux"], device="cpu")
    batches = [Batch(**{f: torch.as_tensor(fx[f"{prefix}_batch{i}.{f}"]) for f in BATCH_FIELDS})
               for i in range(2)]
    return params, aux, batches


def step_config(prefix: str) -> TrainerConfig:
    """The port's counterpart of a fixture's step config."""
    no_refine = ctrl.ControlConfig(densify_from_iter=10**9)
    if prefix == "dp":
        return TrainerConfig(width=32, height=32, max_intersections=1 << 12, max_steps=100,
                             predict_normals=False, control=no_refine)
    return TrainerConfig(width=64, height=64, tile_size=32, max_intersections=2048,
                         max_steps=100, predict_normals=True, control=no_refine)


def stack(batches) -> Batch:
    return Batch(**{f: None if getattr(batches[0], f) is None else
                    torch.stack([torch.as_tensor(getattr(b, f)) for b in batches])
                    for f in BATCH_FIELDS})


def optim_config() -> OptimConfig:
    return OptimConfig(groups=default_groups(100))


def state_leaves(state) -> dict:
    out = {f"params.{k}": v.detach().numpy().copy() for k, v in named_leaves(state.params)}
    for kind, d in state.densify.items():
        for f in dataclasses.fields(d):
            out[f"densify.{kind}.{f.name}"] = getattr(d, f.name).numpy().copy()
    return out


def step_single(prefix: str, views) -> dict:
    """Single-rank references of a fixture's step config: the gradients of
    each batch in `views`, and one `train_step` on views[0]."""
    fx = np.load(FIXTURE)
    params, aux, batches = fixture_scene(fx, prefix)
    cfg = step_config(prefix)
    out = {}
    for v in views:
        _, _, _, sink, grads = loss_and_grads(params, aux, cfg, batches[v], 0, device="cpu")
        out[f"grads{v}"] = {k: g.numpy() for k, g in grads.items()}
        out[f"sink{v}"] = sink.numpy()
    state = init_train_state(params)
    metrics = train_step(state, aux, cfg, batches[views[0]], optim_config(), device="cpu")
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["state"] = state_leaves(state)
    return out


def step_ranked(prefix: str, mesh, views, kind: str) -> dict:
    """One data-parallel ("dp") or 2D ("2d") step of a fixture's config on
    the views `views` (one per rank of the data axis), and the data-mean
    gradients of loss_and_grads, on this rank."""
    fx = np.load(FIXTURE)
    params, aux, batches = fixture_scene(fx, prefix)
    cfg = step_config(prefix)
    data_group = mesh.group("data")
    batch = shard_batch(stack([batches[v] for v in views]), mesh)
    kw = {} if kind == "dp" else dict(mesh=mesh, mesh_axis="tile", inside_shard_map=True)
    ran = []
    with pipelines_run(ran):
        _, _, _, sink, grads = loss_and_grads(params, aux, cfg, batch, 0, device="cpu", **kw)
    keys = list(grads)
    red = pmean([grads[k] for k in keys] + [sink], data_group)
    state = init_train_state(params)
    make = make_dp_train_step if kind == "dp" else make_2d_train_step
    metrics = make(cfg, optim_config(), mesh, device="cpu")(
        state, aux, stack([batches[v] for v in views]))
    return dict(grads={k: g.numpy() for k, g in zip(keys, red)}, sink=red[-1].numpy(),
                metrics={k: float(v) for k, v in metrics.items()}, state=state_leaves(state),
                ran=ran, n_gauss=_total_capacity(params))


def dp_trainer_grows(mesh, world: int) -> dict:
    """DPTrainer through refines that grow the background's capacity (JAX
    `test_dp_trainer_grows_capacity`), `world` views a step."""
    scn = make_synthetic_scene(seed=0, width=32, height=32, n_travels=1, n_frames=2,
                               n_bg=260, n_instance=0, device="cpu")
    params, aux = build_scene_model(scn, with_instances=False, device="cpu")
    cap0 = params.background.capacity
    cfg = TrainerConfig(
        width=32, height=32, max_intersections=1 << 12, max_steps=100,
        predict_normals=False, grow_granule=1024,
        control=ctrl.ControlConfig(
            densify_from_iter=1, refine_every=2, stop_split_at=100, reset_alpha_every=1000,
            sh_degree_interval=10, densify_grad_thresh=1e-9, densify_size_thresh=1e9))

    def stacked():
        it = batch_iterator(scn, device="cpu")
        while True:
            yield stack([next(it) for _ in range(world)])

    trainer = DPTrainer(cfg, params, aux, stacked(), mesh, device="cpu")
    hist = trainer.train(12)
    mu = dict(named_leaves(trainer.state.adam.mu))
    return dict(cap0=cap0, cap=trainer.state.params.background.capacity,
                alive=int(trainer.aux.background.num_alive),
                refine_overflow=trainer.refine_overflow,
                refines=len(trainer.refine_events),
                mu_shape=tuple(mu["background.means"].shape),
                means_shape=tuple(trainer.state.params.background.means.shape),
                history=[{k: float(v) for k, v in h.items()} for h in hist],
                state=state_leaves(trainer.state))


def trainer_scene():
    """The 64x64 synthetic scene of JAX `test_trainer_tile_mesh_matches_unsharded`."""
    scene = make_synthetic_scene(seed=0, width=64, height=64, n_travels=1, n_frames=2,
                                 n_bg=220, n_instance=0, device="cpu")
    params, aux = build_scene_model(scene, with_instances=False, device="cpu")
    return scene, params, aux


TRAINER_CFG = dict(width=64, height=64, tile_size=32, max_steps=100, predict_normals=True)


def trainer_mesh(mesh) -> dict:
    """loss_and_grads under a 2-rank tile mesh, and Trainer(mesh=...) through
    two intersection-buffer growths (isect_grow_frac 0.01: every refine
    grows it), with the sharded pipeline of every step recorded."""
    scene, params, aux = trainer_scene()
    cfg = TrainerConfig(max_intersections=2048,
                        control=ctrl.ControlConfig(densify_from_iter=10**9), **TRAINER_CFG)
    batch = next(batch_iterator(scene, seed=5, device="cpu"))
    ran = []
    with pipelines_run(ran):
        total, _, _, sink, grads = loss_and_grads(params, aux, cfg, batch, 1, device="cpu",
                                                  mesh=mesh)
    out = dict(total=float(total), sink=sink.numpy(), ran=ran,
               grads={k: g.numpy() for k, g in grads.items()})

    scene, params, aux = trainer_scene()
    grow_cfg = TrainerConfig(
        max_intersections=2048, isect_grow_frac=0.01,
        control=ctrl.ControlConfig(densify_from_iter=1, refine_every=2, stop_split_at=100,
                                   reset_alpha_every=1000), **TRAINER_CFG)
    tr = Trainer(grow_cfg, params, aux, batch_iterator(scene, seed=5, device="cpu"),
                 device="cpu", mesh=mesh)
    steps = []
    for _ in range(5):
        ran = []
        with pipelines_run(ran):
            h = tr.train(1)
        steps.append(dict(ran=ran, max_intersections=tr.cfg.max_intersections,
                          **{k: float(v) for k, v in h[0].items()}))
    out.update(steps=steps, growth=tr.growth_events)
    return out


def trainer_single() -> dict:
    """The unsharded reference of `trainer_mesh`'s gradients."""
    scene, params, aux = trainer_scene()
    cfg = TrainerConfig(max_intersections=2048,
                        control=ctrl.ControlConfig(densify_from_iter=10**9), **TRAINER_CFG)
    batch = next(batch_iterator(scene, seed=5, device="cpu"))
    total, _, _, sink, grads = loss_and_grads(params, aux, cfg, batch, 1, device="cpu")
    return dict(total=float(total), sink=sink.numpy(),
                grads={k: g.numpy() for k, g in grads.items()})


def overflow_cases(mesh, world: int) -> dict:
    """Starved exchange blocks of the ownership plan (MTGS_BLK_SLACK 0.25)
    and starved row blocks of the layered plan (MTGS_ROW_SLACK 0.4): the
    render and gradients finite, the capacity signal past the capacity."""
    out = {}
    env = dict(MTGS_DIST="1", MTGS_BLK_SLACK="0.25")
    r = raster_run("dist", mesh, n=560, seed=3, max_intersections=512 * 8, env=env,
                   loss="squares")
    with plan_env(env):
        plan = dist_shard_plan(RasterizeConfig(**{**RASTER, "max_intersections": 512 * 8}),
                               world, 560)
    out["dist"] = dict(r, I_blk=plan.I_blk, I_s=plan.I_s)
    env = dict(MTGS_LAYERED="1", MTGS_ROW_SLACK="0.4")
    r = raster_run("layered", mesh, n=2048, seed=3, env=env, loss="squares")
    with plan_env(env):
        plan = layered_shard_plan(RasterizeConfig(**RASTER), world, 2048)
    out["layered"] = dict(r, N_blk=plan.N_blk, n_local=plan.n_local)
    return out


# ------------------------------------------------------------ worlds

def world2(rank: int, world: int, dev) -> dict:
    """Every case of tests/test_torch_parallel.py on one rank of a 2-rank world."""
    torch.set_num_threads(2)
    out = dict(tf32=(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
    data = make_mesh([world], ("data",))
    tile = make_mesh([world], ("tile",))
    out["raster"] = {p: raster_run(p, data) for p in PLAN_ENV}
    out["dp_same"] = step_ranked("dp", data, [0, 0], "dp")
    out["dp_distinct"] = step_ranked("dp", data, [0, 1], "dp")
    out["dp_trainer"] = dp_trainer_grows(data, world)
    out["trainer_mesh"] = trainer_mesh(tile)
    out["overflow"] = overflow_cases(data, world)
    return out


def world4(rank: int, world: int, dev) -> dict:
    """Every case of tests/test_torch_parallel_2d.py on one rank of a
    4-rank world: a (2 data, 2 tile) mesh, and 4 bands over 3 tile rows."""
    torch.set_num_threads(1)
    out = {}
    mesh2d = make_mesh([2, 2], ("data", "tile"))
    with plan_env(dict(MTGS_DIST="1", MTGS_BLK_SLACK="2.0")):
        out["mesh2d"] = step_ranked("mesh2d", mesh2d, [0, 1], "2d")
    out["dp"] = step_ranked("mesh2d", mesh2d, [0, 1], "dp")
    flat = make_mesh([world], ("data",))
    out["pad_band"] = {p: raster_run(p, flat, height=96) for p in ("band", "dist")}
    return out


def ranks_equal(results: list, key_path) -> bool:
    """Whether every rank's result at key_path (a tuple of keys) is the same
    bits (dicts of arrays compared leaf by leaf)."""
    def get(r):
        for k in key_path:
            r = r[k]
        return r

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        return a == b

    first = get(results[0])
    return all(same(first, get(r)) for r in results[1:])


def raster_image(fx, plan: str, what: str) -> np.ndarray:
    """JAX's render or alpha of a plan from the fixture (kept there as the
    difference from the band plan's: `make_parallel_fixture.compact`)."""
    base = fx[f"raster_band_{what}"]
    return base if plan == "band" else base + fx[f"raster_{plan}_{what}_delta"]


def max_scaled(got, want) -> float:
    if np.size(want) == 0:
        return 0.0
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    return err / scale if scale > 0 else err


def leaf_errors(got: dict, want: dict) -> dict:
    """Each gradient leaf's max error over its largest |value|, that scale
    taken as at least 1e-3 of the largest leaf's: a leaf of rounding noise
    (the quaternions of near-isotropic splats, ~1e-9) is held absolutely."""
    top = max(float(np.abs(w).max()) for w in want.values() if np.size(w))
    out = {}
    for k, w in want.items():
        if np.size(w):
            scale = max(float(np.abs(w).max()), 1e-3 * top)
            out[k] = float(np.abs(np.asarray(got[k]) - w).max()) / scale
    return out
