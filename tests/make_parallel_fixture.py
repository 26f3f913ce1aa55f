"""Write tests/fixtures/parallel_ref.npz: the JAX package's sharded
functions on seeded inputs, for `tests/test_torch_parallel.py`.

JAX's sharded paths take minutes to compile on a CPU (the 8-device
virtual mesh, Pallas in interpret mode), too long for tier-1, so their
results are kept here and the port's sharded paths are held against them.
Everything runs on the 8-device virtual CPU mesh that `tests/conftest.py`
sets up:

* `raster_<plan>_*`: `rasterize(mesh=make_mesh([8]))` on the 600-gaussian
  scene of `tests/test_parallel.py` (`raster_scene`, numpy-seeded) at
  160x128, tile 32, antialiased RGB+ED, I = 512 * 8 * 2, the fused Pallas
  path in interpret mode, under the band plan (MTGS_DIST=0), the ownership
  plan (MTGS_DIST=1, MTGS_BLK_SLACK=2.0) and the layered plan
  (MTGS_LAYERED=1): the render, alpha, the gradients of
  mean|render - target| + 0.1 mean(alpha) with respect to means, quats,
  scales, opacities, colours, the means2d tap and the absgrad sink, and
  n_intersections. `raster_classic_*`: the render and alpha of the classic
  path's blend-only sharding (fused=False). The renders and alphas of the
  plans past the band plan are stored as differences from the band plan's
  (`compact`).
* `dp_*`: `make_dp_train_step` over a 2-device "data" mesh on two views of
  a 32x32 synthetic scene (200 gaussians; the test_parallel.py config, on
  the fused Pallas path in interpret mode: JAX's XLA classic backward
  rounds the geometry gradients past 1e-2 of the fused path's here):
  the scene's state dict (`dp_scene.*`), the two batches (`dp_batch.*`),
  the metrics, the densify statistics and the data-mean gradients
  (`loss_and_grads` under shard_map, pmean).
* `mesh2d_*`: `make_2d_train_step` over a (2 data, 4 tile) mesh on two
  views of a 64x64 scene (220 gaussians, fused Pallas in interpret mode,
  predicted normals, MTGS_DIST=1, MTGS_BLK_SLACK=2.0), the same records and
  the parameters after the step.

Run from the repository root (about 10 minutes on a CPU):
    python tests/make_parallel_fixture.py [OUT.npz]
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import mtgs_tpu  # noqa: E402,F401  (sets JAX's f32 matmul precision)

OUT = ROOT / "tests" / "fixtures" / "parallel_ref.npz"

RASTER = dict(width=160, height=128, tile_size=32, max_intersections=512 * 8 * 2,
              render_mode="RGB+ED", rasterize_mode="antialiased")
RASTER_K = [[120.0, 0, 80], [0, 120.0, 64], [0, 0, 1]]
PLANS = dict(band=dict(MTGS_DIST="0"), dist=dict(MTGS_DIST="1", MTGS_BLK_SLACK="2.0"),
             layered=dict(MTGS_LAYERED="1"))
PLAN_VARS = ("MTGS_DIST", "MTGS_BLK_SLACK", "MTGS_LAYERED")
DP = dict(width=32, height=32, n_bg=200, max_intersections=1 << 12)
MESH2D = dict(width=64, height=64, n_bg=220, max_intersections=2048)
BATCH_FIELDS = ("image", "mask", "c2w", "K", "cam_idx", "image_idx", "travel_index",
                "frame_idx", "timestamp", "lidar_depth", "pseudo_depth")


def raster_scene(n: int = 600, seed: int = 0):
    """test_parallel.py's `_tiny_scene` as numpy arrays (means, quats,
    scales, opacities, colours) and the loss target."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(-9, -4, (n, 1))], 1)
    quats = rng.normal(size=(n, 4))
    scales = rng.uniform(0.05, 0.3, (n, 3))
    opac = rng.uniform(0.2, 0.9, n)
    colors = rng.uniform(0, 1, (n, 3))
    target = np.random.default_rng(1).uniform(0, 1, (RASTER["height"], RASTER["width"], 4))
    return [a.astype(np.float32) for a in (means, quats, scales, opac, colors)], \
        target.astype(np.float32)


def flat(tree, prefix: str) -> dict:
    """A flax state dict as {prefix.dotted.path: numpy array}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif node is not None:
            out[path] = np.asarray(node)

    walk(flax.serialization.to_state_dict(tree), prefix)
    return out


def set_plan(env: dict) -> None:
    for k in PLAN_VARS:
        os.environ.pop(k, None)
    os.environ.update(env)


def raster_records() -> dict:
    from mtgs_tpu.core.camera import camera_to_gsplat_viewmat
    from mtgs_tpu.parallel.mesh import make_mesh
    from mtgs_tpu.raster import RasterizeConfig, rasterize

    arrays, target = raster_scene()
    params = tuple(jnp.asarray(a) for a in arrays)
    n = arrays[0].shape[0]
    viewmat = camera_to_gsplat_viewmat(jnp.eye(4))
    K = jnp.asarray(RASTER_K, jnp.float32)
    mesh = make_mesh([8], ("data",))
    out = {}
    for plan, env in [*PLANS.items(), ("classic", {})]:
        set_plan(env)
        cfg = RasterizeConfig(backend="pallas", interpret=True, fused=plan != "classic",
                              **RASTER)

        def loss_fn(p, tap, sink):
            m, q, s, o, c = p
            render, alpha, info = rasterize(m, q, s, o, c, viewmat, K, cfg, tap2d=tap,
                                            absgrad_sink=sink, mesh=mesh)
            loss = jnp.abs(render - target).mean() + 0.1 * alpha.mean()
            return loss, (render, alpha, info["n_intersections"])

        zeros = jnp.zeros((n, 2), jnp.float32)
        if plan == "classic":
            _, (render, alpha, n_isect) = jax.jit(loss_fn)(params, zeros, zeros)
            grads = None
        else:
            (_, (render, alpha, n_isect)), (g, g_tap, g_sink) = jax.jit(
                jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True))(
                    params, zeros, zeros)
            grads = dict(zip(("means", "quats", "scales", "opacities", "colors"), g),
                         tap=g_tap, sink=g_sink)
        out[f"raster_{plan}_render"] = np.asarray(render)
        out[f"raster_{plan}_alpha"] = np.asarray(alpha)
        out[f"raster_{plan}_n_intersections"] = np.asarray(n_isect)
        for k, v in (grads or {}).items():
            out[f"raster_{plan}_grad_{k}"] = np.asarray(v)
        print(f"raster {plan}: n_intersections {int(n_isect)}", flush=True)
    set_plan({})
    return out


def step_records(prefix: str, size: dict, cfg_kw: dict, mesh_shape, batch_seed: int) -> dict:
    """One data-parallel (1-D) or 2D step on two views, and the data-mean
    gradients, with the scene and batches they ran on."""
    from mtgs_tpu.data.synthetic import batch_iterator, build_scene_model, make_synthetic_scene
    from mtgs_tpu.parallel.data_parallel import make_dp_train_step, shard_batch
    from mtgs_tpu.parallel.mesh import make_mesh
    from mtgs_tpu.parallel.mesh2d import make_2d_train_step
    from mtgs_tpu.train import control as ctrl
    from mtgs_tpu.train import optim as optim_lib
    from mtgs_tpu.train.trainer import TrainerConfig, TrainState, loss_and_grads

    scene = make_synthetic_scene(seed=0, width=size["width"], height=size["height"],
                                 n_travels=1, n_frames=2, n_bg=size["n_bg"], n_instance=0,
                                 backend="xla")
    params, aux = build_scene_model(scene, with_instances=False)
    print(f"{prefix}: scene built", flush=True)
    cfg = TrainerConfig(width=size["width"], height=size["height"],
                        max_intersections=size["max_intersections"], max_steps=100,
                        control=ctrl.ControlConfig(densify_from_iter=10**9), **cfg_kw)
    it = batch_iterator(scene, seed=batch_seed)
    batches = [next(it) for _ in range(2)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *batches)
    optimizer = optim_lib.build_optimizer(
        params, optim_lib.OptimConfig(groups=optim_lib.default_groups(100)))
    state = TrainState(params=jax.tree.map(jnp.array, params),
                       opt_state=optimizer.init(params),
                       densify={"background": ctrl.DensifyState.zeros(
                           params.background.capacity)},
                       step=jnp.zeros((), jnp.int32), key=jax.random.key(0))
    devs = jax.devices()
    if len(mesh_shape) == 1:
        mesh = make_mesh(list(mesh_shape), ("data",), devices=devs[:mesh_shape[0]])
        step = make_dp_train_step(cfg, optimizer, mesh)
        grad_kw, axes = {}, ("data",)
    else:
        mesh = make_mesh(list(mesh_shape), ("data", "tile"), devices=devs[:8])
        step = make_2d_train_step(cfg, optimizer, mesh)
        grad_kw, axes = dict(mesh=mesh, mesh_axis="tile", inside_shard_map=True), \
            ("data", "tile")
    t0 = time.perf_counter()
    new_state, metrics = step(state, aux, shard_batch(stacked, mesh))
    print(f"{prefix}: step in {time.perf_counter() - t0:.0f} s", flush=True)

    def grads_fn(p, aux_, batch_):
        batch_ = jax.tree.map(lambda x: x[0], batch_)
        total, _, _, sink_grad, grads = loss_and_grads(
            p, aux_, cfg, batch_, jnp.asarray(0, jnp.int32), **grad_kw)
        return jax.lax.pmean(grads, axes), jax.lax.pmean(sink_grad, axes)

    grads, sink = jax.jit(jax.shard_map(grads_fn, mesh=mesh, in_specs=(P(), P(), P("data")),
                                        out_specs=(P(), P()), check_vma=False))(
        params, aux, shard_batch(stacked, mesh))
    out = {}
    out.update(flat(params, f"{prefix}_scene.params"))
    out.update(flat(aux, f"{prefix}_scene.aux"))
    for i, b in enumerate(batches):
        for f in BATCH_FIELDS:
            out[f"{prefix}_batch{i}.{f}"] = np.asarray(getattr(b, f))
    for k, v in metrics.items():
        out[f"{prefix}_metric.{k}"] = np.asarray(v)
    if prefix != "dp":  # the 2D step's parameters are compared after the update
        out.update(flat(new_state.params, f"{prefix}_new"))
    out.update(flat(new_state.densify, f"{prefix}_densify"))
    out.update(flat(grads, f"{prefix}_grad"))
    out[f"{prefix}_grad_sink"] = np.asarray(sink)
    print(f"{prefix}: total_loss {float(metrics['total_loss']):.6f}, psnr "
          f"{float(metrics['psnr']):.4f}", flush=True)
    return out


def compact(out: dict) -> dict:
    """The renders and alphas of the ownership, layered and classic plans
    kept as their differences from the band plan's (mostly exact zeros):
    the fixture stays small. `raster_image(fx, plan, what)` in
    tests/torch_parallel_cases.py adds them back."""
    for plan in ("dist", "layered", "classic"):
        for what in ("render", "alpha"):
            out[f"raster_{plan}_{what}_delta"] = (out.pop(f"raster_{plan}_{what}")
                                                  - out[f"raster_band_{what}"])
    return out


def make_fixture() -> dict:
    out = raster_records()
    out.update(step_records("dp", DP, dict(backend="pallas", fused=True, interpret=True,
                                           predict_normals=False), (2,), 0))
    set_plan(dict(MTGS_DIST="1", MTGS_BLK_SLACK="2.0"))
    out.update(step_records("mesh2d", MESH2D, dict(
        backend="pallas", fused=True, interpret=True, predict_normals=True, tile_size=32),
        (2, 4), 9))
    set_plan({})
    return compact(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = Path(argv[0]) if argv else OUT
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **make_fixture())
    print(f"wrote {path} ({path.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
