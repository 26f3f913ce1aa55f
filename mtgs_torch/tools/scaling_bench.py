"""Tile-sharded rasterization scaling harness; port of
`mtgs_tpu/tools/scaling_bench.py`.

Measures the forward + backward wall time of the fully sharded fused
pipeline (`rasterize(mesh=..., shard_axis="tile")`, the band plan: each
rank's spans, depth sort, `expand_fused`, pair sort and blend at I / n)
across world sizes, and reports rays/s and the scaling efficiency
t(1) / (n * t(n)). A world of n ranks is n processes
(`parallel/mesh.py::launch`); world 1 runs unsharded in this process, as
JAX's runs with no mesh. A world is skipped where the buffer does not
split (`max_isect % (n * 512)`).

Where the ranks run:
  * at least n cards: NCCL, rank k on cuda:k;
  * fewer cards: gloo, every rank on cuda:0. The ranks then time-slice one
    card, so the rows measure overhead, not scaling (the JSON's note says
    so, as JAX's says "virtual-cpu mesh");
  * `--cpu`: gloo ranks on the CPU (JAX's virtual CPU mesh: algorithmic
    scaling only).

`--cost` replaces JAX's XLA cost model (torch has none to read): each rank
traces one step with `utils/observability.trace` and reports its summed
CUDA kernel time (the contention-free figure when ranks share one card),
NCCL's collective kernels apart (they hold the wait for the other ranks).
It needs a card. Every world reports the pairs of its fullest band, from
the timed step's own `n_intersections`; a world whose fullest band (or, at
world 1, image) passed its slots was rendered truncated, is flagged in the
JSON's `truncated`, and makes the tool exit 1. JAX's `--interpret` has no
counterpart: on the CPU the kernels' plain versions run.

Run:  python -m mtgs_torch.tools.scaling_bench [--devices 1 2 4 8]
      [--n-gauss 200000] [--width 960] [--height 540] [--cost] [--cpu]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from mtgs_torch import resolve_device

RANK_TIMEOUT = 600.0  # seconds a world of ranks may take, start-up included


def make_scene(n: int, seed: int = 0):
    """bench.py's driving-scene layout at configurable scale: (means,
    quats, scales, opacities, colors) as float32 numpy arrays, the JAX
    tool's draws."""
    rng = np.random.default_rng(seed)
    n_ground, n_struct = n // 2, n // 3
    n_far = n - n_ground - n_struct
    gx = rng.uniform(-60, 60, n_ground)
    gy = rng.uniform(-20, 20, n_ground)
    ground = np.stack([gx, gy, np.zeros_like(gx)], -1)
    struct = np.stack(
        [rng.uniform(-60, 60, n_struct), rng.uniform(-25, 25, n_struct),
         rng.uniform(0, 12, n_struct)], -1)
    theta = rng.uniform(0, 2 * np.pi, n_far)
    phi = rng.uniform(np.pi / 4, np.pi / 2, n_far)
    far = 400.0 * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
         np.cos(phi)], -1)
    means = np.concatenate([ground, struct, far]).astype(np.float32)
    scales = np.concatenate([
        rng.lognormal(-2.3, 0.4, (n_ground, 3)),
        rng.lognormal(-2.0, 0.5, (n_struct, 3)),
        rng.lognormal(0.5, 0.4, (n_far, 3)),
    ]).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, quats, scales, opac, colors


def camera(width: int, height: int):
    """The JAX tool's camera: (c2w [4, 4], K [3, 3]) as numpy float32."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = [0, -1, 0]
    c2w[:3, 1] = [0, 0, 1]
    c2w[:3, 2] = [-1, 0, 0]
    c2w[:3, 3] = [-55.0, 0.0, 1.6]
    K = np.asarray([[800.0, 0, width / 2], [0, 800.0, height / 2], [0, 0, 1.0]], np.float32)
    return c2w, K


def raster_config(a: dict):
    from mtgs_torch.raster import RasterizeConfig

    return RasterizeConfig(
        width=a["width"], height=a["height"], max_intersections=a["max_isect"],
        rasterize_mode="antialiased", render_mode="RGB+ED", fused=True,
    )


def kernel_ms(trace_path: str):
    """The summed durations of the CUDA kernels in a Chrome trace of
    `observability.trace`, in ms: (compute kernels, NCCL's collective
    kernels). A collective kernel runs until every rank has joined it, so
    its time holds the wait for the others."""
    with gzip.open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    compute = collective = 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            if "nccl" in e.get("name", "").lower():
                collective += e["dur"]
            else:
                compute += e["dur"]
    return compute / 1000.0, collective / 1000.0


def bench_rank(rank: int, world: int, dev, a: dict) -> dict:
    """One rank's part (the whole of world 1): the JAX tool's step (loss
    |render - 0|.mean() + 0.1 alpha.mean(), gradients, a 1e-30 update and a
    1e-5 nudge of one coordinate by the step counter) once as warm-up, then
    `iters` steps timed ending in a synchronize; with `cost`, one step traced
    instead. Returns ms a step (or kernel ms), the last step's
    n_intersections as `rasterize` reports it (world 1: the image's pairs;
    sharded: the fullest band's pairs times the world) and the kernel
    launches this rank counted."""
    from mtgs_torch.core.camera import camera_to_gsplat_viewmat
    from mtgs_torch.parallel.mesh import make_mesh
    from mtgs_torch.raster import cuda_build, rasterize
    from mtgs_torch.tools.bench_train import sync
    from mtgs_torch.utils import observability

    if dev.type == "cpu" and world > 1:  # the ranks share the CPU
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cfg = raster_config(a)
    mesh = make_mesh((world,), ("tile",)) if world > 1 else None
    p = [torch.as_tensor(x, device=dev) for x in make_scene(a["n_gauss"])]
    c2w, K = camera(a["width"], a["height"])
    viewmat = camera_to_gsplat_viewmat(torch.as_tensor(c2w, device=dev))
    K = torch.as_tensor(K, device=dev)
    target = torch.zeros((a["height"], a["width"], 4), device=dev)

    def step(p, t):
        leaves = [x.detach().requires_grad_(True) for x in p]
        r, al, info = rasterize(*leaves, viewmat, K, cfg, mesh=mesh, shard_axis="tile")
        loss = (r - target).abs().mean() + 0.1 * al.mean() + 0.0 * t
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            newp = [x - 1e-30 * g for x, g in zip(leaves, grads)]
            newp[0][0, 0] += 1e-5 * t
        return newp, t + 1.0, info["n_intersections"]

    before = dict(cuda_build.LAUNCHES)
    t = torch.ones((), device=dev)
    p, t, _ = step(p, t)
    sync(dev)
    out = dict(rank=rank)
    if a["cost"]:
        logdir = tempfile.mkdtemp(prefix=f"mtgs_scaling_{world}_{rank}_")
        with observability.trace(logdir) as tr:
            p, t, n_isect = step(p, t)
        out["kernel_ms"], out["collective_ms"] = kernel_ms(tr.path)
        os.remove(tr.path)
        os.rmdir(logdir)
    else:
        t0 = time.perf_counter()
        for _ in range(a["iters"]):
            p, t, n_isect = step(p, t)
        sync(dev)
        out["ms"] = (time.perf_counter() - t0) / a["iters"] * 1e3
    out["n_intersections"] = int(n_isect)
    out["launches"] = {k: v - before[k] for k, v in cuda_build.LAUNCHES.items()
                       if v != before[k]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="world sizes (default: 1, 2, 4, 8 up to the cards present, or "
                         "up to the CPU's cores with --cpu)")
    ap.add_argument("--n-gauss", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--max-isect", type=int, default=1 << 19)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cost", action="store_true",
                    help="report each rank's summed CUDA kernel time over one traced step "
                         "(NCCL's collectives apart) instead of wall "
                         "time (needs a card)")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.cost and args.cpu:
        raise ValueError("--cost reads CUDA kernel times: it needs a card, not --cpu")
    dev = resolve_device("cpu" if args.cpu else "cuda")

    from mtgs_torch.parallel.mesh import launch

    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    limit = n_cards if dev.type == "cuda" else (os.cpu_count() or 1)
    counts = args.devices or sorted({n for n in (1, 2, 4, 8) if n <= limit})
    a = dict(n_gauss=args.n_gauss, width=args.width, height=args.height,
             max_isect=args.max_isect, iters=args.iters, cost=args.cost)

    rows, worlds, sliced = [], {}, False
    for nd in counts:
        if args.max_isect % (nd * 512):
            print(f"# skip n={nd}: capacity not divisible", file=sys.stderr)
            continue
        if nd == 1:
            ranks, how = [bench_rank(0, 1, dev, a)], "in process"
        else:
            if dev.type == "cpu":
                backend, device = "gloo", "cpu"
            elif nd <= n_cards:
                backend, device = "nccl", "cuda:rank"
            else:
                backend, device, sliced = "gloo", "cuda:0", True
            ranks = launch(bench_rank, nd, backend=backend, device=device,
                           timeout=RANK_TIMEOUT, args=(a,))
            how = f"{backend} on {device}"
        # rasterize's own count: above max_isect a band (or the image) was truncated
        n_isect = max(r["n_intersections"] for r in ranks)
        worlds[nd] = dict(how=how, ranks=ranks, fullest=n_isect // nd,
                          truncated=n_isect > args.max_isect)
        if args.cost:
            ms = [r["kernel_ms"] for r in ranks]
            rows.append((nd, max(ms), n_isect // nd))
            print(f"# n_dev={nd} ({how}): kernel ms per rank {[round(m, 4) for m in ms]}, "
                  f"fullest band {n_isect // nd} pairs", file=sys.stderr)
        else:
            dt = max(r["ms"] for r in ranks) / 1e3
            rows.append((nd, dt))
            rays = args.width * args.height / dt
            print(f"# n_dev={nd} ({how}): {dt * 1e3:.2f} ms  "
                  f"({rays / 1e6:.2f} Mrays/s)", file=sys.stderr)

    if dev.type == "cpu":
        note = "gloo ranks on the CPU: algorithmic scaling only"
    elif sliced:
        note = "ranks time-sliced on one card: no scaling figure"
    else:
        note = "one card a rank (NCCL)" if max(worlds, default=1) > 1 else "one card"
    per_rank = lambda key: {str(n): [r[key] for r in w["ranks"]] for n, w in worlds.items()}
    per_world = lambda key: {str(n): w[key] for n, w in worlds.items()}
    truncated = [n for n, w in worlds.items() if w["truncated"]]
    if args.cost:
        k1 = {n: k for n, k, _ in rows}.get(1)
        q1 = {n: q for n, _, q in rows}.get(1)
        eff_k = {n: round(k1 / (n * k), 3) for n, k, _ in rows if k1 and n > 1}
        eff_q = {n: round(q1 / (n * q), 3) for n, _, q in rows if q1 and n > 1}
        best = rows[-1]
        print(json.dumps({
            "metric": f"tile-sharded fwd+bwd per-rank CUDA kernel time "
                      f"({args.n_gauss} gaussians, {args.width}x{args.height})",
            "value": round(best[1], 4),
            "unit": f"kernel ms/rank (the fullest) @ {best[0]} ranks",
            "vs_baseline": eff_k.get(best[0], 1.0),
            "per_rank_kernel_ms": per_rank("kernel_ms"),
            "per_rank_collective_ms": per_rank("collective_ms"),
            "fullest_band_pairs": per_world("fullest"),
            "truncated": per_world("truncated"),
            "scaling_efficiency_kernel_ms": eff_k,
            "scaling_efficiency_pairs": eff_q,
            "launches": per_rank("launches"),
            "note": f"{note}; one traced step's compute kernel time a rank (NCCL's kernels "
                    f"apart) is free of the other ranks' contention",
        }))
    else:
        t1 = dict(rows).get(1)
        eff = {n: round(t1 / (n * t), 3) for n, t in rows if t1 and n > 1}
        best = rows[-1]
        print(json.dumps({
            "metric": f"tile-sharded fwd+bwd scaling ({args.n_gauss} gaussians, "
                      f"{args.width}x{args.height}, {dev.type})",
            "value": round(args.width * args.height / best[1] / 1e6, 3),
            "unit": f"Mrays/s @ {best[0]} dev",
            "vs_baseline": eff.get(best[0], 1.0),
            "per_device_ms": {str(n): round(t * 1e3, 2) for n, t in rows},
            "per_rank_ms": per_rank("ms"),
            "fullest_band_pairs": per_world("fullest"),
            "truncated": per_world("truncated"),
            "scaling_efficiency": eff,
            "launches": per_rank("launches"),
            "note": note,
        }))
    if truncated:
        print(f"# worlds {truncated} truncated their render at --max-isect "
              f"{args.max_isect}: not scaling figures", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
