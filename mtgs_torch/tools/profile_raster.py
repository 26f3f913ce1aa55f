"""Rasterizer stage-timing profile on the bench workload (one card); port
of `mtgs_tpu/tools/profile_raster.py`.

Observability tool: times cumulative stages of the port's rasterizer on
the root `bench.py`'s scene (1M gaussians: ground carpet, structures, far
shell; seed 0) and camera at 960x540, each stage a prefix of the forward
built from the rasterizer's own stage functions, and prints the per-stage
deltas:

  classic (default): projection, + binning (`binning.bin_gaussians`:
  spans, depth sort, `expand_pairs`, pair sort), full forward, forward +
  backward;
  fused (`--fused`): projection, + `binning.tile_spans`, + depth sort, +
  `expand_fused`, + pair sort, full forward, forward + backward.

Each stage runs `--iters` times after one warm-up call, between CUDA
events ending in a synchronize (the host clock on the CPU). `_roofline`
compares the blend's least time on these inputs (the pairs and chunks of
the port's binning; the bytes and operations `raster/blend.py` counts, as
`chip_smoke.py` phase 5 bounds its blend kernels) at the H100's published
peaks with the measured forward and forward + backward. `--trace DIR`
captures five forward + backward steps with `utils/observability.trace`
and prints the heaviest events per step.

Run (on the card):  python -m mtgs_torch.tools.profile_raster [--fused]
The scene's size (`--n-gauss`, `--width`, `--height`, `--max-isect`) can
be cut for a run on the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import importlib
import time

import numpy as np
import torch

from mtgs_torch import resolve_device

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# bench.py's workload
WIDTH, HEIGHT = 960, 540
N_GAUSS = 1_000_000
MAX_ISECT = 7 << 18  # 1.835M: ~13% above the pairs of exact alpha-support binning
FOCAL = 800.0        # at WIDTH; scaled with the width


def make_scene(n_gauss: int = N_GAUSS, seed: int = 0):
    """bench.py's `make_scene` in numpy: (means, quats, scales, opacities,
    colors), float32, a driving-scene layout of a ground carpet, structures
    and a far shell."""
    rng = np.random.default_rng(seed)
    n_ground = n_gauss // 2
    n_struct = n_gauss // 3
    n_far = n_gauss - n_ground - n_struct
    gx = rng.uniform(-60, 60, n_ground)
    gy = rng.uniform(-20, 20, n_ground)
    ground = np.stack([gx, gy, np.zeros_like(gx)], -1)
    struct = np.stack(
        [rng.uniform(-60, 60, n_struct), rng.uniform(-25, 25, n_struct),
         rng.uniform(0, 12, n_struct)], -1)
    theta = rng.uniform(0, 2 * np.pi, n_far)
    phi = rng.uniform(np.pi / 4, np.pi / 2, n_far)
    far = 400.0 * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    means = np.concatenate([ground, struct, far]).astype(np.float32)
    scales = np.concatenate([
        rng.lognormal(-2.3, 0.4, (n_ground, 3)),
        rng.lognormal(-2.0, 0.5, (n_struct, 3)),
        rng.lognormal(0.5, 0.4, (n_far, 3)),
    ]).astype(np.float32)
    quats = rng.normal(size=(n_gauss, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n_gauss).astype(np.float32)
    colors = rng.uniform(0, 1, (n_gauss, 3)).astype(np.float32)
    return means, quats, scales, opac, colors


def camera(width: int, height: int):
    """bench.py's camera: 1.6 m up at x = -55, looking along +x; (c2w, K)."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = [0, -1, 0]
    c2w[:3, 1] = [0, 0, 1]
    c2w[:3, 2] = [-1, 0, 0]
    c2w[:3, 3] = [-55.0, 0.0, 1.6]
    f = FOCAL * width / WIDTH
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]], np.float32)
    return c2w, K


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace", default=None, help="trace directory (observability.trace)")
    ap.add_argument("--fused", action="store_true", help="profile the fused path")
    ap.add_argument("--n-gauss", type=int, default=N_GAUSS)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--max-isect", type=int, default=MAX_ISECT)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from mtgs_torch.core.camera import camera_to_gsplat_viewmat
    from mtgs_torch.raster import RasterizeConfig, binning, rasterize
    from mtgs_torch.raster.expand_fused import expand_fused
    from mtgs_torch.raster.projection import project_gaussians

    # the module (the package's attribute of this name is the function)
    rasterize_mod = importlib.import_module("mtgs_torch.raster.rasterize")

    W, H = args.width, args.height
    params = tuple(torch.as_tensor(a, device=dev) for a in make_scene(args.n_gauss))
    c2w, K = camera(W, H)
    viewmat = camera_to_gsplat_viewmat(torch.as_tensor(c2w, device=dev))
    K = torch.as_tensor(K, device=dev)
    cfg = RasterizeConfig(
        width=W, height=H, max_intersections=args.max_isect,
        rasterize_mode="antialiased", render_mode="RGB+ED", fused=args.fused)
    target = torch.zeros((H, W, 3), device=dev)
    num_tiles = cfg.tiles_x * cfg.tiles_y

    def proj(p):
        m, q, s, o, c = p
        return project_gaussians(m, q, s, viewmat, K, W, H, near_plane=cfg.near_plane,
                                 far_plane=cfg.far_plane, antialiased=True)

    def table_of(p, pr):
        # the rasterizer's table: means2d, conic, effective opacity, colours, depth
        op = p[3] * pr.compensations
        return torch.cat([pr.means2d, pr.conics, op[:, None], p[4], pr.depths[:, None]], -1)

    def live_of(p, pr):
        return pr.valid & (p[3] * pr.compensations > 0)

    def spans(p):
        pr = proj(p)
        return pr, binning.tile_spans(
            pr.means2d, pr.radii, live_of(p, pr), width=W, height=H,
            tile_size=cfg.tile_size, conics=pr.conics, op_eff=p[3] * pr.compensations)

    def proj_bin(p):
        pr = proj(p)
        return pr, binning.bin_gaussians(
            pr.means2d, pr.radii, pr.depths, live_of(p, pr), width=W, height=H,
            tile_size=cfg.tile_size, max_intersections=cfg.max_intersections,
            conics=pr.conics, op_eff=p[3] * pr.compensations)

    def upto_depth_sort(p):
        pr, (packed, counts) = spans(p)
        return rasterize_mod._depth_sort(table_of(p, pr), packed, counts, pr.depths)

    def upto_expand(p):
        perm, packed, offsets, total, table_am = upto_depth_sort(p)
        return expand_fused(table_am, offsets, packed, total, cfg.max_intersections,
                            tiles_x=cfg.tiles_x, num_tiles=num_tiles)

    def upto_pair_sort(p):
        key, src, attrs = upto_expand(p)
        return rasterize_mod._pair_sort(key, attrs, cfg.max_intersections)

    def fwd(p):
        return rasterize(*p, viewmat, K, cfg)[:2]

    def fwdbwd(p):
        leaves = [x.detach().requires_grad_(True) for x in p]
        with torch.enable_grad():
            render, alpha, _ = rasterize(*leaves, viewmat, K, cfg)
            loss = (render[..., :3] - target).abs().mean() + 0.1 * alpha.mean()
            return torch.autograd.grad(loss, leaves)

    def blend_inputs(p):
        # the forward blend's slab and ranges on this path, as rasterize
        # builds them (the classic path's binning, or the fused gather)
        if args.fused:
            pr, (packed, counts) = spans(p)
            g = rasterize_mod._gather_fused_fwd(rasterize_mod.FusedStatics.of(cfg),
                                                table_of(p, pr), packed, counts, pr.depths)
            ranges = rasterize_mod._tile_ranges(g["key_s"], num_tiles, cfg.max_intersections)
            return g["slab_t"], ranges, g["total"]
        pr, b = proj_bin(p)
        slab_t = rasterize_mod._GatherIntersections.apply(
            table_of(p, pr), b.perm, b.inv_perm, b.gidx, b.n_intersections, None)
        return (slab_t, (b.tile_offsets, b.tile_heads, b.tile_counts, b.tile_nchunks),
                b.n_intersections)

    def timeit(name, fn):
        with torch.no_grad():
            fn(params)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(args.iters):
                    fn(params)
                b.record()
                b.synchronize()
                dt = a.elapsed_time(b) / args.iters
            else:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    fn(params)
                dt = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"{name:24s} {dt:8.2f} ms", flush=True)
        return dt

    path = "fused" if args.fused else "classic"
    print(f"# {path} path, {args.n_gauss} gaussians at {W}x{H}, max_intersections "
          f"{cfg.max_intersections}, {args.iters} iterations a stage on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    t1 = timeit("projection", proj)
    if args.fused:  # the fused forward runs no bin_gaussians
        ts1 = timeit("proj+tile_spans", spans)
        ts2 = timeit("+depth sort", upto_depth_sort)
        ts3 = timeit("+expand", upto_expand)
        ts4 = timeit("+pair sort", upto_pair_sort)
        t3 = timeit("full forward", fwd)
        t4 = timeit("full fwd+bwd", fwdbwd)
        deltas = dict(tile_spans=ts1 - t1, depth_sort=ts2 - ts1, expand=ts3 - ts2,
                      pair_sort=ts4 - ts3, blend_fwd=t3 - ts4, bwd=t4 - t3)
        print(f"\ntile_spans ~{ts1 - t1:.1f} | depth sort ~{ts2 - ts1:.1f} | "
              f"expand ~{ts3 - ts2:.1f} | pair sort ~{ts4 - ts3:.1f} | "
              f"blend fwd ~{t3 - ts4:.1f} | bwd(all) ~{t4 - t3:.1f} ms")
    else:
        t2 = timeit("projection+binning", proj_bin)
        t3 = timeit("full forward", fwd)
        t4 = timeit("full fwd+bwd", fwdbwd)
        deltas = dict(binning=t2 - t1, blend_fwd=t3 - t2, bwd=t4 - t3)
        print(f"\nbinning ~{t2 - t1:.1f} ms | gather+blend fwd ~{t3 - t2:.1f} ms"
              f" | bwd ~{t4 - t3:.1f} ms")
    with torch.no_grad():
        slab_t, ranges, n_isect = blend_inputs(params)
    roof = _roofline(cfg, slab_t, ranges, int(n_isect), t3, t4)

    trace_top = None
    if args.trace:
        from mtgs_torch.utils.observability import summarize_trace, trace

        fwdbwd(params)
        n_tr = 5
        with trace(args.trace):
            for _ in range(n_tr):
                fwdbwd(params)
        print(f"trace written to {args.trace}; top events (per step):")
        trace_top = summarize_trace(args.trace, top=25, iters=n_tr)
        for ms, cnt, name in trace_top:
            print(f"  {ms:9.3f} ms  x{cnt:<4d} {name}")
    return dict(path=path, stages_ms=dict(projection=t1, full_forward=t3, full_fwd_bwd=t4),
                deltas_ms=deltas, roofline=roof, trace_top=trace_top)


def _roofline(cfg, slab_t, ranges, n_isect: int, t_fwd_ms, t_fwdbwd_ms):
    """Speed-of-light of the blend on this workload: the pairs and chunks of
    the port's binning (`ranges`: tile offsets, heads, counts, chunks), the
    pixels the blend evaluates and composites (the plain forward's counts on
    the binned slab), converted to the bytes and operations
    `raster/blend.py` counts, over the H100's published peaks (the bounds of
    `chip_smoke.py` phase 5), against the measured full forward and forward
    + backward. Returns the numbers printed."""
    from mtgs_torch.raster import blend
    from mtgs_torch.raster.chunk_math import CHUNK

    W, H = cfg.width, cfg.height
    c_total = 4  # RGB + expected depth
    stats = {}
    with torch.no_grad():
        blend.blend_forward_plain(slab_t, *ranges, tile_size=cfg.tile_size,
                                  tiles_x=cfg.tiles_x, c_total=c_total, stats=stats)
    T = cfg.tiles_x * cfg.tiles_y
    n_pix = T * cfg.tile_size * cfg.tile_size
    n_chunks = int(ranges[3].sum())
    f_bytes, f_ops = blend.blend_forward_work(stats, c_total, T, n_pix)
    b_bytes, b_ops = blend.blend_backward_work(stats, c_total, T, n_pix, slab_t.numel())
    sol_fwd = max(f_bytes / PEAK_BYTES_PER_S, f_ops / PEAK_F32_PER_S)
    sol_bwd = max(b_bytes / PEAK_BYTES_PER_S, b_ops / PEAK_F32_PER_S)
    print(f"\n--- roofline (H100 SXM peaks at 700 W: f32 {PEAK_F32_PER_S / 1e12:.0f} TFLOP/s, "
          f"HBM {PEAK_BYTES_PER_S / 1e12:.2f} TB/s) ---")
    print(f"n_intersections={n_isect}  chunk-iters={n_chunks} "
          f"({n_chunks * CHUNK} slots)  pair-evals={stats['pair_evals']}  in support "
          f"{stats['pair_support']}  composited {stats['pair_blends']}")
    print(f"blend fwd : {f_ops / 1e9:.2f} G-op ({f_ops / PEAK_F32_PER_S * 1e3:.3f} ms) | "
          f"{f_bytes / 1e6:.1f} MB ({f_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms)")
    print(f"blend bwd : {b_ops / 1e9:.2f} G-op ({b_ops / PEAK_F32_PER_S * 1e3:.3f} ms) | "
          f"{b_bytes / 1e6:.1f} MB ({b_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms)")
    print(f"SoL fwd ~{sol_fwd * 1e3:.3f} ms vs measured full fwd {t_fwd_ms:.2f} ms"
          f" ({t_fwd_ms / (sol_fwd * 1e3):.1f}x off)")
    print(f"SoL fwd+bwd ~{(sol_fwd + sol_bwd) * 1e3:.3f} ms vs measured "
          f"{t_fwdbwd_ms:.2f} ms ({t_fwdbwd_ms / ((sol_fwd + sol_bwd) * 1e3):.1f}x off)")
    rays = W * H
    print(f"SoL rays/s fwd+bwd ~{rays / (sol_fwd + sol_bwd) / 1e6:.1f} Mrays/s; "
          f"measured {rays / (t_fwdbwd_ms * 1e-3) / 1e6:.2f} Mrays/s")
    return dict(n_intersections=n_isect, chunk_iters=n_chunks, stats=stats,
                fwd_bytes=f_bytes, fwd_ops=f_ops, bwd_bytes=b_bytes, bwd_ops=b_ops,
                sol_fwd_ms=sol_fwd * 1e3, sol_bwd_ms=sol_bwd * 1e3,
                fwd_x_off=t_fwd_ms / (sol_fwd * 1e3),
                fwdbwd_x_off=t_fwdbwd_ms / ((sol_fwd + sol_bwd) * 1e3))


if __name__ == "__main__":
    main()
