"""Numerics validation of the fused path against the classic path on the
card; port of `mtgs_tpu/tools/validate_fused.py`.

Renders one seeded scene through the port's `rasterize` twice, with
`fused=True` (kernels 1-4: `expand_fused`, `blend_forward`,
`blend_backward`, `dense_segment_sum`) and with `fused=False` (the classic
path: `expand_pairs`, `rows_to_attr_major`, the two blends, the segment
sum and `attr_major_to_rows`), and compares the forward render and alpha
(the same slab and blend inputs: expected equal within rounding) and the
parameter gradients and absgrad of one loss (expected allclose: the
per-gaussian reduction orders differ). Gates, as JAX's: equal
n_intersections, render 1e-4, alpha 1e-5, every gradient and the absgrad
1e-3 of its largest |value|.

Run (on the card):  python -m mtgs_torch.tools.validate_fused [--n 200000]
Smoke (CPU):        --device cpu --n 1500 --width 128 --height 96 --max-isect 32768
Prints `VALIDATE PASS` or `VALIDATE FAIL`; exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mtgs_torch import resolve_device

RENDER_TOL = 1e-4
ALPHA_TOL = 1e-5
GRAD_TOL = 1e-3
NAMES = ("means", "quats", "scales", "opac", "colors")


def make_scene(n: int, width: int, height: int, dev):
    """The JAX tool's seeded scene (the same numpy draws): the five
    gaussian tensors, the identity camera's viewmat, K, and the loss's
    pixel weights [H, W]."""
    from mtgs_torch.core.camera import camera_to_gsplat_viewmat

    rng = np.random.default_rng(0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    means = f32(np.stack([
        rng.uniform(-30, 30, n), rng.uniform(-20, 20, n),
        rng.uniform(-60, -4, n)], -1))
    quats = f32(rng.normal(size=(n, 4)))
    scales = f32(np.exp(rng.normal(-1.5, 0.5, (n, 3))))
    opac = f32(rng.uniform(0.2, 0.95, n))
    colors = f32(rng.uniform(0, 1, (n, 3)))
    viewmat = camera_to_gsplat_viewmat(torch.eye(4, device=dev))
    K = f32([[400.0, 0, width / 2], [0, 400.0, height / 2], [0, 0, 1.0]])
    gw = f32(rng.normal(size=(height, width)))
    return (means, quats, scales, opac, colors), viewmat, K, gw


def run(scene, viewmat, K, gw, cfg):
    """One path: (render, alpha, n_intersections, parameter gradients,
    absgrad) of JAX's forward and of its loss
    sum(render[..., :3] * gw) + 0.3 * sum(alpha * gw)."""
    from mtgs_torch.raster import rasterize

    with torch.no_grad():
        r, a, info = rasterize(*scene, viewmat, K, cfg)
    leaves = [t.clone().requires_grad_(True) for t in scene]
    sink = torch.zeros((scene[0].shape[0], 2), device=gw.device, requires_grad=True)
    rg, ag, _ = rasterize(*leaves, viewmat, K, cfg, absgrad_sink=sink)
    loss = torch.sum(rg[..., :3] * gw[..., None]) + 0.3 * torch.sum(ag * gw[..., None])
    *grads, sg = torch.autograd.grad(loss, leaves + [sink])
    return r, a, int(info["n_intersections"].reshape(())), grads, sg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--max-isect", type=int, default=1 << 19)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from mtgs_torch.raster import RasterizeConfig

    scene, viewmat, K, gw = make_scene(args.n, args.width, args.height, dev)

    def make_cfg(fused):
        return RasterizeConfig(
            width=args.width, height=args.height, max_intersections=args.max_isect,
            rasterize_mode="antialiased", render_mode="RGB+ED", fused=fused,
        )

    rc, ac, nic, gc, sc = run(scene, viewmat, K, gw, make_cfg(False))
    rf, af, nif, gf, sf = run(scene, viewmat, K, gw, make_cfg(True))

    print(f"n_intersections classic={nic} fused={nif}")
    ok = nic == nif
    dr = float((rf - rc).abs().max())
    da = float((af - ac).abs().max())
    print(f"forward max|d| render={dr:.3e} alpha={da:.3e}")
    ok &= dr < RENDER_TOL and da < ALPHA_TOL
    for name, a_, b_ in zip(NAMES, gc, gf):
        s = max(float(a_.abs().max()), 1e-3)
        d = float((b_ - a_).abs().max()) / s
        print(f"grad {name:8s} rel max|d| = {d:.3e}")
        ok &= d < GRAD_TOL
    s = max(float(sc.abs().max()), 1e-3)
    d = float((sf - sc).abs().max()) / s
    print(f"absgrad rel max|d| = {d:.3e}")
    ok &= d < GRAD_TOL
    print("VALIDATE", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
