"""Measure on the CPU how the port's draws and XLA math agree with JAX's.

    python tests/measure_draw_parity.py MODE

with MODE one of: `sqrt` (torch's float32 sqrt and xla_math.sqrt against
XLA's), `exp` (xla_math.exp over [-88, 89] at a stride of 37 ulps),
`sincos` (every float32 with 2^-12 <= |x| < 150; ~6 minutes), `normal`
(prng.normal and erf_inv's tail against jax.random), `synthetic` (the
ground truth against JAX's, eager and under jax.jit), `grow` (grow_demo's
densify state before each refine; ~10 minutes), `grow48`
(test_grow_demo_matches_jax's two runs) or `icp` (register_traversals
with the committed and a host-built ICP library).

XLA's side is `jax.jit` of the `jnp` function on the CPU (its sin and cos
call the process's libm). Each mode prints its counts; `grow` runs both
packages' `grow_demo` at 240x136 from 10k seeds for 100 steps (JAX's
trainer on its Pallas path in interpret mode, as
tests/make_grow_fixture.py runs it) and compares the background's
densify statistics and opacities just before each refine; `icp` runs
tests/test_torch_stack_icp.py's traversals.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import mtgs_tpu  # noqa: E402,F401  (JAX's f32 matmul precision)
from mtgs_torch.core import prng, xla_math  # noqa: E402

CHUNK = 1 << 22


def differ(got: np.ndarray, want: np.ndarray) -> int:
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    return int((~same).sum())


def sweep(name: str, bits: np.ndarray) -> int:
    """xla_math.<name> against jax.jit(jnp.<name>) on the float32 of these
    bit patterns, in chunks (one compile for every full chunk)."""
    fn, ref = getattr(xla_math, name), jax.jit(getattr(jnp, name))
    bad = 0
    for i in range(0, len(bits), CHUNK):
        x = bits[i:i + CHUNK].view(np.float32)
        bad += differ(fn(torch.from_numpy(x)).numpy(), np.asarray(ref(x)))
    return bad


def mode_sqrt():
    x = np.random.default_rng(0).uniform(5, 40, CHUNK).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sqrt)(x))
    print(f"sqrt over {x.size} uniform [5, 40): torch float32 differs at "
          f"{differ(torch.sqrt(torch.from_numpy(x)).numpy(), want)}, xla_math.sqrt at "
          f"{differ(xla_math.sqrt(torch.from_numpy(x)).numpy(), want)}")


def mode_exp():
    pos = np.arange(0, 0x42B20000, 37, dtype=np.uint32)
    neg = np.arange(0, 0x42B00000, 37, dtype=np.uint32) | np.uint32(0x80000000)
    print(f"exp over {pos.size + neg.size} inputs in [-88, 89] (stride 37): "
          f"{sweep('exp', pos) + sweep('exp', neg)} differ")


def mode_sincos():
    lo, hi = 0x39800000, 0x43160000          # 2^-12 <= |x| < 150
    bits = np.arange(lo, hi, dtype=np.uint32)
    for name in ("sin", "cos"):
        bad = sweep(name, bits) + sweep(name, bits | np.uint32(0x80000000))
        print(f"{name} over all {2 * bits.size} float32 with 2^-12 <= |x| < 150: {bad} differ")


def mode_normal():
    for seed, shape in ((0, (1 << 20, 3)), (123, (300_000, 3)), (7, (65536, 3)), (3, (300_000,))):
        got = prng.normal(prng.key(seed), shape).numpy()
        want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
        print(f"normal seed {seed} {shape}: {differ(got, want)} differ")
    pos = np.arange(np.float32(0.9966).view(np.int32), np.float32(1.0).view(np.int32),
                    dtype=np.int32).view(np.float32)
    x = np.concatenate([pos, -pos])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    print(f"erf_inv over its {x.size} tail inputs: "
          f"{differ(prng.erf_inv(torch.from_numpy(x)).numpy(), want)} differ")


def mode_synthetic():
    from mtgs_tpu.data import synthetic as js
    from mtgs_torch.data import synthetic as ts

    n, extent = 2000, 20.0
    port = ts._gt_gaussians(prng.key(3), n, extent, 0.18, 0.25)
    eager = js._gt_gaussians(jax.random.key(3), n, extent, 0.18, 0.25)
    whole = jax.jit(js._gt_gaussians, static_argnums=(1, 2, 3, 4))(
        jax.random.key(3), n, extent, 0.18, 0.25)
    size = sum(a.size for a in port)
    for label, ref in (("eager", eager), ("under jax.jit", whole)):
        bad = sum(differ(g, np.asarray(w)) for g, w in zip(port, ref))
        print(f"_gt_gaussians(key 3, {n}, {extent}): {bad} of {size} values differ from "
              f"JAX's draw {label}")


def mode_grow():
    from mtgs_tpu.tools import grow_demo as jgrow
    from mtgs_tpu.train import trainer as jtrainer
    from mtgs_torch.tools import grow_demo as tgrow
    from mtgs_torch.train import trainer as ttrainer

    argv = ["--width", "240", "--height", "136", "--n-bg", "10000", "--max-steps", "100",
            "--max-isect", "262144"]
    host = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    states = {"jax": {}, "port": {}}

    def record(module, name):
        plan = module.Trainer._plan_growth

        def wrapped(self, flags):
            d, p = self.state.densify["background"], self.state.params.background
            n = int(host(self.aux.background.num_alive))
            states[name][int(host(self.state.step))] = dict(
                avg=(host(d.xys_grad_norm) / np.maximum(host(d.vis_counts), 1.0))[:n],
                vis=host(d.vis_counts)[:n], opacity=host(p.opacities).reshape(-1)[:n])
            return plan(self, flags)
        module.Trainer._plan_growth = wrapped

    record(jtrainer, "jax")
    record(ttrainer, "port")
    config = jtrainer.TrainerConfig
    jtrainer.TrainerConfig = lambda **kw: config(**{**kw, "backend": "pallas",
                                                    "interpret": True})
    with contextlib.redirect_stdout(io.StringIO()):
        tgrow.main(argv + ["--device", "cpu"])
        jgrow.main(argv + ["--backend", "xla"])
    for step in sorted(states["jax"]):
        j, t = states["jax"][step], states["port"][step]
        d = np.abs(t["opacity"] - j["opacity"])
        dup_j, dup_t = j["avg"] > 1e-9, t["avg"] > 1e-9
        print(f"refine at step {step}: {j['avg'].size} alive; duplicates JAX "
              f"{int(dup_j.sum())}, port {int(dup_t.sum())}; visible counts differ at "
              f"{int((j['vis'] != t['vis']).sum())}; opacity logits apart by > 1e-4 at "
              f"{int((d > 1e-4).sum())}, > 0.1 at {int((d > 0.1).sum())} (max {d.max():.4f})")
        sigmoid = lambda v: 1 / (1 + np.exp(-v))
        for i in np.nonzero(dup_j != dup_t)[0]:
            print(f"  gaussian {i}: average gradient JAX {j['avg'][i]:.4g}, port "
                  f"{t['avg'][i]:.4g}; opacity JAX {sigmoid(j['opacity'][i]):.4f}, port "
                  f"{sigmoid(t['opacity'][i]):.4f}")


def mode_grow48():
    """tests/test_torch_tools.py::test_grow_demo_matches_jax's two runs, their
    alive counts printed."""
    import re
    from mtgs_tpu.data import synthetic as jsynthetic
    from mtgs_tpu.tools import grow_demo as jgrow
    from mtgs_tpu.train import trainer as jtrainer
    from mtgs_torch.tools import grow_demo as tgrow

    argv = ["--n-bg", "1500", "--target", "100000", "--width", "48", "--height", "48",
            "--refine-every", "5", "--max-steps", "25", "--max-isect", "2560"]
    jsynthetic._gt_gaussians = jax.jit(jsynthetic._gt_gaussians, static_argnums=(1, 2, 3, 4))
    config = jtrainer.TrainerConfig
    jtrainer.TrainerConfig = lambda **kw: config(**{**kw, "backend": "pallas",
                                                    "interpret": True})
    for label, main, extra in (("port", tgrow.main, ["--device", "cpu"]),
                               ("JAX", jgrow.main, ["--backend", "reference"])):
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            main(argv + extra)
        alive = re.findall(r"^# step (\d+): alive=(\d+)", err.getvalue(), re.M)
        print(f"{label}: alive {', '.join(f'{a} at step {s}' for s, a in alive)}")


def mode_icp():
    import test_icp
    from mtgs_tpu.preprocess import lidar_registration as jlr
    from mtgs_torch.preprocess import lidar_registration as tlr

    world = test_icp.make_world()
    rng = np.random.default_rng(3)
    scans, gps = {}, {}
    for travel, lane in enumerate((-1.0, 1.0)):
        poses = test_icp.drive_poses(8, lane_y=lane)
        scans[travel] = [test_icp.scan_from(world, poses[f], rng) for f in range(8)]
        gps[travel] = poses
    got = tlr.register_traversals(scans, gps, voxel_size=0.8, epe_gate=5.0, ate_gate=2.0)
    with tempfile.TemporaryDirectory() as tmp:
        here = Path(tmp) / "libicp_core.so"
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", str(jlr._SRC),
                        "-o", str(here)], check=True)
        for label, so in (("committed", jlr._SO), ("built here", here)):
            jlr._SO, jlr._LIB = so, None
            want = jlr.register_traversals(scans, gps, voxel_size=0.8, epe_gate=5.0,
                                           ate_gate=2.0)
            pose = max(float(np.abs(got[0][t] - want[0][t]).max()) for t in want[0])
            print(f"JAX with the {label} libicp_core.so: ARE "
                  f"{[round(want[1][t]['ARE'], 2) for t in sorted(want[1])]}, the port's "
                  f"{[round(got[1][t]['ARE'], 2) for t in sorted(got[1])]}; poses apart by "
                  f"up to {pose:.4g}")


if __name__ == "__main__":
    modes = {k[5:]: v for k, v in globals().items() if k.startswith("mode_")}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        sys.exit(f"usage: {sys.argv[0]} {{{'|'.join(modes)}}}")
    modes[sys.argv[1]]()
