"""The readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

For each seed, in one process: the cell's set-up as a run makes it (the
program's checked training steps, or its renders of the sampled views),
the numbers of the loop's `compare` against the float32 reference, and,
with `--control`, the same numbers of the control: the reference computed
with TF32 matmuls put in the program's place. With `--fault half_batch`
(train cells) the reference whose loss leaves out the image's lower half
stands in for the program as well. A train cell's lines carry each
step's loss on both sides and each leaf's first-gradient and change
norms on both sides (`leaves`).

    python3 bench_port/readings.py --workload <name> --seeds 1,2,3 [--control] \
        [--fault half_batch] [--out FILE]

`--grad-rms` instead prints, for each seed, each leaf's RMS of the
reference's first gradient at the cell's size: the scale of the Adam
moments a train cell starts from (a configuration's `grad_rms`).
`--reduced` reads the cell cut to the tests' size (`tests/conftest.py`),
and `--device cpu` reads on the CPU: the card against a second witness.

One JSON line a seed and side on standard output (and in FILE).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def half_batch(t):
    """The targets with the mask's lower half cleared: the loss's means
    over the upper half alone."""
    t = dict(t)
    m = t["mask"].clone()
    m[m.shape[0] // 2:] = 0
    t["mask"] = m
    return t


def grad_rms(loop) -> dict:
    """Each leaf's RMS of the reference's gradient on the seed's first view."""
    from bench_port import scene
    from bench_port.reference import train as ref_train
    from bench_port.reference.raster import Prec

    raw = loop.make_scene()
    views = loop.make_views()
    i = scene.view_order(len(views), loop.seed)[0]
    params, aux = loop.reference_scene(raw)
    del raw
    tg = scene.make_targets(views[i], loop.W, loop.H, loop.seed, i, loop.dev)
    grads = ref_train.step_grads(loop.cfg, ref_train._leaves(params), aux, views[i], tg,
                                 loop.traffic["start_step"], loop.W, loop.H, Prec(),
                                 loop.gather)[2]
    return {k: float(g.norm()) / max(g.numel(), 1) ** 0.5 for k, g in grads.items()}


def read_seed(cell, seed, dev, sides, emit):
    """The program's set-up for one seed, then the numbers of each side."""
    import torch

    from bench_port import harness
    from bench_port.loops import train
    from bench_port.reference.raster import Prec

    t0 = time.perf_counter()
    loop = harness.load_loop(cell.traffic["loop"])(cell, seed, dev)
    raw = loop.make_scene()
    views = loop.make_views()
    I = harness.pair_buffer(loop.pair_counts(raw, views), cell.traffic["isect_headroom"])
    loop.build(raw, views, I)
    del raw
    win = harness.Window()
    setup = loop.setup_steps(win)
    pairs = max(int(x) for x in win.n_isect) if win.n_isect else None
    loop.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    base = dict(workload=cell.name, seed=seed, pairs=pairs, buffer=I)
    if loop.KIND == "train":
        ref, params0 = loop.reference(setup["views"], Prec())
        for side in sides:
            if side == "program":
                cand = setup
            elif side == "control":
                cand = loop.as_program(*loop.reference(setup["views"], Prec(tf32=True)),
                                       setup["views"])
            elif side == "half_batch":
                cand = loop.as_program(*loop.reference(setup["views"], Prec(), half_batch),
                                       setup["views"])
            else:
                raise SystemExit(f"unknown fault {side}")
            emit(dict(base, side=side, numbers=train.numbers(cand, ref, params0),
                      losses=cand["losses"], ref_losses=ref["losses"],
                      leaves=train.leaf_table(cand, ref, params0),
                      seconds=time.perf_counter() - t0))
    else:
        for side in sides:
            if side == "control":
                loop.kept = loop.reference_renders(Prec(tf32=True))
            elif side != "program":
                raise SystemExit(f"unknown fault {side} for a render cell")
            emit(dict(base, side=side, numbers=loop.compare(setup),
                      seconds=time.perf_counter() - t0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the control and the faults on the first this many seeds")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--grad-rms", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from bench_port import harness

    if args.reduced:
        from bench_port.tests.conftest import tiny_cell

        cell = tiny_cell(args.workload)
    else:
        cell = harness.Cell.load(args.workload)
    dev = torch.device(args.device)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    if dev.type == "cuda":
        harness.log(f"# card: {harness.card_line()}")
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        if args.grad_rms:
            loop = harness.load_loop(cell.traffic["loop"])(cell, seed, dev)
            emit(dict(workload=cell.name, seed=seed, grad_rms=grad_rms(loop)))
        else:
            sides = ["program"]
            if n < args.control_seeds:
                sides += ["control"] * args.control + args.fault
            read_seed(cell, seed, dev, sides, emit)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
