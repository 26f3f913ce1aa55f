"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name and power limit and the run's progress on
standard error, each compared number beside its limit as the last lines
there, and the result as one JSON object on the last line of standard
output. Without a CUDA device, or with fewer than the cell asks for, it
exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel builds live in the checkout (build/mtgs_torch);
    # any Triton cache goes there too, and no library may load JAX
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    if not torch.cuda.is_available():
        print("bench_port: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from bench_port import harness, program  # noqa: F401 - fails here without the program

    cell = harness.Cell.load(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"bench_port: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    card = harness.card_line()
    print(f"# card: {card}", flush=True)
    harness.log(f"# card: {card}; workload {args.workload} seed {args.seed} "
                f"seconds {args.seconds} trace {args.trace}")
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_process=T_PROCESS, cell=cell)
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder, on the path
    sys.exit(main())
