"""Micro-benchmarks of the rasterizer's index-movement primitives; port of
`mtgs_tpu/tools/microbench_ops.py`.

Asks the JAX tool's data-movement questions of the port's own primitives,
at its sizes (intersection capacity 2^21, 10^6 gaussians, slab width 16):

  * `torch.sort` of int32 keys, stable and not, at capacity and at the
    gaussian count;
  * sort then gather of k - 1 f32 payload rows (k = 1, 2, 3, 5, 11, 17;
    torch has no k-operand sort: this is what the JAX package's payload
    sorts become), with bf16 and complex64-packed payload rows, and at a
    tighter capacity;
  * random row gathers (the `table[gidx]` pattern) at both sizes, the
    attribute-major column gather and `torch.stack` of 16 rows;
  * kernels 6 and 7 (`csrc/transpose.cu`: `rows_to_attr_major`,
    `attr_major_to_rows`), each beside its library call (on a CPU tensor
    the wrappers run their plain versions, which are those calls).

Chained timing, as JAX's: every iteration's FIRST operand is perturbed by
a value derived from the previous output, so successive calls have
distinct inputs and a real data dependency, and every output is consumed.
Each iteration is timed between CUDA events (the host clock on the CPU);
a row reports the median.

Run (on the card):  python -m mtgs_torch.tools.microbench_ops
`run_rows(cap, n, w, device)` runs the rows at other sizes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from mtgs_torch import resolve_device

CAP = 2 << 20          # intersection capacity (bench.py MAX_ISECT)
N = 1_000_000          # gaussian count
W = 16                 # slab width
ITERS = 10             # timed calls a row


def timeit(name, fn, *args, iters: int = ITERS, results=None) -> float:
    """Chained timing of `fn(*args)`: median ms of `iters` calls after one
    warm-up, each call's first operand the previous one's plus a
    data-dependent zero of every output plus one."""
    dev = args[0].device

    def step(first, rest):
        out = fn(first, *rest)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        delta = sum((o.reshape(-1)[0] * 0).to(first.dtype) for o in outs) + 1
        return out, first + delta

    rest = args[1:]
    out, first = step(args[0], rest)
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = []
        for _ in range(iters):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out, first = step(first, rest)
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize(dev)
        times = [e0.elapsed_time(e1) for e0, e1 in events]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            out, first = step(first, rest)
            times.append((time.perf_counter() - t0) * 1e3)
    dt = statistics.median(times)
    print(f"{name:44s} {dt:8.3f} ms")
    if results is not None:
        results[name] = dt
    return dt


def sort_gather(key, *rows):
    """The port's k-operand sort: the keys sorted, each payload row gathered
    by the permutation."""
    s, idx = torch.sort(key, stable=False)
    return (s, *[r[idx] for r in rows])


def run_rows(cap: int, n: int, w: int, device, iters: int = ITERS) -> Dict[str, float]:
    """Every row at capacity `cap`, `n` gaussians and slab width `w` on
    `device`: {row name: median ms}."""
    from mtgs_torch.raster.blend import attr_major_to_rows, rows_to_attr_major
    from mtgs_torch.raster.chunk_math import round8

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    res: Dict[str, float] = {}

    def t(a):
        return torch.as_tensor(a, device=dev)

    def tm(name, fn, *args):
        return timeit(name, fn, *args, iters=iters, results=res)

    key_cap = t(rng.integers(0, 1 << 30, cap, dtype=np.int32))
    key_n = t(rng.integers(0, 1 << 30, n, dtype=np.int32))
    rows_cap = [t(rng.normal(size=cap).astype(np.float32)) for _ in range(18)]
    rows_n = [t(rng.normal(size=n).astype(np.float32)) for _ in range(13)]
    gidx = t(rng.integers(0, n, cap, dtype=np.int32)).long()
    inv_perm = t(rng.permutation(n).astype(np.int32)).long()
    table = t(rng.normal(size=(n, w)).astype(np.float32))
    table_t = table.T.contiguous()

    for k in (1, 2, 3, 5, 11, 17):
        tm(f"sort + gather {k - 1} payloads @cap={cap}", sort_gather, key_cap,
           *rows_cap[: k - 1])
    tm("torch.sort STABLE @cap", lambda key: torch.sort(key, stable=True), key_cap)
    tm(f"torch.sort @n={n}", lambda key: torch.sort(key, stable=False), key_n)
    tm("torch.sort STABLE @n", lambda key: torch.sort(key, stable=True), key_n)
    for k in (2, 5, 11, 13):
        tm(f"sort + gather {k - 1} payloads @n={n}", sort_gather, key_n, *rows_n[: k - 1])

    # byte- or operand-scaled: 11 bf16 payload rows against 11 f32 rows
    rows16 = [r.to(torch.bfloat16) for r in rows_cap[:11]]
    tm("sort + gather 11 bf16 payloads @cap", sort_gather, key_cap, *rows16)

    # complex64 packing: two f32 payload rows to an operand (re/im), exactly
    def packed_sort(key, *rs):
        cs = [torch.complex(rs[2 * i], rs[2 * i + 1]) for i in range(5)]
        out = sort_gather(key, *cs, rs[10])
        fs = []
        for i in range(5):
            fs += [out[1 + i].real, out[1 + i].imag]
        return (out[0], *fs, out[6])

    tm("sort + gather c64-packed 11 f32 payloads @cap", packed_sort, key_cap, *rows_cap[:11])

    def pack_only(key, *rs):
        cs = [torch.complex(rs[2 * i], rs[2 * i + 1]) for i in range(5)]
        fs = []
        for c in cs:
            fs += [c.real, c.imag]
        return (key, *fs)

    tm("c64 pack+unpack only (no sort) @cap", pack_only, key_cap, *rows_cap[:11])

    # capacity sensitivity: what a buffer 7/8 as large buys a sort
    cap_t = cap * 7 // 8
    tm(f"sort + gather 11 payloads @cap={cap_t}", sort_gather, key_cap[:cap_t],
       *[r[:cap_t] for r in rows_cap[:11]])

    table_cap = t(rng.normal(size=(cap, 12)).astype(np.float32))
    tm("sort(key) + row-gather [cap]x12",
       lambda key, tb: tb[torch.sort(key, stable=False).indices], key_cap, table_cap)

    tm(f"row gather [cap]x{w} (table[gidx])", lambda tb, g: tb[g], table, gidx)
    tm("row gather [cap]x1 (int compose)", lambda tb, g: tb[g], table[:, 0].contiguous(), gidx)
    tm(f"row gather [n]x{w} (table[perm])", lambda tb, g: tb[g], table, inv_perm)
    tm(f"col gather attr-major [{w}, n] -> [{w}, cap]", lambda tb, g: tb[:, g], table_t, gidx)
    tm("stack 16 rows -> [16, cap]", lambda *rs: torch.stack(rs), *rows_cap[:16])

    # kernels 6 and 7 beside their library calls
    big = torch.zeros((cap, w), device=dev)
    tm(f"kernel rows_to_attr_major [cap, {w}]", rows_to_attr_major, big)
    tm(f"library F.pad(...).t().contiguous() [cap, {w}]",
       lambda r: F.pad(r, (0, round8(w) - w)).t().contiguous(), big)
    big_t = torch.zeros((w, cap), device=dev)
    tm(f"kernel attr_major_to_rows [{w}, cap]", attr_major_to_rows, big_t)
    tm(f"library .t().contiguous() [{w}, cap]", lambda a: a.t().contiguous(), big_t)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked for)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = run_rows(CAP, N, W, dev)
    print(json.dumps({
        "metric": "index-movement microbench (median ms, chained)",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "sizes": dict(cap=CAP, n=N, w=W), "iters": ITERS, "rows": rows,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
