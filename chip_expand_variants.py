"""Variants of the fused pair expansion (`mtgs_torch/csrc/expand_fused.cu`)
timed on one serving view's inputs, on the H100: what holds the kernel
above its bound.

Builds chip_smoke.py's scene (seed 0, the `mtgs` preset at 960x540),
renders view 0 with the kernel wrappers' arguments captured, prints how
many owners the capture's blocks of slots span, and times (chip_smoke's
`device_ms`: a CUDA graph of 20 launches) the checkout's kernel and
these versions of its source, each built with the port's flags:

- `one_column`: every gather reads column n - 1, so the table costs
  nothing (its output differs from the checkout's);
- `conditional`: a row's gathers written as a conditional expression
  (`cond ? __ldg(...) : 0.0f`), which nvcc compiles to branches;
- each PATH given on the command line (the same C interface, e.g. a
  parent commit's source from `git show`).

Prints the card line first and exits non-zero without a CUDA device.
Run from the repository root:  python3 chip_expand_variants.py [PATH ...]
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from mtgs_torch import configs
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.raster import cuda_build, expand_fused

GATHER = "if (r < nw && jv[p][k] >= 0) v[k] = __ldg(row_in + jv[p][k]);"
VARIANTS = {
    "one_column": (GATHER, "if (r < nw && jv[p][k] >= 0) v[k] = __ldg(row_in + n - 1);"),
    "conditional": ("v[k] = 0.0f;\n        " + GATHER,
                    "v[k] = (r < nw && jv[p][k] >= 0) ? __ldg(row_in + jv[p][k]) : 0.0f;"),
}


def serving_capture(dev):
    """expand_fused's arguments in view 0 of chip_smoke's serving scene."""
    p_sd, a_sd = cs.make_scene_state(0, 900_000, 100_000, 4096)
    params, aux = scene_from_state_dict(p_sd, a_sd, device=dev)
    cfg = configs.mtgs_config(960, 540)
    view = cs.make_views(0, 1, 960, 540, 800.0)[0]
    captured = {}
    with cs.capturing(captured), torch.no_grad():
        cs.render_view(params, aux, cfg, cs.view_batch(view), 10**9, device=dev)
    return captured["expand_fused"]


def owner_spans(offsets, total, I, nw):
    """Per block of slots, the owners it spans; and the share of 2,048-slot
    blocks whose owners' nw table columns exceed 48 KiB."""
    off = offsets.cpu().numpy().astype(np.int64)
    for bs in (256, 2048):
        starts = np.arange(0, min(total, I), bs)
        lo = np.searchsorted(off, starts, side="right") - 1
        hi = np.searchsorted(off, np.minimum(starts + bs, total) - 1, side="right") - 1
        span = hi - lo + 1
        print(f"blocks of {bs} slots: owners 10/50/90/99% "
              f"{np.quantile(span, [0.1, 0.5, 0.9, 0.99]).tolist()}"
              + (f", share over 48 KiB of columns {(span * nw * 4 > 48 * 1024).mean():.3f}"
                 if bs == 2048 else ""))


def main(argv=None):
    paths = [Path(p) for p in (sys.argv[1:] if argv is None else argv)]
    if not torch.cuda.is_available():
        print("chip_expand_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    cuda_build.build(["expand_fused.cu"])
    (table, offsets, packed, total, I), kw = serving_capture(dev)
    print(f"serving capture: n {table.shape[1]}, total {int(total)}, I {I}")
    owner_spans(offsets, int(total), I, table.shape[0])

    source = (cuda_build.CSRC / "expand_fused.cu").read_text()
    others = []
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, (old, new) in VARIANTS.items():
        if old not in source:
            raise RuntimeError(f"variant {name}: its text is not in expand_fused.cu")
        path = out_dir / f"expand_fused_{name}.cu"
        path.write_text(source.replace(old, new))
        others.append((name, path))
    others += [(str(p), p) for p in paths]

    def call():
        return expand_fused.expand_fused(table, offsets, packed, total, I, **kw)

    mine = cuda_build.load("expand_fused.cu")
    ref = call()
    print(f"checkout: {cs.device_ms(call):.4f} ms")
    for name, path in others:
        cuda_build._LIBS["expand_fused.cu"] = cs.build_other(path)
        try:
            got = call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            print(f"{name}: {cs.device_ms(call):.4f} ms (equal to the checkout's: {same})")
        finally:
            cuda_build._LIBS["expand_fused.cu"] = mine
    print(f"checkout: {cs.device_ms(call):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
