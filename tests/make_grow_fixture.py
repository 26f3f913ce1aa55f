"""Record JAX's `grow_demo` trajectory on the CPU as a JSON fixture.

Runs `mtgs_tpu.tools.grow_demo.main` in this process on JAX's CPU backend,
with the arguments given after `--`: the ground truth renders on the XLA
backend (`--backend xla`), the trainer on JAX's Pallas path in interpret
mode (the path JAX's TPU runs take). On the CPU, JAX's XLA backward gives
a visible gaussian that no pixel composites (alpha below 1/255 at every
pixel) a rounding residue of absgrad (3 * 2^-28 after the NDC scale)
where the Pallas path gives 0, and the tool's densify_grad_thresh of 1e-9
then duplicates it: the XLA backend's trajectory parts from the Pallas
path's at the first refine. The script writes every
refine's alive count, capacity, overflow and intersection buffer (the
tool's `# step N:` lines) with the refine's split, duplicate and cull
counts (read from the trainer's refine function), the growth events, the
tool's JSON and the provenance (the command, the commit, the date, the
JAX version). The port's run of the same arguments is held against it.

    python tests/make_grow_fixture.py OUT.json -- --width 240 --height 136 \
        --n-bg 10000 --max-steps 100 --max-isect 262144

`tests/fixtures/grow_demo_jax.json` was written so (8 minutes on eight
cores). `--xla` before the `--` keeps the trainer on the XLA backend, to
show where it parts from the Pallas path (at 48x48 it runs in a minute).
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import re
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

LINE = re.compile(r"^# step (\d+): alive=(\d+) capacity=(\d+) overflow=(\d+) "
                  r"max_isect=(\d+)$", re.M)


def run(argv, xla=False):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mtgs_tpu  # noqa: F401  (JAX's f32 matmul precision)
    from mtgs_tpu.tools import grow_demo
    from mtgs_tpu.train import trainer as jtrainer

    counts = {}      # refine step -> its split, duplicate and cull counts
    get = jtrainer.Trainer._get_refine_fn

    def recording(self, flags, out_caps=None):
        fn = get(self, flags, out_caps)

        def wrapped(state, aux):
            state, aux, info = fn(state, aux)
            counts[int(state.step)] = {k: int(info[k]) for k in ("n_split", "n_dup", "n_cull")}
            return state, aux, info
        return wrapped

    jtrainer.Trainer._get_refine_fn = recording
    config = jtrainer.TrainerConfig
    if not xla:
        jtrainer.TrainerConfig = lambda **kw: config(**{**kw, "backend": "pallas",
                                                        "interpret": True})
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = grow_demo.main(list(argv) + ["--backend", "xla"])
    finally:
        jtrainer.Trainer._get_refine_fn = get
        jtrainer.TrainerConfig = config
    lines = LINE.findall(err.getvalue())
    refines = [dict(step=int(s), alive=int(a), capacity=int(c), overflow=int(o),
                    max_isect=int(m), **counts.get(int(s), {}))
               for s, a, c, o, m in lines]
    events = re.search(r"^# growth events: (.*)$", err.getvalue(), re.M).group(1)
    return dict(rc=rc, refines=refines, growth_events=events,
                result=json.loads(out.getvalue().strip().splitlines()[-1]),
                seconds=round(time.perf_counter() - t0, 1))


def main():
    if "--" not in sys.argv:
        raise SystemExit(__doc__)
    cut = sys.argv.index("--")
    (path, *flags), argv = sys.argv[1:cut], sys.argv[cut + 1:]
    xla = flags == ["--xla"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
                            text=True).stdout.strip()
    import jax

    res = run(argv, xla)
    res["provenance"] = dict(
        command="python tests/make_grow_fixture.py " + " ".join([path, *flags, "--"] + argv),
        tool="mtgs_tpu.tools.grow_demo.main(argv + ['--backend', 'xla']) on the CPU, "
             + ("its trainer on the XLA backend" if xla else
                "its TrainerConfig on backend 'pallas' with interpret=True"),
        commit=commit, date=datetime.date.today().isoformat(), jax=jax.__version__)
    res["argv"] = argv
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
        f.write("\n")
    print(json.dumps(res["refines"]))


if __name__ == "__main__":
    main()
