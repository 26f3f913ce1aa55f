"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the plain reference and the result.

A cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs/<config>.json`: the method preset, the scene's sizes and layout,
the cameras) and a traffic mix (`traffic/<traffic>.json`: the loop it runs,
by the name of its module in `loops/`, the image size and the loop's
parameters). The loop (`loops/base.py`) makes the inputs, builds the
program's objects, runs the units and compares what they produced with
the reference; this module runs it through a window and reads the result.

Per-layer metrics are the readers in `metrics/<name>.py`, run on the
traced sub-window of a `--trace 1` run.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench_port import imports, tracing, work

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
GRANULE = 512      # the program's pair-buffer rounding


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell's entry, configuration, traffic mix and limits."""

    name: str
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    per_layer: List[dict]
    chips: int = 1

    @classmethod
    def load(cls, workload: str, root: Path = ROOT) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
        if entry is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        e2e = {m["name"] for m in bench["end_to_end"]
               if workload in m.get("workloads", [workload])}
        per_layer = [m for m in bench["per_layer"]
                     if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]
        limits_path = HERE / "limits" / f"{workload}.json"
        limits = load_json(limits_path) if limits_path.exists() else {}
        return cls(workload, load_json(HERE / "configs" / f"{entry['config']}.json"),
                   load_json(HERE / "traffic" / f"{entry['traffic']}.json"), limits,
                   per_layer, entry["chips"])


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------------ set-up

def pair_buffer(counts: List[int], headroom: float) -> int:
    need = int(max(counts) * headroom)
    return -(-need // GRANULE) * GRANULE


def load_loop(name: str):
    """The `Loop` class of `loops/<name>.py`."""
    return importlib.import_module(f"bench_port.loops.{name}").Loop


@dataclass
class Window:
    units: int = 0
    failed: int = 0
    seconds: float = 0.0
    untraced_s: float = 0.0        # the wall seconds of the units before the trace
    latencies: List[float] = field(default_factory=list)
    dispatch: List[float] = field(default_factory=list)
    n_isect: List[torch.Tensor] = field(default_factory=list)
    trace: Optional[tracing.TraceSummary] = None
    errors: List[str] = field(default_factory=list)


def _guarded(win: Window, fn):
    try:
        return fn()
    except (RuntimeError, ValueError) as e:
        win.failed += 1
        win.units += 1
        if len(win.errors) < 3:
            win.errors.append(repr(e))
        if win.failed > 8:
            raise
        return None


def run_window(loop, win: Window, seconds: float, trace_units: int, dev, name: str):
    """Units until `seconds` have passed (the last one ends the window);
    with `trace_units`, stop after a traced run of that many units begun
    half-way through. Returns the number of units before the trace."""
    t0 = time.perf_counter()
    traced_from = None
    while True:
        elapsed = time.perf_counter() - t0
        if trace_units and elapsed >= seconds / 2:
            sync(dev)
            traced_from = win.units
            win.untraced_s = time.perf_counter() - t0
            with tracing.Traced(name, dev) as tr:
                for _ in range(trace_units):
                    _guarded(win, lambda: loop.unit(win))
            win.trace = tr.summary
            break
        _guarded(win, lambda: loop.unit(win))
        if not trace_units and time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    win.seconds = time.perf_counter() - t0
    return traced_from


class ReadContext:
    """What a per-layer reader reads: the loop's kind, the trace of `units`
    traced units, the host's dispatch spans and the wall seconds a unit of
    the untraced units before the trace (`unit_s`: the profiler slows the
    host, so a traced unit's wall time is not an untraced one's), and the
    traced views' work counts."""

    def __init__(self, kind, trace, dispatch_s, units, unit_s, work_counts):
        self.kind, self.trace, self.dispatch_s = kind, trace, dispatch_s
        self.units, self.unit_s, self.work = units, unit_s, work_counts

    least_seconds = staticmethod(work.least_seconds)


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -------------------------------------------------------------------- run

def run(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        t_process: Optional[float] = None, cell: Optional[Cell] = None) -> dict:
    """One run of a cell; returns the result line's object. `cell` and
    `device` let a test drive a reduced cell on the CPU."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = cell or Cell.load(workload)
    dev = torch.device(device)
    found = imports.forbidden_loaded()
    if found:
        raise SystemExit(f"JAX modules loaded in set-up: {found}")
    tr = cell.traffic
    loop = load_loop(tr["loop"])(cell, seed, dev)
    raw = loop.make_scene()
    views = loop.make_views()
    counts = loop.pair_counts(raw, views)
    I = pair_buffer(counts, tr["isect_headroom"])
    log(f"# pairs a view {min(counts)}-{max(counts)}, buffer {I}")
    loop.build(raw, views, I)
    del raw
    win = Window()
    setup = loop.setup_steps(win)
    sync(dev)
    setup_s = time.perf_counter() - t_process
    peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win.n_isect.clear()
    trace_units = tr["trace_units"] if trace else 0
    traced_from = run_window(loop, win, seconds, trace_units, dev, workload)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_isect = [int(x) for x in win.n_isect]
    over = sum(n > I for n in n_isect)
    win.failed += over
    log(f"# window {win.seconds:.3f} s, {win.units} units, pairs max "
        f"{max(n_isect) if n_isect else 0} of {I}, {over} over")
    for e in win.errors:
        log(f"# failed: {e}")

    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        unit_s = win.untraced_s / max(traced_from, 1)
        log(f"# traced {trace_units} units: {win.trace.window_s / trace_units * 1e3:.3f} ms a "
            f"unit against {unit_s * 1e3:.3f} untraced; device busy "
            f"{win.trace.busy_s / trace_units * 1e3:.3f} ms a unit")
        w = loop.traced_work(loop.traced_views(traced_from, trace_units))
        ctx = ReadContext(loop.KIND, win.trace, win.dispatch[:traced_from], trace_units,
                          unit_s, w)
        for m in cell.per_layer:
            v = load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": win.trace.device_ops(), "idle_gaps": win.trace.idle_gaps}
    else:
        done = max(win.units, 1)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        metrics[f"{loop.UNIT}_ms"] = {"value": win.seconds / done * 1e3, "unit": "ms"}
        if loop.UNIT == "view":
            lat = sorted(win.latencies)
            p95 = lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)] if lat else 0.0
            metrics["view_p95_ms"] = {"value": p95 * 1e3, "unit": "ms"}
        metrics["peak_mem_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}

    loop.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    found = imports.forbidden_loaded()
    if found:
        raise SystemExit(f"JAX modules loaded after the window: {found}")
    t_check = time.perf_counter()
    numbers = loop.compare(setup)
    log(f"# reference check {time.perf_counter() - t_check:.1f} s; run "
        f"{time.perf_counter() - t_process:.1f} s")
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    correct = bool(cell.limits) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": max(peak, peak_setup)}
    if trace:
        device_info["busy_s"] = win.trace.busy_s
        device_info["window_s"] = win.trace.window_s
    result = {"correct": correct, "attempted": win.units, "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
