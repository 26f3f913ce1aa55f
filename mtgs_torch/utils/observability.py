"""Observability: metric writers, step timing, and trace tooling; port of
`mtgs_tpu/utils/observability.py`.

Replaces the reference's logging/profiling stack (OpenDriveLab/MTGS uses
nerfstudio's `writer` events routed to wandb/tensorboard/a rich local
writer, configured at `mtgs/config/MTGS.py:199-207`, plus a
`@profiler.time_function` decorator and rays/sec instrumentation at
`mtgs/scene_model/custom_pipeline.py:168-181`):

  * `LocalWriter` / `JsonlWriter` / `TensorboardWriter` / `MultiWriter` —
    the event sinks. Tensorboard uses `torch.utils.tensorboard` where it
    imports (it needs the tensorboard package) and is a no-op otherwise.
  * `StepTimer` — wall-clock per-step timing with EMA + rays/s.
  * `time_function` — accumulate wall time per label; `timing_summary()`
    to read it back.
  * `trace` / `summarize_trace` — wrap `torch.profiler.profile` (CPU and,
    where a card is present, CUDA activities), write its Chrome trace as
    `<logdir>/<name>.trace.json.gz`, and parse the newest such file into a
    per-event cost table. On a CUDA trace the kernel events carry the CUDA
    sources' kernel names (`blend_forward_kernel` of
    `csrc/blend_forward.cu`, ...), the torch operators their `aten::` names.

The writers, the timer and the summary give the JAX package's outputs on
the same inputs.
"""

from __future__ import annotations

import collections
import functools
import glob
import gzip
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

_TIMERS: Dict[str, List[float]] = collections.defaultdict(list)


# --------------------------------------------------------------- writers


class Writer:
    """Event-sink protocol: scalars keyed by (name, step)."""

    def put_scalar(self, name: str, value: float, step: int) -> None:
        raise NotImplementedError

    def put_dict(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.put_scalar(k, float(v), step)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class LocalWriter(Writer):
    """Compact stdout table every `steps_per_log` steps (ref: nerfstudio
    local writer with `steps_per_log=50`)."""

    def __init__(self, steps_per_log: int = 50, keys: Optional[Sequence[str]] = None):
        self.steps_per_log = steps_per_log
        self.keys = list(keys) if keys else None
        self._latest: Dict[str, float] = {}
        self._last_step = -1

    def put_scalar(self, name, value, step):
        self._latest[name] = value
        if step != self._last_step and step % self.steps_per_log == 0:
            self._last_step = step
            keys = self.keys or sorted(self._latest)
            parts = [f"step {step}"]
            parts += [f"{k}={self._latest[k]:.4g}" for k in keys if k in self._latest]
            print("  ".join(parts), flush=True)


class JsonlWriter(Writer):
    """One JSON object per logged step — the machine-readable log a
    benchmark harness aggregates."""

    def __init__(self, path: str, steps_per_log: int = 10):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self.steps_per_log = steps_per_log
        self._buf: Dict[str, float] = {}
        self._step = -1

    def put_scalar(self, name, value, step):
        if step != self._step:
            self._emit()
            self._step = step
        self._buf[name] = value

    def _emit(self):
        if self._buf and self._step % self.steps_per_log == 0:
            self._f.write(json.dumps({"step": self._step, **self._buf}) + "\n")
        self._buf = {}

    def flush(self):
        self._emit()
        self._f.flush()

    def close(self):
        self.flush()
        self._f.close()


class TensorboardWriter(Writer):
    """torch.utils.tensorboard sink; a no-op where it does not import."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._w = None
        else:
            self._w = SummaryWriter(logdir)

    def put_scalar(self, name, value, step):
        if self._w is not None:
            self._w.add_scalar(name, value, step)

    def flush(self):
        if self._w is not None:
            self._w.flush()


class MultiWriter(Writer):
    def __init__(self, writers: Sequence[Writer]):
        self.writers = list(writers)

    def put_scalar(self, name, value, step):
        for w in self.writers:
            w.put_scalar(name, value, step)

    def put_dict(self, values, step):
        for w in self.writers:
            w.put_dict(values, step)

    def flush(self):
        for w in self.writers:
            w.flush()


# ---------------------------------------------------------------- timing


class StepTimer:
    """Per-step wall time + EMA + rays/s (ref fps instrumentation,
    `custom_pipeline.py:168-181`). The caller makes the step's device work
    finish before `tick` (a sync), or the time is the host's dispatch."""

    def __init__(self, pixels_per_step: int = 0, ema: float = 0.9):
        self.pixels = pixels_per_step
        self.ema = ema
        self._t: Optional[float] = None
        self.step_ms: float = 0.0

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        out: Dict[str, float] = {}
        if self._t is not None:
            dt = now - self._t
            self.step_ms = (
                self.ema * self.step_ms + (1 - self.ema) * dt * 1e3
                if self.step_ms
                else dt * 1e3
            )
            out["step_ms"] = self.step_ms
            if self.pixels:
                out["rays_per_s"] = self.pixels / (self.step_ms * 1e-3)
        self._t = now
        return out


def time_function(fn: Optional[Callable] = None, *, label: Optional[str] = None):
    """Decorator accumulating wall time under `label` (ref
    `@profiler.time_function`). It times the host call: for work launched
    on a card it measures the enqueue plus whatever the body synchronizes
    on."""

    def wrap(f):
        name = label or f.__qualname__

        @functools.wraps(f)
        def inner(*a, **kw):
            t0 = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                _TIMERS[name].append(time.perf_counter() - t0)

        return inner

    return wrap(fn) if fn is not None else wrap


def timing_summary() -> Dict[str, Dict[str, float]]:
    return {
        k: {"calls": len(v), "total_s": sum(v), "mean_ms": sum(v) / len(v) * 1e3}
        for k, v in _TIMERS.items()
        if v
    }


def reset_timers() -> None:
    _TIMERS.clear()


# --------------------------------------------------------------- tracing


class trace:
    """Context manager around `torch.profiler.profile` writing a Chrome
    trace to `<logdir>/<name>.trace.json.gz` on exit (`path`); the name
    defaults to the start time in nanoseconds, so the newest trace sorts
    last. Where a card is present the CUDA activity is traced too and the
    card is synchronised before the profiler stops.

    Usage:
        with observability.trace("/tmp/trace"):
            step()
        for line in observability.summarize_trace("/tmp/trace"): print(line)
    """

    def __init__(self, logdir: str, name: Optional[str] = None):
        self.logdir = logdir
        self.name = name
        self.path: Optional[str] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * self._cuda
        name = self.name or f"{time.time_ns():020d}"
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(self.logdir, f"{name}.trace.json.gz")
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self._prof.export_chrome_trace(self.path)
        return False


def summarize_trace(
    logdir: str, top: int = 30, iters: int = 1
) -> List[Tuple[float, int, str]]:
    """Parse the newest `*.trace.json.gz` under `logdir` into
    [(total_ms/iters, count/iters, event name)], heaviest first. Kernel
    names are those of the CUDA sources (`csrc/*.cu`) and of torch's own
    kernels; operator names are torch's (`aten::sort`, ...)."""
    files = sorted(glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True))
    if not files:
        return []
    with gzip.open(files[-1]) as f:
        events = json.load(f)["traceEvents"]
    dur: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            dur[e.get("name", "?")] += e["dur"]
            cnt[e.get("name", "?")] += 1
    out = [
        (d / 1000.0 / iters, cnt[name] // iters, name)
        for name, d in dur.items()
    ]
    out.sort(reverse=True)
    return out[:top]
