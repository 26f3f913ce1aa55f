"""The traced sub-window and its reduction.

`torch.profiler` records a few steps or views in the middle of a
`--trace 1` run with the device's activity alone (CUPTI's kernels, copies,
fills and the CUDA runtime calls): recording the host's operators as well
slowed a traced unit by up to two thirds, which a window's idle share
would read as the card waiting. The Chrome trace goes to the run's TMPDIR
and is read back into what the per-layer readers take: the traced
window's length on the host's clock (from the profiler's start to the
last unit's end, synchronized), the seconds some operation ran on the
device (the union of kernels, copies and fills), kernel time and count by
name, and the idle gaps between device work, named by the blocking CUDA
runtime call the host was in when a gap began or, where it was in none,
by the device operation that ended the gap.
"""

import bisect
import collections
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BLOCKING = ("Synchronize", "Memcpy", "cudaFree", "cudaMalloc")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]          # name -> (seconds, count)
    idle_gaps: List[Tuple[str, float]]             # host op -> gap seconds, longest first

    def kernel_seconds(self, patterns) -> float:
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(p in name for p in patterns))

    @property
    def launches(self) -> int:
        return sum(c for _, c in self.kernels.values())

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """The kernels that took most device time, by a short name (the
        signature's parameter list cut off)."""
        total: Dict[str, float] = collections.Counter()
        for name, (sec, _) in self.kernels.items():
            total[short_name(name)] += sec
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]


def short_name(name: str, width: int = 160) -> str:
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # cut at the parameter list's "(" outside templates
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


class Traced:
    """Context manager: profile the device's activity in the code inside
    it (on a machine without a card the host's, so the run still goes
    through). `summary` holds the reduction afterwards."""

    def __init__(self, name: str, dev: torch.device):
        self.dev = torch.device(dev)
        self.path = os.path.join(tempfile.gettempdir(), "bench_port_traces",
                                 f"{name}.trace.json")
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        cuda = self.dev.type == "cuda"
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
            self.summary = summarize(self.path, window_s)
        return False


def summarize(path: str, window_s: float) -> TraceSummary:
    """Reduce a Chrome trace written by `Traced` (times in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e.get("cat"), e.get("name", "?"))
                 for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    busy, gaps, end = 0.0, [], None
    for s, t, cat, name in dev:
        if cat == "kernel":
            kernels[name][0] += (t - s) * 1e-6
            kernels[name][1] += 1
        if end is not None and s > end:
            gaps.append((end, s, name))
        if end is None or t > end:
            busy += t - (s if end is None else max(s, end))
            end = t
    return TraceSummary(window_s=window_s, busy_s=busy * 1e-6,
                        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                        idle_gaps=_name_gaps(events, gaps))


def _name_gaps(events, gaps, top: int = 10):
    """Idle seconds between device operations by the blocking runtime call
    the host was in where each gap began, else by the operation that ended
    it ("before <op>"), the largest totals first."""
    calls = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "?")) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                   and any(b in e.get("name", "") for b in BLOCKING))
    starts = [c[0] for c in calls]
    total: Dict[str, float] = collections.Counter()
    for g0, g1, after in gaps:
        i = bisect.bisect_right(starts, g0)
        name = f"before {short_name(after, 120)}"
        if i and calls[i - 1][1] >= g0:
            name = calls[i - 1][2]
        total[name] += (g1 - g0) * 1e-6
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]
