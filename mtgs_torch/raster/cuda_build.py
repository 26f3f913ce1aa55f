"""Build and load the hand-written CUDA kernels in `mtgs_torch/csrc/`.

Each `.cu` file is compiled on first use by `nvcc` for `sm_90a` into a
shared library with a plain C interface, loaded through `ctypes`. The
library name carries a hash of the source, the shared headers and the
flags, so an edited source rebuilds and a fresh checkout builds from its
own sources. All sources build in parallel (one `nvcc` process each). Nothing here runs at
import time: the CPU tests import every module.

`LAUNCHES` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mtgs_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("blend_forward.cu", "expand_fused.cu", "blend_backward.cu", "segment_sum.cu",
           "expand_pairs.cu", "transpose.cu")

LAUNCHES: Dict[str, int] = dict.fromkeys((
    "blend_forward", "expand_fused", "blend_backward", "dense_segment_sum", "expand_pairs",
    "rows_to_attr_major", "attr_major_to_rows"), 0)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("mtgs_torch: no CUDA toolkit found (CUDA_HOME unset, "
                           "no nvcc on PATH); the kernels cannot be built")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    {source: library path}. nvcc's output (ptxas' registers and shared
    memory of each kernel) is kept beside each library as `.log`. Raises
    with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in sources}
    procs = {}
    for s, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for s, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {s} (exit {proc.returncode}) ---\n{log}")
            continue
        paths[s].with_suffix(".log").write_text(log)
        os.replace(tmp, paths[s])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("mtgs_torch: kernel build failed\n" + "\n".join(failed))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build([source])[source]))
            _LIBS[source] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"mtgs_torch: CUDA kernel {name} failed to launch "
                           f"(cudaError_t {err})")
