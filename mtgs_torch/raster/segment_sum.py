"""Per-gaussian segment sum: CUDA kernel wrapper + plain twin.

Port of `mtgs_tpu/raster/segment_sum.py::dense_segment_sum` (the kernel,
`csrc/segment_sum.cu`). The rasterizer's backward has one gradient row
set per (gaussian, tile) slot in slot order; this reduces them to one
column per gaussian. Input: rows_t f32 [W, I] and src i32 [I], the owner
of each slot, non-decreasing with values in [0, n] (n is the sentinel of
dead slots, whose rows are zero). Output: f32 [W, n + 1], column g the sum
of the slots owned by g, and the sentinel column n zero (the JAX function
pads its output further; only its first n + 1 columns carry values).
"""

from __future__ import annotations

import ctypes

import torch

from mtgs_torch.raster import cuda_build


def _lib():
    fn = cuda_build.load("segment_sum.cu").mtgs_dense_segment_sum
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, ctypes.c_longlong, p, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(rows_t, src, n):
    if rows_t.dtype != torch.float32 or rows_t.ndim != 2 or not rows_t.is_contiguous():
        raise ValueError("rows_t must be a contiguous float32 [W, I] tensor")
    if src.dtype != torch.int32 or src.shape != (rows_t.shape[1],) or src.device != rows_t.device:
        raise ValueError(f"src must be int32 [{rows_t.shape[1]}] on the rows' device")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")


def dense_segment_sum(rows_t: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    """The segment sum: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. `src` must be non-decreasing (not checked:
    that would cost a device sync)."""
    _check_inputs(rows_t, src, n)
    if rows_t.device.type == "cpu":
        return dense_segment_sum_plain(rows_t, src, n)
    if rows_t.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_t.device}")
    W, I = rows_t.shape
    out = torch.empty((W, n + 1), dtype=torch.float32, device=rows_t.device)
    src = src.contiguous()
    err = _lib()(rows_t.data_ptr(), W, I, src.data_ptr(), n + 1, out.data_ptr(),
                 torch.cuda.current_stream(rows_t.device).cuda_stream)
    cuda_build.check(err, "dense_segment_sum")
    cuda_build.LAUNCHES["dense_segment_sum"] += 1
    return out


def dense_segment_sum_plain(rows_t: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    """`index_add_` of every slot's rows into its owner's column."""
    out = torch.zeros((rows_t.shape[0], n + 1), dtype=torch.float32, device=rows_t.device)
    return out.index_add_(1, src.to(torch.int64), rows_t)
