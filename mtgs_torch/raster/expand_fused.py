"""Fused pair expansion: CUDA kernel wrapper + plain twin.

Port of `mtgs_tpu/raster/expand_fused.py::expand_fused`. For every pair
slot s < I in depth order: the owner j (the depth-sorted gaussian with
offsets[j] <= s < offsets[j+1]), the sort key `tile << slot_bits | s`
(dead slots s >= total get tile `num_tiles`), `src = j`, and an exact
copy of the owner's nw attribute columns.

Inputs: the depth-sorted table attribute-major, f32 [nw, n] (the first
nw rows of the JAX kernel's `tab_am`); depth-sorted `offsets` (exclusive
pair-count prefix) and `packed` span words, i32 [n]; `total`, a 0-d i32
tensor (the untruncated pair count). Returns (key [I] i32, src [I] i32,
attrs [round8(nw), I] f32) with zero pad rows — the JAX output contract,
dead slots included.
"""

from __future__ import annotations

import ctypes

import torch

from mtgs_torch.raster import cuda_build
from mtgs_torch.raster.chunk_math import round8

B = 256       # the TPU kernel's pair slots per grid step
ALIGN = 128   # table-window anchor alignment
WINA = 384    # table-window width
_SOURCE = "expand_fused.cu"


def slot_bits(max_intersections: int) -> int:
    return max(1, (max_intersections - 1).bit_length())


def fused_fits(max_intersections: int, num_tiles: int, n_gauss: int) -> bool:
    """Static gate of the JAX fused path: (tile << SB | slot) must fit in a
    positive int32 and slot / gaussian indices stay below 2^24."""
    sb = slot_bits(max_intersections)
    return (
        max_intersections % B == 0
        and max_intersections < (1 << 24)
        and n_gauss < (1 << 24)
        and ((num_tiles + 1) << sb) + max_intersections < (1 << 31)
    )


def _lib():
    lib = cuda_build.load(_SOURCE)
    fn = lib.mtgs_expand_fused
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, p, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(table, offsets, packed, total, max_intersections, num_tiles):
    if table.dtype != torch.float32 or table.ndim != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous float32 [nw, n] tensor")
    n = table.shape[1]
    if n < 1:
        raise ValueError("expand_fused needs at least one gaussian")
    for name, a in (("offsets", offsets), ("packed", packed)):
        if a.dtype != torch.int32 or a.shape != (n,) or a.device != table.device:
            raise ValueError(f"{name} must be int32 [{n}] on the table's device")
    if total.dtype != torch.int32 or total.numel() != 1 or total.device != table.device:
        raise ValueError("total must be a one-element int32 tensor on the table's device")
    if not fused_fits(max_intersections, num_tiles, n):
        raise ValueError(
            f"fused expansion does not fit (max_intersections={max_intersections}, "
            f"num_tiles={num_tiles}, n={n}): rasterize takes the classic path there")


def expand_fused(table, offsets, packed, total, max_intersections: int, *,
                 tiles_x: int, num_tiles: int):
    """The pair expansion: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_inputs(table, offsets, packed, total, max_intersections, num_tiles)
    if table.device.type == "cpu":
        return expand_fused_plain(table, offsets, packed, total, max_intersections,
                                  tiles_x=tiles_x, num_tiles=num_tiles)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    nw, n = table.shape
    I = max_intersections
    w_out = round8(nw)
    dev = table.device
    key = torch.empty((I,), dtype=torch.int32, device=dev)
    src = torch.empty((I,), dtype=torch.int32, device=dev)
    attrs = torch.empty((w_out, I), dtype=torch.float32, device=dev)
    offsets, packed, total = offsets.contiguous(), packed.contiguous(), total.contiguous()
    err = _lib()(
        table.data_ptr(), nw, n, offsets.data_ptr(), packed.data_ptr(),
        total.data_ptr(), I, slot_bits(I), tiles_x, num_tiles, w_out,
        key.data_ptr(), src.data_ptr(), attrs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(err, "expand_fused")
    cuda_build.LAUNCHES["expand_fused"] += 1
    return key, src, attrs


def expand_fused_plain(table, offsets, packed, total, max_intersections: int, *,
                       tiles_x: int, num_tiles: int):
    """searchsorted + gathers (the formulation of the JAX package's
    `binning.searchsorted_expand`), with the TPU kernel's dead-slot values."""
    nw, n = table.shape
    I = max_intersections
    dev = table.device
    slot = torch.arange(I, dtype=torch.int32, device=dev)
    j = torch.searchsorted(offsets, slot, right=True, out_int32=True) - 1
    j = torch.clamp(j, 0, n - 1)
    pk = packed[j]
    local = slot - offsets[j]
    span_x = torch.clamp(pk >> 22, min=1)
    ly = torch.div(local, span_x, rounding_mode="floor")
    lx = local - ly * span_x
    tile = (((pk >> 11) & 0x7FF) + ly) * tiles_x + (pk & 0x7FF) + lx
    live = slot < total.reshape(())
    tile = torch.where(live, tile, torch.full_like(tile, num_tiles))
    # a dead slot copies gaussian n-1 only when it lies in the 384-column
    # table window the TPU kernel loaded for the slot's 256-slot block
    block0 = (slot // B) * B
    g = torch.clamp(torch.searchsorted(offsets, block0, right=True, out_int32=True) - 1,
                    0, n - 1)
    owned = live | ((n - 1) < (g // ALIGN) * ALIGN + WINA)
    key = (tile << slot_bits(I)) | slot
    src = torch.where(owned, j, torch.zeros_like(j))
    attrs = torch.zeros((round8(nw), I), dtype=torch.float32, device=dev)
    attrs[:nw] = torch.where(owned, table[:, j], torch.zeros((), device=dev))
    return key.to(torch.int32), src, attrs
