"""Classic pair expansion: CUDA kernel wrapper.

Port of `mtgs_tpu/raster/expand_pallas.py::expand_pairs` (the kernel,
`csrc/expand_pairs.cu`); its plain version is
`binning.searchsorted_expand`. For every depth-order pair slot s < I: the
owner src (the last depth-sorted gaussian with offsets[src] <= s, clamped
to [0, N-1]) and its tile, decoded from the owner's span word; slots
s >= total get the sentinel tile `num_tiles`, which sorts past every
tile's range.

Inputs: depth-sorted `offsets` (exclusive pair-count prefix) and `packed`
span words, int32 [N]; `total`, a one-element int32 tensor (the
untruncated pair count). Returns (tile, src), int32 [I], equal on every
slot to `searchsorted_expand`, dead slots included.
"""

from __future__ import annotations

import ctypes

import torch

from mtgs_torch.raster import cuda_build


def _lib():
    fn = cuda_build.load("expand_pairs.cu").mtgs_expand_pairs
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(offsets, packed, total, max_intersections):
    n = offsets.shape[0] if offsets.ndim == 1 else 0
    if n < 1:
        raise ValueError("expand_pairs needs at least one gaussian")
    for name, a in (("offsets", offsets), ("packed", packed)):
        if a.dtype != torch.int32 or a.shape != (n,) or a.device != offsets.device:
            raise ValueError(f"{name} must be int32 [{n}] on the offsets' device")
    if total.dtype != torch.int32 or total.numel() != 1 or total.device != offsets.device:
        raise ValueError("total must be a one-element int32 tensor on the offsets' device")
    if not 0 <= max_intersections < (1 << 31):
        raise ValueError(f"max_intersections must be in [0, 2^31), got {max_intersections}")


def expand_pairs(offsets, packed, total, max_intersections: int, *, tiles_x: int,
                 num_tiles: int):
    """The pair expansion: the CUDA kernel for CUDA tensors, the plain
    version (`binning.searchsorted_expand`) for CPU tensors."""
    _check_inputs(offsets, packed, total, max_intersections)
    if offsets.device.type == "cpu":
        # imported here: binning imports this module
        from mtgs_torch.raster.binning import searchsorted_expand

        return searchsorted_expand(offsets, packed, total, max_intersections,
                                   tiles_x=tiles_x, num_tiles=num_tiles)
    if offsets.device.type != "cuda":
        raise ValueError(f"unsupported device {offsets.device}")
    dev = offsets.device
    I = max_intersections
    tile = torch.empty((I,), dtype=torch.int32, device=dev)
    src = torch.empty((I,), dtype=torch.int32, device=dev)
    offsets, packed, total = offsets.contiguous(), packed.contiguous(), total.contiguous()
    err = _lib()(
        offsets.data_ptr(), packed.data_ptr(), offsets.shape[0], total.data_ptr(), I,
        tiles_x, num_tiles, tile.data_ptr(), src.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(err, "expand_pairs")
    cuda_build.LAUNCHES["expand_pairs"] += 1
    return tile, src
