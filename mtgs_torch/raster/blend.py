"""Per-tile forward alpha blend: CUDA kernel wrapper + plain twin.

Port of `mtgs_tpu/raster/blend_pallas.py::blend_forward_pallas` (the
kernel, `csrc/blend_forward.cu`) and `blend_xla.py::blend_forward_xla`
(the plain version, `blend_forward_plain`). Both keep the JAX signature:
an attribute-major slab [W >= 6 + c_total, cap] whose rows are mx, my,
conic a, b, c, opacity, colours; per-tile 128-aligned window starts
`tile_offsets`, `tile_heads` (first live lane), `tile_counts` and
`tile_nchunks`. Each tile blends slab columns
[offset + head, offset + head + count) front to back.

Returns (rgb_tiles [T, c_total, PIX], t_final [T, PIX]).
"""

from __future__ import annotations

import ctypes

import torch

from mtgs_torch.raster import cuda_build
from mtgs_torch.raster.chunk_math import (
    CHUNK, LOG_T_EPS, MAX_CH, NUM_GEOM, forward_chunk, pixel_features,
)

_SOURCE = "blend_forward.cu"
_TILE_GROUP = 128  # tiles per step of the plain version (bounds its temporaries)


def _lib():
    lib = cuda_build.load(_SOURCE)
    fn = lib.mtgs_blend_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(slab_t, ranges, c_total):
    if slab_t.dtype != torch.float32 or slab_t.ndim != 2 or not slab_t.is_contiguous():
        raise ValueError("slab_t must be a contiguous float32 [W, cap] tensor")
    if slab_t.shape[0] < NUM_GEOM + c_total:
        raise ValueError(f"slab_t has {slab_t.shape[0]} rows < 6 + c_total ({c_total})")
    if not 1 <= c_total <= MAX_CH:
        raise ValueError(f"c_total must be in [1, {MAX_CH}], got {c_total}")
    T = ranges[0].shape[0]
    for r in ranges:
        if r.dtype != torch.int32 or r.shape != (T,) or r.device != slab_t.device:
            raise ValueError("tile ranges must be int32 [num_tiles] tensors on "
                             "the slab's device")


def blend_forward(slab_t, tile_offsets, tile_heads, tile_counts, tile_nchunks, *,
                  tile_size: int, tiles_x: int, c_total: int, tile_base: int = 0):
    """The forward blend: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    ranges = (tile_offsets, tile_heads, tile_counts, tile_nchunks)
    _check_inputs(slab_t, ranges, c_total)
    if slab_t.device.type == "cpu":
        return blend_forward_plain(
            slab_t, *ranges, tile_size=tile_size, tiles_x=tiles_x,
            c_total=c_total, tile_base=tile_base)
    if slab_t.device.type != "cuda":
        raise ValueError(f"unsupported device {slab_t.device}")
    if tile_size not in (16, 32):
        raise ValueError(f"the CUDA blend takes tile_size 16 or 32, got {tile_size}")
    T = tile_offsets.shape[0]
    P = tile_size * tile_size
    rgb = torch.empty((T, c_total, P), dtype=torch.float32, device=slab_t.device)
    t_final = torch.empty((T, P), dtype=torch.float32, device=slab_t.device)
    ranges = [r.contiguous() for r in ranges]
    err = _lib()(
        slab_t.data_ptr(), slab_t.shape[1], ranges[0].data_ptr(),
        ranges[1].data_ptr(), ranges[2].data_ptr(), T, tile_size, tiles_x,
        int(tile_base), c_total, rgb.data_ptr(), t_final.data_ptr(),
        torch.cuda.current_stream(slab_t.device).cuda_stream,
    )
    cuda_build.check(err, "blend_forward")
    cuda_build.LAUNCHES["blend_forward"] += 1
    return rgb, t_final


def blend_forward_plain(slab_t, tile_offsets, tile_heads, tile_counts, tile_nchunks,
                        *, tile_size: int, tiles_x: int, c_total: int,
                        tile_base: int = 0, stats=None):
    """chunk_math's forward, vectorised over tiles, looping over chunks.

    Tiles are processed _TILE_GROUP at a time to bound the [A, PIX,
    CHUNK] temporaries; a tile drops out once its chunks are done or all
    of its pixels are saturated (later chunks would add exact zeros).
    `stats`: optional dict, see `chunk_math.forward_chunk`.
    """
    dev = slab_t.device
    T = tile_offsets.shape[0]
    P = tile_size * tile_size
    nw = NUM_GEOM + c_total
    cap = slab_t.shape[1]
    F = pixel_features(tile_size, dev)
    tid = tile_base + torch.arange(T, device=dev)
    ox = ((tid % tiles_x) * tile_size).to(torch.float32)
    oy = ((tid // tiles_x) * tile_size).to(torch.float32)
    log_t_all = torch.zeros((T, P), dtype=torch.float32, device=dev)
    log_t_out = torch.zeros((T, P), dtype=torch.float32, device=dev)
    rgb = torch.zeros((T, c_total, P), dtype=torch.float32, device=dev)
    nchunks = tile_nchunks.to(torch.int64)
    lanes = torch.arange(CHUNK, device=dev)
    k = 0
    while True:
        active = (nchunks > k) & (log_t_all.amax(dim=1) > LOG_T_EPS)
        idx = active.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        for g in range(0, idx.numel(), _TILE_GROUP):
            ti = idx[g:g + _TILE_GROUP]
            base = tile_offsets[ti].to(torch.int64) + k * CHUNK
            cols = torch.clamp(base[:, None] + lanes, max=cap - 1)
            lo = tile_heads[ti] - k * CHUNK
            a, o, r = forward_chunk(
                slab_t[:nw, cols], ox[ti], oy[ti], F, lo, lo + tile_counts[ti],
                log_t_all[ti], log_t_out[ti], rgb[ti], stats)
            log_t_all[ti], log_t_out[ti], rgb[ti] = a, o, r
        k += 1
    return rgb, torch.exp(log_t_out)
