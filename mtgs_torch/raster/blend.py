"""Per-tile alpha blend, forward and backward, and the slab transposes:
CUDA kernel wrappers + plain twins.

Port of `mtgs_tpu/raster/blend_pallas.py::blend_forward_pallas` and
`blend_backward_pallas` (the kernels, `csrc/blend_forward.cu` and
`csrc/blend_backward.cu`) and `blend_xla.py::blend_forward_xla` /
`blend_backward_xla` (the plain versions). All keep the JAX signature:
an attribute-major slab [W >= 6 + c_total, cap] whose rows are mx, my,
conic a, b, c, opacity, colours; per-tile 128-aligned window starts
`tile_offsets`, `tile_heads` (first live lane), `tile_counts` and
`tile_nchunks`. Each tile blends slab columns
[offset + head, offset + head + count) front to back.

The forward returns (rgb_tiles [T, c_total, PIX], t_final [T, PIX]);
the backward the per-intersection gradients g_slab_t [W, cap] (rows g_mx,
g_my, g_cA, g_cB, g_cC, g_opac, g_colours), zero wherever no pixel
composited the intersection: slack slots, slots past a tile's early exit
and lanes outside every tile's range.

The classic path builds the slab from gathered per-slot rows and turns
the per-gaussian gradient sums back into rows with two transposes, ports
of `blend_pallas.py::rows_to_attr_major` and `attr_major_to_rows` (the
kernels, `csrc/transpose.cu`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mtgs_torch.raster import cuda_build
from mtgs_torch.raster.chunk_math import (
    CHUNK, LOG_T_EPS, MAX_CH, NUM_GEOM, backward_chunk, forward_chunk, pixel_features, round8,
)

_TILE_GROUP = 128  # tiles per step of the plain versions (bounds their temporaries)


def _lib():
    fn = cuda_build.load("blend_forward.cu").mtgs_blend_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _lib_backward():
    fn = cuda_build.load("blend_backward.cu").mtgs_blend_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, i, p, p, p, p, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _lib_transpose(name):
    fn = getattr(cuda_build.load("transpose.cu"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, ctypes.c_longlong, i, i, p, p] if name == "mtgs_rows_to_attr_major"
                       else [p, ctypes.c_longlong, i, p, p])
        fn.restype = ctypes.c_int
    return fn


_MAX_TRANSPOSE_W = 32  # csrc/transpose.cu's kMaxW


def _check_2d(a, name):
    if a.dtype != torch.float32 or a.ndim != 2 or not a.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 2-d tensor")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def rows_to_attr_major(rows: torch.Tensor) -> torch.Tensor:
    """[cap, W] slot rows -> [round8(W), cap] attribute-major, pad rows
    zero: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Any cap; W <= 32 on the card."""
    _check_2d(rows, "rows")
    if rows.device.type == "cpu":
        return rows_to_attr_major_plain(rows)
    cap, w = rows.shape
    if not 1 <= w <= _MAX_TRANSPOSE_W:
        raise ValueError(f"the CUDA transpose takes 1 <= W <= {_MAX_TRANSPOSE_W}, got {w}")
    out = torch.empty((round8(w), cap), dtype=torch.float32, device=rows.device)
    err = _lib_transpose("mtgs_rows_to_attr_major")(
        rows.data_ptr(), cap, w, out.shape[0], out.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    cuda_build.check(err, "rows_to_attr_major")
    cuda_build.LAUNCHES["rows_to_attr_major"] += 1
    return out


def rows_to_attr_major_plain(rows: torch.Tensor) -> torch.Tensor:
    w = rows.shape[1]
    return F.pad(rows, (0, round8(w) - w)).t().contiguous()


def attr_major_to_rows(attrs: torch.Tensor) -> torch.Tensor:
    """[W, cap] attribute-major -> [cap, W] rows: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Any cap; W <= 32 on the
    card."""
    _check_2d(attrs, "attrs")
    if attrs.device.type == "cpu":
        return attr_major_to_rows_plain(attrs)
    w, cap = attrs.shape
    if not 1 <= w <= _MAX_TRANSPOSE_W:
        raise ValueError(f"the CUDA transpose takes 1 <= W <= {_MAX_TRANSPOSE_W}, got {w}")
    out = torch.empty((cap, w), dtype=torch.float32, device=attrs.device)
    err = _lib_transpose("mtgs_attr_major_to_rows")(
        attrs.data_ptr(), cap, w, out.data_ptr(),
        torch.cuda.current_stream(attrs.device).cuda_stream)
    cuda_build.check(err, "attr_major_to_rows")
    cuda_build.LAUNCHES["attr_major_to_rows"] += 1
    return out


def attr_major_to_rows_plain(attrs: torch.Tensor) -> torch.Tensor:
    return attrs.t().contiguous()


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


def tile_order(tile_counts: torch.Tensor) -> torch.Tensor:
    """The tiles in descending `tile_counts` order, ties in index order
    (int32): both blend kernels launch their blocks in this order. The
    card holds a fraction of the grid's blocks at once, and a deep tile
    started last would run on alone."""
    return torch.argsort(tile_counts, descending=True, stable=True).to(torch.int32)


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
    order = tile_order(tile_counts)
    err = _lib()(
        slab_t.data_ptr(), slab_t.shape[1], ranges[0].data_ptr(),
        ranges[1].data_ptr(), ranges[2].data_ptr(), order.data_ptr(), T, tile_size,
        tiles_x, int(tile_base), c_total, rgb.data_ptr(), t_final.data_ptr(),
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


def blend_forward_work(stats: dict, c_total: int, tiles: int, n_pix: int):
    """(bytes, operations) the forward blend of some inputs needs at least,
    from `blend_forward_plain`'s `stats` on them (T tiles, n_pix = T * PIX
    pixels). Bytes: the slab columns the early exit must read (per tile,
    those up to the furthest intersection any of its pixels evaluates),
    the ranges, and rgb and t_final written once. Operations: per
    evaluated (pixel, intersection) inside the splat's 1/255 support
    (outside it none is needed) sigma 11, exp and scale 3; per composited
    one clamp, log1p, sum, exp, weight, c_total FMAs, log sum."""
    nbytes = 4 * ((NUM_GEOM + c_total) * stats["pairs_read"] + 3 * tiles
                  + (c_total + 1) * n_pix)
    ops = 14 * stats["pair_support"] + (6 + 2 * c_total) * stats["pair_blends"]
    return nbytes, ops


def blend_backward_work(stats: dict, c_total: int, tiles: int, n_pix: int, grad_elems: int):
    """(bytes, operations) the backward blend's replay of some inputs needs
    at least, from `blend_forward_plain`'s `stats` on the same inputs (the
    pairs the replay reaches). Bytes: read the slab columns up to each
    tile's last evaluated one, the ranges, rgb, t_final and both
    cotangents; write the whole zero-initialised gradient slab
    (`grad_elems`). Operations: per evaluated pair inside the splat's 1/255
    support the forward's 14 (sigma, exp, scale: a pixel outside it needs
    no evaluation, as the kernel's support boxes show); per composited
    one: clamp, log1p, log sum, exp and weight 5, gdot 2 c, the running w
    gdot, 1 / (1 - alpha) and ga 10, the colour sums 2 c, and where alpha
    was not clamped g_sigma with the five centred moments 13 and g_opac 2."""
    nw = NUM_GEOM + c_total
    nbytes = 4 * (nw * stats["pairs_read"] + 3 * tiles + (2 * c_total + 2) * n_pix + grad_elems)
    ops = (14 * stats["pair_support"] + (30 + 4 * c_total) * stats["pair_blends"]
           - 15 * stats["pair_clamped"])
    return nbytes, ops


def _check_backward_inputs(slab_t, ranges, rgb_tiles, t_final, g_rgb, g_t, c_total, P):
    _check_inputs(slab_t, ranges, c_total)
    T = ranges[0].shape[0]
    for name, a, shape in (("rgb_tiles", rgb_tiles, (T, c_total, P)), ("t_final", t_final, (T, P)),
                           ("g_rgb", g_rgb, (T, c_total, P)), ("g_t", g_t, (T, P))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape or a.device != slab_t.device:
            raise ValueError(f"{name} must be float32 {list(shape)} on the slab's device")


def blend_backward(slab_t, tile_offsets, tile_heads, tile_counts, tile_nchunks,
                   rgb_tiles, t_final, g_rgb, g_t, *, tile_size: int, tiles_x: int,
                   c_total: int, tile_base: int = 0):
    """The backward blend: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns g_slab_t [W, cap], zero-initialised.
    Tile t of the ranges is global tile `tile_base + t` (the first tile of
    a sharded render's band), which sets its pixel origin."""
    ranges = (tile_offsets, tile_heads, tile_counts, tile_nchunks)
    P = tile_size * tile_size
    _check_backward_inputs(slab_t, ranges, rgb_tiles, t_final, g_rgb, g_t, c_total, P)
    if slab_t.device.type == "cpu":
        return blend_backward_plain(
            slab_t, *ranges, rgb_tiles, t_final, g_rgb, g_t, tile_size=tile_size,
            tiles_x=tiles_x, c_total=c_total, tile_base=tile_base)
    if slab_t.device.type != "cuda":
        raise ValueError(f"unsupported device {slab_t.device}")
    if tile_size not in (16, 32):
        raise ValueError(f"the CUDA blend takes tile_size 16 or 32, got {tile_size}")
    W, cap = slab_t.shape
    T = tile_offsets.shape[0]
    g_slab = torch.zeros((W, cap), dtype=torch.float32, device=slab_t.device)
    ranges = [r.contiguous() for r in ranges]
    dense = [a.contiguous() for a in (rgb_tiles, t_final, g_rgb, g_t)]
    order = tile_order(tile_counts)
    err = _lib_backward()(
        slab_t.data_ptr(), cap, W, ranges[0].data_ptr(), ranges[1].data_ptr(),
        ranges[2].data_ptr(), order.data_ptr(), T, tile_size, tiles_x, int(tile_base),
        c_total, *(a.data_ptr() for a in dense), g_slab.data_ptr(),
        torch.cuda.current_stream(slab_t.device).cuda_stream,
    )
    cuda_build.check(err, "blend_backward")
    cuda_build.LAUNCHES["blend_backward"] += 1
    return g_slab


def blend_backward_plain(slab_t, tile_offsets, tile_heads, tile_counts, tile_nchunks,
                         rgb_tiles, t_final, g_rgb, g_t, *, tile_size: int,
                         tiles_x: int, c_total: int, tile_base: int = 0):
    """chunk_math's backward replay, vectorised over tiles, looping over
    chunks; a tile drops out once its chunks are done or all of its pixels
    are saturated (later chunks have exactly zero gradients). Each tile's
    in-range lanes are written to their slab columns; the rest of the
    output stays zero."""
    dev = slab_t.device
    T = tile_offsets.shape[0]
    W, cap = slab_t.shape
    nw = NUM_GEOM + c_total
    F = pixel_features(tile_size, dev)
    tid = tile_base + torch.arange(T, device=dev)
    ox = ((tid % tiles_x) * tile_size).to(torch.float32)
    oy = ((tid // tiles_x) * tile_size).to(torch.float32)
    P = tile_size * tile_size
    log_t_all = torch.zeros((T, P), dtype=torch.float32, device=dev)
    wg_cum = torch.zeros((T, P), dtype=torch.float32, device=dev)
    total_dot = (g_rgb * rgb_tiles).sum(dim=1)
    out = torch.zeros((W, cap), dtype=torch.float32, device=dev)
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
            cols = tile_offsets[ti].to(torch.int64)[:, None] + k * CHUNK + lanes
            lo = tile_heads[ti] - k * CHUNK
            hi = lo + tile_counts[ti]
            g_chunk, a, s = backward_chunk(
                slab_t[:nw, torch.clamp(cols, max=cap - 1)], ox[ti], oy[ti], F, lo, hi,
                g_rgb[ti], g_t[ti], t_final[ti], total_dot[ti],
                log_t_all[ti], wg_cum[ti])
            log_t_all[ti], wg_cum[ti] = a, s
            keep = (lanes >= lo[:, None]) & (lanes < hi[:, None])
            out[:nw, cols[keep]] = g_chunk[:, keep]
        k += 1
    return out
