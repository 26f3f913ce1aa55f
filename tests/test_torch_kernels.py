"""The CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU with nvcc and skip on the CPU. The machine
with the card has no JAX, so this file imports neither JAX nor mtgs_tpu,
and it is run there without the repo's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

It also holds the numpy input generators and the blend comparison rule
that the CPU parity tests (test_torch_blend.py, test_torch_expand.py) use.
"""

import numpy as np
import pytest
import torch

from mtgs_torch.raster import cuda_build
from mtgs_torch.raster.binning import padded_capacity, searchsorted_expand
from mtgs_torch.raster.blend import (
    attr_major_to_rows, attr_major_to_rows_plain, blend_backward, blend_backward_plain,
    blend_forward, blend_forward_plain, rows_to_attr_major, rows_to_attr_major_plain,
)
from mtgs_torch.raster.chunk_math import CHUNK, NUM_GEOM
from mtgs_torch.raster.expand_fused import expand_fused, expand_fused_plain
from mtgs_torch.raster.expand_pairs import expand_pairs
from mtgs_torch.raster.segment_sum import dense_segment_sum, dense_segment_sum_plain

TOL = 1e-4       # blend: f32 rounding of the same formulation
FLIP_TOL = 2e-3  # blend: a pixel where a cut-off flips (golden tolerance)
GRAD_TOL = 2e-4  # blend backward: each gradient row's error over its largest |value|
SEGMENT_TOL = 1e-5  # segment sum: each row's error over its largest |value|


def make_expand_inputs(seed, *, n_live, n_dead, nw, tiles_x, tiles_y, zero_runs=()):
    """Depth-sorted inputs as the rasterizer builds them: live gaussians
    own >= 1 pair each, zero-pair gaussians form the tail. `zero_runs`,
    (start, length) pairs, also empty runs of gaussians inside the live
    range, as no rasterizer input has them (the plain versions and the
    kernels must stay exact there all the same)."""
    rng = np.random.default_rng(seed)
    n = n_live + n_dead
    tmin_x = rng.integers(0, tiles_x, n)
    tmin_y = rng.integers(0, tiles_y, n)
    span_x = np.minimum(1 + (rng.random(n) * (tiles_x - tmin_x)).astype(np.int64), 3)
    span_y = np.minimum(1 + (rng.random(n) * (tiles_y - tmin_y)).astype(np.int64), 3)
    counts = (span_x * span_y).astype(np.int32)
    counts[n_live:] = 0
    for start, length in zero_runs:
        counts[start:start + length] = 0
    packed = (tmin_x | (tmin_y << 11) | (span_x << 22)).astype(np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    total = np.int32(counts.sum())
    table = rng.normal(size=(nw, n)).astype(np.float32)
    return table, offsets, packed, total


def make_blend_inputs(seed, *, tiles_x, tiles_y, tile_size, c_total,
                      max_per_tile=300, deep_tiles=(), empty_tiles=(), faint_tiles=(),
                      faint_count=5000, half_tiles=()):
    """Random tile-sorted slab [round8(6 + c_total), cap] and per-tile
    ranges in the rasterizer's layout: tile runs are consecutive from an
    unaligned first start. `deep_tiles` get many near-opaque splats
    covering the tile (their pixels saturate and the tile exits early);
    `faint_tiles` get `faint_count` splats of opacity 0.005-0.02 covering
    the tile, as after an opacity reset (each pixel composites thousands
    of them before it saturates, if it does); `half_tiles` get 700
    near-opaque splats over the left half only (those pixels saturate
    within the first batches, the right half's never do)."""
    rng = np.random.default_rng(seed)
    T = tiles_x * tiles_y
    counts = rng.integers(1, max_per_tile, T).astype(np.int32)
    for t in deep_tiles:
        counts[t] = 3 * CHUNK + 17
    for t in faint_tiles:
        counts[t] = faint_count
    for t in half_tiles:
        counts[t] = 700
    for t in empty_tiles:
        counts[t] = 0
    first = int(rng.integers(1, CHUNK))  # unaligned start of tile 0
    starts = (first + np.cumsum(counts) - counts).astype(np.int32)
    total = first + int(counts.sum())
    nw = NUM_GEOM + c_total
    slab = np.zeros((((nw + 7) // 8) * 8, padded_capacity(total)), np.float32)
    for t in range(T):
        c, s = int(counts[t]), int(starts[t])
        if c == 0:
            continue
        ox, oy = (t % tiles_x) * tile_size, (t // tiles_x) * tile_size
        deep, faint, half = t in deep_tiles, t in faint_tiles, t in half_tiles
        lo, hi = (0.3, 0.7) if deep else (0.0, 1.0) if faint else (-0.3, 1.3)
        mx = ox + tile_size * rng.uniform(lo, hi, c)
        my = oy + tile_size * rng.uniform(lo, hi, c)
        if half:
            mx = ox + tile_size * rng.uniform(0.0, 0.3, c)
        wide = deep or faint
        sx = tile_size * rng.uniform(0.5, 1.2, c) if wide else rng.uniform(0.5, 8.0, c)
        sy = tile_size * rng.uniform(0.5, 1.2, c) if wide else rng.uniform(0.5, 8.0, c)
        if half:
            sx, sy = rng.uniform(1.0, 3.0, c), tile_size * rng.uniform(0.3, 0.8, c)
        th = rng.uniform(0, np.pi, c)
        if half:
            th[:] = 0.0  # axis-aligned: narrow in x
        cs, sn = np.cos(th), np.sin(th)
        v00 = cs * cs * sx * sx + sn * sn * sy * sy + 0.3
        v11 = sn * sn * sx * sx + cs * cs * sy * sy + 0.3
        v01 = cs * sn * (sx * sx - sy * sy)
        det = v00 * v11 - v01 * v01
        op = (rng.uniform(0.9, 0.99, c) if deep or half else rng.uniform(0.005, 0.02, c)
              if faint else rng.uniform(0.0, 0.99, c))
        cols = rng.uniform(0.0, 1.0, (c_total, c))
        if c_total >= 4:
            cols[-1] = rng.uniform(1.0, 60.0, c)  # a depth channel
        rows = [mx, my, v11 / det, -v01 / det, v00 / det, op, *cols]
        slab[:nw, s:s + c] = np.stack(rows)
    offsets = (starts // CHUNK) * CHUNK
    heads = starts - offsets
    nchunks = np.where(counts > 0, (heads + counts + CHUNK - 1) // CHUNK, 0)
    ranges = [a.astype(np.int32) for a in (offsets, heads, counts, nchunks)]
    return slab, ranges


def assert_blend_close(got, want, label):
    """max |err| <= TOL except at reported cut-off flip pixels (<= FLIP_TOL,
    at most 0.1% of pixels); each rgb channel's error is scaled by
    max(1, its largest |value|) so the depth channel is held relatively."""
    for g, w, part in zip(got, want, ("rgb", "t_final")):
        g, w = np.asarray(g), np.asarray(w)
        err = np.abs(g - w)
        if part == "rgb":
            scale = np.maximum(1.0, np.abs(w).max(axis=(0, 2), keepdims=True))
            err = (err / scale).max(axis=1)  # per pixel over channels
        flips = int((err > TOL).sum())
        if flips:
            print(f"{label} {part}: {flips} cut-off flip pixel(s), "
                  f"max err {err.max():.3g}")
        assert flips <= max(2, err.size // 1000), (label, part, flips)
        assert err.max() <= FLIP_TOL, (label, part, float(err.max()))


def case_ids(cases):
    """Test ids: a case's numbers joined by '-' (pytest's own ids before
    the last field), then '-zero_runs' where it has such runs."""
    return ["-".join(map(str, c[:-1])) + ("-zero_runs" if c[-1] else "") for c in cases]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# (n_live, n_dead, I, tiles_x, tiles_y, nw, zero_runs): small shapes, then
# the main path's (960x540 at tile 32, ~1M gaussians, I = 2^21, c_total 7);
# then a 2,048-slot block of the kernel that straddles total, a capacity
# with no live slot (total 0), a truncating one over several blocks
# (total > I), n below one block, and runs of zero-pair gaussians inside
# the live range, one of each longer than a warp's 256-owner shared window
EXPAND_CASES = [
    (300, 5, 2048, 6, 4, 13, ()),
    (200, 700, 2048, 6, 4, 10, ()),
    (900, 20, 1024, 6, 4, 13, ()),
    (700_000, 304_096, 1 << 21, 30, 17, 13, ()),
    (1500, 40, 8192, 6, 4, 13, ()),
    (0, 64, 1024, 6, 4, 13, ()),
    (5000, 10, 4096, 6, 4, 13, ()),
    (20, 1, 1024, 6, 4, 13, ()),
    (6000, 50, 1 << 14, 6, 4, 13, ((0, 3), (2000, 3000), (5500, 7))),
    (2000, 3000, 8192, 6, 4, 13, ((1, 1100),)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_live,n_dead,I,tiles_x,tiles_y,nw,zero_runs", EXPAND_CASES,
                         ids=case_ids(EXPAND_CASES))
def test_expand_kernel_matches_plain(cuda, n_live, n_dead, I, tiles_x, tiles_y, nw, zero_runs):
    table, offsets, packed, total = make_expand_inputs(
        7, n_live=n_live, n_dead=n_dead, nw=nw, tiles_x=tiles_x, tiles_y=tiles_y,
        zero_runs=zero_runs)
    args = [torch.from_numpy(a).to(cuda) for a in (table, offsets, packed)]
    args.append(torch.tensor([total], dtype=torch.int32, device=cuda))
    kw = dict(tiles_x=tiles_x, num_tiles=tiles_x * tiles_y)
    before = cuda_build.LAUNCHES["expand_fused"]
    got = expand_fused(*args, I, **kw)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["expand_fused"] == before + 1
    want = expand_fused_plain(*args, I, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (tile_size, c_total, tiles_x, tiles_y, max_per_tile)
BLEND_CASES = [
    (16, 3, 3, 2, 300),
    (32, 4, 2, 2, 300),
    (16, 7, 4, 3, 600),
    (32, 7, 30, 17, 8000),  # the main path's tile grid and depth
]


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,c_total,tiles_x,tiles_y,max_per_tile", BLEND_CASES)
def test_blend_kernel_matches_plain(cuda, tile_size, c_total, tiles_x, tiles_y,
                                    max_per_tile):
    slab, ranges = make_blend_inputs(
        3, tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size, c_total=c_total,
        max_per_tile=max_per_tile, deep_tiles=(1,), empty_tiles=(2,))
    args = [torch.from_numpy(a).to(cuda) for a in (slab, *ranges)]
    kw = dict(tile_size=tile_size, tiles_x=tiles_x, c_total=c_total)
    before = cuda_build.LAUNCHES["blend_forward"]
    got = blend_forward(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["blend_forward"] == before + 1
    want = blend_forward_plain(*args, **kw)
    assert_blend_close([g.cpu() for g in got], [w.cpu() for w in want],
                       f"tile{tile_size}/c{c_total}")


def row_errors(got, want):
    """Each row's max |error| over its largest |value| (0 for an all-zero
    row that the kernel also left zero)."""
    err = (got - want).abs().amax(dim=1)
    scale = want.abs().amax(dim=1)
    return torch.where(scale > 0, err / torch.clamp(scale, min=1e-30), err)


# BLEND_CASES, then faint deep tiles (thousands of pairs across many of the
# kernel's batches; pixels that saturate mid-list and ones that never do)
# beside a half-covered tile, at both tile sizes
BACKWARD_CASES = [(*case, {}) for case in BLEND_CASES] + [
    (16, 7, 3, 2, 300, dict(faint_tiles=(3,), half_tiles=(4,))),
    (32, 7, 3, 2, 300, dict(faint_tiles=(3,), half_tiles=(4,))),
    (32, 3, 4, 2, 300, dict(faint_tiles=(0, 5), faint_count=9000, half_tiles=(4,))),
]


def backward_inputs(cuda, seed, tile_size, c_total, tiles_x, tiles_y, max_per_tile,
                    extra):
    """(slab, ranges, forward outputs, random cotangents, kw) on the card."""
    slab, ranges = make_blend_inputs(
        seed, tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size, c_total=c_total,
        max_per_tile=max_per_tile, deep_tiles=(1,), empty_tiles=(2,), **extra)
    args = [torch.from_numpy(a).to(cuda) for a in (slab, *ranges)]
    kw = dict(tile_size=tile_size, tiles_x=tiles_x, c_total=c_total)
    rgb, t_final = blend_forward(*args, **kw)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g_rgb = torch.randn(rgb.shape, generator=gen, device=cuda)
    g_t = torch.randn(t_final.shape, generator=gen, device=cuda)
    return slab, ranges, args, rgb, t_final, g_rgb, g_t, kw


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,c_total,tiles_x,tiles_y,max_per_tile,extra",
                         BACKWARD_CASES)
def test_blend_backward_kernel_matches_plain(cuda, tile_size, c_total, tiles_x, tiles_y,
                                             max_per_tile, extra):
    """Gradient rows within GRAD_TOL of the plain version (sums in another
    order; the kernel's centred moments lose fewer digits); exact zeros
    outside every tile's range."""
    slab, ranges, args, rgb, t_final, g_rgb, g_t, kw = backward_inputs(
        cuda, 5, tile_size, c_total, tiles_x, tiles_y, max_per_tile, extra)
    before = cuda_build.LAUNCHES["blend_backward"]
    got = blend_backward(*args, rgb, t_final, g_rgb, g_t, **kw)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["blend_backward"] == before + 1
    want = blend_backward_plain(*args, rgb, t_final, g_rgb, g_t, **kw)
    nw = NUM_GEOM + c_total
    errs = row_errors(got[:nw], want[:nw])
    assert float(errs.max()) <= GRAD_TOL, errs.tolist()
    live = torch.zeros(slab.shape[1], dtype=torch.bool, device=cuda)
    for o, h, c in zip(*(r.tolist() for r in ranges[:3])):
        live[o + h:o + h + c] = True
    assert not got[:, ~live].any() and not got[nw:].any()
    assert got[:nw, live].abs().sum() > 0


def make_edge_inputs(seed, *, tile_size, c_total, tiles_x=2, tiles_y=2, per_tile=600):
    """Splats at the edge of the backward kernel's row-support test: a
    third centred up to three tiles away with scales that reach in, a
    third needles at every angle, a third with opacity just above 1/255."""
    rng = np.random.default_rng(seed)
    T = tiles_x * tiles_y
    first = int(rng.integers(1, CHUNK))
    nw = NUM_GEOM + c_total
    total = first + T * per_tile
    slab = np.zeros((((nw + 7) // 8) * 8, padded_capacity(total)), np.float32)
    k = per_tile // 3
    for t in range(T):
        ox, oy = (t % tiles_x) * tile_size, (t // tiles_x) * tile_size
        far = rng.uniform(-3.0, 4.0, (2, k)), rng.uniform(5.0, 60.0, (2, k))
        needle = rng.uniform(-0.5, 1.5, (2, k)), np.stack([rng.uniform(0.2, 0.6, k),
                                                           rng.uniform(10.0, 80.0, k)])
        faint = (rng.uniform(0.0, 1.0, (2, per_tile - 2 * k)),
                 rng.uniform(0.5, 8.0, (2, per_tile - 2 * k)))
        pos = np.concatenate([far[0], needle[0], faint[0]], 1)
        scale = np.concatenate([far[1], needle[1], faint[1]], 1)
        op = np.concatenate([rng.uniform(0.004, 0.05, 2 * k),
                             rng.uniform(1.0, 1.1, per_tile - 2 * k) / 255.0])
        th = rng.uniform(0, np.pi, per_tile)
        cs, sn = np.cos(th), np.sin(th)
        sx, sy = scale
        v00 = cs * cs * sx * sx + sn * sn * sy * sy + 0.3
        v11 = sn * sn * sx * sx + cs * cs * sy * sy + 0.3
        v01 = cs * sn * (sx * sx - sy * sy)
        det = v00 * v11 - v01 * v01
        cols = rng.uniform(0.0, 1.0, (c_total, per_tile))
        rows = [ox + tile_size * pos[0], oy + tile_size * pos[1], v11 / det, -v01 / det,
                v00 / det, op, *cols]
        order = rng.permutation(per_tile)
        s0 = first + t * per_tile
        slab[:nw, s0:s0 + per_tile] = np.stack(rows)[:, order]
    starts = (first + per_tile * np.arange(T)).astype(np.int32)
    counts = np.full(T, per_tile, np.int32)
    offsets = (starts // CHUNK) * CHUNK
    heads = starts - offsets
    nchunks = (heads + counts + CHUNK - 1) // CHUNK
    return slab, [a.astype(np.int32) for a in (offsets, heads, counts, nchunks)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_backward_support_skip_keeps_every_pair(cuda, tile_size):
    """The kernel leaves out a warp's rows where a splat cannot reach
    alpha 1/255; on splats built to sit at the edge of that test it gives
    the plain version's gradients, with a non-zero colour gradient on
    exactly the intersections the plain version composites."""
    slab, ranges = make_edge_inputs(8, tile_size=tile_size, c_total=4)
    args = [torch.from_numpy(a).to(cuda) for a in (slab, *ranges)]
    kw = dict(tile_size=tile_size, tiles_x=2, c_total=4)
    rgb, t_final = blend_forward(*args, **kw)
    gen = torch.Generator(device=cuda).manual_seed(2)
    cot = [torch.randn(a.shape, generator=gen, device=cuda) for a in (rgb, t_final)]
    got = blend_backward(*args, rgb, t_final, *cot, **kw)
    want = blend_backward_plain(*args, rgb, t_final, *cot, **kw)
    errs = row_errors(got[:NUM_GEOM + 4], want[:NUM_GEOM + 4])
    assert float(errs.max()) <= GRAD_TOL, errs.tolist()
    assert torch.equal(got[NUM_GEOM] != 0, want[NUM_GEOM] != 0)
    assert int((want[NUM_GEOM] != 0).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,c_total,tiles_x,tiles_y,max_per_tile,extra",
                         BACKWARD_CASES[len(BLEND_CASES):])
def test_blend_forward_kernel_matches_plain_on_faint_tiles(cuda, tile_size, c_total, tiles_x,
                                                          tiles_y, max_per_tile, extra):
    """The forward on faint deep tiles (each of a tile's blocks walks
    thousands of pairs across many batches, leaving out the splats whose
    support misses its warps' pixels), a deep near-opaque tile and a
    half-covered one, within the TOL / FLIP_TOL rule of the plain version;
    two launches give the same bits."""
    slab, ranges = make_blend_inputs(
        5, tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size, c_total=c_total,
        max_per_tile=max_per_tile, deep_tiles=(1,), empty_tiles=(2,), **extra)
    args = [torch.from_numpy(a).to(cuda) for a in (slab, *ranges)]
    kw = dict(tile_size=tile_size, tiles_x=tiles_x, c_total=c_total)
    got = blend_forward(*args, **kw)
    again = blend_forward(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = blend_forward_plain(*args, **kw)
    assert_blend_close([g.cpu() for g in got], [w.cpu() for w in want],
                       f"faint tile{tile_size}/c{c_total}")
    assert float(got[1].min()) < 0.5 and float(got[1].max()) > 0.5  # some saturate, some not


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_forward_support_skip_keeps_every_pair(cuda, tile_size):
    """The forward leaves out a warp's pixels where a splat cannot reach
    alpha 1/255; on splats built to sit at the edge of that test (far,
    needles, opacity just above 1/255) it gives the plain version's
    blend, the same bits on two launches."""
    slab, ranges = make_edge_inputs(8, tile_size=tile_size, c_total=4)
    args = [torch.from_numpy(a).to(cuda) for a in (slab, *ranges)]
    kw = dict(tile_size=tile_size, tiles_x=2, c_total=4)
    got = blend_forward(*args, **kw)
    again = blend_forward(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = blend_forward_plain(*args, **kw)
    assert_blend_close([g.cpu() for g in got], [w.cpu() for w in want], f"edge tile{tile_size}")
    assert float(got[1].min()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_backward_kernel_repeats_bit_for_bit(cuda, tile_size):
    """Two launches on the same faint, deep inputs give the same bits: the
    sums are taken in a fixed order, with no atomics."""
    _, _, args, rgb, t_final, g_rgb, g_t, kw = backward_inputs(
        cuda, 6, tile_size, 7, 3, 2, 300, dict(faint_tiles=(0, 3), half_tiles=(4,)))
    first = blend_backward(*args, rgb, t_final, g_rgb, g_t, **kw)
    second = blend_backward(*args, rgb, t_final, g_rgb, g_t, **kw)
    torch.cuda.synchronize()
    assert first.abs().sum() > 0 and torch.equal(first, second)


# (n, I, n_live, sentinel tail, extra): small, then the main path's (~1M
# gaussians, I = 2^21); then a gaussian owning 2,040 slots (the tile count
# of a 1920x1080 frame) across many of the kernel's 256-slot blocks, ids
# with no slot between live ones, segments of up to 300 slots crossing
# its warps' and blocks' boundaries, no live slot at all (total 0), and an
# I that is no multiple of 256
SEGMENT_CASES = [
    (700, 2048, 400, 256, {}), (5000, 8192, 5000, 0, {}),
    (1_007_616, 1 << 21, 700_000, 357_088, {}),
    (3000, 16384, 2000, 1000, dict(long=(37, 2040))),
    (9000, 8192, 1500, 500, dict(gaps=True)),
    (2000, 65536, 1000, 4000, dict(max_count=300)),
    (500, 4096, 0, 4096, {}),
    (700, 2048 + 77, 400, 100, {}),
]


def make_segment_inputs(seed, n, I, n_live, tail, *, long=None, gaps=False, max_count=5):
    """(src [I], rows [15, I]): n_live owners of 1 .. max_count slots each
    (owner long[0] of long[1] slots), ids 0 .. n_live - 1 or, with `gaps`,
    a sorted random n_live of 0 .. n - 1; their slots cut to the first I
    - tail, the rest the sentinel n with zero rows."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_count + 1, size=n_live)
    if long is not None:
        counts[long[0]] = long[1]
    ids = np.sort(rng.choice(n, n_live, replace=False)) if gaps else np.arange(n_live)
    src = np.repeat(ids, counts)[:I - tail]
    total = src.shape[0]
    src = np.concatenate([src, np.full(I - total, n)]).astype(np.int32)
    rows = rng.normal(size=(15, I)).astype(np.float32)
    rows[:, total:] = 0.0
    return src, rows


@pytest.mark.cuda
@pytest.mark.parametrize("n,I,n_live,tail,extra", SEGMENT_CASES)
def test_segment_sum_kernel_matches_plain(cuda, n, I, n_live, tail, extra):
    """Per-gaussian sums within SEGMENT_TOL of index_add_ over each row's
    largest |value| (the same sums, which the atomics of index_add_ take in
    no fixed order), and within 1e-5 of it elementwise where no segment
    is longer than 5 slots (a long segment's sum may cancel to far below
    the rounding of its terms); zero columns for ids without slots and for
    the sentinel; two launches give the same bits."""
    src, rows = make_segment_inputs(n, n, I, n_live, tail, **extra)
    rows_t, src_t = torch.from_numpy(rows).to(cuda), torch.from_numpy(src).to(cuda)
    before = cuda_build.LAUNCHES["dense_segment_sum"]
    got = dense_segment_sum(rows_t, src_t, n)
    again = dense_segment_sum(rows_t, src_t, n)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["dense_segment_sum"] == before + 2
    assert torch.equal(got, again)
    want = dense_segment_sum_plain(rows_t, src_t, n)
    assert got.shape == want.shape == (15, n + 1)
    errs = row_errors(got, want)
    assert float(errs.max()) <= SEGMENT_TOL, errs.tolist()
    if extra.get("max_count", 5) <= 5 and "long" not in extra:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    owned = np.zeros(n + 1, bool)
    owned[src[src < n]] = True
    assert not got[:, torch.from_numpy(~owned).to(cuda)].any()
    assert bool(got[:, torch.from_numpy(owned).to(cuda)].any(dim=0).all())


# (n_live, n_dead, I, tiles_x, tiles_y, total_override, zero_runs): the
# expansion of the classic path; None keeps the inputs' own total, 0 is an
# empty view. Totals: 5,230 and 14,902 of I (every pair held), 1,275 of an
# I that is no multiple of 256, 2,996 of 1,024 (overflow), and the
# 1920x1080 render's tile grid with 5,935,225 pairs of I = 2^23; then no
# live gaussian with I % 4 != 0, n below one 4,096-slot block of the
# kernel with I % 4 != 0, a truncating I of 3,001 over runs of zero-pair
# gaussians inside the live range, and such runs at I = 2^15 and 2^14,
# one of each longer than a warp's 256-owner shared window
PAIRS_CASES = [
    (800, 200, 1 << 13, 30, 17, None, ()),
    (2000, 500, 1 << 15, 60, 34, None, ()),
    (300, 212, 3000, 8, 8, None, ()),
    (900, 20, 1024, 6, 4, None, ()),
    (300, 5, 2048, 6, 4, 0, ()),
    (800_000, 200_000, 1 << 23, 60, 34, None, ()),
    (0, 50, 3001, 8, 8, None, ()),
    (20, 1, 1023, 6, 4, None, ()),
    (4000, 900, 3001, 8, 8, None, ((10, 1500), (3000, 2))),
    (6000, 50, 1 << 15, 30, 17, None, ((0, 3), (2000, 3000), (5500, 7))),
    (3000, 4000, 1 << 14, 30, 17, None, ((1, 1100),)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_live,n_dead,I,tiles_x,tiles_y,total,zero_runs", PAIRS_CASES,
                         ids=case_ids(PAIRS_CASES))
def test_expand_pairs_kernel_matches_plain(cuda, n_live, n_dead, I, tiles_x, tiles_y, total,
                                           zero_runs):
    """Bit-equal to searchsorted_expand on every slot, dead ones included."""
    _, offsets, packed, own_total = make_expand_inputs(
        11, n_live=n_live, n_dead=n_dead, nw=1, tiles_x=tiles_x, tiles_y=tiles_y,
        zero_runs=zero_runs)
    total = own_total if total is None else total
    args = [torch.from_numpy(a).to(cuda) for a in (offsets, packed)]
    args.append(torch.tensor([total], dtype=torch.int32, device=cuda))
    kw = dict(tiles_x=tiles_x, num_tiles=tiles_x * tiles_y)
    before = cuda_build.LAUNCHES["expand_pairs"]
    got = expand_pairs(*args, I, **kw)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["expand_pairs"] == before + 1
    want = searchsorted_expand(*args, I, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    live = min(int(total), I)
    assert (got[0][live:] == tiles_x * tiles_y).all()
    assert bool((got[0][:live] < tiles_x * tiles_y).all())


# (w, cap): the classic path's widths, caps that are not multiples of the
# kernel's 256-slot blocks, and the 1920x1080 render's slab at I = 2^23;
# then widths 1 and 32 (the kernels' range), caps below one block, caps
# that are not multiples of 4, and the grown training step's [16, 1,609,729]
TRANSPOSE_CASES = [(13, 1000), (15, 70_001), (16, 1_000_001), (13, padded_capacity(1 << 23)),
                   (1, 100), (1, 70_003), (32, 255), (32, 70_001), (16, 3), (15, 256),
                   (16, 1_609_729)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,cap", TRANSPOSE_CASES)
def test_transpose_kernels_match_plain(cuda, w, cap):
    """Both transposes bit-equal to theirs: a transpose is a copy. The
    attribute-major input is also taken at each 4-byte offset from a
    16-byte boundary (a contiguous view into a larger buffer)."""
    gen = torch.Generator(device=cuda).manual_seed(w)
    rows = torch.randn((cap, w), generator=gen, device=cuda)
    before = dict(cuda_build.LAUNCHES)
    got = rows_to_attr_major(rows)
    torch.cuda.synchronize()
    assert got.shape == ((w + 7) // 8 * 8, cap)
    assert torch.equal(got, rows_to_attr_major_plain(rows))
    attrs = torch.randn((w, cap), generator=gen, device=cuda)
    got = attr_major_to_rows(attrs)
    torch.cuda.synchronize()
    assert torch.equal(got, attr_major_to_rows_plain(attrs))
    assert cuda_build.LAUNCHES["rows_to_attr_major"] == before["rows_to_attr_major"] + 1
    assert cuda_build.LAUNCHES["attr_major_to_rows"] == before["attr_major_to_rows"] + 1
    buf = torch.randn(w * cap + 3, generator=gen, device=cuda)
    for off in (1, 2, 3):
        view = buf[off:off + w * cap].view(w, cap)
        assert torch.equal(attr_major_to_rows(view), attr_major_to_rows_plain(view))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,c_total,tiles_x,tiles_y,max_per_tile", BLEND_CASES[1:])
def test_blends_ignore_dead_slots_holding_real_rows(cuda, tile_size, c_total, tiles_x,
                                                    tiles_y, max_per_tile):
    """On the classic path the slots past `total` carry a real gaussian's
    row (the gather copies gaussian N-1 there) next to the last tile's
    run, which ends mid-window. Both kernels must leave them out: the
    same outputs as with zero dead slots, bit for bit, equal to the plain
    versions, and a zero gradient on every dead slot."""
    slab, ranges = make_blend_inputs(
        9, tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size, c_total=c_total,
        max_per_tile=max_per_tile, deep_tiles=(1,), empty_tiles=(2,))
    offs, heads, counts, _ = ranges
    total = int(offs[-1] + heads[-1] + counts[-1])
    assert total % CHUNK and total < slab.shape[1]  # the last run ends mid-window
    dead = slab.copy()
    nw = NUM_GEOM + c_total
    opaque = slab[:nw, total - 1].copy()
    opaque[2:5] = [1e-3, 0.0, 1e-3]   # a wide splat over every tile
    opaque[5] = 0.99
    dead[:nw, total:] = opaque[:, None]
    kw = dict(tile_size=tile_size, tiles_x=tiles_x, c_total=c_total)
    r = [torch.from_numpy(a).to(cuda) for a in ranges]
    clean, real = torch.from_numpy(slab).to(cuda), torch.from_numpy(dead).to(cuda)
    fwd = blend_forward(real, *r, **kw)
    for g, w in zip(fwd, blend_forward(clean, *r, **kw)):
        assert torch.equal(g, w)
    assert_blend_close([g.cpu() for g in fwd],
                       [w.cpu() for w in blend_forward_plain(real, *r, **kw)], "dead slots")
    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = [torch.randn(a.shape, generator=gen, device=cuda) for a in fwd]
    got = blend_backward(real, *r, *fwd, *cot, **kw)
    assert torch.equal(got, blend_backward(clean, *r, *fwd, *cot, **kw))
    assert not got[:, total:].any()
    errs = row_errors(got[:nw], blend_backward_plain(real, *r, *fwd, *cot, **kw)[:nw])
    assert float(errs.max()) <= GRAD_TOL, errs.tolist()
