"""mtgs_torch blend_forward_plain vs the JAX Pallas blend (interpret mode).

Identical slabs and tile ranges go to `blend_forward_pallas(...,
interpret=True)` and to the port. Both use chunk_math's formulation in
f32, so the tolerance is 1e-4, absolute for colour channels and
transmittance and relative to the channel's largest value for the depth
channel (values up to 60 carry f32 rounding of that size). A pixel where a last-ulp
difference in sigma flips the alpha = 1/255 or sigma = 0 cut-off may
differ by one gaussian's weight: such pixels are counted, reported, and
held to the golden tolerance of 2e-3 instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.raster.blend_pallas import blend_forward_pallas
from mtgs_torch.raster.blend import blend_forward, blend_forward_plain, tile_order
from mtgs_torch.raster.chunk_math import (
    ALPHA_MIN, CHUNK, NUM_GEOM, conic_coefficients, pixel_features, sigma,
)
from tests.test_torch_kernels import assert_blend_close, make_blend_inputs, make_edge_inputs


def jax_blend(slab, ranges, *, tile_size, tiles_x, c_total):
    rgb, tfin = blend_forward_pallas(
        jnp.asarray(slab), *(jnp.asarray(r) for r in ranges), tile_size=tile_size,
        tiles_x=tiles_x, c_total=c_total, interpret=True,
        tile_base=jnp.zeros((1,), jnp.int32))
    return np.asarray(rgb), np.asarray(tfin)


# (tile_size, c_total, tiles_x, tiles_y)
CASES = [(16, 3, 3, 2), (32, 4, 2, 2), (32, 7, 2, 2), (16, 7, 2, 2)]


@pytest.mark.parametrize("tile_size,c_total,tiles_x,tiles_y", CASES)
def test_blend_plain_matches_pallas(tile_size, c_total, tiles_x, tiles_y):
    slab, ranges = make_blend_inputs(
        tile_size * 10 + c_total, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_size=tile_size, c_total=c_total, deep_tiles=(1,), empty_tiles=(2,))
    want = jax_blend(slab, ranges, tile_size=tile_size, tiles_x=tiles_x,
                     c_total=c_total)
    got = blend_forward_plain(
        torch.from_numpy(slab), *(torch.from_numpy(r) for r in ranges),
        tile_size=tile_size, tiles_x=tiles_x, c_total=c_total)
    got = [g.numpy() for g in got]
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert_blend_close(got, want, f"tile{tile_size}/c{c_total}")
    # the deep tile saturates in its first chunk: cutting its run to one
    # chunk changes nothing (the kernels' early exit is exact there)
    cut = [r.copy() for r in ranges]
    cut[2][1] = CHUNK - cut[1][1]
    cut[3][1] = 1
    again = blend_forward_plain(
        torch.from_numpy(slab), *(torch.from_numpy(r) for r in cut),
        tile_size=tile_size, tiles_x=tiles_x, c_total=c_total)
    assert torch.equal(again[0][1], torch.from_numpy(got[0][1]))
    assert torch.equal(again[1][1], torch.from_numpy(got[1][1]))
    # the empty tile stays clear
    np.testing.assert_array_equal(got[1][2], 1.0)
    np.testing.assert_array_equal(got[0][2], 0.0)


def test_blend_plain_stats_count_the_early_exit():
    """Flat gaussians (zero conic, so sigma = 0 at every pixel): tile 0
    has 300 at opacity 1, alpha clamped to 0.999, so every pixel stops at
    its second (the terminator, evaluated but not composited); tile 1 has
    50 at alpha 0.01 across a chunk boundary, all evaluated and
    composited."""
    c_total, P = 3, 16 * 16
    slab = np.zeros((6 + c_total, 640), np.float32)
    slab[5, 5:305] = 1.0
    slab[5, 504:554] = 0.01
    slab[6:] = 0.5
    ranges = [np.array(v, np.int32) for v in ([0, 384], [5, 120], [300, 50], [3, 2])]
    stats = {}
    rgb, t_final = blend_forward_plain(
        torch.from_numpy(slab), *(torch.from_numpy(r) for r in ranges),
        tile_size=16, tiles_x=2, c_total=c_total, stats=stats)
    assert stats == dict(pair_evals=(2 + 50) * P, pair_support=(2 + 50) * P,
                         pair_blends=(1 + 50) * P, pair_clamped=P, pairs_read=2 + 50)
    np.testing.assert_allclose(t_final[0].numpy(), 1e-3, rtol=1e-4)
    np.testing.assert_allclose(t_final[1].numpy(), 0.99 ** 50, rtol=1e-4)


def test_blend_plain_stats_count_the_support():
    """One narrow splat (conic 2, 0, 2 at the centre of a 16-pixel tile,
    opacity 0.5): sigma = dx^2 + dy^2, and alpha reaches 1/255 only where
    that is at most log(127.5) = 4.85, at the 4 x 4 pixels with |dx|, |dy|
    in {0.5, 1.5}. Every pixel evaluates it; 16 lie in its support."""
    slab = np.zeros((7, 128), np.float32)
    slab[:6, 0] = [8.0, 8.0, 2.0, 0.0, 2.0, 0.5]
    slab[6, 0] = 1.0
    ranges = [np.array([v], np.int32) for v in (0, 0, 1, 1)]
    stats = {}
    blend_forward_plain(torch.from_numpy(slab), *(torch.from_numpy(r) for r in ranges),
                        tile_size=16, tiles_x=1, c_total=1, stats=stats)
    assert stats == dict(pair_evals=256, pair_support=16, pair_blends=16, pair_clamped=0,
                         pairs_read=1)


def test_blend_wrapper_uses_plain_on_cpu():
    slab, ranges = make_blend_inputs(5, tiles_x=2, tiles_y=1, tile_size=16, c_total=4)
    args = (torch.from_numpy(slab), *(torch.from_numpy(r) for r in ranges))
    kw = dict(tile_size=16, tiles_x=2, c_total=4)
    a = blend_forward(*args, **kw)
    b = blend_forward_plain(*args, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="rows"):
        blend_forward(args[0][:8], *args[1:], tile_size=16, tiles_x=2, c_total=4)


def test_tile_order_puts_the_deepest_tiles_first():
    counts = torch.tensor([3, 9, 0, 9, 5, 3], dtype=torch.int32)
    order = tile_order(counts)
    assert order.dtype == torch.int32 and order.tolist() == [1, 3, 4, 0, 5, 2]


def _support_range(qa, qb, q2, qd, qe, q5, lim):
    """Float64 twin of csrc/blend_math.cuh's support_range, elementwise:
    the (lo, hi) rows (or columns) outside which the splat's sigma exceeds
    lim, in f32 as the kernels store them."""
    inf = torch.full_like(qa, float("inf"))
    h = 0.25 / qa
    A = qb - q2 * q2 * h
    B = qe - 2.0 * q2 * qd * h
    Cq = q5 - qd * qd * h
    ok = (qa > 0) & (A > 0) & torch.isfinite(B) & torch.isfinite(Cq)
    disc = B * B - 4.0 * A * (Cq - lim)
    real = ok & (disc >= 0)
    empty = ok & ~(disc >= 0) & torch.isfinite(disc)  # sigma > lim everywhere
    r = torch.sqrt(torch.where(real, disc, torch.zeros_like(disc)))
    y1, y2 = (-B - r) * (0.5 / A), (-B + r) * (0.5 / A)
    lo = torch.where(real, y1 - 1e-3 * (1.0 + y1.abs()), -inf)
    hi = torch.where(real, y2 + 1e-3 * (1.0 + y2.abs()), inf)
    lo, hi = torch.where(empty, inf, lo), torch.where(empty, -inf, hi)
    return lo.float(), hi.float()


def _support_box(Q, op):
    """Float64 twin of csrc/blend_math.cuh's support_box: Q [6, m] and op
    [m] (f32) -> x0, x1, y0, y1 [m] of tile-local pixel centres."""
    q = Q.double()
    S = (1024.0 * (q[0].abs() + q[1].abs() + q[2].abs()) + 32.0 * (q[3].abs() + q[4].abs())
         + q[5].abs())
    lim = torch.log(255.0 * op).double() + 1e-3 + 1e-5 * S  # logf of the f32 product
    x0, x1 = _support_range(q[1], q[0], q[2], q[4], q[3], q[5], lim)
    y0, y1 = _support_range(q[0], q[1], q[2], q[3], q[4], q[5], lim)
    box = torch.stack([x0, x1, y0, y1])
    box = torch.where(torch.isfinite(lim), box, torch.tensor([-1.0, 1.0, -1.0, 1.0])[:, None]
                      * float("inf"))
    return torch.where(op > 0, box, torch.tensor([1.0, -1.0, 1.0, -1.0])[:, None]
                       * float("inf"))


def test_support_box_is_conservative():
    """Both blend kernels leave out a warp's pixels outside an
    intersection's support box. On random splats (faint deep tiles,
    near-opaque and half-covered ones) and on ones at the edge of the test
    (far, needles, opacity just above 1/255), every (pixel, intersection)
    pair that chunk_math's sigma and the 1/255 test let composite lies
    inside the twin's box; and the boxes leave out a good part of the pairs."""
    cases = [(*make_blend_inputs(4, tiles_x=3, tiles_y=2, tile_size=32, c_total=1,
                                 deep_tiles=(1,), faint_tiles=(3,), half_tiles=(4,)), 32, 3),
             (*make_edge_inputs(8, tile_size=16, c_total=1), 16, 2),
             (*make_edge_inputs(9, tile_size=32, c_total=1), 32, 2)]
    outside = pairs = 0
    for slab, (offs, heads, counts, _), tile_size, tiles_x in cases:
        F = pixel_features(tile_size, "cpu")
        for t in range(len(counts)):
            lo = int(offs[t] + heads[t])
            geom = torch.from_numpy(slab[:NUM_GEOM, lo:lo + int(counts[t])])
            ox = torch.tensor(float((t % tiles_x) * tile_size))
            oy = torch.tensor(float((t // tiles_x) * tile_size))
            Q = conic_coefficients(geom[:, None, :], ox, oy)
            S = sigma(Q, F)[0]                                     # [PIX, m]
            contrib = (S >= 0.0) & (geom[5] * torch.exp(-S) >= ALPHA_MIN)
            x0, x1, y0, y1 = _support_box(Q[:, 0, :], geom[5])
            x, y = F[3][:, None], F[4][:, None]
            inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
            assert not (contrib & ~inside).any(), (tile_size, t)
            outside += int((~inside).sum())
            pairs += inside.numel()
    assert outside > 0.25 * pairs, (outside, pairs)  # 31% on these inputs
