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
from mtgs_torch.raster.blend import blend_forward, blend_forward_plain
from mtgs_torch.raster.chunk_math import CHUNK
from tests.test_torch_kernels import assert_blend_close, make_blend_inputs


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
