"""What the sharded paths of mtgs_torch need of the single-rank modules,
against the JAX package:

* `blend_backward` / `blend_backward_plain` at a nonzero `tile_base` (the
  first tile of a tile-row band) against JAX's
  `blend_backward_pallas(tile_base=...)` in interpret mode: the band's
  tiles of a multi-row image, blended and replayed as the band plan does;
* `binning.tile_spans(row_range=...)` against JAX's, for every band of a
  split and a band past the last tile row;
* `Trainer._isect_granule`: 512 times the size of the mesh's raster axis.

Tolerances: the blend backward as test_torch_backward.py (1e-4 per row,
scaled by max(1, its largest |value|)); the spans exactly (integer math on
the same f32 inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.raster import binning as jbinning
from mtgs_tpu.raster.blend_pallas import blend_backward_pallas
from mtgs_torch.parallel.mesh import Mesh
from mtgs_torch.raster import binning
from mtgs_torch.raster.blend import blend_backward, blend_backward_plain, blend_forward_plain
from mtgs_torch.raster.chunk_math import NUM_GEOM
from tests.test_torch_backward import TOL, assert_rows_close
from tests.test_torch_kernels import make_blend_inputs


# (tile_size, c_total, tiles_x, tiles_y, first band row, band rows)
BANDS = [(16, 3, 3, 4, 2, 2), (32, 7, 2, 3, 1, 2)]


@pytest.mark.parametrize("tile_size,c_total,tiles_x,tiles_y,r0,rows", BANDS)
def test_blend_backward_tile_base_matches_pallas(tile_size, c_total, tiles_x, tiles_y, r0,
                                                 rows):
    slab, ranges = make_blend_inputs(
        tile_size * 10 + c_total + r0, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_size=tile_size, c_total=c_total, deep_tiles=(r0 * tiles_x,))
    base = r0 * tiles_x
    band = [a[base:base + rows * tiles_x] for a in ranges]
    kw = dict(tile_size=tile_size, tiles_x=tiles_x, c_total=c_total)
    t_args = [torch.from_numpy(a) for a in (slab, *band)]
    rgb, t_final = blend_forward_plain(*t_args, tile_base=base, **kw)
    rng = np.random.default_rng(2)
    g_rgb = rng.normal(size=rgb.shape).astype(np.float32)
    g_t = rng.normal(size=t_final.shape).astype(np.float32)
    want = np.asarray(blend_backward_pallas(
        *(jnp.asarray(a) for a in (slab, *band)), jnp.asarray(rgb.numpy()),
        jnp.asarray(t_final.numpy()), jnp.asarray(g_rgb), jnp.asarray(g_t),
        interpret=True, tile_base=jnp.asarray([base], jnp.int32), **kw))
    cot = (rgb, t_final, torch.from_numpy(g_rgb), torch.from_numpy(g_t))
    got = blend_backward(*t_args, *cot, tile_base=base, **kw)
    assert torch.equal(got, blend_backward_plain(*t_args, *cot, tile_base=base, **kw))
    nw = NUM_GEOM + c_total
    assert_rows_close(got.numpy()[:nw], want[:nw], TOL, f"tile{tile_size} base {base}")
    assert np.abs(want[:nw]).max() > 0
    # the band's pixels are not tile 0's: at base 0 the gradients differ
    at_zero = blend_backward_plain(*t_args, *cot, tile_base=0, **kw).numpy()
    assert np.abs(at_zero[:nw] - want[:nw]).max() > 100 * TOL


@pytest.mark.parametrize("n_bands", [2, 3, 5])
def test_tile_spans_row_range_matches_jax(n_bands):
    rng = np.random.default_rng(n_bands)
    n, width, height, ts = 400, 160, 128, 32
    means2d = np.stack([rng.uniform(-20, width + 20, n), rng.uniform(-20, height + 20, n)], 1)
    radii = rng.integers(0, 60, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.9
    a = rng.uniform(0.01, 0.2, n)
    c = rng.uniform(0.01, 0.2, n)
    b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c)
    conics = np.stack([a, b, c], 1).astype(np.float32)
    op_eff = rng.uniform(0.0, 1.0, n).astype(np.float32)
    means2d = means2d.astype(np.float32)
    tiles_y = -(-height // ts)
    rows_per = -(-tiles_y // n_bands)
    kw = dict(width=width, height=height, tile_size=ts)
    total = 0
    for s in range(n_bands):
        r0 = s * rows_per
        r1 = min(r0 + rows_per, tiles_y)
        want = jbinning.tile_spans(
            jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(valid),
            conics=jnp.asarray(conics), op_eff=jnp.asarray(op_eff),
            row_range=(jnp.int32(r0), jnp.int32(r1)), **kw)
        got = binning.tile_spans(
            torch.from_numpy(means2d), torch.from_numpy(radii), torch.from_numpy(valid),
            conics=torch.from_numpy(conics), op_eff=torch.from_numpy(op_eff),
            row_range=(r0, r1), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if r0 >= tiles_y:
            assert not got[1].any()  # a band past the image has no pairs
        total += int(got[1].sum())
    full = binning.tile_spans(torch.from_numpy(means2d), torch.from_numpy(radii),
                              torch.from_numpy(valid), conics=torch.from_numpy(conics),
                              op_eff=torch.from_numpy(op_eff), **kw)
    assert total == int(full[1].sum())  # the bands partition the pairs


def test_isect_granule_follows_the_raster_axis():
    from mtgs_torch.train.trainer import Trainer

    def granule(mesh, axis="tile"):
        t = Trainer.__new__(Trainer)
        t.mesh, t.mesh_axis = mesh, axis
        return t._isect_granule()

    assert granule(None) == 512
    assert granule(Mesh((4,), ("tile",), {}, {"tile": 0})) == 2048
    assert granule(Mesh((2, 3), ("data", "tile"), {}, {"data": 0, "tile": 0})) == 1536
    assert granule(Mesh((4,), ("data",), {}, {"data": 0})) == 512
