"""The rasterizer's backward in mtgs_torch against the JAX package and
the gsplat-math goldens.

* `chunk_math.backward_chunk` against JAX `chunk_math.backward_chunk`
  (eager), tile by tile;
* `blend_backward_plain` against `blend_backward_pallas(interpret=True)`
  on the slabs of test_torch_blend.py, and `dense_segment_sum_plain`
  against `dense_segment_sum(interpret=True)` on a sorted id stream with
  truncation slack and sentinel columns;
* gradients through the port's `rasterize` (tap2d and absgrad_sink
  included) against the four goldens of tests/goldens/.

Tolerances: the chunk and blend backward 1e-4, scaled per gradient row by
max(1, its largest |value|), and the chunk's carries 1e-4 absolute and
relative (both run chunk_math's f32 formulation; only the order of sums
differs, and at tile 32 the tile-local expansion of sigma cancels terms
of ~1e3, so sigma itself carries ~1e-4 of rounding); the segment sum 1e-5 relative (the same sums
in another order); the goldens as test_goldens.py: every gradient
max-scaled 2e-4 (f32 against a float64 golden).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.raster import chunk_math as jcm
from mtgs_tpu.raster.blend_pallas import blend_backward_pallas
from mtgs_tpu.raster.segment_sum import dense_segment_sum as jax_segment_sum
from mtgs_torch.raster import RasterizeConfig, rasterize
from mtgs_torch.raster.blend import blend_backward, blend_backward_plain, blend_forward_plain
from mtgs_torch.raster.chunk_math import (
    CHUNK, NUM_GEOM, backward_chunk, forward_chunk, pixel_features,
)
from mtgs_torch.raster.segment_sum import dense_segment_sum, dense_segment_sum_plain
from tests.test_torch_kernels import make_blend_inputs

GOLDEN_DIR = Path(__file__).parent / "goldens"
TOL = 1e-4


def assert_rows_close(got, want, tol, label):
    """Each row's max error, scaled by max(1, its largest |value|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    for r in range(want.shape[0]):
        scale = max(1.0, float(np.abs(want[r]).max()))
        err = float(np.abs(got[r] - want[r]).max()) / scale
        assert err <= tol, (label, r, err)


def _random_chunk(rng, tile_size, c_total, A):
    """A tile's first chunk, for A tiles: gaussians near each tile, some
    lanes out of range; rgb and t_final from the port's forward_chunk."""
    P = tile_size * tile_size
    ox = (np.arange(A) * tile_size).astype(np.float32)
    oy = np.zeros(A, np.float32)
    mx = ox[:, None] + tile_size * rng.uniform(-0.3, 1.3, (A, CHUNK))
    my = oy[:, None] + tile_size * rng.uniform(-0.3, 1.3, (A, CHUNK))
    sx, sy = rng.uniform(0.5, 6.0, (2, A, CHUNK))
    th = rng.uniform(0, np.pi, (A, CHUNK))
    c, s = np.cos(th), np.sin(th)
    v00 = c * c * sx * sx + s * s * sy * sy + 0.3
    v11 = s * s * sx * sx + c * c * sy * sy + 0.3
    v01 = c * s * (sx * sx - sy * sy)
    det = v00 * v11 - v01 * v01
    rows = [mx, my, v11 / det, -v01 / det, v00 / det, rng.uniform(0.05, 0.99, (A, CHUNK)),
            *rng.uniform(0, 1, (c_total, A, CHUNK))]
    slab = torch.from_numpy(np.stack(rows).astype(np.float32))    # [6 + c, A, CHUNK]
    lo = torch.from_numpy(rng.integers(0, 40, A).astype(np.int32))
    hi = lo + torch.from_numpy(rng.integers(30, CHUNK - 40, A).astype(np.int32))
    zeros = torch.zeros((A, P))
    _, log_t_out, rgb = forward_chunk(
        slab, torch.from_numpy(ox), torch.from_numpy(oy), pixel_features(tile_size, "cpu"),
        lo, hi, zeros, zeros, torch.zeros((A, c_total, P)))
    g_rgb = torch.from_numpy(rng.normal(size=(A, c_total, P)).astype(np.float32))
    carry = dict(g_rgb=g_rgb, g_t=torch.from_numpy(rng.normal(size=(A, P)).astype(np.float32)),
                 t_final=torch.exp(log_t_out), total_dot=(g_rgb * rgb).sum(1))
    return slab, ox, oy, lo, hi, carry


@pytest.mark.parametrize("tile_size,c_total", [(16, 3), (16, 7), (32, 4)])
def test_backward_chunk_matches_jax(tile_size, c_total):
    rng = np.random.default_rng(tile_size + c_total)
    A = 3
    slab, ox, oy, lo, hi, cr = _random_chunk(rng, tile_size, c_total, A)
    P = tile_size * tile_size
    zeros = torch.zeros((A, P))
    g, log_t, wg = backward_chunk(
        slab, torch.from_numpy(ox), torch.from_numpy(oy), pixel_features(tile_size, "cpu"),
        lo, hi, cr["g_rgb"], cr["g_t"], cr["t_final"], cr["total_dot"], zeros, zeros)
    F = jcm.pixel_features(tile_size)
    LT = jcm.tri_inclusive(CHUNK)
    col = lambda a: jnp.asarray(a.numpy()[:, None])
    for a in range(A):
        carry = jcm.BwdCarry(log_t_all=col(zeros[a]), wg_cum=col(zeros[a]))
        want, new = jcm.backward_chunk(
            carry, jnp.asarray(slab[:, a].numpy()), ox[a], oy[a],
            jnp.asarray(cr["g_rgb"][a].numpy()), col(cr["g_t"][a]), col(cr["t_final"][a]),
            col(cr["total_dot"][a]), F, LT, bounds=(int(lo[a]), int(hi[a])))
        assert_rows_close(g[:, a].numpy(), want, TOL, f"tile {a}")
        np.testing.assert_allclose(log_t[a].numpy(), np.asarray(new.log_t_all)[:, 0],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(wg[a].numpy(), np.asarray(new.wg_cum)[:, 0],
                                   rtol=TOL, atol=TOL)
        out = np.ones(CHUNK, bool)
        out[int(lo[a]):int(hi[a])] = False
        assert not g[:, a, torch.from_numpy(out)].any(), "lanes out of range must be zero"


# (tile_size, c_total, tiles_x, tiles_y), as test_torch_blend.py
CASES = [(16, 3, 3, 2), (32, 4, 2, 2), (16, 7, 2, 2)]


@pytest.mark.parametrize("tile_size,c_total,tiles_x,tiles_y", CASES)
def test_blend_backward_plain_matches_pallas(tile_size, c_total, tiles_x, tiles_y):
    slab, ranges = make_blend_inputs(
        tile_size * 10 + c_total, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_size=tile_size, c_total=c_total, deep_tiles=(1,), empty_tiles=(2,))
    kw = dict(tile_size=tile_size, tiles_x=tiles_x, c_total=c_total)
    t_args = [torch.from_numpy(a) for a in (slab, *ranges)]
    rgb, t_final = blend_forward_plain(*t_args, **kw)
    rng = np.random.default_rng(1)
    g_rgb = rng.normal(size=rgb.shape).astype(np.float32)
    g_t = rng.normal(size=t_final.shape).astype(np.float32)
    want = np.asarray(blend_backward_pallas(
        *(jnp.asarray(a) for a in (slab, *ranges)), jnp.asarray(rgb.numpy()),
        jnp.asarray(t_final.numpy()), jnp.asarray(g_rgb), jnp.asarray(g_t),
        interpret=True, tile_base=jnp.zeros((1,), jnp.int32), **kw))
    got = blend_backward(*t_args, rgb, t_final, torch.from_numpy(g_rgb),
                         torch.from_numpy(g_t), **kw)
    assert torch.equal(got, blend_backward_plain(*t_args, rgb, t_final, torch.from_numpy(g_rgb),
                                                 torch.from_numpy(g_t), **kw))
    nw = NUM_GEOM + c_total
    assert_rows_close(got.numpy()[:nw], want[:nw], TOL, f"tile{tile_size}/c{c_total}")
    # zero outside every tile's range (pad rows, the unaligned head, the
    # slack past the last tile) and past the deep tile's early exit
    live = np.zeros(slab.shape[1], bool)
    offs, heads, counts, _ = ranges
    for o, h, c in zip(offs, heads, counts):
        live[o + h:o + h + c] = True
    assert not got[:, torch.from_numpy(~live)].any() and not got[nw:].any()
    d0 = offs[1] + heads[1]
    assert not got[:, d0 + CHUNK:d0 + counts[1]].any()
    assert got[:, d0:d0 + 8].abs().sum() > 0


def test_dense_segment_sum_plain_matches_jax():
    """The sorted id stream of test_rasterize.py's kernel test: live ids
    dense in a prefix, truncation slack carrying the last live id with
    zero rows, then the sentinel n."""
    rng = np.random.default_rng(0)
    n, cap, w = 700, 2048, 16
    counts = rng.integers(1, 6, size=n)
    n_live = int(np.searchsorted(np.cumsum(counts), cap * 3 // 4)) - 1
    gidx = np.repeat(np.arange(n_live), counts[:n_live])[:cap]
    total = gidx.shape[0]
    gidx = np.concatenate([gidx, np.full(cap - total - 256, n_live - 1),
                           np.full(256, n)]).astype(np.int32)
    rows = rng.normal(size=(w, cap)).astype(np.float32)
    rows[:, total:] = 0.0
    want = np.asarray(jax_segment_sum(jnp.asarray(rows), jnp.asarray(gidx), n,
                                      interpret=True))
    got = dense_segment_sum(torch.from_numpy(rows), torch.from_numpy(gidx), n)
    assert torch.equal(got, dense_segment_sum_plain(torch.from_numpy(rows),
                                                    torch.from_numpy(gidx), n))
    assert got.shape == (w, n + 1)
    np.testing.assert_allclose(got.numpy(), want[:, :n + 1], rtol=1e-5, atol=1e-5)
    assert not got[:, n_live:].any()  # ids without slots and the sentinel column


@pytest.mark.parametrize("name", ["classic_rgb", "antialiased_rgbed",
                                  "antialiased_rgbed_tile16", "deep_stack_classic"])
def test_gradients_match_gsplat_golden(name):
    g = np.load(GOLDEN_DIR / f"{name}.npz")
    cfg = RasterizeConfig(
        width=int(g["W"]), height=int(g["H"]), tile_size=int(g["tile_size"]),
        rasterize_mode="antialiased" if bool(g["antialiased"]) else "classic",
        render_mode="RGB+ED" if bool(g["with_depth"]) else "RGB",
        max_intersections=1 << 16)
    keys = ("means", "quats", "scales", "opac", "colors")
    params = [torch.tensor(np.asarray(g[k], np.float32), requires_grad=True) for k in keys]
    viewmat, K = (torch.from_numpy(np.asarray(g[k], np.float32)) for k in ("viewmat", "K"))
    n = params[0].shape[0]
    tap = torch.zeros((n, 2), requires_grad=True)
    sink = torch.zeros((n, 2), requires_grad=True)
    render, alpha, _ = rasterize(*params, viewmat, K, cfg, tap2d=tap, absgrad_sink=sink)
    loss = (render * torch.from_numpy(g["cot_r"].astype(np.float32))).sum() \
        + (alpha * torch.from_numpy(g["cot_a"].astype(np.float32))).sum()
    grads = torch.autograd.grad(loss, params + [tap, sink])
    for got, k in zip(grads, keys):
        scale = max(1.0, float(np.abs(g[f"g_{k}"]).max()))
        np.testing.assert_allclose(got.numpy() / scale, g[f"g_{k}"] / scale, atol=2e-4,
                                   err_msg=f"grad {k} differs from gsplat-math golden")
    m2d_scale = max(1.0, float(np.abs(g["g_means2d"]).max()))
    np.testing.assert_allclose(grads[5].numpy() / m2d_scale, g["g_means2d"] / m2d_scale,
                               atol=2e-4)
    np.testing.assert_allclose(grads[6].numpy() / m2d_scale, g["absgrad"] / m2d_scale,
                               atol=2e-4, err_msg="absgrad differs from golden")
