"""The classic rasterizer path of mtgs_torch against the JAX package, and
the render tool.

The classic path (binning.bin_gaussians with the pair expansion, the
gathered slab turned attribute-major, the blend, and the sorted segment
sum in the backward) runs where `fused=False` or where the fused path's
int32 key packing does not fit. The JAX side runs its classic path as its
own CPU tests do: `backend="pallas", interpret=True, fused=False` for
`rasterize` and `render_view` (its gather and backward then take their
CPU forms: a pad-transpose and a cumsum over all slots), and
`interpret=True` for the Pallas kernels 5-7 called directly.

Tolerances: binning, the expansion and the transposes exact (integer
math and copies); renders the golden ones (rgb 2e-3, alpha 1e-3, depth
1e-3 relative where alpha > 1e-2); gradients, tap2d and absgrad 2e-4 of
the largest |value| of each (the golden tolerance), against JAX's fused
path (see `classic_pair`: JAX's classic backward on a CPU rounds more
than that) and against the float64 goldens. The port's classic path against its own fused
path: render 1e-6, gradients 1e-5 max-scaled, loss terms 1e-6 relative
(the same slab, the same blend and per-gaussian sums in the same order).
Render tool: poses and quaternions 1e-6, colormap and frames exact.
"""

import dataclasses
import importlib
import json
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu import configs as jconfigs
from mtgs_tpu.core import quat as jquat
from mtgs_tpu.raster import RasterizeConfig as JConfig
from mtgs_tpu.raster import binning as jbin
from mtgs_tpu.raster import rasterize as jrasterize
from mtgs_tpu.raster.blend_pallas import attr_major_to_rows as j_attr_major_to_rows
from mtgs_tpu.raster.blend_pallas import rows_to_attr_major as j_rows_to_attr_major
from mtgs_tpu.raster.expand_pallas import expand_pairs as j_expand_pairs
from mtgs_tpu.tools import render as jrender
from mtgs_tpu.train import trainer as jtr
from mtgs_torch import configs as tconfigs
from mtgs_torch.core.camera import camera_to_gsplat_viewmat
from mtgs_torch.core.quat import rotmat_to_quat
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.raster import RasterizeConfig, binning, rasterize
from mtgs_torch.raster.blend import (
    attr_major_to_rows, attr_major_to_rows_plain, rows_to_attr_major, rows_to_attr_major_plain,
)
from mtgs_torch.raster.expand_fused import fused_fits
from mtgs_torch.raster.expand_pairs import expand_pairs
from mtgs_torch.tools import render as trender
from mtgs_torch.train import trainer as ttr
from mtgs_torch.train.optim import OptimConfig, default_groups
from tests.test_torch_slice import (
    H, I_CAP, W, assert_renders_close, build_jax_scene, jax_batch, make_views,
)

rasterize_mod = importlib.import_module("mtgs_torch.raster.rasterize")
GOLDEN_DIR = Path(__file__).parent / "goldens"
GRAD_TOL = 2e-4
INPUTS = ("means", "quats", "scales", "opacities", "colors", "tap2d", "absgrad")


def max_scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    return err / scale if scale > 0 else err


def assert_images_close(render, alpha, want_render, want_alpha):
    """rgb (all channels but the last) 2e-3, alpha 1e-3, the ED depth
    channel 1e-3 relative where alpha > 1e-2."""
    render, alpha = np.asarray(render), np.asarray(alpha)
    want_render, want_alpha = np.asarray(want_render), np.asarray(want_alpha)
    np.testing.assert_allclose(render[..., :-1], want_render[..., :-1], atol=2e-3)
    np.testing.assert_allclose(alpha, want_alpha, atol=1e-3)
    covered = want_alpha[..., 0] > 1e-2
    assert covered.mean() > 0.2
    d_got, d_want = render[..., -1][covered], want_render[..., -1][covered]
    assert (np.abs(d_got - d_want) / np.abs(d_want)).max() <= 1e-3


# ----------------------------------------------------------- binning

def make_binning_inputs(seed, n, *, culled_frac=0.0):
    """Projected gaussians over a 96x64 image at tile 16, some partly off
    screen; with culled_frac, that share is invalid or has radius 0."""
    rng = np.random.default_rng(seed)
    means2d = np.stack([rng.uniform(-20, W + 20, n), rng.uniform(-20, H + 20, n)], -1)
    radii = rng.integers(1, 30, n)
    depths = rng.uniform(0.5, 40.0, n)
    valid = np.ones(n, bool)
    cull = rng.random(n) < culled_frac
    radii[cull & (rng.random(n) < 0.5)] = 0
    valid[cull] &= rng.random(int(cull.sum())) < 0.5
    sx, sy = rng.uniform(0.5, 12.0, (2, n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    v00 = c * c * sx * sx + s * s * sy * sy + 0.3
    v11 = s * s * sx * sx + c * c * sy * sy + 0.3
    v01 = c * s * (sx * sx - sy * sy)
    det = v00 * v11 - v01 * v01
    conics = np.stack([v11 / det, -v01 / det, v00 / det], -1)
    op_eff = rng.uniform(0.0, 1.0, n)
    return dict(means2d=means2d.astype(np.float32), radii=radii.astype(np.int32),
                depths=depths.astype(np.float32), valid=valid,
                conics=conics.astype(np.float32), op_eff=op_eff.astype(np.float32))


@pytest.mark.parametrize("case", ["normal", "overflow", "culled"])
def test_bin_gaussians_matches_jax(case):
    inp = make_binning_inputs({"normal": 0, "overflow": 1, "culled": 2}[case], 600,
                              culled_frac=0.4 if case == "culled" else 0.0)
    kw = dict(width=W, height=H, tile_size=16)
    total = int(jbin.bin_gaussians(
        *(jnp.asarray(inp[k]) for k in ("means2d", "radii", "depths", "valid")),
        max_intersections=1 << 14, conics=jnp.asarray(inp["conics"]),
        op_eff=jnp.asarray(inp["op_eff"]), **kw).n_intersections)
    I = total // 2 if case == "overflow" else 1 << 14
    assert (total > I) == (case == "overflow") and total > 500
    want = jbin.bin_gaussians(
        *(jnp.asarray(inp[k]) for k in ("means2d", "radii", "depths", "valid")),
        max_intersections=I, conics=jnp.asarray(inp["conics"]),
        op_eff=jnp.asarray(inp["op_eff"]), **kw)
    got = binning.bin_gaussians(
        *(torch.from_numpy(inp[k]) for k in ("means2d", "radii", "depths", "valid")),
        max_intersections=I, conics=torch.from_numpy(inp["conics"]),
        op_eff=torch.from_numpy(inp["op_eff"]), **kw)
    for field in binning.BinnedIntersections._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == np.int32, field
        np.testing.assert_array_equal(g.reshape(w.shape), w, err_msg=field)
    if case == "culled":
        assert int((got.pair_counts == 0).sum()) > 100


# -------------------------------------------------- pair expansion (5)

def make_expand_case(N, tiles_x, tiles_y, seed, live_frac=0.9, max_span=6, zero_runs=()):
    """Depth-sorted offsets and span words as binning makes them (the
    cases of the JAX package's expand_pairs test, made anew here):
    zero-pair gaussians at the tail; `zero_runs`, (start, length) pairs,
    also empty runs inside the live range, which binning never makes."""
    r = np.random.default_rng(seed)
    live = r.random(N) < live_frac
    span_x = np.where(live, r.integers(1, max_span + 1, N), 0).astype(np.int32)
    span_y = np.where(live, r.integers(1, max_span + 1, N), 0).astype(np.int32)
    tmin_x = r.integers(0, tiles_x, N).astype(np.int32)
    tmin_y = r.integers(0, tiles_y, N).astype(np.int32)
    counts = (span_x * span_y).astype(np.int32)
    order = np.argsort(counts == 0, kind="stable")
    counts, tmin_x, tmin_y, span_x = counts[order], tmin_x[order], tmin_y[order], span_x[order]
    for start, length in zero_runs:
        counts[start:start + length] = 0
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    total = int(offsets[-1] + counts[-1])
    packed = (tmin_x | (tmin_y << 11) | (span_x << 22)).astype(np.int32)
    return offsets, packed, total


# (seed, N, I, tx, ty, zero_runs); the fourth has total > I, the fifth runs
# of zero-pair gaussians inside the live range, one of them longer than the
# CUDA kernel's 1,024-owner window
EXPAND_CASES = [(0, 2000, 1 << 13, 30, 17, ()), (1, 5000, 1 << 15, 60, 34, ()),
                (2, 512, 1 << 13, 8, 8, ()), (3, 100, 1024, 4, 4, ()),
                (4, 2000, 1 << 13, 30, 17, ((0, 3), (300, 1100), (1600, 7)))]


@pytest.mark.parametrize("seed,N,I,tx,ty,zero_runs", EXPAND_CASES,
                         ids=["-".join(map(str, c[:5])) + ("-zero_runs" if c[5] else "")
                              for c in EXPAND_CASES])
def test_searchsorted_expand_matches_jax(seed, N, I, tx, ty, zero_runs):
    offsets, packed, total = make_expand_case(N, tx, ty, seed, zero_runs=zero_runs)
    nt = tx * ty
    kw = dict(tiles_x=tx, num_tiles=nt)
    t_args = (torch.from_numpy(offsets), torch.from_numpy(packed),
              torch.tensor([total], dtype=torch.int32))
    j_args = (jnp.asarray(offsets), jnp.asarray(packed), jnp.asarray(total, jnp.int32))
    got = binning.searchsorted_expand(*t_args, I, **kw)
    for g, w in zip(got, jbin.searchsorted_expand(*j_args, I, **kw)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(expand_pairs(*t_args, I, **kw), got):  # the wrapper, on the CPU
        assert torch.equal(g, w)
    if zero_runs:
        # the Pallas kernel telescopes offsets over a 640-wide window, which
        # holds a block's owners only when every live gaussian owns a pair
        # (as binning makes them): on a longer empty run it differs on live
        # slots, so it is held on binning's inputs only
        return
    # the Pallas kernel: equal on live slots, the sentinel tile on dead ones
    t_pl, s_pl = map(np.asarray, j_expand_pairs(*j_args, I, interpret=True, **kw))
    live = min(total, I)
    np.testing.assert_array_equal(got[0].numpy()[:live], t_pl[:live])
    np.testing.assert_array_equal(got[1].numpy()[:live], s_pl[:live])
    assert (got[0].numpy()[live:] == nt).all() and (t_pl[live:] == nt).all()


# ------------------------------------------------- transposes (6, 7)

@pytest.mark.parametrize("w", [13, 15])
def test_transposes_match_jax(w):
    rng = np.random.default_rng(w)
    cap = 1024
    rows = rng.normal(size=(cap, w)).astype(np.float32)
    got = rows_to_attr_major(torch.from_numpy(rows))
    assert got.shape == (16, cap)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_rows_to_attr_major(jnp.asarray(rows), interpret=True)))
    assert torch.equal(got, rows_to_attr_major_plain(torch.from_numpy(rows)))
    attrs = rng.normal(size=(w, cap)).astype(np.float32)
    got = attr_major_to_rows(torch.from_numpy(attrs))
    assert got.shape == (cap, w)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_attr_major_to_rows(jnp.asarray(attrs), interpret=True)))
    assert torch.equal(got, attr_major_to_rows_plain(torch.from_numpy(attrs)))


# --------------------------------------------- rasterize, classic path

@pytest.fixture(scope="module")
def scene():
    params, aux = build_jax_scene()
    p_sd = jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))
    a_sd = jax.tree.map(np.asarray, flax.serialization.to_state_dict(aux))
    return dict(jax=(params, aux), sd=(p_sd, a_sd))


@pytest.fixture(scope="module")
def gaussians(scene):
    """The rasterizer's inputs for view 3 of the 96x64 scene (its
    gaussians made anisotropic, as trained ones are: the initialiser's
    are spheres, whose quaternion gradient is rounding noise; three extra
    colour channels in [-1, 1] stand in for the preset's normals) and
    cotangents for the render and alpha."""
    t_params, t_aux = scene_from_state_dict(*scene["sd"], device="cpu")
    v = make_views()[3]
    cfg = tconfigs.mtgs_config(W, H).replace(max_intersections=I_CAP)
    g = ttr.render_view(t_params, t_aux, cfg, ttr.Batch(**v), 10**9,
                        device="cpu")["gaussians"]
    rng = np.random.default_rng(4)
    n = g["means"].shape[0]
    colors = np.concatenate([g["colors"].numpy(), rng.uniform(-1, 1, (n, 3))], -1)
    arrays = dict(means=g["means"].numpy(), quats=g["quats"].numpy(),
                  scales=(g["scales"].numpy() * np.exp(rng.normal(0, 0.4, (n, 3)))
                          ).astype(np.float32),
                  opacities=g["opacities"].numpy(),
                  colors=colors.astype(np.float32),
                  viewmat=camera_to_gsplat_viewmat(torch.from_numpy(v["c2w"])).numpy(),
                  K=v["K"])
    cot_r = rng.normal(size=(H, W, 7)).astype(np.float32)
    cot_r[..., -1] *= 0.05  # the depth channel is in metres
    return dict(arrays=arrays, cot_r=cot_r, cot_a=rng.normal(size=(H, W, 1)).astype(np.float32))


RASTER_KW = dict(width=W, height=H, tile_size=32, rasterize_mode="antialiased",
                 render_mode="RGB+ED")
PARAM_KEYS = ("means", "quats", "scales", "opacities", "colors")


def jax_render_and_grads(gs, config):
    a = {k: jnp.asarray(v) for k, v in gs["arrays"].items()}
    n = a["means"].shape[0]

    def loss_fn(params, tap, sink):
        render, alpha, info = jrasterize(*params, a["viewmat"], a["K"], config, tap2d=tap,
                                         absgrad_sink=sink)
        loss = (render * gs["cot_r"]).sum() + (alpha * gs["cot_a"]).sum()
        return loss, (render, alpha, info["n_intersections"])

    zeros = jnp.zeros((n, 2), jnp.float32)
    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True))(
        tuple(a[k] for k in PARAM_KEYS), zeros, zeros)
    return aux, (*grads[0], grads[1], grads[2])


def torch_render_and_grads(gs, config):
    a = {k: torch.from_numpy(np.asarray(v)) for k, v in gs["arrays"].items()}
    params = [a[k].clone().requires_grad_(True) for k in PARAM_KEYS]
    n = params[0].shape[0]
    tap = torch.zeros((n, 2), requires_grad=True)
    sink = torch.zeros((n, 2), requires_grad=True)
    render, alpha, info = rasterize(*params, a["viewmat"], a["K"], config, tap2d=tap,
                                    absgrad_sink=sink)
    loss = (render * torch.from_numpy(gs["cot_r"])).sum() \
        + (alpha * torch.from_numpy(gs["cot_a"])).sum()
    grads = torch.autograd.grad(loss, params + [tap, sink])
    return (render.detach(), alpha.detach(), info["n_intersections"]), grads


@pytest.fixture(scope="module")
def classic_pair(gaussians):
    """The port's classic path; JAX's render on its classic path and its
    gradients on its fused path. JAX's classic backward on a CPU is a
    cumsum over all slots less its values at the gaussians' boundaries:
    here (4,323 pairs) that rounding alone puts its scales gradient
    4.6e-4 of the largest |value| from its own fused path's, whose
    per-gaussian sums are taken slot by slot as the port's are (the port
    is within 6e-6 of it). The classic gradients are also held against
    the float64 goldens below."""
    kw = dict(**RASTER_KW, max_intersections=I_CAP, backend="pallas", interpret=True)
    want_render, _ = jax_render_and_grads(gaussians, JConfig(**kw, fused=False))
    _, want_grads = jax_render_and_grads(gaussians, JConfig(**kw, fused=True))
    got = torch_render_and_grads(
        gaussians, RasterizeConfig(**RASTER_KW, max_intersections=I_CAP, fused=False))
    return got, (want_render, want_grads)


def test_classic_render_matches_jax(classic_pair):
    (got, _), (want, _) = classic_pair
    assert_images_close(got[0], got[1], want[0], want[1])
    assert 1000 < int(want[2]) <= I_CAP
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("which", INPUTS)
def test_classic_gradients_match_jax(classic_pair, which):
    (_, got), (_, want) = classic_pair
    i = INPUTS.index(which)
    g, w = got[i].numpy(), np.asarray(want[i])
    assert np.abs(w).max() > 0, which
    assert max_scaled_err(g, w) <= GRAD_TOL, (which, max_scaled_err(g, w))


@pytest.mark.parametrize("name", ["classic_rgb", "antialiased_rgbed",
                                  "antialiased_rgbed_tile16", "deep_stack_classic"])
def test_classic_gradients_match_gsplat_golden(name):
    """The classic path's gradients, tap2d and absgrad against the
    float64 gsplat-math goldens (test_goldens.py's tolerances)."""
    g = np.load(GOLDEN_DIR / f"{name}.npz")
    cfg = RasterizeConfig(
        width=int(g["W"]), height=int(g["H"]), tile_size=int(g["tile_size"]),
        rasterize_mode="antialiased" if bool(g["antialiased"]) else "classic",
        render_mode="RGB+ED" if bool(g["with_depth"]) else "RGB",
        max_intersections=1 << 16, fused=False)
    keys = ("means", "quats", "scales", "opac", "colors")
    params = [torch.tensor(np.asarray(g[k], np.float32), requires_grad=True) for k in keys]
    viewmat, K = (torch.from_numpy(np.asarray(g[k], np.float32)) for k in ("viewmat", "K"))
    n = params[0].shape[0]
    tap = torch.zeros((n, 2), requires_grad=True)
    sink = torch.zeros((n, 2), requires_grad=True)
    render, alpha, _ = rasterize(*params, viewmat, K, cfg, tap2d=tap, absgrad_sink=sink)
    np.testing.assert_allclose(render.detach().numpy(), g["render"], atol=2e-3)
    np.testing.assert_allclose(alpha.detach().numpy(), g["alpha"], atol=1e-3)
    loss = (render * torch.from_numpy(g["cot_r"].astype(np.float32))).sum() \
        + (alpha * torch.from_numpy(g["cot_a"].astype(np.float32))).sum()
    grads = torch.autograd.grad(loss, params + [tap, sink])
    wants = [g[f"g_{k}"] for k in keys] + [g["g_means2d"], g["absgrad"]]
    for got, want, k in zip(grads, wants, (*keys, "tap2d", "absgrad")):
        scale = max(1.0, float(np.abs(want if k != "absgrad" else g["g_means2d"]).max()))
        np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=2e-4, err_msg=k)


def test_classic_overflow_matches_jax(gaussians):
    """max_intersections below the pair count: both drop the same
    farthest-in-depth-order pairs."""
    a = gaussians["arrays"]
    I = 2048
    jcfg = JConfig(**RASTER_KW, max_intersections=I, backend="pallas", interpret=True,
                   fused=False)
    want = jax.jit(lambda *x: jrasterize(*x, jcfg))(*(jnp.asarray(a[k]) for k in (
        *PARAM_KEYS, "viewmat", "K")))
    got = rasterize(*(torch.from_numpy(np.asarray(a[k])) for k in (*PARAM_KEYS, "viewmat", "K")),
                    RasterizeConfig(**RASTER_KW, max_intersections=I, fused=False))
    assert int(got[2]["n_intersections"]) == int(want[2]["n_intersections"]) > 2 * I
    assert_images_close(got[0], got[1], want[0], want[1])


def test_rasterize_takes_classic_path_where_key_packing_fails(monkeypatch):
    """512x512 at tile 8 is 4,096 tiles; with I = 2^19 the fused key
    ((4096 + 1) << 19) + I passes 2^31, so rasterize takes the classic
    path (it used to raise there) and renders as JAX's classic path does.
    JAX renders at a capacity of 2^13, which holds every pair, so its
    image and pair count are those at 2^19: its XLA blend scans every
    tile over all cap / 128 windows, ~12 minutes on a CPU at 2^19."""
    cfg = RasterizeConfig(512, 512, tile_size=8, rasterize_mode="antialiased",
                          render_mode="RGB+ED", max_intersections=1 << 19)
    rng = np.random.default_rng(9)
    n = 200
    assert cfg.fused and not fused_fits(cfg.max_intersections, cfg.tiles_x * cfg.tiles_y, n)
    arrays = dict(
        means=np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                        rng.uniform(4, 10, n)], -1),
        quats=rng.normal(size=(n, 4)), scales=np.exp(rng.normal(-2.5, 0.5, (n, 3))),
        opacities=rng.uniform(0.2, 0.95, n), colors=rng.uniform(0, 1, (n, 3)),
        viewmat=np.eye(4), K=np.array([[400.0, 0, 256], [0, 400.0, 256], [0, 0, 1]]))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    calls = []
    binned = rasterize_mod.bin_gaussians
    monkeypatch.setattr(rasterize_mod, "bin_gaussians",
                        lambda *a, **kw: calls.append(1) or binned(*a, **kw))
    got = rasterize(*(torch.from_numpy(v) for v in arrays.values()), cfg)
    assert calls == [1]
    jcfg = JConfig(512, 512, tile_size=8, rasterize_mode="antialiased", render_mode="RGB+ED",
                   max_intersections=1 << 13, backend="xla")
    want = jax.jit(lambda *x: jrasterize(*x, jcfg))(*(jnp.asarray(v) for v in arrays.values()))
    total = int(want[2]["n_intersections"])
    assert int(got[2]["n_intersections"]) == total and 4000 < total <= 1 << 13
    assert_images_close(got[0], got[1], want[0], want[1])


# ------------------------------------ the port's classic against fused

def test_classic_matches_fused_in_the_port(gaussians, monkeypatch):
    """The same scene through both paths of the port at I = 2^14: the
    classic slab equals the fused one on every live slot, so renders and
    gradients agree to rounding."""
    slabs = {}
    blend = rasterize_mod.blend_forward

    def record(fused):
        def call(slab_t, *a, **kw):
            slabs[fused] = (slab_t.clone(), [x.clone() for x in a[:4]])
            return blend(slab_t, *a, **kw)
        return call

    out = {}
    for fused in (True, False):
        monkeypatch.setattr(rasterize_mod, "blend_forward", record(fused))
        out[fused] = torch_render_and_grads(
            gaussians, RasterizeConfig(**RASTER_KW, max_intersections=1 << 14, fused=fused))
    (r_f, a_f, n_f), g_f = out[True]
    (r_c, a_c, n_c), g_c = out[False]
    total = int(n_f)
    assert total == int(n_c) and 1000 < total <= 1 << 14
    for f, c in zip(slabs[True][1], slabs[False][1]):  # the per-tile ranges
        assert torch.equal(f, c)
    assert torch.equal(slabs[True][0][:, :total], slabs[False][0][:, :total])
    assert float((r_f - r_c).abs().max()) <= 1e-6
    assert float((a_f - a_c).abs().max()) <= 1e-6
    for name, f, c in zip(INPUTS, g_f, g_c):
        assert max_scaled_err(c.numpy(), f.numpy()) <= 1e-5, name


def test_classic_train_step_matches_fused(scene):
    """One full train_step on each path from the same state: every loss
    term within 1e-6 relative."""
    v = make_views()[3]
    v["image"] = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(np.float32)
    v["pseudo_depth"] = np.full((H, W, 1), 10.0, np.float32)
    metrics = {}
    for fused in (True, False):
        params, aux = scene_from_state_dict(*scene["sd"], device="cpu")
        cfg = tconfigs.mtgs_config(W, H).replace(max_intersections=1 << 14, fused=fused)
        state = ttr.init_train_state(params)
        state.step = 3000
        metrics[fused] = ttr.train_step(state, aux, cfg, ttr.Batch(**v),
                                        OptimConfig(groups=default_groups(cfg.max_steps)),
                                        device="cpu")
    assert set(metrics[True]) == set(metrics[False])
    for k, f in metrics[True].items():
        c = metrics[False][k]
        assert abs(float(c) - float(f)) <= 1e-6 * max(1.0, abs(float(f))), (k, c, f)


def test_render_view_classic_matches_jax(scene):
    params, aux = scene["jax"]
    t_params, t_aux = scene_from_state_dict(*scene["sd"], device="cpu")
    jcfg = jconfigs.mtgs_config(W, H).replace(
        backend="pallas", interpret=True, fused=False, max_intersections=I_CAP)
    tcfg = tconfigs.mtgs_config(W, H).replace(max_intersections=I_CAP, fused=False)
    v = make_views()[1]
    want = jax.jit(lambda p, b: jtr.render_view(
        p, aux, jcfg, b, jnp.asarray(10**9, jnp.int32), training=False))(params, jax_batch(v))
    got = ttr.render_view(t_params, t_aux, tcfg, ttr.Batch(**v), 10**9, device="cpu")
    assert_renders_close(got, want)


# ------------------------------------------------------- render tool

def test_rotmat_to_quat_and_interpolate_poses_match_jax():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:8, 0] = 0.0  # rotations by pi: the pivot falls on x, y or z
    R = np.asarray(jquat.quat_to_rotmat(jnp.asarray(q)))
    got = rotmat_to_quat(torch.from_numpy(R)).numpy()
    want = np.asarray(jquat.rotmat_to_quat(jnp.asarray(R)))
    sign = np.where(np.sum(got * want, -1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * sign, want, atol=1e-6)

    c2ws = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    c2ws[:, :3, :3] = R[8:12]
    c2ws[:, :3, 3] = rng.normal(size=(4, 3))
    ts = np.array([0.0, 0.4, 0.7, 1.0])
    poses, times = trender.interpolate_poses(c2ws, ts, target_hz=10.0, source_hz=2.0)
    w_poses, w_times = jrender.interpolate_poses(c2ws, ts, target_hz=10.0, source_hz=2.0)
    assert poses.shape == w_poses.shape == (16, 4, 4)
    np.testing.assert_allclose(poses, w_poses, atol=1e-6)
    np.testing.assert_allclose(times, w_times, atol=1e-6)


def test_camera_path_json_and_depth_colormap_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    spec = dict(render_width=320, seconds=2.0, camera_path=[
        dict(camera_to_world=rng.normal(size=16).tolist(), fov=40.0 + 5 * i) for i in range(3)])
    path = tmp_path / "path.json"
    path.write_text(json.dumps(spec))
    got, want = trender.load_camera_path_json(path), jrender.load_camera_path_json(path)
    assert got.keys() == want.keys() and got["height"] == 1080 and got["width"] == 320
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    depth = rng.uniform(0.0, 80.0, (24, 32, 1)).astype(np.float32)
    depth[0, :4] = 0.0
    depth[1, :2] = np.nan
    np.testing.assert_array_equal(trender.depth_colormap(depth), jrender.depth_colormap(depth))
    np.testing.assert_array_equal(trender.depth_colormap(depth, far=30.0),
                                  jrender.depth_colormap(depth, far=30.0))


def _tool_scene(scene):
    params, aux = scene_from_state_dict(*scene["sd"], device="cpu")
    cfg = tconfigs.mtgs_config(32, 24).replace(max_intersections=1 << 14)
    return params, aux, cfg


def test_render_camera_path_writes_the_rendered_frames(scene, tmp_path):
    params, aux, cfg = _tool_scene(scene)
    views = make_views()
    frames = [dict(camera_to_world=v["c2w"].reshape(-1).tolist(), fov=60.0) for v in views[:3]]
    path = tmp_path / "path.json"
    path.write_text(json.dumps(dict(render_width=32, render_height=24, fps=10,
                                    camera_path=frames)))
    written = trender.render_camera_path(params, aux, cfg, path, tmp_path / "frames",
                                         make_video=False, device="cpu")
    assert [p.name for p in written] == [f"frame_{i:05d}.png" for i in range(3)]
    spec = trender.load_camera_path_json(path)
    icfg = cfg.replace(scene=dataclasses.replace(cfg.scene, interp_poses=True))
    for i, p in enumerate(written):
        batch = ttr.Batch(image=np.zeros((1, 1, 3), np.float32),
                          mask=np.ones((1, 1, 1), np.float32), c2w=spec["poses"][i],
                          K=spec["Ks"][0], cam_idx=0, image_idx=0, travel_index=0,
                          frame_idx=0, timestamp=float(np.linspace(0, 1, 3)[i]))
        out = ttr.render_view(params, aux, icfg, batch, 10**6, device="cpu")
        want = (torch.clamp(out["rgb_appearance"], 0, 1) * 255).to(torch.uint8).numpy()
        img = np.asarray(Image.open(p))
        assert img.shape == (24, 32, 3) and img.max() > 0
        np.testing.assert_array_equal(img, want)


def test_render_dataset_applies_the_camera_deltas(scene, tmp_path):
    params, aux, cfg = _tool_scene(scene)
    v = make_views()[0]
    v.update(image=np.random.default_rng(13).uniform(0, 1, (24, 32, 3)).astype(np.float32),
             mask=np.ones((24, 32, 1), np.float32), lidar_depth=None,
             K=np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]], np.float32))
    params.camera_opt[v["image_idx"]] = torch.tensor([0.3, -0.2, 0.1, 0.05, 0.1, -0.05])
    batch = ttr.Batch(**v)
    written = trender.render_dataset(params, aux, cfg, [batch], tmp_path, device="cpu")
    assert sorted(p.parent.name for p in written) == ["depth", "gt", "rgb"]
    img = {p.parent.name: np.asarray(Image.open(p)) for p in written}
    renders = {opt: ttr.render_view(params, aux, cfg, batch, 10**9, apply_cam_opt=opt,
                                    device="cpu") for opt in (True, False)}
    to8 = lambda x: (torch.clamp(x, 0, 1) * 255).to(torch.uint8).numpy()
    np.testing.assert_array_equal(img["rgb"], to8(renders[True]["rgb_appearance"]))
    assert not np.array_equal(img["rgb"], to8(renders[False]["rgb_appearance"]))
    np.testing.assert_array_equal(img["gt"], to8(torch.from_numpy(v["image"])))
    np.testing.assert_array_equal(
        img["depth"], trender.depth_colormap(renders[True]["depth"].numpy()))
