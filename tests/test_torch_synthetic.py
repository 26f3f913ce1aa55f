"""The synthetic scene of mtgs_torch against the JAX package's.

Both packages draw the ground truth from `key(seed)` (the port with
`core.prng`, its copy of `jax.random`), so one seed gives one scene: the
two `make_synthetic_scene`s run unpatched on the same arguments (JAX
renders with its XLA backend; one jit compile, shared by the module
fixture). Tolerances: the ground-truth gaussians bit-equal (the same
draws, with XLA's CPU sin, cos and exp, `core/xla_math.py`), and within
1e-6, relative above 1, of JAX's draw compiled whole by `jax.jit` (XLA
fuses across its ops there, which JAX's eager scene does not); images (rgb)
2e-3 (the golden render tolerance); depth 1e-3 relative where both
packages' alpha > 0.5 masks agree, and the masks may disagree only where
|alpha - 0.5| < 1e-3; cameras, intrinsics, timestamps and the instance
poses exact (the same numpy arithmetic); the seed points exact (the same
numpy draws on equal ground truth). `build_scene_model` against JAX's on
one scene: every leaf bit-equal, the WildGaussians weights included
(both drawn from `key(0)`).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.data import synthetic as js
from mtgs_torch.core import prng
from mtgs_torch.core.camera import camera_to_gsplat_viewmat
from mtgs_torch.data import synthetic as ts
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.raster.projection import project_gaussians
from mtgs_torch.train.optim import named_leaves

W, H = 48, 32
N_BG, N_INST = 300, 40
SCENE_KW = dict(seed=0, width=W, height=H, n_travels=2, n_frames=2, n_bg=N_BG,
                n_instance=N_INST, n_seed=200, color_noise=0.25, gt_max_intersections=1 << 12)


def close_gt(got, want, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6, err_msg=msg)


def same(got, want, msg=""):
    want = np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), msg


@pytest.fixture(scope="module")
def shared():
    """(port scene, JAX scene, the port's alpha of each view) of one seed,
    neither package patched."""
    alphas = []

    def recording(*a, **kw):
        out = rasterize(*a, **kw)
        alphas.append(out[1].numpy())
        return out

    rasterize = ts.rasterize
    mp = pytest.MonkeyPatch()
    mp.setattr(ts, "rasterize", recording)
    try:
        port = ts.make_synthetic_scene(device="cpu", **SCENE_KW)
    finally:
        mp.undo()
    ref = js.make_synthetic_scene(backend="xla", **SCENE_KW)
    return port, ref, np.stack(alphas).reshape(port.depths.shape)


@pytest.mark.parametrize("seed, n, extent, ground_scale, color_noise", [
    (0, N_BG, 12.0, 0.4, 0.25), (5, N_BG, 12.0, 0.4, 0.25)])
def test_gt_gaussians_match_jax(shared, seed, n, extent, ground_scale, color_noise):
    """The ground truth and the instance of one seed, every array JAX's
    bit for bit (after the module fixture, whose JAX scene compiled these
    shapes' ops; the street-layout test holds another size)."""
    jkb, jki = jax.random.split(jax.random.key(seed))
    tkb, tki = prng.split(prng.key(seed))
    got = ts._gt_gaussians(tkb, n, extent, ground_scale, color_noise)
    want = js._gt_gaussians(jkb, n, extent, ground_scale, color_noise)
    names = ("means", "quats", "scales", "opacities", "colors")
    for name, g, w in zip(names, got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        same(g, w, name)
    for name, g, w in zip(names, ts._instance_gaussians(tki, N_INST),
                          js._instance_gaussians(jki, N_INST)):
        same(g, w, "instance " + name)


def test_renders_match_jax_on_shared_ground_truth(shared):
    port, ref, alpha = shared
    assert port.images.shape == ref.images.shape == (2, 2, H, W, 3)
    assert float(port.images.std()) > 0.05  # the views see structure, not one colour
    np.testing.assert_allclose(port.images, ref.images, rtol=0, atol=2e-3)
    mask_t, mask_j = port.depths > 0, ref.depths > 0
    assert mask_t.mean() > 0.15  # the depth comparison covers a fifth of the pixels
    both = mask_t & mask_j
    rel = np.abs(port.depths[both] - ref.depths[both]) / np.abs(ref.depths[both])
    assert rel.max() <= 1e-3
    assert np.all(np.abs(alpha[mask_t != mask_j] - 0.5) < 1e-3)
    for name in ("c2ws", "K", "timestamps", "instance_quats", "instance_trans",
                 "instance_present", "instance_size", "masks"):
        a, b = getattr(port, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("seed_xyz", "seed_rgb", "instance_xyz", "instance_rgb"):
        same(getattr(port, name), getattr(ref, name), name)
    assert port.seed_xyz.shape == (200, 3)


def test_gt_gaussians_keep_the_street_layout_of_jax():
    """JAX's class shares (ground 45%, buildings 35%, roadside 15%,
    backdrop 5%), its clear carriageway and its value ranges; the same
    key gives the same arrays, JAX's within 1e-6 (its draw compiled whole
    by `jax.jit`: one compile in place of one for each eager op, ~10 s
    here; XLA then fuses multiply-adds across the draw's ops, so 1,549 of
    these 28,000 values round apart from JAX's eager draw, which the port
    equals), another key others."""
    n, extent = 2000, 20.0
    port = ts._gt_gaussians(prng.key(3), n, extent, 0.18, 0.25)
    again = ts._gt_gaussians(prng.key(3), n, extent, 0.18, 0.25)
    other = ts._gt_gaussians(prng.key(4), n, extent, 0.18, 0.25)
    assert all(np.array_equal(a, b) for a, b in zip(port, again))
    assert not np.array_equal(port[0], other[0])
    draw = jax.jit(js._gt_gaussians, static_argnums=(1, 2, 3, 4))
    ref = [np.asarray(a) for a in draw(jax.random.key(3), n, extent, 0.18, 0.25)]
    for g, w in zip(port, ref):
        close_gt(g, w)
    n_g, n_b, n_o = int(n * 0.45), int(n * 0.35), int(n * 0.15)
    for arrays in (port, ref):
        means, quats, scales, opac, colors = arrays
        assert [a.shape for a in arrays] == [(n, 3), (n, 4), (n, 3), (n,), (n, 3)]
        assert all(a.dtype == np.float32 for a in arrays)
        ground, build = means[:n_g], means[n_g:n_g + n_b]
        back = means[n_g + n_b + n_o:]
        assert np.all(ground[:, 2] == 0) and np.all(np.abs(ground[:, :2]) <= extent)
        assert np.all(scales[:n_g] == np.float32([0.18, 0.18, 0.045]))
        # the clear carriageway: no building gaussian within 3.5 m of the road's centre
        assert np.all(np.abs(build[:, 1]) >= 3.5 - 1e-5)
        assert np.all(build[:, 2] >= 0.05)
        r = np.hypot(back[:, 0], back[:, 1])
        assert np.all((r >= 1.3 * extent - 1e-4) & (r <= 1.7 * extent + 1e-4))
        assert np.all((colors >= 0) & (colors <= 1)) and np.all(opac == np.float32(0.9))
        assert np.all(quats[:n_g] == np.float32([1, 0, 0, 0]))


def test_scene_is_the_same_on_a_second_run():
    kw = dict(SCENE_KW, n_bg=200, n_instance=20)
    a = ts.make_synthetic_scene(device="cpu", **kw)
    b = ts.make_synthetic_scene(device="cpu", **kw)
    for f in dataclasses.fields(ts.SyntheticScene):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(x, y), f.name


def _jax_scene(scene):
    return js.SyntheticScene(**{f.name: getattr(scene, f.name)
                                for f in dataclasses.fields(ts.SyntheticScene)})


def test_build_scene_model_matches_jax(shared):
    port_scene = shared[0]
    kw = dict(with_instances=True, with_skybox=True, skybox_points=64)
    jp, ja = js.build_scene_model(_jax_scene(port_scene), **kw)
    sd = lambda tree: jax.tree.map(np.asarray, flax.serialization.to_state_dict(tree))
    want_p, want_a = scene_from_state_dict(sd(jp), sd(ja), device="cpu")
    got_p, got_a = ts.build_scene_model(port_scene, device="cpu", **kw)
    for got, want in ((got_p, want_p), (got_a, want_a)):
        g, w = dict(named_leaves(got)), dict(named_leaves(want))
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            assert torch.equal(g[k], w[k]), k
    assert got_p.background.features_rest.shape[1] == 2   # per-traversal SH rest
    # WildGaussians: the same leaves, the wild weights drawn from key(0) in both
    jp, ja = js.build_scene_model(_jax_scene(port_scene), wild_appearance=True, **kw)
    want_p, _ = scene_from_state_dict(sd(jp), sd(ja), device="cpu")
    got_p, _ = ts.build_scene_model(port_scene, wild_appearance=True, device="cpu", **kw)
    g, w = dict(named_leaves(got_p)), dict(named_leaves(want_p))
    assert list(g) == list(w) and "wild.embeddings" in w
    assert w["wild.embeddings"].shape == (port_scene.frame_rows, 32)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k
    assert float(g["wild.w1"].std()) > 0.05     # He-normal, not zeros


def test_batch_iterator_order_matches_jax(shared):
    port_scene = shared[0]
    ref = js.batch_iterator(_jax_scene(port_scene), seed=5)
    got = ts.batch_iterator(port_scene, seed=5, device="cpu")
    for _ in range(10):
        a, b = next(got), next(ref)
        assert (a.travel_index, a.frame_idx, a.image_idx) == (
            int(b.travel_index), int(b.frame_idx), int(b.image_idx))
        assert np.array_equal(a.image.numpy(), np.asarray(b.image))
        assert np.array_equal(a.lidar_depth.numpy(), np.asarray(b.lidar_depth))
        assert a.timestamp == float(b.timestamp)


def numpy_street(rng, n, extent, ground_scale):
    """Arbitrary ground truth for the truncation test, from a numpy
    generator: the street layout of `_gt_gaussians` (ground, building
    boxes, roadside clusters, a backdrop ring), without colour noise;
    float32 (means, quats, scales, opacities, colors)."""
    u, nrm = rng.uniform, rng.standard_normal
    n_g, n_b, n_o = int(n * 0.45), int(n * 0.35), int(n * 0.15)
    n_back = n - n_g - n_b - n_o
    gx, gy = u(-extent, extent, n_g), u(-extent, extent, n_g)
    ground = np.stack([gx, gy, np.zeros_like(gx)], -1)
    gcol = np.stack([0.5 + 0.4 * np.sin(gx * 0.7), 0.5 + 0.4 * np.cos(gy * 0.9),
                     0.4 + 0.3 * np.sin((gx + gy) * 0.5)], -1)
    gscale = np.tile([ground_scale, ground_scale, min(0.05, ground_scale / 4)], (n_g, 1))
    nb = max(4, int(extent / 4))
    bx = u(-extent, extent, nb)
    side = np.where(rng.random(nb) < 0.5, 1.0, -1.0)
    by = side * u(min(7.0, extent * 0.45), min(15.0, extent * 0.9), nb)
    bw = u(1.5, 4.0, (nb, 3)) * np.array([1.0, 1.0, 2.0])
    by = side * np.maximum(np.abs(by), bw[:, 1] + 3.5)
    bcol = u(0.15, 0.9, (nb, 3))
    which = rng.integers(0, nb, n_b)
    build = np.stack([bx, by, bw[:, 2]], -1)[which] + u(-1.0, 1.0, (n_b, 3)) * bw[which]
    build[:, 2] = np.maximum(build[:, 2], 0.05)
    bcols = np.clip(bcol[which] + 0.15 * np.sin(build[:, 2] * 4.0)[:, None], 0.02, 1.0)
    bscale, bquat = np.exp(nrm((n_b, 3)) * 0.25 - 1.35), nrm((n_b, 4))
    ncl = max(6, n_o // 400)
    cx = u(-extent, extent, ncl)
    cy = np.where(rng.random(ncl) < 0.5, 1.0, -1.0) * u(4.5, 7.0, ncl)
    cz, ccol = u(0.8, 2.5, ncl), u(0.1, 0.8, (ncl, 3))
    ow = rng.integers(0, ncl, n_o)
    objs = np.stack([cx, cy, cz], -1)[ow] + 0.6 * nrm((n_o, 3))
    objs[:, 2] = np.abs(objs[:, 2]) + 0.1
    ocols = np.clip(ccol[ow] + 0.1 * nrm((n_o, 3)), 0.02, 1.0)
    oscale, oquat = np.exp(nrm((n_o, 3)) * 0.3 - 1.6), nrm((n_o, 4))
    th = u(0, 2 * np.pi, n_back)
    rr = extent * (1.3 + 0.4 * rng.random(n_back))
    back = np.stack([rr * np.cos(th), rr * np.sin(th), u(0.0, extent * 0.25, n_back)], -1)
    backcol = np.stack([0.35 + 0.3 * np.sin(th * 3), 0.4 + 0.2 * np.cos(th * 5),
                        0.5 + 0.2 * np.sin(th * 2 + 1.0)], -1)
    unit = lambda m: np.tile([1.0, 0, 0, 0], (m, 1))
    arrays = (np.concatenate([ground, build, objs, back]),
              np.concatenate([unit(n_g), bquat, oquat, unit(n_back)]),
              np.concatenate([gscale, bscale, oscale, np.full((n_back, 3), extent * 0.02)]),
              np.full((n,), 0.9), np.concatenate([gcol, bcols, ocols, backcol]))
    return tuple(np.asarray(a, np.float32) for a in arrays)


def test_truncated_ground_truth_matches_jax(monkeypatch):
    """A ground truth whose pairs pass gt_max_intersections raises by
    default; with truncate_gt the port keeps the truncated render (the
    farthest pairs dropped), as JAX's `make_synthetic_scene` always does:
    the same images as JAX's on shared ground truth (2e-3, the golden
    render tolerance), and not the untruncated ones."""
    n = 6000
    gt = numpy_street(np.random.default_rng([0, 0]), n, 12.0, 0.4)
    monkeypatch.setattr(js, "_gt_gaussians", lambda key, *a: tuple(jnp.asarray(x) for x in gt))
    monkeypatch.setattr(ts, "_gt_gaussians", lambda key, *a: gt)
    kw = dict(seed=0, width=64, height=64, n_travels=1, n_frames=2, n_bg=n, n_instance=0,
              gt_max_intersections=1024)
    with pytest.raises(ValueError, match="would be truncated"):
        ts.make_synthetic_scene(device="cpu", **kw)
    port = ts.make_synthetic_scene(device="cpu", truncate_gt=True, **kw)
    ref = js.make_synthetic_scene(backend="xla", **kw)
    full = ts.make_synthetic_scene(device="cpu", **dict(kw, gt_max_intersections=1 << 14))
    np.testing.assert_allclose(port.images, ref.images, rtol=0, atol=2e-3)
    assert np.abs(port.images - full.images).mean() > 0.05


def cutoff_pairs(scene, t, f, means, quats, scales, opacities, x, y):
    """The alpha of each gaussian of view (t, f) at pixel (x, y) whose alpha
    there lies within 1e-4 relative of the 1/255 cut-off (float64 from the
    port's projection): the pairs that differently rounded blends may take
    on different sides of it."""
    on = lambda a: torch.as_tensor(np.asarray(a))
    p = project_gaussians(on(means), on(quats), on(scales),
                          camera_to_gsplat_viewmat(on(scene.c2ws[t, f])), on(scene.K),
                          scene.width, scene.height)
    d = (torch.tensor([x + 0.5, y + 0.5]) - p.means2d).double()
    a, b, c = p.conics.double().unbind(-1)
    sigma = 0.5 * (a * d[:, 0] ** 2 + c * d[:, 1] ** 2) + b * d[:, 0] * d[:, 1]
    alpha = on(opacities).double() * p.compensations.double() * torch.exp(-sigma)
    near = p.valid & ((alpha * 255.0 - 1.0).abs() <= 1e-4)
    return alpha[near].tolist()


def test_truncated_seed_0_parts_from_jax_only_at_the_cutoff(monkeypatch):
    """Seed 0's own street truncated at 1024 pairs, the port's render
    against JAX's: JAX renders the port's draw of seed 0 (JAX's own within
    1e-6, test_gt_gaussians_match_jax), which keeps JAX's compile of its
    draw at this size off the test. Every pixel within 2e-3 but cut-off
    flips: at most one a view, with a gaussian whose alpha there lies
    within 1e-4 relative of 1/255 (taken by one blend, dropped by the
    other), and within 2e-3 plus that alpha (what one pair in or out moves
    a colour in [0, 1] by at most). Seed 0 has one (view 0, pixel (62, 26),
    alpha 0.0039217; the same with JAX's own draw)."""
    n = 6000
    kw = dict(seed=0, width=64, height=64, n_travels=1, n_frames=2, n_bg=n, n_instance=0,
              gt_max_intersections=1024)
    gt = ts._gt_gaussians(prng.split(prng.key(0))[0], n, 12.0, 0.4, 0.0)
    monkeypatch.setattr(js, "_gt_gaussians", lambda key, *a: tuple(jnp.asarray(x) for x in gt))
    port = ts.make_synthetic_scene(device="cpu", truncate_gt=True, **kw)
    ref = js.make_synthetic_scene(backend="xla", **kw)
    err = np.abs(port.images - ref.images).max(-1)
    for f in range(2):
        flips = np.argwhere(err[0, f] > 2e-3)
        assert len(flips) <= 1, flips
        for y, x in flips:
            alphas = cutoff_pairs(port, 0, f, *gt[:4], x, y)
            assert alphas and err[0, f, y, x] <= 2e-3 + max(alphas), (f, x, y, alphas)
