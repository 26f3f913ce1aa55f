"""The synthetic scene of mtgs_torch against the JAX package's.

The port draws its ground truth from numpy generators and the JAX package
from `jax.random`, so their scenes differ. Parity is held on shared
ground truth: one set of gaussians and one instance, drawn by the port,
are patched into both packages' `make_synthetic_scene` (JAX renders with
its XLA backend; one jit compile, shared by the module fixture).
Tolerances: images (rgb) 2e-3 (the golden render tolerance); depth 1e-3
relative where both packages' alpha > 0.5 masks agree, and the masks may
disagree only where |alpha - 0.5| < 1e-3; cameras, intrinsics, timestamps
and the instance poses exact (the same numpy arithmetic); the seed points
1e-6 (the same numpy draws on equal ground truth). `build_scene_model`
against JAX's on one scene: every leaf within 1e-6.
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
from mtgs_torch.data import synthetic as ts
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.train.optim import named_leaves

W, H = 48, 32
N_BG, N_INST = 300, 40
SCENE_KW = dict(seed=0, width=W, height=H, n_travels=2, n_frames=2, n_bg=N_BG,
                n_instance=N_INST, n_seed=200, color_noise=0.25, gt_max_intersections=1 << 12)


@pytest.fixture(scope="module")
def shared():
    """(port scene, JAX scene, the port's alpha of each view) on the same
    ground-truth gaussians."""
    gt = ts._gt_gaussians(np.random.default_rng([0, 0]), N_BG, 12.0, 0.4, 0.25)
    inst = ts._instance_gaussians(np.random.default_rng([0, 1]), N_INST)
    alphas = []

    def recording(*a, **kw):
        out = rasterize(*a, **kw)
        alphas.append(out[1].numpy())
        return out

    rasterize = ts.rasterize
    mp = pytest.MonkeyPatch()
    mp.setattr(js, "_gt_gaussians", lambda key, *a: tuple(jnp.asarray(x) for x in gt))
    mp.setattr(js, "_instance_gaussians", lambda key, m: tuple(jnp.asarray(x) for x in inst))
    mp.setattr(ts, "_gt_gaussians", lambda rng, *a: gt)
    mp.setattr(ts, "_instance_gaussians", lambda rng, m: inst)
    mp.setattr(ts, "rasterize", recording)
    try:
        port = ts.make_synthetic_scene(device="cpu", **SCENE_KW)
        ref = js.make_synthetic_scene(backend="xla", **SCENE_KW)
    finally:
        mp.undo()
    return port, ref, np.stack(alphas).reshape(port.depths.shape)


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
        np.testing.assert_allclose(getattr(port, name), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert port.seed_xyz.shape == (200, 3)


def test_gt_gaussians_keep_the_street_layout_of_jax():
    """JAX's class shares (ground 45%, buildings 35%, roadside 15%,
    backdrop 5%), its clear carriageway and its value ranges; the same
    seed gives the same arrays."""
    n, extent = 2000, 20.0
    port = ts._gt_gaussians(np.random.default_rng([3, 0]), n, extent, 0.18, 0.25)
    again = ts._gt_gaussians(np.random.default_rng([3, 0]), n, extent, 0.18, 0.25)
    other = ts._gt_gaussians(np.random.default_rng([4, 0]), n, extent, 0.18, 0.25)
    assert all(np.array_equal(a, b) for a, b in zip(port, again))
    assert not np.array_equal(port[0], other[0])
    ref = [np.asarray(a) for a in js._gt_gaussians(jax.random.key(3), n, extent, 0.18, 0.25)]
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
            torch.testing.assert_close(g[k], w[k], rtol=1e-6, atol=1e-6, msg=k)
    assert got_p.background.features_rest.shape[1] == 2   # per-traversal SH rest
    # WildGaussians: the same leaves; the wild ones by shape and dtype only
    # (the packages' generators differ)
    jp, ja = js.build_scene_model(_jax_scene(port_scene), wild_appearance=True, **kw)
    want_p, _ = scene_from_state_dict(sd(jp), sd(ja), device="cpu")
    got_p, _ = ts.build_scene_model(port_scene, wild_appearance=True, device="cpu", **kw)
    g, w = dict(named_leaves(got_p)), dict(named_leaves(want_p))
    assert list(g) == list(w) and "wild.embeddings" in w
    assert w["wild.embeddings"].shape == (port_scene.frame_rows, 32)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        if not k.startswith("wild."):
            torch.testing.assert_close(g[k], w[k], rtol=1e-6, atol=1e-6, msg=k)


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


def test_truncated_ground_truth_matches_jax(monkeypatch):
    """A ground truth whose pairs pass gt_max_intersections raises by
    default; with truncate_gt the port keeps the truncated render (the
    farthest pairs dropped), as JAX's `make_synthetic_scene` always does:
    the same images as JAX's on shared ground truth (2e-3, the golden
    render tolerance), and not the untruncated ones."""
    n = 6000
    gt = ts._gt_gaussians(np.random.default_rng([0, 0]), n, 12.0, 0.4, 0.0)
    monkeypatch.setattr(js, "_gt_gaussians", lambda key, *a: tuple(jnp.asarray(x) for x in gt))
    monkeypatch.setattr(ts, "_gt_gaussians", lambda rng, *a: gt)
    kw = dict(seed=0, width=64, height=64, n_travels=1, n_frames=2, n_bg=n, n_instance=0,
              gt_max_intersections=1024)
    with pytest.raises(ValueError, match="would be truncated"):
        ts.make_synthetic_scene(device="cpu", **kw)
    port = ts.make_synthetic_scene(device="cpu", truncate_gt=True, **kw)
    ref = js.make_synthetic_scene(backend="xla", **kw)
    full = ts.make_synthetic_scene(device="cpu", **dict(kw, gt_max_intersections=1 << 14))
    np.testing.assert_allclose(port.images, ref.images, rtol=0, atol=2e-3)
    assert np.abs(port.images - full.images).mean() > 0.05
