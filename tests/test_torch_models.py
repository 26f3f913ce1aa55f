"""mtgs_torch models, losses, metrics and presets vs the JAX package.

Node initialisers draw the same numpy random numbers as the JAX ones, so
both build the same node. Float outputs agree to f32 rounding
(|port - jax| <= 1e-5 * max(1, |jax|)); PSNR to 1e-4 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu import configs as jconfigs
from mtgs_tpu.eval import metrics as jm
from mtgs_tpu.models import appearance as japp
from mtgs_tpu.models import fourier as jfour
from mtgs_tpu.models import gaussians as jg
from mtgs_tpu.train import control as jctrl
from mtgs_tpu.train import losses as jloss
from mtgs_torch import configs as tconfigs
from mtgs_torch.eval import metrics as tm
from mtgs_torch.models import appearance as tapp
from mtgs_torch.models import fourier as tfour
from mtgs_torch.models import gaussians as tg
from mtgs_torch.train import control as tctrl
from mtgs_torch.train import losses as tloss
from tests.test_torch_core import close, t


@pytest.mark.parametrize("multi_rest,fourier_dim", [(False, 0), (True, 3)])
def test_init_node_from_points_matches(multi_rest, fourier_dim):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (300, 3)).astype(np.float32)
    kw = dict(capacity=512, num_traversals=2, multi_feature_rest=multi_rest, seed=5,
              fourier_dim=fourier_dim)
    jp, ja = jg.init_node_from_points(xyz, rgb, **kw)
    tp, ta = tg.init_node_from_points(xyz, rgb, **kw, device="cpu")
    for f in ("means", "scales", "quats", "features_dc", "features_rest", "opacities",
              "features_adapters", "fourier_dc"):
        close(getattr(tp, f), getattr(jp, f))
    close(ta.alive, ja.alive)
    assert int(ta.num_alive) == int(ja.num_alive) == 300
    assert tp.multicolor and tp.multi_feature_rest == multi_rest
    assert tp.fourier == (fourier_dim > 0)
    close(tg.get_scales(tp), jg.get_scales(jp))
    close(tg.get_quats(tp), jg.get_quats(jp))
    close(tg.get_opacities(tp, ta), jg.get_opacities(jp, ja))
    assert tg.node_capacity(300) == jg.node_capacity(300)
    assert tg.node_capacity(5000, 1024) == jg.node_capacity(5000, 1024)


def test_init_skybox_node_matches():
    jp, _ = jg.init_skybox_node(num_points=700, radius=250.0, num_traversals=2, seed=4)
    tp, _ = tg.init_skybox_node(num_points=700, radius=250.0, num_traversals=2, seed=4,
                                device="cpu")
    for f in ("means", "scales", "quats", "features_dc"):
        close(getattr(tp, f), getattr(jp, f))
    assert tp.capacity == jp.capacity


def test_appearance_fourier_and_sh_mask_match():
    rng = np.random.default_rng(6)
    app = rng.normal(size=(3, 3, 4)).astype(np.float32) * 0.2
    app[:, :, :3] += np.eye(3, dtype=np.float32)
    rgb = rng.random((8, 9, 3)).astype(np.float32)
    for cam in range(3):
        close(tapp.apply_exposure(t(app), t(rgb), cam),
              japp.apply_exposure(jnp.asarray(app), jnp.asarray(rgb), cam))
    close(tapp.init_exposure(2, device="cpu"), japp.init_exposure(2))
    coeffs = rng.normal(size=(50, 5, 3)).astype(np.float32)
    for ts in (0.0, 0.37, 1.0):
        close(tfour.fourier_features_dc(t(coeffs), torch.tensor(ts)),
              jfour.fourier_features_dc(jnp.asarray(coeffs), jnp.asarray(ts, jnp.float32)))
    cfg_t, cfg_j = tctrl.ControlConfig(sh_degree_interval=100), jctrl.ControlConfig(
        sh_degree_interval=100)
    for step in (0, 150, 250, 10**9):
        close(tctrl.sh_degree_mask(step, cfg_t),
              jctrl.sh_degree_mask(jnp.asarray(step), cfg_j))


def test_normals_ssim_and_metrics_match():
    rng = np.random.default_rng(7)
    n = 200
    scales = rng.random((n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    from mtgs_tpu.core.quat import quat_to_rotmat
    R = np.asarray(quat_to_rotmat(jnp.asarray(q)))
    means = rng.normal(size=(n, 3)).astype(np.float32)
    cam = rng.normal(size=3).astype(np.float32)
    c2w_rot = R[0]
    close(tloss.gaussian_camera_normals(t(scales), t(R), t(means), t(cam), t(c2w_rot)),
          jloss.gaussian_camera_normals(*(jnp.asarray(a) for a in
                                          (scales, R, means, cam, c2w_rot))))

    H, W = 40, 52
    gt = rng.random((H, W, 3)).astype(np.float32)
    pred = np.clip(0.8 * gt + 0.1 + 0.05 * rng.normal(size=gt.shape), 0, 1).astype(np.float32)
    mask = (rng.random((H, W, 1)) > 0.2).astype(np.float32)
    close(tloss.ssim(t(gt), t(pred), t(mask)),
          jloss.ssim(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(mask)))
    close(tloss.ssim(t(gt), t(pred)), jloss.ssim(jnp.asarray(gt), jnp.asarray(pred)))
    close(tm.masked_psnr(t(pred), t(gt), t(mask)),
          jm.masked_psnr(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)), tol=1e-4)
    close(tm.color_correct(t(pred), t(gt)),
          jm.color_correct(jnp.asarray(pred), jnp.asarray(gt)), tol=1e-4)
    dp = rng.uniform(0.5, 90, (H, W, 1)).astype(np.float32)
    dg = np.where(rng.random((H, W, 1)) > 0.5, dp * rng.uniform(0.8, 1.3, dp.shape), 0.0)
    dg = dg.astype(np.float32)
    got = tm.depth_metrics(t(dp), t(dg), t(mask))
    want = jm.depth_metrics(jnp.asarray(dp), jnp.asarray(dg), jnp.asarray(mask))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("case", ["same", "orthogonal", "antiparallel", "random"])
def test_mean_angular_error_matches_jax(case):
    """`mean_angular_error` on the cases of tests/test_eval_metrics.py (x
    against x, x against y, x against -x: 0, pi/2, pi) and on random unit
    normals, against JAX's."""
    x = np.zeros((2, 2, 3), np.float32)
    x[..., 0] = 1.0
    if case == "random":
        rng = np.random.default_rng(3)
        a, b = (rng.normal(size=(16, 24, 3)).astype(np.float32) for _ in range(2))
        a, b = (v / np.linalg.norm(v, axis=-1, keepdims=True) for v in (a, b))
    else:
        y = np.zeros_like(x)
        y[..., 1] = 1.0
        a, b = x, dict(same=x, orthogonal=y, antiparallel=-x)[case]
    got = tloss.mean_angular_error(t(a), t(b))
    want = jloss.mean_angular_error(jnp.asarray(a), jnp.asarray(b))
    assert tuple(got.shape) == a.shape[:2]
    close(got, want)
    if case != "random":
        expect = dict(same=0.0, orthogonal=np.pi / 2, antiparallel=np.pi)[case]
        np.testing.assert_allclose(got.numpy(), expect, atol=1e-6)


def test_mtgs_config_render_fields_match():
    j = jconfigs.mtgs_config(960, 540, max_steps=10001)
    p = tconfigs.mtgs_config(960, 540, max_steps=10001)
    for f in ("width", "height", "tile_size", "max_intersections", "rasterize_mode",
              "predict_normals", "background_color", "max_steps"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.control.sh_degree == j.control.sh_degree
    assert p.control.sh_degree_interval == j.control.sh_degree_interval
    assert p.scene.sh_degree == j.scene.sh_degree
    assert p.scene.travel_mode == j.scene.travel_mode
    jr, pr = j.raster_config(), p.raster_config()
    for f in ("width", "height", "tile_size", "max_intersections", "rasterize_mode",
              "render_mode", "tiles_x", "tiles_y"):
        assert getattr(pr, f) == getattr(jr, f), f
