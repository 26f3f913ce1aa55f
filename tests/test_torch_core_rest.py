"""The rest of `core/` and the Fourier edits: mtgs_torch vs the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and its
port. Floats agree within atol 1e-6, or within 1e-5 where JAX's own tests of
the function use it (`redistort_image`: tests/test_eval_metrics.py; the SH
colour: tests/test_core_math.py; the velocities: tests/test_models.py).
`random_quats` draws JAX's uniforms from a `core.prng` key: it is held
as tests/test_core_math.py holds the JAX one (unit norm, uniform on the
sphere), and against JAX's on the same key bit for bit (XLA's CPU sqrt,
sin and cos, `core/xla_math.py`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
import mtgs_tpu.core as jcore
from mtgs_tpu.core import camera as jcam
from mtgs_tpu.core import quat as jquat
from mtgs_tpu.core import sh as jsh
from mtgs_tpu.models import fourier as jfourier
import mtgs_torch.core as tcore
from mtgs_torch.core import camera as tcam
from mtgs_torch.core import prng
from mtgs_torch.core import quat as tquat
from mtgs_torch.core import sh as tsh
from mtgs_torch.models import fourier as tfourier


def close(got, want, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_core_package_exports_match():
    names = [n for n in dir(jcore) if not n.startswith("_") and callable(getattr(jcore, n))]
    assert len(names) == 16
    for n in names:
        assert callable(getattr(tcore, n)), n


def test_pinhole_camera_and_frames_match():
    rng = np.random.default_rng(0)
    intr = rng.uniform(100, 900, (5, 4)).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    c2w[:, :3] = rng.normal(size=(5, 3, 4))
    jc = jcam.PinholeCamera(*(jnp.asarray(intr[:, i]) for i in range(4)), c2w=jnp.asarray(c2w),
                            width=1920, height=1080)
    tc = tcam.PinholeCamera(*(t(intr[:, i]) for i in range(4)), c2w=t(c2w), width=1920,
                            height=1080)
    close(tc.K, jc.K)
    for s in (0.5, 0.37):
        js, ts = jc.rescale(s), tc.rescale(s)
        close(ts.K, js.K)
        assert (ts.width, ts.height) == (js.width, js.height)
        assert tc.width == 1920  # frozen: rescale returns a new camera
    close(tcam.opencv_to_scene_frame(t(c2w)), jcam.opencv_to_scene_frame(jnp.asarray(c2w)))
    close(tcam.scene_to_opencv_frame(t(c2w)), jcam.scene_to_opencv_frame(jnp.asarray(c2w)))
    before = t(c2w)
    tcam.opencv_to_scene_frame(before)
    close(before, c2w)  # a new tensor; the input is unchanged


def test_world_to_camera_and_projection_match():
    rng = np.random.default_rng(1)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = tquat.quat_to_rotmat(t(rng.normal(size=4))).numpy()
    c2w[:3, 3] = rng.normal(size=3)
    view_j = jcam.camera_to_gsplat_viewmat(jnp.asarray(c2w))
    view_t = tcam.camera_to_gsplat_viewmat(t(c2w))
    pts = rng.normal(size=(64, 3)).astype(np.float32) * 4
    pc_j = jcam.world_to_camera(jnp.asarray(pts), view_j)
    pc_t = tcam.world_to_camera(t(pts), view_t)
    close(pc_t, pc_j)
    pc = np.array(pc_j)
    pc[:, 2] = np.abs(pc[:, 2]) + 0.5
    pc[:3, 2] = [0.0, -1.0, 1e-9]  # at and behind the camera: the eps floor
    K = np.array([[400.0, 0, 320], [0, 410.0, 240], [0, 0, 1]], np.float32)
    got = tcam.project_points(t(pc), t(K)).numpy()
    want = np.asarray(jcam.project_points(jnp.asarray(pc), jnp.asarray(K)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)  # pixels: f32 rounding


@pytest.mark.parametrize("n_coeffs", [4, 5])
def test_distortion_matches(n_coeffs):
    rng = np.random.default_rng(n_coeffs)
    dist = np.array([0.1, -0.05, 0.01, -0.01, 0.02][:n_coeffs], np.float32)
    xy = rng.uniform(-0.4, 0.4, (100, 2)).astype(np.float32)
    xy_d = tcam.distort_opencv(t(xy), t(dist))
    close(xy_d, jcam.distort_opencv(jnp.asarray(xy), jnp.asarray(dist)))
    back = tcam.undistort_points(xy_d, t(dist))
    close(back, jcam.undistort_points(jnp.asarray(xy_d.numpy()), jnp.asarray(dist)))
    np.testing.assert_allclose(back.numpy(), xy, atol=1e-4)


@pytest.mark.parametrize("case", ["identity", "warp", "raw_hw"])
def test_redistort_image_matches(case):
    rng = np.random.default_rng(3)
    H, W = 24, 32
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    K_raw = np.array([[25.0, 0, 16], [0, 25.0, 12], [0, 0, 1]], np.float32)
    K_und = np.array([[22.0, 0, 15], [0, 22.0, 11], [0, 0, 1]], np.float32)
    dist = np.array([0.05, -0.01, 0.001, 0.002], np.float32)
    out_hw = None
    if case == "identity":
        K_und, dist = K_raw, np.zeros(4, np.float32)
    elif case == "raw_hw":
        out_hw = (30, 41)
        K_raw = np.array([[20.0, 0, 20.5], [0, 20.0, 15], [0, 0, 1]], np.float32)  # wider
    got = tcam.redistort_image(t(img), t(K_raw), t(dist), t(K_und), out_hw)
    want = jax.jit(jcam.redistort_image, static_argnums=4)(  # one compile, not one per op
        jnp.asarray(img), jnp.asarray(K_raw), jnp.asarray(dist), jnp.asarray(K_und), out_hw)
    close(got, want, atol=1e-5)
    if case == "identity":
        close(got, img, atol=1e-5)
    if case == "raw_hw":
        outside = got.abs().sum(-1) == 0  # zero padding where the raw view leaves the render
        assert got.shape == (30, 41, 3) and outside[0, 0] and 0.2 < outside.float().mean() < 0.8


def test_camera_velocity_in_world_matches():
    rng = np.random.default_rng(4)
    v, w = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    cam2ego, ego2global = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    cam2ego[:3, 3] = [1.5, 0.2, 1.6]
    ego2global[:3, :3] = tquat.quat_to_rotmat(t(rng.normal(size=4))).numpy()
    got = tcam.camera_velocity_in_world(v, w, t(cam2ego), t(ego2global))
    want = jcam.camera_velocity_in_world(jnp.asarray(v), jnp.asarray(w), jnp.asarray(cam2ego),
                                         jnp.asarray(ego2global))
    for g, wt in zip(got, want):
        close(g, wt)


def test_random_quats_are_uniform_unit_quaternions():
    q = tquat.random_quats(prng.key(0), 20000)
    assert q.shape == (20000, 4) and q.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-6)
    # uniform on S^3: every component has mean 0 and E[q_i^2] = 1/4
    assert float(q.mean(0).abs().max()) < 0.02
    np.testing.assert_allclose((q * q).mean(0).numpy(), 0.25, atol=0.01)
    # the rotation of a fixed axis is uniform on S^2 (mean 0)
    R = tquat.quat_to_rotmat(q)
    assert float(R[:, :, 2].mean(0).abs().max()) < 0.03
    # one key gives one draw, another key another
    assert torch.equal(q, tquat.random_quats(prng.key(0), 20000))
    assert not torch.equal(q, tquat.random_quats(prng.key(1), 20000))


@pytest.mark.parametrize("seed, n", [(0, 257), (11, 1000), (0, 20000)])
def test_random_quats_formula_matches_jax(seed, n):
    """Shoemake's formula on JAX's uniforms: the same key, the same
    quaternions, bit for bit."""
    want = np.asarray(jquat.random_quats(jax.random.key(seed), n))
    got = tquat.random_quats(prng.key(seed), n).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_rotate_vector_to_vector_matches():
    rng = np.random.default_rng(6)
    v1 = rng.normal(size=(40, 3)).astype(np.float32)
    v2 = rng.normal(size=(40, 3)).astype(np.float32)
    v2[0] = -3.0 * v1[0]                  # antiparallel: a rotation by pi
    v1[1] = [0.95, 0.1, 0.0]              # antiparallel with |a_x| >= 0.9: the y helper axis
    v2[1] = -v1[1]
    v2[2] = 2.0 * v1[2]                   # parallel: the identity
    got = tquat.rotate_vector_to_vector(t(v1), t(v2))
    want = jax.jit(jquat.rotate_vector_to_vector)(jnp.asarray(v1), jnp.asarray(v2))
    close(got, want, atol=1e-5)
    a = v1 / np.linalg.norm(v1, axis=-1, keepdims=True)
    b = v2 / np.linalg.norm(v2, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", got.numpy(), a), b, atol=1e-5)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches(degree):
    rng = np.random.default_rng(10 + degree)
    coeffs = rng.normal(size=(2, 65, 16, 3)).astype(np.float32)  # bases past the degree
    dirs = rng.normal(size=(2, 65, 3)).astype(np.float32) * 7.0  # not normalized
    dirs[0, 0] = 0.0  # the 1e-12 floor
    got = tsh.eval_sh(degree, t(coeffs), t(dirs))
    want = jsh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(dirs))
    close(got, want, atol=1e-5)
    assert got.shape == (2, 65, 3)


def _trajectory(rng, I=3, F=5, cap=7):
    quats = rng.normal(size=(I, F, 4)).astype(np.float32)
    trans = rng.normal(size=(I, F, 3)).astype(np.float32) * 5
    ts = np.cumsum(rng.uniform(0.05, 0.2, F)).astype(np.float32)
    ts[3] = ts[2]  # a repeated timestamp: the dt floor
    means = rng.normal(size=(I, cap, 3)).astype(np.float32)
    return quats, trans, ts, means


@pytest.mark.parametrize("frame", [0, 2, 3, 4])
def test_instance_velocities_match(frame):
    quats, trans, ts, means = _trajectory(np.random.default_rng(20))
    got = tfourier.instance_velocities(t(quats), t(trans), t(ts), frame, t(means))
    want = jax.jit(jfourier.instance_velocities)(
        jnp.asarray(quats), jnp.asarray(trans), jnp.asarray(ts), jnp.asarray(frame),
        jnp.asarray(means))
    close(got, want, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_edits_match_and_leave_their_inputs():
    rng = np.random.default_rng(21)
    quats, trans, _, _ = _trajectory(rng)
    off = rng.normal(size=3).astype(np.float32)
    rot = rng.normal(size=4).astype(np.float32)
    rot /= np.linalg.norm(rot)
    pivot = rng.normal(size=3).astype(np.float32)
    tq, tt = t(quats), t(trans)
    close(tfourier.edit_translate(tt, 1, t(off)),
          jfourier.edit_translate(jnp.asarray(trans), 1, jnp.asarray(off)))
    got_q, got_t = tfourier.edit_rotate(tq, tt, 2, t(rot), t(pivot))
    want_q, want_t = jax.jit(jfourier.edit_rotate, static_argnums=2)(
        jnp.asarray(quats), jnp.asarray(trans), 2, jnp.asarray(rot), jnp.asarray(pivot))
    close(got_q, want_q)
    close(got_t, want_t, atol=1e-5)
    close(tq, quats)
    close(tt, trans)
    assert math.isclose(float(torch.linalg.norm(got_q[2, 0])),
                        float(np.linalg.norm(quats[2, 0])), rel_tol=1e-5)
