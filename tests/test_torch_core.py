"""mtgs_torch core math, projection and tile spans vs the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and
its port. Floats agree to f32 rounding: |port - jax| <= 1e-5 * max(1,
|jax|) elementwise (pixel coordinates of a few hundred carry rounding of
that relative size). `tile_spans` is integer math over f32 floor/ceil and
must be equal given identical inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.core import camera as jcam
from mtgs_tpu.core import quat as jquat
from mtgs_tpu.core import sh as jsh
from mtgs_tpu.raster import binning as jbin
from mtgs_tpu.raster import projection as jproj
from mtgs_torch.core import camera as tcam
from mtgs_torch.core import quat as tquat
from mtgs_torch.core import sh as tsh
from mtgs_torch.raster import binning as tbin
from mtgs_torch.raster import projection as tproj

TOL = 1e-5


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want) / np.maximum(1.0, np.abs(want))
    assert err.max(initial=0.0) <= tol, float(err.max())


def quats(rng, *shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q


def t(a):
    return torch.from_numpy(np.array(a))


def test_quat_functions_match():
    rng = np.random.default_rng(0)
    q0, q1 = quats(rng, 64), quats(rng, 64)
    q0[0] = 0.0  # a padded row: eps-safe normalisation
    v = rng.normal(size=(64, 3)).astype(np.float32)
    close(tquat.quat_normalize(t(q0)), jquat.quat_normalize(jnp.asarray(q0)))
    close(tquat.quat_to_rotmat(t(q0)), jquat.quat_to_rotmat(jnp.asarray(q0)))
    close(tquat.quat_mult(t(q0), t(q1)), jquat.quat_mult(jnp.asarray(q0), jnp.asarray(q1)))
    close(tquat.quat_rotate(t(q1), t(v)), jquat.quat_rotate(jnp.asarray(q1), jnp.asarray(v)))
    # slerp: general pairs, antipodal flips and a near-parallel pair (lerp)
    q1[1] = -q0[1]
    q1[2] = q0[2] * 1.0000001
    tt = rng.random(64).astype(np.float32)
    close(tquat.slerp(t(q0[1:]), t(q1[1:]), t(tt[1:])),
          jquat.slerp(jnp.asarray(q0[1:]), jnp.asarray(q1[1:]), jnp.asarray(tt[1:])))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_basis_matches(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(tsh.sh_basis(degree, t(d)), jsh.sh_basis(degree, jnp.asarray(d)))
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)
    rgb = rng.random((16, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(t(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))


def random_c2w(rng):
    R = tquat.quat_to_rotmat(t(quats(rng))).numpy()
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R
    c2w[:3, 3] = rng.normal(size=3) * 5.0
    return c2w


def test_viewmat_matches():
    rng = np.random.default_rng(1)
    c2w = np.stack([random_c2w(rng) for _ in range(4)])
    close(tcam.camera_to_gsplat_viewmat(t(c2w)),
          jcam.camera_to_gsplat_viewmat(jnp.asarray(c2w)))


def projection_inputs(seed, n=1500, width=128, height=96):
    """Gaussians around a camera at the origin looking down +z (cv frame):
    most in view, some behind the near plane, some far outside."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                      rng.uniform(-1.0, 12.0, n)], -1).astype(np.float32)
    q = quats(rng, n)
    scales = np.exp(rng.uniform(-4.0, 0.0, (n, 3))).astype(np.float32)
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, 3] = rng.normal(size=3) * 0.1
    K = np.array([[100.0, 0, width / 2 + 0.3], [0, 95.0, height / 2 - 0.2], [0, 0, 1]],
                 np.float32)
    return means, q, scales, viewmat, K


@pytest.mark.parametrize("antialiased", [False, True])
def test_projection_matches(antialiased):
    means, q, scales, viewmat, K = projection_inputs(2 + antialiased)
    kw = dict(width=128, height=96, antialiased=antialiased)
    want = jproj.project_gaussians(*(jnp.asarray(a) for a in (means, q, scales, viewmat, K)),
                                   kw["width"], kw["height"], antialiased=antialiased)
    got = tproj.project_gaussians(*(t(a) for a in (means, q, scales, viewmat, K)),
                                  kw["width"], kw["height"], antialiased=antialiased)
    valid = np.array(want.valid)
    assert 0.3 < valid.mean() < 0.95  # both culled and kept gaussians occur
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for f in ("means2d", "conics", "depths", "compensations"):
        close(getattr(got, f)[torch.from_numpy(valid)], np.asarray(getattr(want, f))[valid])
    # 3-sigma radii are f32 ceil: equal but for a borderline last-ulp flip
    r_got, r_want = got.radii.numpy(), np.asarray(want.radii)
    assert np.abs(r_got - r_want).max() <= 1
    assert (r_got != r_want).sum() <= max(1, len(r_want) // 1000)


@pytest.mark.parametrize("tile_size", [16, 32])
def test_tile_spans_equal(tile_size):
    means, q, scales, viewmat, K = projection_inputs(7)
    p = jproj.project_gaussians(*(jnp.asarray(a) for a in (means, q, scales, viewmat, K)),
                                128, 96, antialiased=True)
    rng = np.random.default_rng(8)
    op_eff = (rng.random(len(means)) * np.asarray(p.compensations)).astype(np.float32)
    op_eff[:50] = 1.0 / 512.0  # below the 1/255 floor: dropped
    args = dict(width=128, height=96, tile_size=tile_size)
    arrays = [np.asarray(a) for a in (p.means2d, p.radii, p.valid, p.conics)]
    for with_alpha_support in (False, True):
        extra_j = dict(conics=jnp.asarray(arrays[3]), op_eff=jnp.asarray(op_eff)) \
            if with_alpha_support else {}
        extra_t = dict(conics=t(arrays[3]), op_eff=t(op_eff)) if with_alpha_support else {}
        jp, jc = jbin.tile_spans(*(jnp.asarray(a) for a in arrays[:3]), **args, **extra_j)
        tp, tc = tbin.tile_spans(*(t(a) for a in arrays[:3]), **args, **extra_t)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert np.asarray(jc).sum() > 0
    assert tbin.padded_capacity(1 << 16) == jbin.padded_capacity(1 << 16)
    assert tbin.padded_capacity(5000) == jbin.padded_capacity(5000)
