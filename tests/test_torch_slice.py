"""The serving slice end to end: mtgs_torch vs the JAX package.

One scene (a multicolour background with per-traversal SH rest, a
skybox, one rigid instance with Fourier dc and 4 frame poses; 2
traversals) is built with the JAX package's own initialisers, given
seeded random opacities, SH rest and adapters, carried across with
`scene_from_state_dict`, and rendered by both packages at 96x64 with the
`mtgs` preset. The JAX side runs its fused Pallas path in interpret mode
(backend="pallas", interpret=True, fused=True), the path the port mirrors.

Tolerances (the golden ones of test_goldens.py): rgb, rgb_appearance and
normal 2e-3; accumulation 1e-3; depth 1e-3 relative where alpha > 1e-2;
psnr and cc_psnr 0.05 dB; ssim 1e-3; n_intersections within 0.1% (a
last-ulp difference in projection can move a borderline gaussian's tile
span).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu import configs as jconfigs
from mtgs_tpu.eval import pipeline as jpipe
from mtgs_tpu.models import gaussians as jg
from mtgs_tpu.models import scene_graph as jsg
from mtgs_tpu.train import trainer as jtr
from mtgs_torch import configs as tconfigs
from mtgs_torch.eval import pipeline as tpipe
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.train import trainer as ttr

W, H = 96, 64
I_CAP = 1 << 15
N_TRAVELS, N_FRAMES = 2, 2


def _logit(p):
    return np.log(p / (1.0 - p)).astype(np.float32)


def build_jax_scene(seed=0):
    """JAX (SceneParams, SceneAux) in the world frame (z up), in front of
    cameras that look along +x."""
    rng = np.random.default_rng(seed)
    n_bg = 900
    xyz = np.stack([rng.uniform(3, 16, n_bg), rng.uniform(-6, 6, n_bg),
                    rng.uniform(-2, 3, n_bg)], -1).astype(np.float32)
    bg, bg_aux = jg.init_node_from_points(
        xyz, rng.uniform(0, 255, (n_bg, 3)), capacity=1024,
        num_traversals=N_TRAVELS, multi_feature_rest=True, seed=seed)
    sky, sky_aux = jg.init_skybox_node(num_points=1024, radius=300.0,
                                       num_traversals=N_TRAVELS, seed=seed + 1)
    n_in = 300
    local = (rng.uniform(-0.5, 0.5, (n_in, 3)) * [4.0, 2.0, 1.5]).astype(np.float32)
    node, node_aux = jg.init_node_from_points(
        local, rng.uniform(0, 255, (n_in, 3)), capacity=512, seed=seed + 2,
        fourier_dim=4)

    def randomise(p):
        cap = p.means.shape[0]
        op = _logit(rng.uniform(0.2, 0.95, (cap, 1)))
        rest = (0.3 * rng.normal(size=p.features_rest.shape)).astype(np.float32)
        ad = (0.3 * rng.normal(size=p.features_adapters.shape)).astype(np.float32)
        fields = dict(opacities=jnp.asarray(op), features_rest=jnp.asarray(rest),
                      features_adapters=jnp.asarray(ad))
        if p.fourier:
            f = np.asarray(p.fourier_dc).copy()
            f[:, 1:] = 0.2 * rng.normal(size=f[:, 1:].shape)
            fields["fourier_dc"] = jnp.asarray(f)
        return p.replace(**fields)

    bg, sky, node = randomise(bg), randomise(sky), randomise(node)
    F = N_TRAVELS * N_FRAMES
    yaw = rng.uniform(-0.3, 0.3, F)
    inst_q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    inst_t = np.stack([rng.uniform(7, 10, F), rng.uniform(-1.5, 1.5, F),
                       np.zeros(F)], -1)
    inst = jsg.InstanceParams(
        node=jax.tree.map(lambda a: a[None], node),
        quats=jnp.asarray(inst_q, jnp.float32)[None],
        trans=jnp.asarray(inst_t, jnp.float32)[None])
    inst_aux = jsg.InstanceAux(
        alive=node_aux.alive[None], num_alive=node_aux.num_alive[None],
        present=jnp.asarray([[1.0, 1.0, 0.0, 1.0]], jnp.float32),
        is_static=jnp.zeros((1,), jnp.float32),
        frame_timestamps=jnp.asarray(np.linspace(0, 1, F), jnp.float32),
        travel_of_frame=jnp.repeat(jnp.arange(N_TRAVELS, dtype=jnp.int32), N_FRAMES),
        sizes=jnp.asarray([[4.0, 2.0, 1.5]], jnp.float32))
    params, aux = jsg.init_scene((bg, bg_aux), (sky, sky_aux), (inst, inst_aux),
                                 num_cameras=2, num_images=4)
    exposure = np.asarray(params.appearance).copy()
    exposure[1, :, :3] *= 0.9
    exposure[1, :, 3] += 0.03
    return params.replace(appearance=jnp.asarray(exposure)), aux


def make_views(seed=1):
    """Eval views as numpy fields: 2 per traversal, cameras looking along
    +x (scene frame: camera x right, y up, z backward)."""
    rng = np.random.default_rng(seed)
    R = np.array([[0, 0, -1], [-1, 0, 0], [0, 1, 0]], np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    views = []
    for i in range(N_TRAVELS * N_FRAMES):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R
        c2w[:3, 3] = [rng.uniform(-1, 0.5), rng.uniform(-0.5, 0.5), rng.uniform(0.5, 1.5)]
        depth = rng.uniform(2.0, 30.0, (H, W, 1)).astype(np.float32)
        depth[rng.random((H, W, 1)) < 0.5] = 0.0  # no LiDAR return
        mask = np.ones((H, W, 1), np.float32)
        mask[:6] = 0.0
        views.append(dict(
            image=np.zeros((H, W, 3), np.float32), mask=mask, c2w=c2w, K=K,
            cam_idx=i % 2, image_idx=i, travel_index=i // N_FRAMES, frame_idx=i,
            timestamp=np.float32(i / 3.0), lidar_depth=depth))
    return views


def jax_batch(v):
    return jtr.Batch(**{k: jnp.asarray(a) for k, a in v.items()})


def torch_batch(v):
    return ttr.Batch(**v)


@pytest.fixture(scope="module")
def scene():
    params, aux = build_jax_scene()
    p_sd = jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))
    a_sd = jax.tree.map(np.asarray, flax.serialization.to_state_dict(aux))
    t_params, t_aux = scene_from_state_dict(p_sd, a_sd, device="cpu")
    jcfg = jconfigs.mtgs_config(W, H).replace(
        backend="pallas", interpret=True, fused=True, max_intersections=I_CAP)
    tcfg = tconfigs.mtgs_config(W, H).replace(max_intersections=I_CAP)
    views = make_views()
    # ground truth near the render (an exposure change plus noise), as a
    # real eval sees it: against pure noise the cc_psnr colour fit is so
    # ill-conditioned that f32 solves disagree by ~0.06 dB (JAX's own
    # eager color_correct returns NaN there)
    rng = np.random.default_rng(2)
    for v in views:
        out = ttr.render_view(t_params, t_aux, tcfg, torch_batch(v), 10**9, device="cpu")
        noise = 0.03 * rng.normal(size=(H, W, 3))
        v["image"] = np.clip(0.85 * out["rgb"].numpy() + 0.08 + noise, 0, 1).astype(np.float32)
    return dict(jax=(params, aux, jcfg), torch=(t_params, t_aux, tcfg), views=views)


def assert_renders_close(got, want):
    for k, tol in (("rgb", 2e-3), ("rgb_appearance", 2e-3), ("normal", 2e-3),
                   ("accumulation", 1e-3)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, err_msg=k)
    alpha = np.asarray(want["accumulation"])
    covered = alpha > 1e-2
    assert covered.mean() > 0.3
    d_got, d_want = got["depth"].numpy()[covered], np.asarray(want["depth"])[covered]
    assert (np.abs(d_got - d_want) / np.abs(d_want)).max() <= 1e-3
    n_got = int(got["n_intersections"])
    n_want = int(want["n_intersections"])
    assert 0 < n_want <= I_CAP
    assert abs(n_got - n_want) <= max(1, n_want // 1000), (n_got, n_want)


@pytest.mark.parametrize("mode", ["index", "mean", "null"])
def test_render_view_matches_jax(scene, mode):
    params, aux, jcfg = scene["jax"]
    t_params, t_aux, tcfg = scene["torch"]
    v = scene["views"][3]  # traversal 1: adapters and per-traversal rest differ
    step = 10**9
    want = jax.jit(lambda p, b: jtr.render_view(
        p, aux, jcfg, b, jnp.asarray(step, jnp.int32), training=False,
        travel_mode=mode))(params, jax_batch(v))
    got = ttr.render_view(t_params, t_aux, tcfg, torch_batch(v), step, training=False,
                          travel_mode=mode, device="cpu")
    assert_renders_close(got, want)


def test_evaluate_scene_matches_jax(scene):
    params, aux, jcfg = scene["jax"]
    t_params, t_aux, tcfg = scene["torch"]
    views = scene["views"]
    modes = {0: "index", 1: "null"}
    want = jpipe.evaluate_scene(params, aux, jcfg, [jax_batch(v) for v in views],
                                eval_cfg=jpipe.EvalConfig(lpips=False, dinov2=False),
                                travel_modes=modes)
    got = tpipe.evaluate_scene(t_params, t_aux, tcfg, [torch_batch(v) for v in views],
                               eval_cfg=tpipe.EvalConfig(), travel_modes=modes,
                               device="cpu")
    assert set(got) == set(want)
    assert got["num_images"] == want["num_images"] == len(views)
    assert np.isfinite(got["fps"])
    for k, w in want.items():
        if k in ("fps", "num_images"):
            continue
        tol = 1e-3 if k.endswith("ssim") else 0.05 if "psnr" in k else None
        if tol is None:  # depth metrics: 1e-3 relative
            tol = 1e-3 * max(1.0, abs(w))
        assert abs(got[k] - w) <= tol, (k, got[k], w)
    assert "trv0_psnr" in got and "trv1_depth_RMSE" in got
