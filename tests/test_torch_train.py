"""The training slice of mtgs_torch against the JAX package.

One full training step: the 96x64 scene of test_torch_slice.py (built by
the JAX package's initialisers, carried across with
`scene_from_state_dict`) goes through JAX `make_train_step` (its fused
Pallas path in interpret mode) and through the port's `train_step`, from
the same parameters, at step 3000 (SH degree 3 live, the sharp-shape
gate open). The view has a 50%-holed LiDAR map and a hole-free pseudo
depth, so the NCC term sees fully valid 8x8 patches (NCC patch and stride
8: the default 32/16 extraction makes the JAX step take minutes on a CPU;
`test_ncc_default_patches_match_jax` covers 32/16 on its own).

Tolerances: each loss term 1e-4 relative; each gradient leaf and the
absgrad signal max-scaled 2e-4 (the golden tolerance: the same f32
formulation, sums in another order); Adam's mu 2e-4 and nu 4e-4
max-scaled (nu squares the gradient); densify statistics 2e-4 relative
(max 2D size exact); the updated parameters 1e-6 relative where
|g| > 1e-3 max|g| (Adam's first step moves a parameter by lr * sign(g):
where g is rounding noise the two may move in opposite directions).

Also here: refine / count / reset against JAX's control.py with JAX's
own split noise, NCC at the default 32/16 patches, and one test per
stop-gradient of the JAX package (each fails without the port's detach).
"""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu import configs as jconfigs
from mtgs_tpu.models import scene_graph as jsg
from mtgs_tpu.train import control as jctrl
from mtgs_tpu.train import losses as jlosses
from mtgs_tpu.train import optim as joptim
from mtgs_tpu.train import trainer as jtr
from mtgs_torch import configs as tconfigs
from mtgs_torch.core.quat import quat_to_rotmat
from mtgs_torch.models import gaussians as tg
from mtgs_torch.models import scene_graph as tsg
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.train import control as tctrl
from mtgs_torch.train import losses as tlosses
from mtgs_torch.train import trainer as ttr
from mtgs_torch.train.optim import named_leaves
from tests.test_torch_slice import H, I_CAP, W, build_jax_scene, make_views

STEP = 3000
NCC = dict(ncc_patch_size=8, ncc_stride=8)
NODE_FIELDS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities",
               "features_adapters", "fourier_dc")
LEAVES = [f"{node}.{f}" for node in ("background", "skybox", "instances.node")
          for f in NODE_FIELDS] + ["instances.quats", "instances.trans", "appearance",
                                   "camera_opt"]


def flat(sd, prefix=""):
    """Nested state dict -> {dotted path: numpy array}, None skipped."""
    out = {}
    for k, v in sd.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        elif v is not None:
            out[path] = np.asarray(v)
    return out


def to_sd(tree):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(tree))


def max_scaled_err(got, want):
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale if scale > 0 else float(np.abs(got).max())


@pytest.fixture(scope="module")
def step_pair():
    params, aux = build_jax_scene()
    # the background between the cameras and the rigid instance made
    # fainter (opacity logits - 3), so the instance and the skybox get
    # gradients of the same order as the background's
    bg = params.background
    near = np.asarray(bg.means)[:, :1] < 8.0
    params = params.replace(background=bg.replace(
        opacities=jnp.where(near, bg.opacities - 3.0, bg.opacities)))
    p_sd, a_sd = to_sd(params), to_sd(aux)
    t_params, t_aux = scene_from_state_dict(p_sd, a_sd, device="cpu")
    t_init, _ = scene_from_state_dict(p_sd, a_sd, device="cpu")
    jcfg = jconfigs.mtgs_config(W, H)
    jcfg = jcfg.replace(backend="pallas", interpret=True, fused=True,
                        max_intersections=I_CAP, loss=jcfg.loss.replace(**NCC))
    tcfg = tconfigs.mtgs_config(W, H)
    tcfg = tcfg.replace(max_intersections=I_CAP, loss=dataclasses.replace(tcfg.loss, **NCC))

    # the view: traversal 1, a target near the render, LiDAR with holes and
    # a hole-free pseudo depth near the rendered depth
    v = make_views()[3]
    v["image_idx"] = 2
    out = ttr.render_view(t_params, t_aux, tcfg, ttr.Batch(**v), STEP, device="cpu")
    rng = np.random.default_rng(3)
    v["image"] = np.clip(0.85 * out["rgb"].numpy() + 0.08
                         + 0.03 * rng.normal(size=(H, W, 3)), 0, 1).astype(np.float32)
    d = out["depth"].numpy()
    v["pseudo_depth"] = np.clip(d * (1.0 + 0.05 * rng.normal(size=d.shape)), 0.5, 79.0
                                ).astype(np.float32)

    # JAX: the step of make_train_step; an optimizer wrapper keeps the
    # gradients in the optimizer state and a wrapped _accumulate_all the
    # absgrad sink's gradient in the densify dict, both returned in the state
    inner = joptim.build_optimizer(params, joptim.OptimConfig(
        groups=joptim.default_groups(jcfg.max_steps)))

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    stash = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    acc = jtr._accumulate_all

    def acc_stash(params, densify, sink_grad, *a, **kw):
        return {**acc(params, densify, sink_grad, *a, **kw), "absgrad": sink_grad}

    state = jtr.TrainState(params=params, opt_state=stash.init(params),
                           densify=jtr._make_densify(params),
                           step=jnp.asarray(STEP, jnp.int32), key=jax.random.key(0))
    batch = jtr.Batch(**{k: jnp.asarray(a) for k, a in v.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_accumulate_all", acc_stash)
        new_state, j_metrics = jtr.make_train_step(jcfg, stash)(state, aux, batch)
    (adam, _), j_grads = new_state.opt_state
    jax_res = dict(
        grads=flat(to_sd(j_grads)), mu=flat(to_sd(adam.mu)), nu=flat(to_sd(adam.nu)),
        params=flat(to_sd(new_state.params)), absgrad=np.asarray(new_state.densify["absgrad"]),
        densify={k: flat(to_sd(s)) for k, s in new_state.densify.items() if k != "absgrad"},
        metrics={k: float(m) for k, m in j_metrics.items()})

    # the port: gradients of the same step, then the step itself
    tb = ttr.Batch(**v)
    _, _, _, t_sink, t_grads = ttr.loss_and_grads(t_init, t_aux, tcfg, tb, STEP, device="cpu")
    tstate = ttr.init_train_state(t_params)
    tstate.step = STEP
    t_metrics = ttr.train_step(tstate, t_aux, tcfg, tb, tconfigs.optimizer_table(tcfg.max_steps),
                               device="cpu")
    torch_res = dict(
        grads={k: g.numpy() for k, g in t_grads.items()}, absgrad=t_sink.numpy(),
        mu={k: m.numpy() for k, m in named_leaves(tstate.adam.mu)},
        nu={k: m.numpy() for k, m in named_leaves(tstate.adam.nu)},
        params={k: p.detach().numpy() for k, p in named_leaves(tstate.params)},
        densify={k: {f.name: getattr(s, f.name).numpy() for f in dataclasses.fields(s)}
                 for k, s in tstate.densify.items()},
        metrics={k: float(m) for k, m in t_metrics.items()}, step=tstate.step,
        count=int(tstate.adam.count))
    return jax_res, torch_res


def test_train_step_losses_match_jax(step_pair):
    j, t = step_pair
    terms = ("l1", "ssim", "depth", "ncc", "normal", "two_d_reg", "sharp_shape", "oob",
             "camera_opt", "total_loss", "psnr")
    for k in terms:
        assert abs(t["metrics"][k] - j["metrics"][k]) <= 1e-4 * abs(j["metrics"][k]) + 1e-9, (
            k, t["metrics"][k], j["metrics"][k])
    # the terms are live: NCC sees valid patches, sharp_shape's gate is open
    assert 0 < j["metrics"]["ncc"] < 0.099 and j["metrics"]["sharp_shape"] >= 0
    assert t["metrics"]["nonfinite_grad_step"] == 0 == j["metrics"]["nonfinite_grad_step"]
    assert t["metrics"]["n_intersections"] == j["metrics"]["n_intersections"]
    assert t["metrics"]["gaussian_count"] == j["metrics"]["gaussian_count"]
    assert t["step"] == STEP + 1 and t["count"] == 1


@pytest.mark.parametrize("leaf", LEAVES)
def test_train_step_gradients_match_jax(step_pair, leaf):
    j, t = step_pair
    g_j, g_t = j["grads"][leaf], t["grads"][leaf]
    assert g_t.shape == g_j.shape
    if g_j.size == 0:
        return
    assert np.isfinite(g_t).all()
    assert max_scaled_err(g_t, g_j) <= 2e-4, (leaf, max_scaled_err(g_t, g_j))
    # Adam's moments after one step: mu = 0.1 g, nu = 0.001 g^2
    assert max_scaled_err(t["mu"][leaf], j["mu"][leaf]) <= 2e-4
    assert max_scaled_err(t["nu"][leaf], j["nu"][leaf]) <= 4e-4
    # the updated parameters, where the gradient is not rounding noise
    sel = np.abs(g_j) > 1e-3 * np.abs(g_j).max()
    np.testing.assert_allclose(t["params"][leaf][sel], j["params"][leaf][sel],
                               rtol=1e-6, atol=1e-7, err_msg=leaf)


def test_train_step_absgrad_and_densify_match_jax(step_pair):
    j, t = step_pair
    assert np.abs(j["absgrad"]).max() > 0
    assert max_scaled_err(t["absgrad"], j["absgrad"]) <= 2e-4
    for node in ("background", "skybox", "instances"):
        dj, dt = j["densify"][node], t["densify"][node]
        np.testing.assert_array_equal(dt["vis_counts"], dj["vis_counts"], err_msg=node)
        np.testing.assert_array_equal(dt["max_2dsize"], dj["max_2dsize"], err_msg=node)
        np.testing.assert_allclose(dt["last_comp"], dj["last_comp"], rtol=2e-4, atol=1e-6)
        assert max_scaled_err(dt["xys_grad_norm"], dj["xys_grad_norm"]) <= 2e-4, node


# ------------------------------------------------------------- control

def _node_pair(seed, cap=512, n=400):
    """A JAX node with random opacities/scales and densify stats that
    trigger splits, dups and culls, and its port twin."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-150, 150, (n, 3)).astype(np.float32)
    jp, ja = jg_init(xyz, rng.uniform(0, 255, (n, 3)), cap, seed)
    op = np.log(rng.uniform(0.002, 0.9, (cap, 1)) / 0.99).astype(np.float32)
    sc = rng.normal(-2.0, 1.2, (cap, 3)).astype(np.float32)
    jp = jp.replace(opacities=jnp.asarray(op), scales=jnp.asarray(sc))
    js = jctrl.DensifyState(
        xys_grad_norm=jnp.asarray(rng.uniform(0, 0.01, cap).astype(np.float32)),
        vis_counts=jnp.asarray(rng.integers(0, 5, cap).astype(np.float32)),
        max_2dsize=jnp.asarray(rng.uniform(0, 200, cap).astype(np.float32)),
        last_comp=jnp.asarray(rng.uniform(0.001, 1.0, cap).astype(np.float32)))
    mu = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), jp)
    nu = jax.tree.map(lambda a: jnp.asarray(rng.uniform(size=a.shape).astype(np.float32)), jp)
    t = lambda tree, cls: cls(**{k: torch.from_numpy(np.array(v)) for k, v in to_sd(tree).items()})
    return (jp, ja, mu, nu, js), (t(jp, tg.GaussianNodeParams), t(ja, tg.NodeAux),
                                  t(mu, tg.GaussianNodeParams), t(nu, tg.GaussianNodeParams),
                                  t(js, tctrl.DensifyState))


def jg_init(xyz, rgb, cap, seed):
    from mtgs_tpu.models import gaussians as jg

    return jg.init_node_from_points(xyz, rgb, capacity=cap, seed=seed)


FLAGS = [(True, True, True), (True, False, False), (False, True, True)]


@pytest.mark.parametrize("do_densify,do_cull_big,use_screen", FLAGS)
def test_refine_node_matches_jax(do_densify, do_cull_big, use_screen):
    (jp, ja, jmu, jnu, js), (tp, ta, tmu, tnu, ts) = _node_pair(7)
    kw = dict(do_densify=do_densify, do_cull_big=do_cull_big, use_screen_size=use_screen)
    jc, tc = jctrl.ControlConfig(), tctrl.ControlConfig()
    n_j = int(jctrl.count_refine_candidates(jp, ja, js, jc, **kw))
    assert int(tctrl.count_refine_candidates(tp, ta, ts, tc, **kw)) == n_j
    out_cap = 1024 if do_densify else 512
    key = jax.random.key(11)
    want = jax.jit(functools.partial(jctrl.refine_node, cfg=jc, out_cap=out_cap, **kw))(
        key, jp, ja, jmu, jnu, js, step=jnp.asarray(100))
    eps = torch.from_numpy(np.array(jax.random.normal(key, (out_cap, 3), jnp.float32)))
    got = tctrl.refine_node(eps, tp, ta, tmu, tnu, ts, tc, out_cap=out_cap, **kw)
    if do_densify:
        assert int(want.n_split) > 0 and int(want.n_dup) > 0
    assert int(want.n_cull) > 0
    for k in ("n_split", "n_dup", "n_cull", "overflow"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    assert int(got.aux.num_alive) == int(want.aux.num_alive) == min(n_j, out_cap)
    np.testing.assert_array_equal(got.aux.alive.numpy(), np.asarray(want.aux.alive))
    for name, g_tree, w_tree in (("params", got.params, want.params), ("mu", got.mu, want.mu),
                                 ("nu", got.nu, want.nu)):
        w_flat = flat(to_sd(w_tree))
        for k, g in named_leaves(g_tree):
            np.testing.assert_allclose(g.numpy(), w_flat[k], rtol=1e-6, atol=1e-5,
                                       err_msg=f"{name}.{k}")
    for f in ("xys_grad_norm", "vis_counts", "max_2dsize", "last_comp"):
        np.testing.assert_array_equal(getattr(got.state, f).numpy(),
                                      np.asarray(getattr(want.state, f)), err_msg=f)


@pytest.mark.parametrize("with_comp", [False, True])
def test_reset_opacities_matches_jax(with_comp):
    (jp, _, jmu, jnu, js), (tp, _, tmu, tnu, ts) = _node_pair(3)
    cfg_j, cfg_t = jctrl.ControlConfig(), tctrl.ControlConfig()
    want = jctrl.reset_opacities(jp, jmu, jnu, cfg_j, js.last_comp if with_comp else None)
    got = tctrl.reset_opacities(tp, tmu, tnu, cfg_t, ts.last_comp if with_comp else None)
    np.testing.assert_allclose(got[0].opacities.numpy(), np.asarray(want[0].opacities),
                               rtol=1e-6, atol=1e-6)
    assert (got[0].opacities < tp.opacities).any()
    for g, w in zip(got[1:], want[1:]):
        assert not g.opacities.any() and not np.asarray(w.opacities).any()
        np.testing.assert_array_equal(g.means.numpy(), np.asarray(w.means))


# ------------------------------------------------------------------ losses

def test_ncc_default_patches_match_jax():
    """NCC at the default patch 32 / stride 16 on a 96x64 depth pair with
    a masked band: forward value within 1e-5."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    gt = (5.0 + 0.1 * xx + 0.05 * yy + rng.normal(0, 0.2, (H, W)))[..., None].astype(np.float32)
    pred = (gt + rng.normal(0, 0.5, gt.shape)).astype(np.float32)
    mask = np.ones((H, W, 1), bool)
    mask[:10] = False
    want = float(jlosses.ncc_depth_loss(jnp.asarray(pred), jnp.asarray(gt),
                                        jnp.asarray(mask), 32, 16))
    got = float(tlosses.ncc_depth_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                                       torch.from_numpy(mask), 32, 16))
    assert 0.05 < want < 0.95
    assert abs(got - want) <= 1e-5, (got, want)


# ------------------------------------------ the stop-gradients of the JAX package

def test_sh_view_direction_has_no_means_gradient():
    """_eval_colors: the SH view direction is stop_gradient(means) -
    cam_pos in JAX, so colours carry gradient to cam_pos, never to means."""
    rng = np.random.default_rng(0)
    n = 64
    means = rng.normal(0, 3, (n, 3)).astype(np.float32)
    dc = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    rest = rng.normal(0, 0.3, (n, 15, 3)).astype(np.float32)
    cam = np.array([0.5, -0.2, 4.0], np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    mask = np.ones(16, np.float32)

    def jloss(m, c):
        return (jsg._eval_colors(m, jnp.asarray(dc), jnp.asarray(rest), c,
                                 jnp.asarray(mask)) * w).sum()

    gm_j, gc_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(means), jnp.asarray(cam))
    m_t = torch.tensor(means, requires_grad=True)
    c_t = torch.tensor(cam, requires_grad=True)
    loss = (tsg._eval_colors(m_t, torch.from_numpy(dc), torch.from_numpy(rest), c_t,
                             torch.from_numpy(mask)) * torch.from_numpy(w)).sum()
    gm_t, gc_t = torch.autograd.grad(loss, (m_t, c_t), allow_unused=True)
    assert not np.asarray(gm_j).any()
    assert gm_t is None or not gm_t.any(), "SH view direction leaks gradient into means"
    assert np.abs(np.asarray(gc_j)).max() > 0
    np.testing.assert_allclose(gc_t.numpy(), np.asarray(gc_j), rtol=1e-4, atol=1e-5)


def test_normal_orientation_keeps_no_means_graph():
    """gaussian_camera_normals: the camera-facing test reads
    stop_gradient(means) in JAX. The port's test records no autograd
    state for the means (with a graph through them, the view direction's
    normalisation would save its tensors for a backward that only ever
    yields zeros); the normals and their gradient equal JAX's."""
    rng = np.random.default_rng(1)
    n = 50
    scales = rng.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    means = rng.normal(0, 3, (n, 3)).astype(np.float32)
    cam = np.array([0.3, 0.1, 5.0], np.float32)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    R = quat_to_rotmat(torch.from_numpy(quats))
    m_t = torch.tensor(means, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x, lambda x: x):
        out = tlosses.gaussian_camera_normals(torch.from_numpy(scales), R, m_t,
                                              torch.from_numpy(cam), torch.from_numpy(rot))
    assert not saved and not out.requires_grad, "the orientation test tracks the means"
    from mtgs_tpu.core.quat import quat_to_rotmat as jrot

    want = jlosses.gaussian_camera_normals(jnp.asarray(scales), jrot(jnp.asarray(quats)),
                                           jnp.asarray(means), jnp.asarray(cam),
                                           jnp.asarray(rot))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_depth_fill_of_empty_pixels_has_no_gradient():
    """render_view fills pixels with alpha <= 1e-6 with the largest depth
    under stop_gradient in JAX: a loss on those pixels alone has zero
    gradient everywhere."""
    rng = np.random.default_rng(0)
    xyz = np.stack([rng.uniform(-1, 1, 20), rng.uniform(-1, 1, 20),
                    rng.uniform(-6, -3, 20)], -1).astype(np.float32)
    params, aux = tsg.init_scene(tg.init_node_from_points(xyz, rng.uniform(0, 255, (20, 3)),
                                                          capacity=32, device="cpu"),
                                 device="cpu")
    cfg = tconfigs.mtgs_config(32, 16).replace(max_intersections=1 << 12)
    K = np.array([[20.0, 0, 16], [0, 20.0, 8], [0, 0, 1]], np.float32)
    batch = ttr.Batch(image=np.zeros((16, 32, 3), np.float32),
                      mask=np.ones((16, 32, 1), np.float32), c2w=np.eye(4, dtype=np.float32),
                      K=K, cam_idx=0, image_idx=0, travel_index=0, frame_idx=0, timestamp=0.0)
    leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
    out = ttr.render_view(params, aux, cfg, batch, 0, training=True, device="cpu")
    empty = out["accumulation"] <= 1e-6
    assert empty.any() and (~empty).any()
    grads = torch.autograd.grad(out["depth"][empty].sum(), leaves, allow_unused=True,
                                retain_graph=True)
    assert all(g is None or not g.any() for g in grads), "empty-pixel depth fill has a gradient"
    # the covered pixels' depth does carry gradient
    grads = torch.autograd.grad(out["depth"][~empty].sum(), leaves, allow_unused=True)
    assert any(g is not None and g.any() for g in grads)


def test_trainer_loop_refines_resets_and_grows_on_schedule():
    """Trainer.train on a 32x16 view: with refine_every 2 and a zero
    densify threshold, refines fire at steps 2, 4, 6 and opacity resets at
    2 and 6 (the JAX loop's `sref % (reset_alpha_every * refine_every) ==
    refine_every`); the background outgrows its 256 rows and the Adam
    moments and densify statistics follow the rows."""
    rng = np.random.default_rng(5)
    n = 200
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.5, 0.5, n),
                    rng.uniform(-6, -3, n)], -1).astype(np.float32)
    params, aux = tsg.init_scene(tg.init_node_from_points(xyz, rng.uniform(0, 255, (n, 3)),
                                                          capacity=256, init_opacity=0.5,
                                                          device="cpu"),
                                 device="cpu")
    cfg = tconfigs.mtgs_config(32, 16, max_steps=30).replace(max_intersections=1 << 12)
    cfg = cfg.replace(control=dataclasses.replace(cfg.control, refine_every=2,
                                                  densify_grad_thresh=0.0))
    K = np.array([[20.0, 0, 16], [0, 20.0, 8], [0, 0, 1]], np.float32)
    depth = rng.uniform(3, 6, (16, 32, 1)).astype(np.float32)
    batch = ttr.Batch(image=rng.uniform(0, 1, (16, 32, 3)).astype(np.float32),
                      mask=np.ones((16, 32, 1), np.float32), c2w=np.eye(4, dtype=np.float32),
                      K=K, cam_idx=0, image_idx=0, travel_index=0, frame_idx=0, timestamp=0.0,
                      lidar_depth=depth, pseudo_depth=depth)
    trainer = ttr.Trainer(cfg, params, aux, iter([batch] * 6), device="cpu")
    history = trainer.train(6)
    assert [e["step"] for e in trainer.refine_events] == [2, 4, 6]
    assert trainer.reset_steps == [2, 6]
    assert trainer.refine_events[0]["n_split"] + trainer.refine_events[0]["n_dup"] > 0
    grown = [e for e in trainer.growth_events if e["node"] == "background"]
    assert grown and grown[0]["old"] == 256 and grown[0]["new"] >= 4096
    st = trainer.state
    cap = st.params.background.capacity
    assert cap == grown[-1]["new"] and trainer.aux.background.alive.shape == (cap,)
    assert int(trainer.aux.background.num_alive) == int(trainer.aux.background.alive.sum()) > n
    for (path, p), (_, m), (_, v) in zip(named_leaves(st.params), named_leaves(st.adam.mu),
                                         named_leaves(st.adam.nu)):
        assert m.shape == v.shape == p.shape, path
        assert torch.isfinite(p).all(), path
    assert st.densify["background"].xys_grad_norm.shape == (cap,)
    assert st.step == 6 and int(st.adam.count) == 6
    assert all(float(h["nonfinite_grad_step"]) == 0 for h in history)


def test_trainer_refine_split_noise_matches_jax():
    """One refine of a Trainer, split noise on (`clone_sample_means`), on
    the same seed: the port's key chain splits as JAX's does (five keys, the
    first carried on; the instance rows split(k3, I)), so the sampled means
    of every node, and so every refined parameter, equal JAX's: the
    background's within 1e-6 (relative above 1), the skybox's and the
    instance's within 1e-6 of the leaf's largest magnitude (a sky mean 300
    m out that the noise moves near 0 keeps the rounding of 300: ulp 3e-5);
    the carried key is JAX's. Growth is off on both sides (JAX's growth
    plan would start a speculative compile)."""
    jp, ja = build_jax_scene(4)
    tp, ta = scene_from_state_dict(to_sd(jp), to_sd(ja), device="cpu")
    cc = dict(densify_grad_thresh=1e-4, densify_size_thresh=0.6)
    jcfg = jtr.TrainerConfig(width=W, height=H, auto_grow=False, backend="xla",
                             control=jctrl.ControlConfig(**cc))
    tcfg = ttr.TrainerConfig(width=W, height=H, auto_grow=False,
                             control=tctrl.ControlConfig(**cc))
    jt = jtr.Trainer(jcfg, jp, ja, iter(()), seed=9)
    tt = ttr.Trainer(tcfg, tp, ta, iter(()), seed=9, device="cpu")
    rng = np.random.default_rng(21)
    densify = {}
    for kind, d in jt.state.densify.items():
        shape = d.xys_grad_norm.shape
        vis = rng.integers(1, 4, shape).astype(np.float32)
        densify[kind] = dict(xys_grad_norm=(rng.uniform(0, 6e-4, shape) * vis).astype(np.float32),
                             vis_counts=vis,
                             max_2dsize=rng.uniform(0, 50, shape).astype(np.float32),
                             last_comp=rng.uniform(0.5, 1.0, shape).astype(np.float32))
    jt.state = jt.state.replace(densify={k: jctrl.DensifyState(**{
        f: jnp.asarray(v) for f, v in d.items()}) for k, d in densify.items()})
    tt.state.densify = {k: tctrl.DensifyState(**{f: torch.from_numpy(v) for f, v in d.items()})
                        for k, d in densify.items()}
    flags = (True, False, True)
    fn = jt._get_refine_fn(flags, jt._plan_growth(flags))
    jstate, jaux, jinfo = fn(jt.state, jt.aux)
    info = tt.refine(flags)
    assert int(jinfo["n_split"]) > 0 and int(jinfo["n_dup"]) > 0
    for k in ("n_split", "n_dup", "n_cull", "overflow"):
        assert info[k] == int(jinfo[k]), k
    assert np.array_equal(tt.key.numpy(), raw_key(jstate.key))
    want = flat(to_sd(jstate.params))
    got = dict(named_leaves(tt.state.params))
    for node in ("background", "skybox", "instances.node"):
        for f in NODE_FIELDS:
            k = f"{node}.{f}"
            scale = 1.0 if node == "background" else float(np.abs(want[k]).max(initial=1.0))
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=k)
    np.testing.assert_array_equal(tt.aux.background.alive.numpy(),
                                  np.asarray(jaux.background.alive))


def raw_key(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)
