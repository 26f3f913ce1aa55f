"""Deformable nodes and WildGaussians appearance in mtgs_torch against the
JAX package.

The scene is test_torch_slice.py's (a multicolour background with
per-traversal SH rest, a skybox, one rigid instance with Fourier dc; 2
traversals x 2 frames) with two deformable instances and the WildGaussians
appearance added by the JAX package's own initialisers, their output heads
scaled up so the offsets and the colour MLP matter; it is carried across
with `scene_from_state_dict`.

Tolerances: the MLPs' and the scene graph's values rtol 1e-5 / atol 1e-6,
their gradients max-scaled 1e-5 (the same f32 formulation, the matmul sums
in another order); one `train_step` at the slice test's tolerances
(losses 1e-4 relative, gradients and Adam's mu 2e-4 max-scaled, nu 4e-4).
The JAX step runs its fused Pallas path in interpret mode at 48x32 with
NCC patch and stride 8, as test_torch_train.py does.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu import configs as jconfigs
from mtgs_tpu.models import deform as jdeform
from mtgs_tpu.models import gaussians as jg
from mtgs_tpu.models import scene_graph as jsg
from mtgs_tpu.models import wild as jwild
from mtgs_tpu.train import optim as joptim
from mtgs_tpu.train import trainer as jtr
from mtgs_torch import configs as tconfigs
from mtgs_torch.core import prng
from mtgs_torch.data import synthetic as tsyn
from mtgs_torch.models import deform as tdeform
from mtgs_torch.models import scene_graph as tsg
from mtgs_torch.models import wild as twild
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.train import checkpoint as tckpt
from mtgs_torch.train import control as tctrl
from mtgs_torch.train import trainer as ttr
from mtgs_torch.train.optim import named_leaves, param_labels
from tests.test_torch_slice import N_FRAMES, N_TRAVELS, build_jax_scene

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5
STEP_GRAD_TOL = 2e-4
W, H = 48, 32
I_CAP = 1 << 13
NCC = dict(ncc_patch_size=8, ncc_stride=8)
F = N_TRAVELS * N_FRAMES


def to_sd(tree):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(tree))


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


def max_scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.size == 0:
        return 0.0
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale if scale > 0 else float(np.abs(got).max())


def build_deform_scene(seed=0):
    """test_torch_slice's JAX scene with two deformable instances and the
    WildGaussians appearance; the MLP heads scaled up from their
    near-identity start."""
    params, aux = build_jax_scene(seed)
    rng = np.random.default_rng(seed + 10)
    nodes, auxs = [], []
    for i in range(2):
        n = 150
        local = (rng.uniform(-0.5, 0.5, (n, 3)) * [1.5, 1.5, 2.0]).astype(np.float32)
        node, naux = jg.init_node_from_points(local, rng.uniform(0, 255, (n, 3)),
                                              capacity=256, seed=seed + 20 + i)
        op = np.log(rng.uniform(0.5, 0.95, (256, 1)) / 0.99).astype(np.float32)
        nodes.append(node.replace(opacities=jnp.asarray(op)))
        auxs.append(naux)
    node = jax.tree.map(lambda *a: jnp.stack(a), *nodes)
    yaw = rng.uniform(-1, 1, (2, F))
    quats = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    trans = np.stack([rng.uniform(4, 6, (2, F)), rng.uniform(-1.5, 1.5, (2, F)),
                      np.full((2, F), 0.5)], -1)
    mlp = jdeform.init_deform_mlp(jax.random.key(seed + 3))
    hk = jax.random.split(jax.random.key(seed + 4), 3)
    mlp = mlp.replace(w_xyz=jax.random.normal(hk[0], (jdeform.HIDDEN, 3)) * 0.02,
                      w_quat=jax.random.normal(hk[1], (jdeform.HIDDEN, 4)) * 0.02,
                      w_scale=jax.random.normal(hk[2], (jdeform.HIDDEN, 3)) * 0.02,
                      b_xyz=jnp.asarray([0.01, -0.02, 0.03]))
    deform = jsg.DeformableParams(
        node=node, quats=jnp.asarray(quats, jnp.float32), trans=jnp.asarray(trans, jnp.float32),
        embeddings=jnp.asarray(rng.normal(size=(2, 16)), jnp.float32), mlp=mlp)
    daux = jsg.InstanceAux(
        alive=jnp.stack([a.alive for a in auxs]),
        num_alive=jnp.stack([a.num_alive for a in auxs]),
        present=jnp.asarray([[1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 1.0]], jnp.float32),
        is_static=jnp.asarray([0.0, 1.0], jnp.float32),
        frame_timestamps=jnp.asarray(np.linspace(0, 1, F), jnp.float32),
        travel_of_frame=jnp.repeat(jnp.arange(N_TRAVELS, dtype=jnp.int32), N_FRAMES),
        sizes=jnp.asarray([[1.5, 1.5, 2.0]] * 2, jnp.float32))
    wild = jwild.init_wild(jax.random.key(seed + 5), F)
    wild = wild.replace(w3=jax.random.normal(jax.random.key(seed + 6), (jwild.HIDDEN, 6)) * 0.3,
                        b3=jnp.asarray([0.5, -0.5, 0.2, 0.1, -0.3, 0.4]))
    # the background between the cameras and the instances made fainter,
    # so the instances get gradients of the background's order
    bg = params.background
    near = np.asarray(bg.means)[:, :1] < 8.0
    bg = bg.replace(opacities=jnp.where(near, bg.opacities - 3.0, bg.opacities))
    params = params.replace(background=bg, deformables=deform, wild=wild)
    aux = aux.replace(deformables=daux)
    return params, aux


@pytest.fixture(scope="module")
def scene_pair():
    jp, ja = build_deform_scene()
    tp, ta = scene_from_state_dict(to_sd(jp), to_sd(ja), device="cpu")
    return (jp, ja), (tp, ta)


def jax_leaf_paths(tree):
    """The dotted path of each leaf of a JAX pytree, in jax.tree.leaves order."""
    name = lambda k: str(getattr(k, "name", getattr(k, "idx", k)))
    return [".".join(name(k) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


def torch_leaves(tree):
    return dict(named_leaves(tree))


# ------------------------------------------------------------- the MLPs

def test_posenc_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.25, 1.25, (64, 3)).astype(np.float32)
    want = np.asarray(jdeform.posenc(jnp.asarray(x), tdeform.X_MULTIRES))
    got = tdeform.posenc(torch.from_numpy(x), tdeform.X_MULTIRES).numpy()
    assert got.shape == want.shape == (64, 63)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the layout: the input, then sin of every frequency, then cos
    np.testing.assert_array_equal(got[:, :3], x)
    np.testing.assert_allclose(got[:, 3:6], np.sin(x), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[:, 33:36], np.cos(x), rtol=1e-6, atol=1e-7)
    assert (tdeform._in_dim(16), twild.IN_DIM) == (100, 59)


@pytest.mark.parametrize("seed, embed_dim, num_images", [(0, 16, 4), (7, 8, 6)])
def test_init_deform_mlp_and_init_wild_match_jax(seed, embed_dim, num_images):
    """The deform MLP (split(key, DEPTH + 3)) and the WildGaussians weights
    (split(key, 4)) drawn from one key: JAX's within 1e-6 (the He scale
    sqrt(2 / fan_in) in float32, as JAX takes it)."""
    init_mlp = jax.jit(jdeform.init_deform_mlp, static_argnums=(1,))  # one compile
    want = flat(to_sd(init_mlp(jax.random.key(seed), embed_dim)))
    got = dict(named_leaves(tdeform.init_deform_mlp(prng.key(seed), embed_dim, device="cpu")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-7, err_msg=k)
    want = flat(to_sd(jax.jit(jwild.init_wild, static_argnums=(1,))(jax.random.key(seed),
                                                                      num_images)))
    got = dict(named_leaves(twild.init_wild(prng.key(seed), num_images, device="cpu")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-7, err_msg=k)
    assert float(got["w1"].std()) > 0.05


def test_deform_mlp_and_apply_deform_match_jax(scene_pair):
    (jp, _), (tp, _) = scene_pair
    jd, td = jp.deformables, tp.deformables
    rng = np.random.default_rng(1)
    g_out = [rng.normal(size=(2, 256, k)).astype(np.float32) for k in (3, 4, 3)]
    ts = np.float32(0.37)

    def jloss(mlp, emb):
        outs = jdeform.apply_deform(mlp, jd.node.means, emb, jnp.asarray(ts), xyz_bound=4.0)
        return sum(jnp.sum(o * g) for o, g in zip(outs, g_out)), outs

    (_, j_outs), j_grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jd.mlp, jd.embeddings)
    leaves = [p.requires_grad_(True) for _, p in named_leaves(td.mlp)] + [
        td.embeddings.requires_grad_(True)]
    t_outs = tdeform.apply_deform(td.mlp, td.node.means, td.embeddings, torch.tensor(ts),
                                  xyz_bound=4.0)
    loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(t_outs, g_out))
    t_grads = torch.autograd.grad(loss, leaves)
    for got, want in zip(t_outs, j_outs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want = jax.tree.leaves(j_grads[0]) + [j_grads[1]]
    assert len(want) == len(t_grads) == 23
    for got, w in zip(t_grads, want):
        assert max_scaled_err(got.numpy(), w) <= GRAD_TOL


def test_wild_colors_matches_jax(scene_pair):
    (jp, _), (tp, _) = scene_pair
    rng = np.random.default_rng(2)
    dc = rng.normal(0, 1.5, (300, 3)).astype(np.float32)   # some rgb past the clamp
    rest = rng.normal(0, 0.3, (300, 15, 3)).astype(np.float32)
    g = rng.normal(size=(300, 3)).astype(np.float32)

    def jloss(wp, dc, rest):
        c = jwild.wild_colors(wp, dc, rest, jnp.asarray(2, jnp.int32))
        return jnp.sum(c * g), c

    (_, j_c), j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jp.wild, jnp.asarray(dc), jnp.asarray(rest))
    t_dc = torch.from_numpy(dc).requires_grad_(True)
    t_rest = torch.from_numpy(rest).requires_grad_(True)
    leaves = [p.requires_grad_(True) for _, p in named_leaves(tp.wild)] + [t_dc, t_rest]
    t_c = twild.wild_colors(tp.wild, t_dc, t_rest, 2)
    t_grads = torch.autograd.grad((t_c * torch.from_numpy(g)).sum(), leaves)
    np.testing.assert_allclose(t_c.detach().numpy(), np.asarray(j_c), rtol=RTOL, atol=ATOL)
    assert float(t_c.detach().min()) < 0 or float(t_c.detach().max()) > 1   # not clamped
    want = jax.tree.leaves(j_grads[0]) + [j_grads[1], j_grads[2]]
    for got, w in zip(t_grads, want):
        assert max_scaled_err(got.numpy(), w) <= GRAD_TOL
    # only the first 24 rest values reach the MLP
    assert np.all(t_grads[-1].numpy().reshape(300, -1)[:, 24:] == 0)


# ------------------------------------------------------- the scene graph

def _views(jp):
    """(JAX ViewInputs, port ViewInputs) of frame 3 (traversal 1)."""
    cam = np.float32([0.2, -0.3, 1.0])
    mask = np.ones(16, np.float32)
    mask[9:] = 0.0     # degree 2
    jv = jsg.ViewInputs(travel_index=jnp.asarray(1), frame_idx=jnp.asarray(3),
                        timestamp=jnp.asarray(0.8, jnp.float32), cam_pos=jnp.asarray(cam),
                        sh_mask=jnp.asarray(mask), image_idx=jnp.asarray(3))
    tv = tsg.ViewInputs(travel_index=1, frame_idx=3, timestamp=torch.tensor(0.8),
                        cam_pos=torch.from_numpy(cam), sh_mask=torch.from_numpy(mask),
                        image_idx=3)
    return jv, tv


@pytest.mark.parametrize("deform_enabled", [False, True])
def test_collect_gaussians_matches_jax(scene_pair, deform_enabled):
    (jp, ja), (_, ta) = scene_pair
    # a fresh copy: the shared one's leaves stay without requires_grad
    tp, _ = scene_from_state_dict(to_sd(jp), to_sd(ja), device="cpu")
    jv, tv = _views(jp)
    jcfg = jsg.SceneConfig(deform_enabled=deform_enabled)
    tcfg = tsg.SceneConfig(deform_enabled=deform_enabled)
    rng = np.random.default_rng(3)
    keys = ("means", "quats", "scales", "opacities", "colors")
    n = tsg.node_segments(tp)[-1][2]
    shapes = dict(means=(n, 3), quats=(n, 4), scales=(n, 3), opacities=(n,), colors=(n, 3))
    wts = {k: rng.normal(size=shapes[k]).astype(np.float32) for k in keys}

    def jloss(p):
        out = jsg.collect_gaussians(p, ja, jcfg, jv)
        return sum(jnp.sum(out[k] * wts[k]) for k in keys), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    j_grads = flat(to_sd(j_grads))
    leaves = torch_leaves(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    t_out = tsg.collect_gaussians(tp, ta, tcfg, tv)
    loss = sum((t_out[k] * torch.from_numpy(wts[k])).sum() for k in keys)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    t_grads = {k: np.zeros(p.shape, np.float32) if g is None else g.numpy()
               for (k, p), g in zip(leaves.items(), grads)}
    assert [s[0] for s in tsg.node_segments(tp)][-2:] == ["deformable_0", "deformable_1"]
    for k in keys:
        assert t_out[k].shape[0] == n
        np.testing.assert_allclose(t_out[k].detach().numpy(), np.asarray(j_out[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert sorted(t_grads) == sorted(j_grads)
    for k, want in j_grads.items():
        assert max_scaled_err(t_grads[k], want) <= GRAD_TOL, (k, max_scaled_err(t_grads[k], want))
    mlp_g = np.abs(t_grads["deformables.mlp.w.0"]).max()
    canon_g = np.abs(t_grads["deformables.node.means"]).max()
    if deform_enabled:
        assert mlp_g > 0 and np.abs(t_grads["deformables.embeddings"]).max() > 0
        assert canon_g == 0      # the canonical means are frozen
    else:
        assert mlp_g == 0 and canon_g > 0
    # the wild path: the MLP gets gradients, the background's SH rest beyond
    # the first 24 values does not
    assert np.abs(t_grads["wild.w1"]).max() > 0
    rest_g = t_grads["background.features_rest"][:, 1].reshape(tp.background.capacity, -1)
    assert np.abs(rest_g[:, :24]).max() > 0 and np.all(rest_g[:, 24:] == 0)


def test_param_labels_match_jax(scene_pair):
    (jp, _), (tp, _) = scene_pair
    want = flat(flax.serialization.to_state_dict(joptim.param_labels(jp)))
    got = param_labels(tp)
    assert list(got) == jax_leaf_paths(jp)   # jax.tree.leaves order
    assert got == {k: str(v) for k, v in want.items()}
    assert got["deformables.mlp.w.7"] == "deform_network"
    assert got["deformables.node.features_dc"] == "features_dc"
    assert got["wild.b3"] == "appearance"


@pytest.mark.parametrize("deformable", [False, True])
def test_translate_and_rotate_instance_match_jax(scene_pair, deformable):
    (jp, _), (tp, _) = scene_pair
    q = [0.9, 0.1, -0.2, 0.3]
    for jfn, tfn, arg in ((jsg.translate_instance, tsg.translate_instance, [0.5, -1.0, 0.25]),
                          (jsg.rotate_instance, tsg.rotate_instance, q)):
        want = flat(to_sd(jfn(jp, 0, arg, deformable=deformable)))
        got = torch_leaves(tfn(tp, 0, arg, deformable=deformable))
        for k in ("quats", "trans"):
            key = f"{'deformables' if deformable else 'instances'}.{k}"
            np.testing.assert_allclose(got[key].detach().numpy(), want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
    # the input scene is unchanged
    np.testing.assert_array_equal(tp.deformables.trans.detach().numpy(),
                                  np.asarray(jp.deformables.trans))


# ------------------------------------------------------------ one train step

STEP = 3000


@pytest.fixture(scope="module")
def step_pair(scene_pair):
    """One `train_step` of the deform + wild scene with deformation on, in
    both packages from the same parameters, at step 3000 (SH degree 3
    live, the sharp-shape gate open): (JAX results, port results, initial
    canonical means)."""
    from tests.test_torch_slice import make_views

    params, aux = scene_pair[0]
    p_sd, a_sd = to_sd(params), to_sd(aux)
    t_params, t_aux = scene_from_state_dict(p_sd, a_sd, device="cpu")
    t_init, _ = scene_from_state_dict(p_sd, a_sd, device="cpu")
    jcfg = jconfigs.mtgs_deformable_config(W, H)
    jcfg = jcfg.replace(backend="pallas", interpret=True, fused=True, max_intersections=I_CAP,
                        loss=jcfg.loss.replace(**NCC),
                        scene=jcfg.scene.replace(deform_enabled=True))
    tcfg = tconfigs.mtgs_deformable_config(W, H)
    tcfg = tcfg.replace(max_intersections=I_CAP, loss=dataclasses.replace(tcfg.loss, **NCC),
                        scene=dataclasses.replace(tcfg.scene, deform_enabled=True))

    v = make_views()[3]
    v["K"] = v["K"] * np.float32([[0.5], [0.5], [1.0]])
    v["mask"], v["lidar_depth"] = v["mask"][::2, ::2], v["lidar_depth"][::2, ::2]
    out = ttr.render_view(t_params, t_aux, tcfg, ttr.Batch(**v), STEP, device="cpu")
    rng = np.random.default_rng(3)
    v["image"] = np.clip(0.85 * out["rgb"].numpy() + 0.08
                         + 0.03 * rng.normal(size=(H, W, 3)), 0, 1).astype(np.float32)
    d = out["depth"].numpy()
    v["pseudo_depth"] = np.clip(d * (1.0 + 0.05 * rng.normal(size=d.shape)), 0.5, 79.0
                                ).astype(np.float32)

    # JAX: make_train_step's step; an optimizer wrapper keeps the gradients
    # in the optimizer state and a wrapped _accumulate_all the absgrad
    # sink's gradient in the densify dict
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
        metrics={k: float(m) for k, m in t_metrics.items()})
    return jax_res, torch_res, p_sd["deformables"]["node"]["means"]


def test_train_step_losses_and_densify_match_jax(step_pair):
    j, t, _ = step_pair
    for k in ("l1", "ssim", "depth", "ncc", "normal", "two_d_reg", "sharp_shape", "oob",
              "camera_opt", "total_loss", "psnr"):
        assert abs(t["metrics"][k] - j["metrics"][k]) <= 1e-4 * abs(j["metrics"][k]) + 1e-9, (
            k, t["metrics"][k], j["metrics"][k])
    for k in ("nonfinite_grad_step", "n_intersections", "gaussian_count"):
        assert t["metrics"][k] == j["metrics"][k], k
    assert t["metrics"]["nonfinite_grad_step"] == 0
    assert max_scaled_err(t["absgrad"], j["absgrad"]) <= STEP_GRAD_TOL
    assert sorted(t["densify"]) == sorted(j["densify"])
    dj, dt = j["densify"]["deformables"], t["densify"]["deformables"]
    assert dj["vis_counts"].sum() > 0
    np.testing.assert_array_equal(dt["vis_counts"], dj["vis_counts"])
    assert max_scaled_err(dt["xys_grad_norm"], dj["xys_grad_norm"]) <= STEP_GRAD_TOL


def test_train_step_gradients_match_jax(step_pair):
    """Every leaf, the deform MLP's, the embeddings' and the wild MLP's
    included: gradients, Adam's moments and the updated parameters (where
    the gradient is not rounding noise); the canonical means keep their
    values while their moments take the zero gradient."""
    j, t, means0 = step_pair
    assert sorted(t["grads"]) == sorted(j["grads"])
    live = [k for k in j["grads"] if k.startswith(("deformables.mlp", "wild"))]
    assert len(live) == 22 + 7
    for leaf, g_j in j["grads"].items():
        g_t = t["grads"][leaf]
        assert g_t.shape == g_j.shape, leaf
        if g_j.size == 0:
            continue
        assert np.isfinite(g_t).all(), leaf
        assert max_scaled_err(g_t, g_j) <= STEP_GRAD_TOL, (leaf, max_scaled_err(g_t, g_j))
        assert max_scaled_err(t["mu"][leaf], j["mu"][leaf]) <= STEP_GRAD_TOL, leaf
        assert max_scaled_err(t["nu"][leaf], j["nu"][leaf]) <= 2 * STEP_GRAD_TOL, leaf
        sel = np.abs(g_j) > 1e-3 * np.abs(g_j).max()
        np.testing.assert_allclose(t["params"][leaf][sel], j["params"][leaf][sel],
                                   rtol=1e-6, atol=1e-7, err_msg=leaf)
    for k in live + ["deformables.embeddings"]:
        assert np.abs(j["grads"][k]).max() > 0, k
    assert np.all(j["grads"]["deformables.node.means"] == 0)
    for res in (j, t):
        np.testing.assert_array_equal(res["params"]["deformables.node.means"], means0)


# ------------------------------------------------ the trainer, port only

def deformable_model(scene, *, cap=None, wild=False):
    """The synthetic scene's model with its rigid instance made a
    deformable one (zero embeddings, a seeded MLP), as the JAX package's
    test_train_e2e.py builds it; `cap` cuts the block's capacity."""
    params, aux = tsyn.build_scene_model(scene, with_instances=True, wild_appearance=wild,
                                         device="cpu")
    inst, iaux = params.instances, aux.instances
    node = inst.node if cap is None else dataclasses.replace(inst.node, **{
        f.name: getattr(inst.node, f.name)[:, :cap] for f in dataclasses.fields(inst.node)})
    iaux = iaux if cap is None else dataclasses.replace(iaux, alive=iaux.alive[:, :cap])
    deform = tsg.DeformableParams(
        node=node, quats=inst.quats, trans=inst.trans,
        embeddings=torch.zeros((inst.node.means.shape[0], 16)),
        mlp=tdeform.init_deform_mlp(prng.key(0), device="cpu"))
    params = dataclasses.replace(params, instances=None, deformables=deform)
    return params, dataclasses.replace(aux, instances=None, deformables=iaux)


@pytest.fixture(scope="module")
def small_scene():
    return tsyn.make_synthetic_scene(seed=0, width=48, height=48, n_travels=1, n_frames=2,
                                     n_bg=200, n_instance=40, gt_max_intersections=1 << 13,
                                     device="cpu")


def _trainer_cfg(**kw):
    return ttr.TrainerConfig(width=48, height=48, max_intersections=1 << 13, max_steps=100,
                             predict_normals=False, **kw)


def test_deformable_enable_schedule_and_canonical_freeze(small_scene):
    """The Trainer turns deformation on at deform_enable_step (the MLP and
    the embeddings inert before, bit for bit, while the canonical means
    train) and from then on the canonical xyz stay exactly where they
    were; a trainer resumed past the step turns it on at once."""
    params, aux = deformable_model(small_scene)
    cfg = _trainer_cfg(deform_enable_step=4,
                       control=tctrl.ControlConfig(densify_from_iter=10**9))
    assert not cfg.scene.deform_enabled
    m_init = params.deformables.node.means.detach().clone()
    mlp_init = {k: p.detach().clone() for k, p in named_leaves(params.deformables.mlp)}
    emb_init = params.deformables.embeddings.detach().clone()
    trainer = ttr.Trainer(cfg, params, aux, tsyn.batch_iterator(small_scene, device="cpu"),
                          device="cpu")

    trainer.train(3)    # steps 0..2: deformation inert
    d = trainer.state.params.deformables
    assert not trainer.cfg.scene.deform_enabled
    alive = trainer.aux.deformables.alive[0] > 0
    assert (d.node.means[0][alive] - m_init[0][alive]).abs().max() > 0
    assert all(torch.equal(p, mlp_init[k]) for k, p in named_leaves(d.mlp))
    assert torch.equal(d.embeddings, emb_init)
    assert int(trainer.state.adam.count) == 3

    trainer.train(2)    # step 3 inert, step 4 turns it on, then steps
    assert trainer.cfg.scene.deform_enabled and trainer._base_cfg.scene.deform_enabled
    m_flip = trainer.state.params.deformables.node.means.detach().clone()
    trainer.train(3)
    d = trainer.state.params.deformables
    assert torch.equal(d.node.means, m_flip), "canonical xyz moved after the flip"
    assert not torch.equal(d.mlp.w[0], mlp_init["w.0"])
    assert not torch.equal(d.embeddings, emb_init)
    # the frozen leaf's moments still take its (zero) gradient
    assert trainer.state.adam.mu.deformables.node.means.abs().max() > 0

    params, aux = deformable_model(small_scene)
    resumed = ttr.Trainer(cfg, params, aux, tsyn.batch_iterator(small_scene, device="cpu"),
                          device="cpu")
    resumed.state.step = 10
    resumed.train(1)
    assert resumed.cfg.scene.deform_enabled


def test_deformable_training_and_refine(small_scene):
    """Deformable nodes train, refine (their densify statistics consumed)
    and reset their opacities like every other node."""
    params, aux = deformable_model(small_scene)
    cfg = _trainer_cfg(control=tctrl.ControlConfig(
        densify_from_iter=2, refine_every=4, stop_split_at=100, reset_alpha_every=2,
        sh_degree_interval=10, densify_grad_thresh=1e-6))
    cfg = cfg.replace(scene=dataclasses.replace(cfg.scene, deform_enabled=True))
    trainer = ttr.Trainer(cfg, params, aux, tsyn.batch_iterator(small_scene, device="cpu"),
                          device="cpu")
    n0 = int(trainer.aux.deformables.num_alive.sum())
    hist = trainer.train(10)
    assert all(bool(torch.isfinite(h["total_loss"])) for h in hist)
    assert int(trainer.aux.deformables.num_alive.sum()) != n0
    assert [e["step"] for e in trainer.refine_events] == [4, 8]
    assert trainer.reset_steps == [4]
    # the refine after step 7 consumed the statistics: steps 8 and 9 since
    assert 0 < float(trainer.state.densify["deformables"].vis_counts.max()) <= 2


def state_leaves(params, aux, adam):
    """{name: tensor} of a training state's params, aux and Adam moments."""
    trees = dict(params=params, aux=aux, mu=adam.mu, nu=adam.nu)
    return {f"{t}.{k}": v for t, tree in trees.items() for k, v in named_leaves(tree)}


def test_checkpoint_round_trip_with_deformables_and_wild(small_scene, tmp_path):
    """A run whose deformable block grew is saved; a freshly built scene
    padded to `checkpoint_layout`'s capacities loads it exactly (the MLP
    tuples and the wild leaves included) and trains on."""
    cfg = _trainer_cfg(grow_granule=256, deform_enable_step=0, control=tctrl.ControlConfig(
        densify_from_iter=0, refine_every=2, stop_split_at=100, reset_alpha_every=1000,
        densify_grad_thresh=1e-12))
    data = tsyn.batch_iterator(small_scene, device="cpu")
    first = ttr.Trainer(cfg, *deformable_model(small_scene, cap=64, wild=True), data,
                        device="cpu")
    first.train(4)
    assert any(e["node"] == "deformables" for e in first.growth_events), first.growth_events
    tckpt.save_checkpoint(tmp_path / "c", first.state, first.aux)
    layout = tckpt.checkpoint_layout(tmp_path / "c")
    assert layout["caps"]["deformables"] == first.state.params.deformables.node.means.shape[1]
    assert layout["caps"]["deformables"] > 64 and layout["step"] == 4

    params, aux = tckpt.pad_scene_to_caps(*deformable_model(small_scene, cap=64, wild=True),
                                          layout["caps"])
    resumed = ttr.Trainer(cfg, params, aux, data, device="cpu")
    template = {"params": resumed.state.params, "densify": resumed.state.densify,
                "step": resumed.state.step, "aux": resumed.aux, "opt_state": resumed.state.adam}
    got = tckpt.load_checkpoint(tmp_path / "c", template)
    have = state_leaves(got["params"], got["aux"], got["opt_state"])
    want = state_leaves(first.state.params, first.aux, first.state.adam)
    assert sorted(have) == sorted(want)
    for k in want:
        assert torch.equal(have[k], want[k]), k
    assert {"params.deformables.mlp.w.7", "params.wild.w3"} <= set(have)
    st = resumed.state
    st.params, st.densify, st.step, st.adam = (got["params"], got["densify"], got["step"],
                                               got["opt_state"])
    resumed.aux = got["aux"]
    hist = resumed.train(1)
    assert bool(torch.isfinite(hist[0]["total_loss"])) and resumed.state.step == 5
