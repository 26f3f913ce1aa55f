"""Image and gaussian export: mtgs_torch vs the JAX package.

One small scene (a multicolour background of 300 gaussians with
per-traversal SH rest, 2 traversals) is built with the JAX package's own
initialisers, given seeded random opacities, SH rest and adapters, and
carried across with `scene_from_state_dict`. The JAX side renders with its
XLA backend at 32x32, as tests/test_eval_metrics.py exports (its blend is
the chunk math of the Pallas path the port mirrors).

- `export_eval_images` in its three modes: the same relative paths and
  symlink targets as JAX's; the ground-truth JPEGs byte-equal; the renders,
  decoded by the port's decoder (PIL-exact), within one level at >= 99.9% of
  values (the two renders agree to f32 rounding, which can move a truncated
  level).
- `tools/export.py`: the .ply, .splat and point-cloud files byte-equal to
  JAX's for the same state; `read_gaussian_ply` gives the parameters back
  exactly.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu import configs as jconfigs
from mtgs_tpu.eval import pipeline as jpipe
from mtgs_tpu.models import gaussians as jg
from mtgs_tpu.models import scene_graph as jsg
from mtgs_tpu.tools import export as jexport
from mtgs_tpu.train import trainer as jtr
from mtgs_torch import configs as tconfigs
from mtgs_torch.data import image_io
from mtgs_torch.eval import pipeline as tpipe
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.tools import export as texport
from mtgs_torch.train import trainer as ttr

W = H = 32
N_TRAVELS, N_FRAMES = 2, 2


def _logit(p):
    return np.log(p / (1.0 - p)).astype(np.float32)


def small_scene(seed=0):
    """A JAX scene and its port: (jax (params, aux, cfg), torch (params,
    aux, cfg), views as numpy dicts with a ground truth near the render)."""
    rng = np.random.default_rng(seed)
    n = 300
    xyz = np.stack([rng.uniform(3, 12, n), rng.uniform(-4, 4, n),
                    rng.uniform(-2, 2, n)], -1).astype(np.float32)
    bg, bg_aux = jg.init_node_from_points(xyz, rng.uniform(0, 255, (n, 3)), capacity=512,
                                          num_traversals=N_TRAVELS, multi_feature_rest=True,
                                          seed=seed)
    bg = bg.replace(
        opacities=jnp.asarray(_logit(rng.uniform(0.2, 0.95, (512, 1)))),
        features_rest=jnp.asarray(0.3 * rng.normal(size=bg.features_rest.shape), jnp.float32),
        features_adapters=jnp.asarray(0.3 * rng.normal(size=bg.features_adapters.shape),
                                      jnp.float32))
    params, aux = jsg.init_scene((bg, bg_aux), num_cameras=2, num_images=4)
    p_sd = jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))
    a_sd = jax.tree.map(np.asarray, flax.serialization.to_state_dict(aux))
    t_params, t_aux = scene_from_state_dict(p_sd, a_sd, device="cpu")
    jcfg = jconfigs.mtgs_config(W, H).replace(backend="xla", max_intersections=1 << 12)
    tcfg = tconfigs.mtgs_config(W, H).replace(max_intersections=1 << 12)

    R = np.array([[0, 0, -1], [-1, 0, 0], [0, 1, 0]], np.float32)  # looking along +x
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    views = []
    for i in range(N_TRAVELS * N_FRAMES):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R
        c2w[:3, 3] = [rng.uniform(-1, 0.5), rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3)]
        mask = np.ones((H, W, 1), np.float32)
        mask[:4] = 0.0
        v = dict(image=np.zeros((H, W, 3), np.float32), mask=mask, c2w=c2w, K=K,
                 cam_idx=i % 2, image_idx=i, travel_index=i // N_FRAMES, frame_idx=i,
                 timestamp=np.float32(i / 3.0))
        out = ttr.render_view(t_params, t_aux, tcfg, ttr.Batch(**v), 10**9, device="cpu")
        noise = 0.03 * rng.normal(size=(H, W, 3))
        v["image"] = np.clip(0.85 * out["rgb"].numpy() + 0.08 + noise, 0, 1).astype(np.float32)
        views.append(v)
    return dict(jax=(params, aux, jcfg), torch=(t_params, t_aux, tcfg), views=views)


def jax_batches(views):
    return [jtr.Batch(**{k: jnp.asarray(a) for k, a in v.items()}) for v in views]


def torch_batches(views):
    return [ttr.Batch(**v) for v in views]


@pytest.fixture(scope="module")
def scene():
    return small_scene()


def _relative(paths, root):
    return [os.path.relpath(p, root) for p in paths]


def _assert_renders_close(got_path, want_path):
    got = image_io.read_image(got_path).astype(np.int16)
    want = image_io.read_image(want_path).astype(np.int16)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1).mean() >= 0.999, np.abs(got - want).max()


def test_export_eval_images_matches_jax(scene, tmp_path):
    params, aux, jcfg = scene["jax"]
    t_params, t_aux, tcfg = scene["torch"]
    views = scene["views"]
    raw = tmp_path / "raw.jpg"
    raw.write_bytes(b"raw")
    metas = [dict(raw_path=str(raw)), dict(travel_id=7, cam_name="CAM_F0", view_idx=11), None,
             {}]
    want = jpipe.export_eval_images(params, aux, jcfg, jax_batches(views), tmp_path / "j",
                                    mode="sequential_with_gt", view_metas=metas)
    got = tpipe.export_eval_images(t_params, t_aux, tcfg, torch_batches(views), tmp_path / "t",
                                   mode="sequential_with_gt", view_metas=metas, device="cpu")
    assert _relative(got, tmp_path / "t") == _relative(want, tmp_path / "j")
    assert "traversal_7/CAM_F0/11_rendered.jpg" in _relative(got, tmp_path / "t")
    for g, w in zip(got, want):
        if g.endswith("_gt.jpg"):
            assert os.readlink(g) == os.readlink(w) == str(raw.resolve())
        elif g.endswith("_gt_processed.jpg"):
            assert open(g, "rb").read() == open(w, "rb").read()
        else:
            _assert_renders_close(g, w)
    # again into the same folder: the symlink is replaced
    again = tpipe.export_eval_images(t_params, t_aux, tcfg, torch_batches(views[:1]),
                                     tmp_path / "t", mode="sequential_with_gt",
                                     view_metas=metas[:1], device="cpu")
    assert os.readlink(again[-1]) == str(raw.resolve())
    seq = tpipe.export_eval_images(t_params, t_aux, tcfg, torch_batches(views), tmp_path / "s",
                                   view_metas=metas, device="cpu")
    assert _relative(seq, tmp_path / "s") == [r for r in _relative(got, tmp_path / "t")
                                              if r.endswith("_rendered.jpg")]


def test_export_nuplan_mode_matches_jax(scene, tmp_path):
    """The nuplan mode re-distorts the uint8 render onto a larger raw camera
    (raw_hw is (height, width)) and writes {rel_path}."""
    params, aux, jcfg = scene["jax"]
    t_params, t_aux, tcfg = scene["torch"]
    views = scene["views"]
    K_raw = np.array([[34.0, 0, 20], [0, 34.0, 17], [0, 0, 1]], np.float32)
    metas = [dict(rel_path=f"log/CAM_F0/tok{i}.jpg", K_raw=K_raw, K_und=v["K"],
                  dist=np.array([0.03, -0.01, 0.001, 0.0, 0.002], np.float32), raw_hw=(34, 40))
             for i, v in enumerate(views)]
    metas[3] = dict(metas[3], rel_path=None)
    del metas[3]["rel_path"], metas[3]["raw_hw"]  # the default path, the render's size
    want = jpipe.export_eval_images(params, aux, jcfg, jax_batches(views), tmp_path / "j",
                                    mode="nuplan", view_metas=metas)
    got = tpipe.export_eval_images(t_params, t_aux, tcfg, torch_batches(views), tmp_path / "t",
                                   mode="nuplan", view_metas=metas, device="cpu")
    rel = _relative(got, tmp_path / "t")
    assert rel == _relative(want, tmp_path / "j")
    assert rel[0] == "log/CAM_F0/tok0.jpg" and rel[3] == "log/cam1/3.jpg"
    for g, w in zip(got, want):
        _assert_renders_close(g, w)
    assert image_io.read_image(got[0]).shape == (34, 40, 3)
    assert image_io.read_image(got[3]).shape == (H, W, 3)


def test_export_modes_raise(scene, tmp_path):
    t_params, t_aux, tcfg = scene["torch"]
    batches = torch_batches(scene["views"][:1])
    with pytest.raises(ValueError, match="K_raw"):
        tpipe.export_eval_images(t_params, t_aux, tcfg, batches, tmp_path, mode="nuplan",
                                 view_metas=[dict(dist=np.zeros(4))], device="cpu")
    with pytest.raises(ValueError, match="image_saving_mode"):
        tpipe.export_eval_images(t_params, t_aux, tcfg, batches, tmp_path, mode="video",
                                 device="cpu")
    assert not list(tmp_path.rglob("*.jpg"))


@pytest.fixture(scope="module")
def nodes():
    """JAX nodes and their ports: a multicolour node with per-traversal rest,
    a mono node with isotropic scales; both padded past their live rows."""
    rng = np.random.default_rng(4)
    out = []
    for kw in (dict(num_traversals=2, multi_feature_rest=True), dict(isotropic=True)):
        n = 50
        node, node_aux = jg.init_node_from_points(
            rng.normal(size=(n, 3)).astype(np.float32) * 5, rng.uniform(0, 255, (n, 3)),
            capacity=n + 14, seed=1, **kw)
        node = node.replace(
            opacities=jnp.asarray(rng.normal(size=node.opacities.shape) * 3, jnp.float32),
            features_dc=jnp.asarray(rng.normal(size=node.features_dc.shape) * 2, jnp.float32),
            features_rest=jnp.asarray(rng.normal(size=node.features_rest.shape), jnp.float32),
            features_adapters=jnp.asarray(rng.normal(size=node.features_adapters.shape),
                                          jnp.float32),
            scales=jnp.asarray(rng.normal(size=node.scales.shape) - 2, jnp.float32))
        params, aux = jsg.init_scene((node, node_aux))
        p_sd = jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))
        a_sd = jax.tree.map(np.asarray, flax.serialization.to_state_dict(aux))
        t_params, t_aux = scene_from_state_dict(p_sd, a_sd, device="cpu")
        out.append(((node, node_aux), (t_params.background, t_aux.background)))
    return out


@pytest.mark.parametrize("fmt", ["ply", "splat", "point_cloud"])
@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("travel_index", [None, 1])
def test_gaussian_exports_byte_equal_to_jax(nodes, tmp_path, fmt, which, travel_index):
    (jnode, jaux), (tnode, taux) = nodes[which]
    kw = dict(travel_index=travel_index)
    want = getattr(jexport, f"export_{fmt}")(jnode, jaux, tmp_path / f"j.{fmt}", **kw)
    got = getattr(texport, f"export_{fmt}")(tnode, taux, tmp_path / f"t.{fmt}", **kw)
    data = got.read_bytes()
    assert data == want.read_bytes()
    if fmt == "splat":
        assert len(data) == 32 * int(taux.num_alive)


@pytest.mark.parametrize("which", [0, 1])
def test_read_gaussian_ply_gives_the_parameters_back(nodes, tmp_path, which):
    _, (tnode, taux) = nodes[which]
    n = int(taux.num_alive)
    path = texport.export_ply(tnode, taux, tmp_path / "g.ply", travel_index=1)
    back = texport.read_gaussian_ply(path)
    assert back.keys() == jexport.read_gaussian_ply(path).keys()
    for k, v in jexport.read_gaussian_ply(path).items():
        assert np.array_equal(back[k], v), k
    scales = tnode.scales[:n].numpy()
    np.testing.assert_array_equal(back["means"], tnode.means[:n].numpy())
    np.testing.assert_array_equal(back["scales"], np.broadcast_to(scales, (n, 3)))
    np.testing.assert_array_equal(back["quats"], tnode.quats[:n].numpy())
    np.testing.assert_array_equal(back["opacities"], tnode.opacities[:n].numpy())
    dc = tnode.features_dc[:n].numpy()
    if tnode.features_adapters.shape[1]:
        dc = dc + tnode.features_adapters[:n, 1].numpy()
    np.testing.assert_array_equal(back["features_dc"], dc)
    rest = tnode.features_rest[:n]
    rest = rest[:, 1] if rest.ndim == 4 else rest
    np.testing.assert_array_equal(back["features_rest"], rest.numpy())
    with pytest.raises(ValueError, match="not a ply"):
        texport.read_gaussian_ply(image_io.write_jpeg(tmp_path / "x.jpg",
                                                      np.zeros((8, 8, 3), np.uint8)))
