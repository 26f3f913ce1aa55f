"""Checkpoints of mtgs_torch: the round trip, partial loads, rotation,
`pad_scene_to_caps` against the JAX package's, and resume continuity.

Exactness: a save/load round trip and a resumed run are `torch.equal`
to the saved state and to an uninterrupted run (the CPU runs each step's
reductions in the same order every time, and nothing in the window is
random: no refine falls inside it, and a rebuilt Trainer starts its
refine key chain anew from its seed, as JAX's does). `pad_scene_to_caps` is held exactly
equal to JAX's on the same numpy scene.
"""

import dataclasses
import itertools

import flax
import jax
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.data import synthetic as js
from mtgs_tpu.train import checkpoint as jckpt
from mtgs_torch import configs
from mtgs_torch.data import synthetic as ts
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.tools.campaign import node_caps
from mtgs_torch.train import checkpoint as ckpt
from mtgs_torch.train import control as ctrl
from mtgs_torch.train.optim import named_leaves
from mtgs_torch.train.trainer import Trainer

W, H = 48, 32


@pytest.fixture(scope="module")
def scene():
    return ts.make_synthetic_scene(seed=1, width=W, height=H, n_travels=2, n_frames=2,
                                   n_bg=300, n_instance=40, n_seed=200,
                                   gt_max_intersections=1 << 13, device="cpu")


@pytest.fixture(scope="module")
def batches(scene):
    it = ts.batch_iterator(scene, seed=0, device="cpu")
    return [next(it) for _ in range(3)]


def _model(scene, **kw):
    return ts.build_scene_model(scene, with_skybox=True, skybox_points=64, device="cpu", **kw)


def _cfg(**control):
    cfg = configs.method_config("mtgs", width=W, height=H, max_steps=100)
    return cfg.replace(max_intersections=1 << 14,
                       control=dataclasses.replace(cfg.control, **control))


def _trainer(scene, data, cfg=None, **kw):
    params, aux = _model(scene, **kw)
    return Trainer(cfg or _cfg(), params, aux, data, device="cpu")


def _template(tr, optimizer=True):
    t = {"params": tr.state.params, "densify": tr.state.densify, "step": tr.state.step,
         "aux": tr.aux}
    if optimizer:
        t["opt_state"] = tr.state.adam
    return t


def _leaves(tree):
    """(name, leaf) of every tensor of a template-like dict of trees."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, torch.Tensor):
            out[key] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                out.update({f"{key}.{k}.{n}": x for n, x in named_leaves(v)})
        elif node is not None and not isinstance(node, int):
            out.update({f"{key}.{n}": x for n, x in named_leaves(node)})
    return out


def _assert_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w) and len(w) > 30
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("optimizer", [True, False])
def test_round_trip_is_exact(scene, batches, tmp_path, optimizer):
    tr = _trainer(scene, itertools.cycle(batches))
    tr.train(2)
    ckpt.save_checkpoint(tmp_path / "c", tr.state, tr.aux, keep_optimizer=optimizer)
    fresh = _trainer(scene, iter(batches))
    got = ckpt.load_checkpoint(tmp_path / "c", _template(fresh, optimizer))
    assert got["step"] == 2 and isinstance(got["step"], int)
    _assert_equal(got, _template(tr, optimizer))
    if not optimizer:  # a stripped checkpoint cannot restore an optimizer
        with pytest.raises(ValueError, match="keys"):
            ckpt.load_checkpoint(tmp_path / "c", _template(fresh, True))


def test_partial_load_restores_params_and_aux_only(scene, batches, tmp_path):
    tr = _trainer(scene, itertools.cycle(batches))
    tr.train(1)
    ckpt.save_checkpoint(tmp_path / "c", tr.state, tr.aux)
    fresh = _trainer(scene, iter(batches))
    got = ckpt.load_checkpoint_partial(tmp_path / "c", {"params": fresh.state.params,
                                                        "aux": fresh.aux})
    assert sorted(got) == ["aux", "params"]
    _assert_equal(got, {"params": tr.state.params, "aux": tr.aux})


def test_rotating_keeps_the_newest(scene, batches, tmp_path):
    tr = _trainer(scene, iter(batches))
    for step in (5, 10, 15, 20):
        path = ckpt.save_checkpoint_rotating(tmp_path, tr.state, tr.aux, step, keep=2)
        assert path == tmp_path / f"step-{step:09d}" and ckpt.payload_path(path).exists()
    assert sorted(p.name for p in tmp_path.glob("step-*")) == ["step-000000015",
                                                               "step-000000020"]


def test_load_raises_on_a_template_of_another_capacity(scene, batches, tmp_path):
    tr = _trainer(scene, iter(batches))
    ckpt.save_checkpoint(tmp_path / "c", tr.state, tr.aux)
    caps = node_caps(tr.state.params)
    params, aux = ckpt.pad_scene_to_caps(*_model(scene), dict(
        caps, background=caps["background"] + 4096))
    bigger = Trainer(_cfg(), params, aux, iter(batches), device="cpu")
    with pytest.raises(ValueError, match="background"):
        ckpt.load_checkpoint(tmp_path / "c", _template(bigger))


def test_pad_scene_to_caps_matches_jax(scene):
    jscene = js.SyntheticScene(**{f.name: getattr(scene, f.name)
                                  for f in dataclasses.fields(ts.SyntheticScene)})
    jp, ja = js.build_scene_model(jscene, with_instances=True, with_skybox=True,
                                  skybox_points=64)
    sd = lambda tree: jax.tree.map(np.asarray, flax.serialization.to_state_dict(tree))
    caps = dict(background=jp.background.capacity + 4096,
                skybox=jp.skybox.capacity + 8192,
                instances=int(jp.instances.node.means.shape[1]) + 1024, deformables=None)
    want_p, want_a = scene_from_state_dict(*(sd(x) for x in jckpt.pad_scene_to_caps(
        jp, ja, caps)), device="cpu")
    got_p, got_a = ckpt.pad_scene_to_caps(*scene_from_state_dict(sd(jp), sd(ja),
                                                                 device="cpu"), caps)
    assert node_caps(got_p) == caps
    for got, want in ((got_p, want_p), (got_a, want_a)):
        g, w = dict(named_leaves(got)), dict(named_leaves(want))
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_resume_continues_bit_for_bit(scene, batches, tmp_path):
    """3 steps, save, a fresh Trainer loads and trains 2 more: equal to 5
    straight steps (no refine in the window: refine_every 100)."""
    straight = _trainer(scene, itertools.cycle(batches))
    straight.train(5)
    first = _trainer(scene, itertools.cycle(batches))
    first.train(3)
    ckpt.save_checkpoint(tmp_path / "c", first.state, first.aux)
    resumed = _trainer(scene, itertools.islice(itertools.cycle(batches), 3, None))
    got = ckpt.load_checkpoint(tmp_path / "c", _template(resumed))
    st = resumed.state
    st.params, st.densify, st.step, st.adam = (got["params"], got["densify"], got["step"],
                                               got["opt_state"])
    resumed.aux = got["aux"]
    resumed.train(2)
    assert straight.refine_events == resumed.refine_events == []
    assert resumed.state.step == 5
    _assert_equal(_template(resumed), _template(straight))


def test_resume_after_a_capacity_growth(scene, batches, tmp_path):
    """A run that grew its nodes pads a freshly built scene to the grown
    capacities, loads, and trains on."""
    cfg = _cfg(refine_every=2, densify_from_iter=0, densify_grad_thresh=1e-12)
    cfg = cfg.replace(grow_granule=256)
    first = _trainer(scene, itertools.cycle(batches), cfg, capacity=256)
    first.train(4)
    grown = {e["node"] for e in first.growth_events}
    assert "background" in grown, first.growth_events
    caps = node_caps(first.state.params)
    ckpt.save_checkpoint(tmp_path / "c", first.state, first.aux)

    fresh = _model(scene, capacity=256)
    with pytest.raises(ValueError):  # the built scene's capacities are the seed's
        ckpt.load_checkpoint(tmp_path / "c", _template(Trainer(
            cfg, *fresh, iter(batches), device="cpu")))
    resumed = Trainer(cfg, *ckpt.pad_scene_to_caps(*_model(scene, capacity=256), caps),
                      itertools.cycle(batches), device="cpu")
    got = ckpt.load_checkpoint(tmp_path / "c", _template(resumed))
    st = resumed.state
    st.params, st.densify, st.step, st.adam = (got["params"], got["densify"], got["step"],
                                               got["opt_state"])
    resumed.aux = got["aux"]
    assert node_caps(resumed.state.params) == caps
    _assert_equal(_template(resumed), _template(first))
    hist = resumed.train(2)
    assert resumed.state.step == 6
    assert all(bool(torch.isfinite(h["total_loss"])) and float(h["nonfinite_grad_step"]) == 0
               for h in hist)
    assert isinstance(resumed.state.densify["background"], ctrl.DensifyState)
