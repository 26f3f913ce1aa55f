"""`tools/train_scene.py` of mtgs_torch on a 96x64 road block written by
`tests/make_nuplan_fixture.py`: `build_model_from_parsed` against the JAX
package's (carried across with `scene_from_state_dict`), `main --device
cpu` training, resuming (from a full and from a stripped checkpoint) and
reloading through `eval_setup`, `render_interpolated`'s frames and poses
against JAX's, the importer of the reference's checkpoints against JAX's on
the fake checkpoints of tests/test_checkpoint.py, and the viewer over a
trained run (`viewer.server.viewer_from_run` and `main`)."""

import dataclasses
import json
import shutil

import flax
import jax
import numpy as np
import pytest
import torch

import make_nuplan_fixture as fixture
import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu import configs as jconfigs
from mtgs_tpu.data import dataset as jds
from mtgs_tpu.data import nuplan as jnuplan
from mtgs_tpu.tools import render as jrender
from mtgs_tpu.tools import train_scene as jtrain_scene
from mtgs_tpu.train import checkpoint as jckpt
from mtgs_torch import configs
from mtgs_torch.data import dataset as tds
from mtgs_torch.data import image_io, loader
from mtgs_torch.data import nuplan as tnuplan
from mtgs_torch.eval.pipeline import evaluate_scene
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.tools import render, train_scene
from mtgs_torch.train import checkpoint as ckpt
from mtgs_torch.viewer import server as viewer_server

W, H = 96, 64
RUN = ["--device", "cpu", "--width", str(W // 2), "--height", str(H // 2), "--scale", "0.5",
       "--travels", "0", "1", "--eval-travels", "2"]


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    root = tmp_path_factory.mktemp("road_block")
    b = fixture.make_block(moving_vehicle=True)
    fixture.write_images(root, b, W, H)
    fixture.write_runtime_files(root, b, W, H, n_seed=3000, n_vehicle=400, beams=16,
                                azimuths=256)
    return root


@pytest.fixture
def small_isect_buffer(monkeypatch):
    """The preset's 2^21-slot intersection buffer costs the CPU a 2M-key
    sort per view; these 48x32 views make a few hundred pairs."""
    preset = configs.method_config
    monkeypatch.setattr(configs, "method_config", lambda name, **kw: preset(name, **kw).replace(
        max_intersections=1 << 14))


def _sd(tree):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(tree))


def _node_equal(got, want, where):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f"{where}.{f.name}"
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where}.{f.name}"
        assert torch.equal(g, w), f"{where}.{f.name}"


@pytest.mark.parametrize("split", ["train", "val"])
def test_build_model_from_parsed_matches_jax(block, split):
    kw = dict(cameras=("CAM_F0",), split=split, train_travels=[0, 1], eval_travels=[2])
    tscene, jscene = tnuplan.parse_scene(block, **kw), jnuplan.parse_scene(block, **kw)
    cfg = configs.method_config("mtgs", width=W // 2, height=H // 2)
    jcfg = jconfigs.method_config("mtgs", width=W // 2, height=H // 2)
    got_p, got_a = train_scene.build_model_from_parsed(tscene, cfg, tds.SampleConfig(),
                                                       device="cpu")
    jp, ja = jtrain_scene.build_model_from_parsed(jscene, jcfg, jds.SampleConfig())
    want_p, want_a = scene_from_state_dict(_sd(jp), _sd(ja), device="cpu")

    _node_equal(got_p.background, want_p.background, "background")
    _node_equal(got_a.background, want_a.background, "aux.background")
    _node_equal(got_p.instances.node, want_p.instances.node, "instances.node")
    for k in ("quats", "trans"):
        assert torch.equal(getattr(got_p.instances, k), getattr(want_p.instances, k)), k
    for f in dataclasses.fields(want_a.instances):
        g, w = getattr(got_a.instances, f.name), getattr(want_a.instances, f.name)
        assert g.dtype == w.dtype and torch.equal(g, w), f"aux.instances.{f.name}"
    # no static instance in this block: the poses are the tracks' own; the
    # val split's rows are traversal 2's, where no train track is present
    assert not got_a.instances.is_static.any()
    assert bool(got_a.instances.present.any()) == (split == "train")
    assert got_p.appearance.shape == want_p.appearance.shape          # num_cameras
    assert got_p.camera_opt.shape == want_p.camera_opt.shape          # num_images
    # the skybox comes from each package's own generator: shape, capacity, radius
    gs, ws = got_p.skybox, want_p.skybox
    assert gs.means.shape == ws.means.shape and gs.capacity == ws.capacity
    n = int(got_a.skybox.num_alive)
    assert n == int(want_a.skybox.num_alive) == 100_000
    np.testing.assert_allclose(gs.means[:n].norm(dim=-1).max(), ws.means[:n].norm(dim=-1).max(),
                               rtol=1e-6)


@pytest.mark.parametrize("method", ["mtgs", "3dgs", "mtgs_deformable", "wild_gaussians"])
def test_method_presets_match_jax(method):
    """Every field of the port's preset that the JAX preset also has, the
    nested loss, control and scene configs included, is JAX's."""
    got = configs.method_config(method, width=960, height=540, max_steps=200)
    want = jconfigs.method_config(method, width=960, height=540, max_steps=200)

    def same(g, w, where):
        shared = {f.name for f in dataclasses.fields(g)} & {f.name for f in dataclasses.fields(w)}
        assert shared, where
        for name in shared:
            a, b = getattr(g, name), getattr(w, name)
            if dataclasses.is_dataclass(a):
                same(a, b, f"{where}.{name}")
            else:
                assert a == b, f"{where}.{name}: {a!r} != {b!r}"

    same(got, want, method)


def _eval_again(run_dir):
    """eval_setup of a run, then evaluate_scene over its val split."""
    params, aux, cfg, scene, rc = train_scene.eval_setup(run_dir, device="cpu")
    ev = tnuplan.parse_scene(rc["data"], split="val", train_travels=rc["travels"],
                             eval_travels=rc["eval_travels"], load_points=False)
    cache = loader.SampleCache(ev.records, tds.SampleConfig(scale_factor=rc["scale"]),
                               strategy="on_demand")
    batches = [loader.batch_from_sample(r, cache.get(i), device="cpu")
               for i, r in enumerate(ev.records)]
    return evaluate_scene(params, aux, cfg, batches, device="cpu"), params


def _close_to(result, again):
    for k, v in result.items():
        if k == "fps":
            continue
        if np.isnan(v):
            assert np.isnan(again[k]), k
        else:
            assert abs(again[k] - v) <= 1e-6, (k, again[k], v)


def test_main_trains_resumes_and_reloads(block, tmp_path, capsys, small_isect_buffer):
    """main for 2 steps (a checkpoint each step), then: a fresh --out
    holding only the step-1 checkpoint (with Adam's state) resumed to 3
    steps; the first run resumed from its stripped final checkpoint to 3
    steps; eval_setup + evaluate_scene repeat each run's eval_result.json."""
    out = tmp_path / "run"
    assert train_scene.main(["--data", str(block), "--out", str(out), "--steps", "2",
                             "--save-every", "1", *RUN]) == 0
    printed = capsys.readouterr().out
    assert "[     0]" in printed and "[     1]" in printed
    assert sorted(p.name for p in out.glob("step-*")) == ["step-000000001", "step-000000002"]
    result = json.loads((out / "eval_result.json").read_text())
    assert result["num_images"] == 2 and np.isfinite(result["psnr"])
    rc = json.loads((out / "run_config.json").read_text())
    assert rc["travels"] == [0, 1] and rc["eval_travels"] == [2] and rc["steps"] == 2
    layout = ckpt.checkpoint_layout(out / "step-000000002")
    assert not layout["has_optimizer"] and layout["step"] == 2
    assert ckpt.checkpoint_layout(out / "step-000000001")["has_optimizer"]
    again, params = _eval_again(out)
    _close_to(result, again)

    # resume with Adam's state: the step-1 checkpoint (2 steps done) alone
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    shutil.copytree(out / "step-000000001", fresh / "step-000000001")
    assert train_scene.main(["--data", str(block), "--out", str(fresh), "--steps", "3",
                             "--resume", *RUN]) == 0
    printed = capsys.readouterr().out
    assert "resumed from step-000000001 (step 2)" in printed
    assert "[     2]" in printed and "[     1]" not in printed  # one step trained
    restored = torch.load(ckpt.payload_path(fresh / "step-000000003"), weights_only=True)
    assert restored["step"] == 3 and "opt_state" not in restored
    _close_to(json.loads((fresh / "eval_result.json").read_text()), _eval_again(fresh)[0])

    # resume from the stripped final checkpoint: Adam restarts
    assert train_scene.main(["--data", str(block), "--out", str(out), "--steps", "3",
                             "--resume", *RUN]) == 0
    assert "resumed from step-000000002 (step 2)" in capsys.readouterr().out
    after, params3 = _eval_again(out)
    _close_to(json.loads((out / "eval_result.json").read_text()), after)
    assert not torch.equal(params3.background.means, params.background.means)


def test_main_trains_from_a_data_config(block, tmp_path, small_isect_buffer):
    """`--data-config` names the road block through a RoadBlockConfig (a
    YAML written by `save_yaml`, read back with the port's own reader; JAX's
    loader reads the same file to the same folder); `--data` wins over it."""
    from mtgs_tpu.preprocess import roadblock_config as jrb
    from mtgs_torch.preprocess.roadblock_config import RoadBlockConfig, save_yaml

    cfg = tmp_path / "road_block.yaml"
    save_yaml(RoadBlockConfig(road_block_name=block.name, data_root=str(block.parent),
                              road_block=(-10.0, -20.0, 120.0, 20.0)), cfg)
    assert jrb.load_road_block_config(cfg).scene_dir == block
    other = tmp_path / "elsewhere"
    assert train_scene.parse_args(["--data-config", str(cfg), "--out", "x"]).data == str(block)
    assert train_scene.parse_args(["--data", str(other), "--data-config", str(cfg),
                                   "--out", "x"]).data == str(other)
    out = tmp_path / "run"
    assert train_scene.main(["--data-config", str(cfg), "--out", str(out), "--steps", "1",
                             *RUN]) == 0
    rc = json.loads((out / "run_config.json").read_text())
    assert rc["data"] == str(block.absolute()) and rc["steps"] == 1
    result = json.loads((out / "eval_result.json").read_text())
    assert result["num_images"] == 2 and np.isfinite(result["psnr"])


def test_viewer_serves_a_trained_run(block, tmp_path, monkeypatch, small_isect_buffer):
    """`python -m mtgs_torch.viewer.server --run DIR` on a 1-step run: the
    scene eval_setup reloads, every traversal with its first frame, the
    start camera 2 m above the seed cloud's median, every dataset camera as
    a frustum with its split; frames render at both rungs; without a card
    it raises before it serves."""
    out = tmp_path / "run"
    assert train_scene.main(["--data", str(block), "--out", str(out), "--steps", "1",
                             *RUN]) == 0
    served = []
    monkeypatch.setattr(viewer_server.ViewerServer, "serve",
                        lambda self, port=7007, host="0.0.0.0": served.append((self, port)))
    viewer_server.main(["--run", str(out), "--port", "0", "--device", "cpu"])
    (srv, port), = served
    assert port == 0
    params, _, cfg, scene, _ = train_scene.eval_setup(out, device="cpu")
    assert torch.equal(srv.params.background.means, params.background.means)
    assert srv.cfg == cfg and srv.device.type == "cpu"
    recs = scene.records
    assert srv.travels == sorted({r.travel_index for r in recs}) == [0, 1]
    first = {}
    for r in recs:
        first.setdefault(r.travel_index, r.frame_idx)
    assert srv.frame_of_travel == first
    center = np.median(scene.seed_xyz, axis=0)
    assert srv.init_pos == pytest.approx([center[0], center[1], center[2] + 2.0])
    assert len(srv.cameras) == len(recs)
    assert [c["split"] for c in srv.cameras] == [
        "train" if r.travel_id in scene.train_travel_ids else "eval" for r in recs]
    np.testing.assert_allclose(np.reshape(srv.cameras[0]["c2w"], (3, 4)), recs[0].c2w[:3])
    for lowres, shape in (("0", (cfg.height, cfg.width, 3)),
                          ("1", (cfg.height // 4, cfg.width // 4, 3))):
        jpeg = srv.render(dict(travel="1", lowres=lowres, output="depth"))
        (tmp_path / "f.jpg").write_bytes(jpeg)
        assert image_io.read_image(tmp_path / "f.jpg").shape == shape
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        viewer_server.main(["--run", str(out)])
    assert len(served) == 1


def test_main_raises_without_a_card(block, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_scene.main(["--data", str(block), "--out", str(tmp_path / "x"), "--steps", "1"])
    assert not (tmp_path / "x").exists()
    with pytest.raises(SystemExit):  # neither --data nor --data-config
        train_scene.parse_args(["--out", str(tmp_path)])


def test_render_interpolated_frames_and_poses_match_jax(block, tmp_path, monkeypatch):
    """The frames `render_interpolated` renders for a traversal: their
    count, poses, intrinsics, times and frame rows, against JAX's (the
    render itself is stubbed out on both sides)."""
    kw = dict(cameras=("CAM_F0",), train_travels=[0, 1])
    tscene, jscene = tnuplan.parse_scene(block, **kw), jnuplan.parse_scene(block, **kw)
    seen = {"torch": [], "jax": []}

    def t_stub(params, aux, cfg, batch, step, **k):
        seen["torch"].append((np.asarray(batch.c2w), np.asarray(batch.K),
                              np.float32(batch.timestamp), int(batch.frame_idx)))
        assert cfg.scene.interp_poses
        return {"rgb_appearance": torch.zeros((cfg.height, cfg.width, 3))}

    def j_stub(params, aux, cfg, batch, step, **k):
        seen["jax"].append((np.asarray(batch.c2w), np.asarray(batch.K),
                            np.float32(batch.timestamp), int(batch.frame_idx)))
        return {"rgb_appearance": jax.numpy.zeros((cfg.height, cfg.width, 3))}

    monkeypatch.setattr(render, "render_view", t_stub)
    monkeypatch.setattr(jrender, "render_view", j_stub)
    monkeypatch.setattr(jax, "jit", lambda f: f)  # JAX's stubbed render, run eagerly
    cfg = configs.method_config("mtgs", width=48, height=32)
    jcfg = jconfigs.method_config("mtgs", width=48, height=32)
    got = render.render_interpolated(None, None, cfg, tscene, 1, tmp_path / "t",
                                     cameras=("CAM_F0",), target_hz=6.0, make_video=False,
                                     device="cpu")
    want = jrender.render_interpolated(None, None, jcfg, jscene, 1, tmp_path / "j",
                                       cameras=("CAM_F0",), target_hz=6.0, make_video=False)
    assert len(got) == len(want) == len(seen["torch"]) == len(seen["jax"]) == 10
    for (c, k, ts, row), (jc, jk, jts, jrow) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_allclose(c, jc, atol=1e-6)
        np.testing.assert_array_equal(k, jk)
        assert ts == jts and row == jrow
    assert image_io.read_image(got[0]).shape == (32, 48, 3)


# ----------------------------------------------------- reference checkpoints

def _reference_checkpoint(path, *, seed=1, T=2, K=16, fourier=4):
    """The reference-schema checkpoint of tests/test_checkpoint.py: a
    multicolour background and skybox, two rigid instances (one with
    Fourier dc, one parked off-frame at frame 2), exposure and pose deltas."""
    rng = np.random.default_rng(seed)

    def gp(prefix, n, *, multicolor=False, fdim=0):
        d = {
            f"{prefix}.means": rng.normal(0, 3, (n, 3)),
            f"{prefix}.scales": rng.normal(-2.0, 0.3, (n, 3)),
            f"{prefix}.quats": rng.normal(size=(n, 4)),
            f"{prefix}.features_dc": (rng.normal(0, 0.3, (n, fdim, 3)) if fdim
                                      else rng.normal(0, 0.3, (n, 3))),
            f"{prefix}.features_rest": rng.normal(0, 0.01, (n, K - 1, 3)),
            f"{prefix}.opacities": rng.normal(2.0, 0.5, (n, 1)),
        }
        if multicolor:
            d[f"{prefix}.features_adapters"] = rng.normal(0, 0.1, (n, T, 3))
        return d

    state = {}
    state.update(gp("_model.gaussian_models.background.gauss_params", 500, multicolor=True))
    state.update(gp("_model.gaussian_models.skybox.gauss_params", 200, multicolor=True))
    state.update(gp("_model.gaussian_models.vehicle-a.gauss_params", 60))
    state.update(gp("_model.gaussian_models.vehicle-b.gauss_params", 40, fdim=fourier))
    for name in ("vehicle-a", "vehicle-b"):
        q = rng.normal(size=(3, 4))
        t = rng.normal(0, 2, (3, 3))
        if name == "vehicle-b":
            t[2, 2] = 1e5
        state[f"_model.gaussian_models.{name}.instance_quats"] = q
        state[f"_model.gaussian_models.{name}.instance_trans"] = t
    state["_model.appearance_model.exposure_params"] = np.tile(
        np.eye(3, 4, dtype=np.float32), (8, 1, 1))
    state["_model.camera_optimizer.pose_adjustment"] = rng.normal(0, 0.01, (6, 6))
    state = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in state.items()}
    torch.save({"pipeline": state, "step": 30000}, path)
    return path


def _minimal_reference_checkpoint(path, n=100, T=2, K=16):
    """tests/test_checkpoint.py's first checkpoint: a multicolour
    background, a vehicle with means and poses only, pose deltas."""
    rng = np.random.default_rng(0)
    f32 = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32))
    bg = "_model.gaussian_models.background.gauss_params."
    state = {bg + "means": f32(n, 3), bg + "scales": f32(n, 3), bg + "quats": f32(n, 4),
             bg + "features_dc": f32(n, 3), bg + "features_rest": f32(n, T, K - 1, 3),
             bg + "opacities": f32(n, 1), bg + "features_adapters": f32(n, T, 3),
             "_model.gaussian_models.vehicle-abc.gauss_params.means": f32(20, 3),
             "_model.gaussian_models.vehicle-abc.instance_quats": f32(5, 4),
             "_model.gaussian_models.vehicle-abc.instance_trans": f32(5, 3),
             "_model.camera_optimizer.pose_adjustment": f32(8, 6)}
    torch.save({"pipeline": state, "step": 10000}, path)
    return path


@pytest.mark.parametrize("make", [_minimal_reference_checkpoint, _reference_checkpoint])
def test_reference_checkpoint_import_matches_jax(tmp_path, make):
    path = make(tmp_path / "step.ckpt")
    got, want = ckpt.import_torch_checkpoint(path), jckpt.import_torch_checkpoint(path)
    assert got["step"] == want["step"] in (10000, 30000)
    assert got.keys() == want.keys() and got["nodes"].keys() == want["nodes"].keys()
    for name, node in want["nodes"].items():
        assert got["nodes"][name].keys() == node.keys()
        for k, v in node.items():
            np.testing.assert_array_equal(got["nodes"][name][k], v)
    for k in ("appearance", "camera_opt"):
        assert (k in got) == (k in want)
        if k in want:
            np.testing.assert_array_equal(got[k], want[k])
    p, a = ckpt.node_from_torch_params(got["nodes"]["background"], device="cpu")
    jp, ja = jckpt.node_from_torch_params(want["nodes"]["background"])
    wp, wa = scene_from_state_dict(
        {"background": _sd(jp), "appearance": np.zeros((1, 3, 4), np.float32),
         "camera_opt": np.zeros((1, 6), np.float32)}, {"background": _sd(ja)}, device="cpu")
    _node_equal(p, wp.background, "background")
    _node_equal(a, wa.background, "aux.background")


def test_scene_from_reference_checkpoint_matches_jax(tmp_path):
    path = _reference_checkpoint(tmp_path / "step-000030000.ckpt")
    got_p, got_a, step = ckpt.scene_from_torch_checkpoint(path, device="cpu")
    jp, ja, jstep = jckpt.scene_from_torch_checkpoint(path)
    want_p, want_a = scene_from_state_dict(_sd(jp), _sd(ja), device="cpu")
    assert step == jstep == 30000
    for name in ("background", "skybox"):
        _node_equal(getattr(got_p, name), getattr(want_p, name), name)
        _node_equal(getattr(got_a, name), getattr(want_a, name), f"aux.{name}")
    _node_equal(got_p.instances.node, want_p.instances.node, "instances.node")
    assert got_p.instances.node.fourier  # lifted to a common F_dim
    for k in ("quats", "trans"):
        assert torch.equal(getattr(got_p.instances, k), getattr(want_p.instances, k)), k
    for f in dataclasses.fields(want_a.instances):
        g, w = getattr(got_a.instances, f.name), getattr(want_a.instances, f.name)
        assert g.dtype == w.dtype, f.name
        torch.testing.assert_close(g, w, rtol=0, atol=1e-7, msg=f.name)
    assert float(got_a.instances.present[1, 2]) == 0.0
    for k in ("appearance", "camera_opt"):
        assert torch.equal(getattr(got_p, k), getattr(want_p, k)), k
