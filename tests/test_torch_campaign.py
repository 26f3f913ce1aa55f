"""The training campaign of mtgs_torch: the ladder's schedule and batches
against the JAX package's (exact), the Trainer's resolution ladder (the
port of tests/test_train_e2e.py's ladder test, plus a stage that starts
after an intersection-buffer growth), `tools/campaign.py::main` end to end
on the CPU at a tiny size with its resume, and the scene cache read
across the two packages."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.data import synthetic as js
from mtgs_tpu.tools import campaign as jcampaign
from mtgs_torch.data import synthetic as ts
from mtgs_torch.tools import campaign
from mtgs_torch.train import control as ctrl
from mtgs_torch.train.trainer import Trainer, TrainerConfig

TINY = ["--device", "cpu", "--steps", "40", "--save-every", "10", "--width", "64",
        "--height", "48", "--n-bg", "600", "--n-seed", "300", "--n-instance", "60",
        "--skybox-points", "64", "--n-travels", "2", "--n-frames", "4", "--extent", "12",
        "--max-isect", "16384", "--gt-max-isect", "65536", "--log-every", "1000"]


def _hand_scene(seed=0, T=2, F=2, H=48, W=64):
    """A SyntheticScene with random numpy contents (no render)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.random(s, dtype=np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (T, F, 1, 1))
    c2ws[..., :3, 3] = f32(T, F, 3)
    return ts.SyntheticScene(
        width=W, height=H, n_travels=T, n_frames=F, images=f32(T, F, H, W, 3),
        depths=f32(T, F, H, W, 1) * (f32(T, F, H, W, 1) > 0.3),
        masks=np.ones((T, F, H, W, 1), np.float32), c2ws=c2ws,
        K=np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32),
        timestamps=f32(T, F), seed_xyz=f32(30, 3), seed_rgb=255 * f32(30, 3),
        instance_xyz=f32(8, 3), instance_rgb=255 * f32(8, 3),
        instance_quats=f32(T * F, 4), instance_trans=f32(T * F, 3),
        instance_present=np.ones(T * F, np.float32),
        instance_size=np.array([4.0, 2.0, 1.5], np.float32))


@pytest.mark.parametrize("steps", [1, 2, 3, 10, 40, 600, 10001])
def test_stages_match_jax(steps):
    assert campaign._stages_for(steps) == jcampaign._stages_for(steps)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25])
def test_make_batch_matches_jax(scale):
    scene = _hand_scene()
    for t, f in ((0, 1), (1, 0)):
        got = campaign.make_batch(scene, t, f, scale, device="cpu")
        want = jcampaign.make_batch(scene, t, f, scale)
        for name in ("image", "lidar_depth", "pseudo_depth", "K", "c2w", "mask"):
            a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert a.shape == b.shape and np.array_equal(a, b), name
        assert got.image.shape[:2] == (int(48 * scale), int(64 * scale))
        assert (got.travel_index, got.frame_idx, got.image_idx, got.cam_idx) == (
            int(want.travel_index), int(want.frame_idx), int(want.image_idx),
            int(want.cam_idx))
        assert got.timestamp == float(want.timestamp)


def _stage_log(monkeypatch):
    """Records (step, scale, width, height, max_intersections, base
    max_intersections) at every ladder stage switch."""
    log = []
    saved = Trainer._set_resolution_stage

    def record(self, scale):
        saved(self, scale)
        log.append((self.state.step, scale, self.cfg.width, self.cfg.height,
                    self.cfg.max_intersections, self._base_cfg.max_intersections))

    monkeypatch.setattr(Trainer, "_set_resolution_stage", record)
    return log


def _rule(base, scale):
    return ((max(int(base * scale * scale), 1 << 14) + 511) // 512) * 512


def _ladder_scenes():
    scenes = {}

    def scene_at(s):
        if s not in scenes:
            scenes[s] = ts.make_synthetic_scene(
                seed=0, width=int(64 * s), height=int(64 * s), n_travels=1, n_frames=2,
                n_bg=300, n_instance=0, device="cpu")
        return scenes[s]

    return scene_at


def test_resolution_ladder_stage_switch(monkeypatch):
    log = _stage_log(monkeypatch)
    scene_at = _ladder_scenes()
    params, aux = ts.build_scene_model(scene_at(1.0), with_instances=False, device="cpu")
    cfg = TrainerConfig(width=64, height=64, max_intersections=1 << 16, max_steps=60,
                        predict_normals=False,
                        control=ctrl.ControlConfig(densify_from_iter=10**9))
    seen = []

    def factory(scale):
        seen.append(scale)
        return ts.batch_iterator(scene_at(scale), device="cpu")

    trainer = Trainer(cfg, params, aux, data_factory=factory,
                      resolution_stages=[(8, 1.0), (0, 0.5)], device="cpu")
    assert trainer.resolution_stages == [(0, 0.5), (8, 1.0)]
    hist = trainer.train(12, log_every=1000)
    assert seen == [0.5, 1.0]
    assert log == [(0, 0.5, 32, 32, 16384, 1 << 16), (8, 1.0, 64, 64, 1 << 16, 1 << 16)]
    assert trainer.cfg.width == 64 and trainer._cur_scale == 1.0
    losses = [float(h["total_loss"]) for h in hist]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert trainer.loop_stats["steps"] == 12
    assert all(trainer.loop_stats[k] > 0 for k in ("dispatch_s", "refine_s"))
    with pytest.raises(ValueError, match="data_factory"):
        Trainer(cfg, params, aux, resolution_stages=[(0, 0.5)], device="cpu")
    with pytest.raises(ValueError, match="need `data`"):
        Trainer(cfg, params, aux, device="cpu")


def test_ladder_stage_after_growth_starts_from_the_grown_base(monkeypatch):
    """The intersection buffer grows at the refines of the half-resolution
    stage (isect_grow_frac 1e-6: any count passes it); the full-resolution
    stage then starts from the base grown by the same factor."""
    log = _stage_log(monkeypatch)
    scene_at = _ladder_scenes()
    params, aux = ts.build_scene_model(scene_at(1.0), with_instances=False, device="cpu")
    cfg = TrainerConfig(width=64, height=64, max_intersections=1 << 16, max_steps=60,
                        predict_normals=False, isect_grow_frac=1e-6,
                        control=ctrl.ControlConfig(densify_from_iter=0, refine_every=2))
    trainer = Trainer(cfg, params, aux, device="cpu",
                      data_factory=lambda s: ts.batch_iterator(scene_at(s), device="cpu"),
                      resolution_stages=[(0, 0.5), (4, 1.0)])
    trainer.train(6, log_every=1000)
    grow = [e for e in trainer.growth_events if e["node"] == "max_intersections"]
    assert [e["step"] for e in grow] == [2, 4, 6]
    base = 1 << 16
    for step, scale, w, h, isect, stage_base in log:
        n_grown = sum(e["step"] <= step for e in grow)
        assert stage_base == int(base * 1.5 ** n_grown)
        assert isect == _rule(stage_base, scale) and (w, h) == (64 * scale, 64 * scale)
    assert [(s, n) for s, _, _, _, _, n in log] == [(0, 1 << 16), (4, 147456)]
    assert log[1][4] == 147456 > 1 << 16
    assert trainer.cfg.max_intersections == _rule(147456 * 1.5, 1.0)


def test_main_end_to_end_and_resume(tmp_path, capsys):
    out = tmp_path / "run"
    assert campaign.main(["--out", str(out)] + TINY) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["metric"].startswith("40-step") and np.isfinite(first["value"])
    assert (out / "RESUME_DEMO_DONE").read_text() == "20"
    assert sorted(p.name for p in out.glob("step-*")) == ["step-000000030", "step-000000040"]
    assert (out / "final-step-000000040").exists()
    result = json.loads((out / "eval_result.json").read_text())
    for key in ("psnr", "cc_psnr", "ssim", "depth_absRel", "depth_delta1"):
        for t in ("", "trv0_", "trv1_"):  # seen traversal 0, unseen 1
            assert np.isfinite(result[t + key]), t + key
    assert result["num_images"] == 5
    assert sorted(p.name for p in (out / "preview").glob("*.png")) == ["trv0_f2.png",
                                                                       "trv1_f3.png"]
    summary = json.loads((out / "campaign_summary.json").read_text())
    assert summary["steps"] == 40 and summary["resume_demo"] is True
    assert summary["seed_alive"] == 300 and [leg["to_step"] for leg in summary["legs"]] == [
        10, 20, 30, 40]
    assert json.loads((out / "resume_meta.json").read_text())["seed_alive"] == 300

    # a second run on the same --out resumes from the latest step, not from 0
    assert campaign.main(["--out", str(out)] + TINY) == 0
    capsys.readouterr()
    again = json.loads((out / "campaign_summary.json").read_text())
    assert again["steps"] == 40 and again["legs"] == [] and again["seed_alive"] == 300
    assert "resumed from step 40" in (out / "campaign.log").read_text()
    result2 = json.loads((out / "eval_result.json").read_text())
    assert {k: v for k, v in result2.items() if k != "fps"} == {
        k: v for k, v in result.items() if k != "fps"}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_scene_cache_reads_across_packages(tmp_path, writer):
    scene = _hand_scene(seed=3)
    path = tmp_path / "scene_cache.npz"
    jscene = js.SyntheticScene(**{f.name: getattr(scene, f.name)
                                  for f in dataclasses.fields(ts.SyntheticScene)})
    (jcampaign if writer == "jax" else campaign)._scene_cache_roundtrip(
        path, lambda: jscene if writer == "jax" else scene)

    def no_build():
        raise AssertionError("the cache was not read")

    reader = campaign if writer == "jax" else jcampaign
    got = reader._scene_cache_roundtrip(path, no_build)
    for f in dataclasses.fields(ts.SyntheticScene):
        a, b = getattr(got, f.name), getattr(scene, f.name)
        assert np.array_equal(a, b) and type(a) is type(b), f.name
    assert isinstance(got.width, int) and got.frame_row(1, 1) == 3
    assert torch.as_tensor(got.images).dtype == torch.float32
