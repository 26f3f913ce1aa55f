"""mtgs_torch stands alone: it imports neither JAX, flax, mtgs_tpu, PIL nor PyYAML,
builds its image decoders from its own source, and its entry points never
fall back to the CPU on their own."""

import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mtgs_torch
from mtgs_torch import configs
from mtgs_torch.eval import pipeline
from mtgs_torch.models.appearance import init_exposure
from mtgs_torch.models.gaussians import init_node_from_points, init_skybox_node
from mtgs_torch.models.scene_graph import init_scene
from mtgs_torch.data import synthetic
from mtgs_torch.parallel.data_parallel import DPTrainer, make_dp_train_step
from mtgs_torch.parallel.mesh import Mesh
from mtgs_torch.parallel.mesh2d import make_2d_train_step
from mtgs_torch.tools import campaign, render
from mtgs_torch.train import trainer
from mtgs_torch.train.optim import OptimConfig, default_groups

PKG = Path(mtgs_torch.__file__).parent
FORBIDDEN = ("jax", "flax", "mtgs_tpu", "PIL", "yaml")


def all_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "mtgs_torch."))


def test_importing_the_port_loads_no_jax():
    mods = all_modules()
    assert "mtgs_torch.eval.pipeline" in mods and "mtgs_torch.raster.blend" in mods
    assert "mtgs_torch.tools.render" in mods and "mtgs_torch.raster.expand_pairs" in mods
    assert "mtgs_torch.core.prng" in mods
    assert {"mtgs_torch.data.synthetic", "mtgs_torch.train.checkpoint",
            "mtgs_torch.tools.campaign"} <= set(mods)
    assert {"mtgs_torch.data.image_io", "mtgs_torch.data.nuplan", "mtgs_torch.data.dataset",
            "mtgs_torch.data.loader", "mtgs_torch.utils.pointcloud",
            "mtgs_torch.tools.train_scene"} <= set(mods)
    assert {"mtgs_torch.viewer.server", "mtgs_torch.utils.observability",
            "mtgs_torch.tools.bench_train", "mtgs_torch.tools.profile_raster"} <= set(mods)
    assert {f"mtgs_torch.preprocess.{m}" for m in (
        "video_scene", "roadblock_config", "stack_point_cloud", "lidar_registration", "colmap",
        "video_split", "dense_depth", "semantic_masks", "pipeline", "export_videos")} | {
        "mtgs_torch.tools.preview"} <= set(mods)
    assert {f"mtgs_torch.tools.{m}" for m in (
        "benchmark_farm", "validate_fused", "onchip_smoke", "grow_demo", "scaling_bench",
        "microbench_ops")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = PKG.parent
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|mtgs_tpu|PIL|yaml)\b|import_module\("
                         r"\s*['\"](jax|flax|mtgs_tpu|PIL|yaml)")
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cc")]
    assert len(files) > 20
    for p in files:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            assert not pattern.search(line), f"{p.relative_to(PKG.parent)}:{i}: {line}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_scene():
    rng = np.random.default_rng(0)
    xyz = np.stack([rng.uniform(-1, 1, 20), rng.uniform(-1, 1, 20),
                    rng.uniform(-6, -3, 20)], -1).astype(np.float32)
    bg = init_node_from_points(xyz, rng.uniform(0, 255, (20, 3)), capacity=32, device="cpu")
    return init_scene(bg, device="cpu")


def _batch():
    K = np.array([[20.0, 0, 16], [0, 20.0, 8], [0, 0, 1]], np.float32)
    return trainer.Batch(
        image=np.zeros((16, 32, 3), np.float32), mask=np.ones((16, 32, 1), np.float32),
        c2w=np.eye(4, dtype=np.float32), K=K, cam_idx=0, image_idx=0, travel_index=0,
        frame_idx=0, timestamp=0.0)


def test_entry_points_raise_without_a_card(no_card):
    params, aux = _tiny_scene()
    cfg = configs.mtgs_config(32, 16).replace(max_intersections=1 << 12)
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.render_view(params, aux, cfg, _batch(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.evaluate_scene(params, aux, cfg, [_batch()])
    with pytest.raises(RuntimeError, match="cuda"):
        mtgs_torch.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.Trainer(cfg, params, aux, iter([_batch()]))
    # the sharded entry points (a mesh object needs no process group here)
    data_mesh = Mesh((1,), ("data",), {}, {"data": 0})
    tile_mesh = Mesh((1,), ("tile",), {}, {"tile": 0})
    optim = OptimConfig(groups=default_groups(10))
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.render_view(params, aux, cfg, _batch(), 0, mesh=tile_mesh)
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.loss_and_grads(params, aux, cfg, _batch(), 0, mesh=tile_mesh)
    with pytest.raises(RuntimeError, match="cuda"):
        make_dp_train_step(cfg, optim, data_mesh)
    with pytest.raises(RuntimeError, match="cuda"):
        make_2d_train_step(cfg, optim, data_mesh)
    with pytest.raises(RuntimeError, match="cuda"):
        DPTrainer(cfg, params, aux, iter([_batch()]), data_mesh)
    # asked for explicitly, the CPU runs
    out = trainer.render_view(params, aux, cfg, _batch(), 0, device="cpu")
    assert out["rgb"].shape == (16, 32, 3) and float(out["accumulation"].max()) > 0
    res = pipeline.evaluate_scene(params, aux, cfg, [_batch()], device="cpu")
    assert res["num_images"] == 1
    # the public scene builders default to the card as well
    xyz = np.random.default_rng(1).uniform(-1, 1, (8, 3)).astype(np.float32)
    rgb = np.full((8, 3), 128.0, np.float32)
    builders = dict(
        init_node_from_points=lambda **kw: init_node_from_points(xyz, rgb, **kw),
        init_skybox_node=lambda **kw: init_skybox_node(num_points=16, **kw),
        init_exposure=lambda **kw: init_exposure(2, **kw),
    )
    for name, build in builders.items():
        with pytest.raises(RuntimeError, match="cuda"):
            build()
        parts = build(device="cpu")
        parts = parts if isinstance(parts, tuple) else (parts,)
        tensors = [v for p in parts for v in (vars(p).values() if dataclasses.is_dataclass(p)
                                              else [p]) if isinstance(v, torch.Tensor)]
        assert tensors and all(t.device.type == "cpu" for t in tensors), name
    bg = init_node_from_points(xyz, rgb, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        init_scene(bg)
    params, aux = init_scene(bg, device="cpu")
    assert params.appearance.device.type == params.camera_opt.device.type == "cpu"
    assert aux.background.alive.device.type == "cpu"


def test_render_tool_raises_without_a_card(no_card, tmp_path):
    """The render tool's entry points default to the card as render_view
    does, and write nothing when there is none."""
    params, aux = _tiny_scene()
    cfg = configs.mtgs_config(32, 16).replace(max_intersections=1 << 12)
    b = _batch()
    with pytest.raises(RuntimeError, match="cuda"):
        render.render_trajectory(params, aux, cfg, b.c2w[None], np.zeros(1), b.K, 0,
                                 tmp_path / "traj", make_video=False)
    with pytest.raises(RuntimeError, match="cuda"):
        render.render_dataset(params, aux, cfg, [b], tmp_path / "data")
    assert not list(tmp_path.rglob("*.png"))
    out = render.render_dataset(params, aux, cfg, [b], tmp_path / "data", device="cpu")
    assert len(out) == 3 and all(p.exists() for p in out)


def test_forward_only_and_precision_pins():
    """TF32 stays off; the serving forward (training=False) builds no
    autograd graph even for parameters that require grad, while the
    training forward does."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    params, aux = _tiny_scene()
    params.background.means.requires_grad_(True)
    cfg = configs.mtgs_config(32, 16).replace(max_intersections=1 << 12)
    out = trainer.render_view(params, aux, cfg, _batch(), 0, device="cpu")
    assert not out["rgb"].requires_grad and not out["depth"].requires_grad
    out = trainer.render_view(params, aux, cfg, _batch(), 0, training=True, device="cpu")
    assert out["rgb"].requires_grad and out["depth"].requires_grad


def test_campaign_entry_points_raise_without_a_card(no_card, tmp_path):
    """The synthetic scene, its model, the ladder Trainer and the campaign
    default to the card and raise without one (the campaign before it
    writes anything); asked for, the CPU runs."""
    kw = dict(width=32, height=16, n_travels=1, n_frames=1, n_bg=50, n_instance=8,
              gt_max_intersections=1 << 12)
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic.make_synthetic_scene(**kw)
    scene = synthetic.make_synthetic_scene(device="cpu", **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic.build_scene_model(scene)
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic.batch_iterator(scene)
    params, aux = synthetic.build_scene_model(scene, device="cpu")
    assert params.background.means.device.type == "cpu"
    cfg = configs.method_config("mtgs", width=32, height=16).replace(
        max_intersections=1 << 14)
    stages = dict(data_factory=lambda s: synthetic.batch_iterator(scene, device="cpu"),
                  resolution_stages=[(0, 1.0)])
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.Trainer(cfg, params, aux, **stages)
    assert trainer.Trainer(cfg, params, aux, device="cpu", **stages).train(1)
    with pytest.raises(RuntimeError, match="cuda"):
        campaign.main(["--out", str(tmp_path / "run"), "--steps", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        campaign.make_batch(scene, 0, 0, 1.0)
    assert not (tmp_path / "run").exists()
    with pytest.raises(KeyError, match="mtgs"):
        configs.method_config("nerf")
    # the deformable and WildGaussians presets are the mtgs preset, the first
    # with deformation switched on at the reference's absolute step
    # (test_torch_train_scene.py holds all four against JAX's, field by field)
    mtgs = configs.method_config("mtgs", max_steps=200)
    assert configs.method_config("wild_gaussians", max_steps=200) == mtgs
    assert configs.method_config("mtgs_deformable", max_steps=200) == mtgs.replace(
        deform_enable_step=3000)
    assert configs.DEFORM_ENABLE_STEP == 3000 and not mtgs.scene.deform_enabled
    assert configs.method_config("3dgs").rasterize_mode == "classic"


def test_image_decoders_build_from_the_checkout(tmp_path, monkeypatch):
    """`image_io` compiles mtgs_torch/csrc/image_decode.cc with the host
    compiler into build/mtgs_torch/, under a name hashing the source and
    the flags; without a compiler it raises, naming it."""
    from mtgs_torch.data import image_io

    assert image_io.SOURCE == PKG / "csrc" / "image_decode.cc" and image_io.SOURCE.exists()
    lib = image_io.library_path()
    assert lib.parent == PKG.parent / "build" / "mtgs_torch"
    assert lib.name.startswith("image_decode_") and lib.suffix == ".so"
    assert image_io.build() == lib and lib.exists()
    monkeypatch.setattr(image_io, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        image_io.build()


def test_eval_and_export_modules_import_no_jax():
    """The scoring, export and encoding modules, imported alone, load none of
    JAX, flax, mtgs_tpu or PIL."""
    mods = ["mtgs_torch.eval.lpips", "mtgs_torch.eval.dinov2", "mtgs_torch.eval.pipeline",
            "mtgs_torch.tools.export", "mtgs_torch.data.image_io", "mtgs_torch.core.camera",
            "mtgs_torch.models.fourier"]
    assert set(mods) <= set(all_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_image_encoder_builds_from_the_checkout(tmp_path, monkeypatch):
    """`image_io` compiles mtgs_torch/csrc/image_encode.cc (the JPEG encoder
    and the uint8 resize) with the host compiler into build/mtgs_torch/,
    under a name hashing the source and the flags; without a compiler the
    encoder raises, naming it."""
    from mtgs_torch.data import image_io

    src = image_io.ENCODE_SOURCE
    assert src == PKG / "csrc" / "image_encode.cc" and src.exists()
    lib = image_io.library_path(src)
    assert lib.parent == PKG.parent / "build" / "mtgs_torch"
    assert lib.name.startswith("image_encode_") and lib.suffix == ".so"
    assert lib != image_io.library_path()  # the decoders' library is another
    assert image_io.build(src) == lib and lib.exists()
    monkeypatch.setattr(image_io, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(image_io, "_ENC_LIB", None)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler.*image_encode.cc"):
        image_io.write_jpeg(tmp_path / "x.jpg", np.zeros((8, 8, 3), np.uint8))
    assert not (tmp_path / "x.jpg").exists()


def test_scoring_and_export_raise_without_a_card(no_card, tmp_path, monkeypatch):
    """`export_eval_images`, `get_lpips` and `get_dinov2` default to the card
    and raise without one, before they look for weights or write a file;
    asked for, the CPU runs."""
    from mtgs_torch.eval import dinov2, lpips

    monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    monkeypatch.setenv("MTGS_DINOV2_WEIGHTS", str(tmp_path / "none.npz"))
    params, aux = _tiny_scene()
    cfg = configs.mtgs_config(32, 16).replace(max_intersections=1 << 12)
    for fn in (lpips.get_lpips, dinov2.get_dinov2):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
        assert fn(device="cpu") is None  # no weight file
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.export_eval_images(params, aux, cfg, [_batch()], tmp_path / "out")
    assert not (tmp_path / "out").exists()
    out = pipeline.export_eval_images(params, aux, cfg, [_batch()], tmp_path / "out",
                                      device="cpu")
    assert [Path(p).relative_to(tmp_path / "out").as_posix() for p in out] == [
        "traversal_0/cam0/0_rendered.jpg"]
