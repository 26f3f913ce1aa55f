"""Point-cloud stacking and multi-traversal LiDAR registration of mtgs_torch
against the JAX package's, on the CPU: the voxel average on tensors against
numpy's, `points_in_boxes`, `paint_points`, `brightness_adjust_factors` and
`StackAccumulator` against JAX's numpy functions on seeded inputs, the ICP
(built from `mtgs_torch/csrc/icp_core.cc` into `build/mtgs_torch/`) on
tests/test_icp.py's world against JAX's, and stages 5-8 of the pipeline on
a small road block against JAX's (the slice as a whole)."""

import hashlib
import inspect
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import make_nuplan_fixture as fixture
import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
import test_icp
from mtgs_tpu.preprocess import lidar_registration as jlr
from mtgs_tpu.preprocess import pipeline as jpipe
from mtgs_tpu.preprocess import stack_point_cloud as jstack
from mtgs_tpu.preprocess import video_scene as jvs
from mtgs_tpu.utils import pointcloud as jpc
from mtgs_torch.data import image_io
from mtgs_torch.preprocess import lidar_registration as tlr
from mtgs_torch.preprocess import pipeline as tpipe
from mtgs_torch.preprocess import stack_point_cloud as tstack
from mtgs_torch.preprocess import video_scene as tvs
from mtgs_torch.utils import pointcloud as tpc

ROOT = Path(__file__).resolve().parents[1]
JAX_ICP_LIB = ROOT / "cpp" / "icp" / "libicp_core.so"
POSE_TOL = 1e-5    # register_traversals: refined poses and error tables
FACTOR_TOL = 1e-6  # brightness factors: a float64 mean against numpy's float32 pairwise one


def ulps32(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in float32 ulps between two float32 arrays."""
    a = got.astype(np.float32).view(np.int32).astype(np.int64)
    b = want.astype(np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def assert_same_cloud(got, want):
    """The same rows (voxels), xyz and rgb within one float32 ulp."""
    assert got[0].shape == want[0].shape, (got[0].shape, want[0].shape)
    assert ulps32(got[0], want[0]) <= 1 and ulps32(got[1], want[1]) <= 1


# ------------------------------------------------------------ stacking


@pytest.mark.parametrize("voxel", [0.15, 0.075, 1.0])
def test_voxel_downsample_tensor_matches_numpy(voxel):
    """The same voxels in `np.unique`'s order, float64 means within one
    float32 ulp. Keys come from a float32 division as numpy 2 makes them:
    points just past a voxel edge in float32 but not in float64 sit in the
    input, so a float64 division would give other rows."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-40, 40, (20000, 3)).astype(np.float32)
    edge = (np.arange(1, 200) * voxel).astype(np.float32)
    xyz[:199, 0] = np.nextafter(edge, np.float32(-np.inf))
    xyz[199:398, 1] = edge
    xyz[398:597, 2] = np.nextafter(edge, np.float32(np.inf))
    rgb = rng.uniform(0, 255, (20000, 3)).astype(np.float32)
    want = tpc.voxel_downsample(xyz, rgb, voxel)
    assert np.array_equal(want[0], jpc.voxel_downsample(xyz, rgb, voxel)[0])
    got = tpc.voxel_downsample_tensor(torch.from_numpy(xyz), torch.from_numpy(rgb), voxel)
    assert_same_cloud((got[0].numpy(), got[1].numpy()), want)
    xyz_only = tpc.voxel_downsample_tensor(torch.from_numpy(xyz), None, voxel)
    assert xyz_only[1] is None and torch.equal(xyz_only[0], got[0])
    keys64 = np.floor(xyz.astype(np.float64) / voxel)
    keys32 = np.floor(xyz / voxel)
    assert (keys64 != keys32).any() or voxel == 1.0  # the trap is in the input
    empty = torch.zeros((0, 3))
    assert tpc.voxel_downsample_tensor(empty, None, voxel)[0] is empty


def scene(seed=0, n=20000, n_cams=3, H=48, W=64, n_boxes=12):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 4, n)
    imgs = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(n_cams)]
    sems = [rng.integers(0, 19, (H, W), dtype=np.uint8) for _ in range(n_cams)]
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
    R_cv = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    cams = []
    for yaw in np.linspace(0, 2 * np.pi, n_cams, endpoint=False):
        c, s = np.cos(yaw), np.sin(yaw)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ R_cv
        m[:3, 3] = [1.0, 0.2, 1.5]
        cams.append(m)
    boxes = np.concatenate([rng.uniform(-20, 20, (n_boxes, 3)), rng.uniform(1, 6, (n_boxes, 3)),
                            rng.uniform(-3, 3, (n_boxes, 1))], 1)
    return pts, imgs, sems, cams, [K] * n_cams, boxes


def test_points_in_boxes_matches_jax():
    pts, *_, boxes = scene()
    for b in (boxes, boxes[:0], np.array([[5.0, 0, 0, 2.0, 1.5, 1.0, 0.0]]),
              np.array([[0.0, 0, 0, 4.0, 1.0, 1.0, np.pi / 2]])):
        bg_t, per_t = tstack.points_in_boxes(pts, b, device="cpu")
        bg_j, per_j = jstack.points_in_boxes(pts, b)
        assert np.array_equal(bg_t.numpy(), bg_j) and len(per_t) == len(per_j)
        assert all(np.array_equal(t.numpy(), j) for t, j in zip(per_t, per_j))
    pts = np.array([[0.0, 0, 0], [5.0, 0, 0], [5.0, 0.4, 0.2], [10.0, 0, 0]])
    bg, per = tstack.points_in_boxes(pts, np.array([[5.0, 0, 0, 2.0, 1.5, 1.0, 0.0]]),
                                     device="cpu")
    assert bg.tolist() == [True, False, False, True] and per[0].tolist() == [False, True, True,
                                                                            False]


@pytest.mark.parametrize("images", ["uint8", "float"])
def test_paint_points_matches_jax(images):
    """rgb, seen and the semantic labels equal JAX's: the projection is
    float64 as numpy's, the first camera that sees a point colours it."""
    pts, imgs, sems, cams, Ks, _ = scene()
    fimgs = [np.asarray(i, np.float32) / 255.0 for i in imgs]
    sems = [sems[0], None, sems[2]]
    want = jstack.paint_points(pts, fimgs, cams, Ks, sems)
    got = tstack.paint_points(pts, imgs if images == "uint8" else fimgs, cams, Ks, sems,
                              device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w) and g.numpy().dtype == w.dtype
    assert want[1].sum() > 1000 and (want[2] >= 0).sum() > 500
    no_sem = tstack.paint_points(pts, imgs, cams, Ks, device="cpu")
    assert torch.equal(no_sem[0], got[0]) and bool((no_sem[2] == -1).all())


def test_brightness_factors_match_jax():
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(0, s, (48, 64, 3)).astype(np.float32) for s in (0.9, 0.4, 1.0)]
    got = tstack.brightness_adjust_factors(imgs, 1, device="cpu")
    want = jstack.brightness_adjust_factors(imgs, 1)
    assert np.allclose(got, want, rtol=FACTOR_TOL, atol=0)


def test_stack_accumulator_matches_jax(tmp_path):
    """Three frames through both accumulators: the background and instance
    clouds have the same rows, within one float32 ulp; the same files."""
    pts, imgs, sems, cams, Ks, boxes = scene(n=30000)
    fimgs = [np.asarray(i, np.float32) / 255.0 for i in imgs]
    toks = [f"trk{i}" for i in range(len(boxes) - 2)]  # the last two boxes untracked
    acc_t = tstack.StackAccumulator(voxel=0.15, device="cpu")
    acc_j = jstack.StackAccumulator(voxel=0.15)
    rng = np.random.default_rng(9)
    for f in range(3):
        yaw = 0.2 * f
        e2g = np.eye(4)
        e2g[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        e2g[:3, 3] = [12.5 * f, -3.1, 0.4]
        p = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
        rgb, seen, sem = jstack.paint_points(p, fimgs, cams, Ks, sems)
        acc_j.add_frame(p, rgb, seen, sem, e2g, boxes, toks)
        rgb_t, seen_t, sem_t = tstack.paint_points(p, imgs, cams, Ks, sems, device="cpu")
        acc_t.add_frame(p, rgb_t, seen_t, sem_t, e2g, boxes, toks)
    written = acc_t.finalize(tmp_path / "t")
    acc_j.finalize(tmp_path / "j")
    want = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.npz"))
    assert sorted(p.relative_to(tmp_path / "t") for p in written) == want and len(want) > 3
    for rel in want:
        assert_same_cloud(tpc.load_pcd(tmp_path / "t" / rel), jpc.load_pcd(tmp_path / "j" / rel))
    # fewer than five seen points in a box: no instance file (ref filter)
    acc = tstack.StackAccumulator(voxel=0.1, device="cpu")
    p = np.array([[-0.5, 0.0, 5.0], [0.5, 0.0, 5.0], [0.0, 0.0, -5.0]])
    acc.add_frame(p, torch.zeros(3, 3), torch.tensor([True, True, False]), None, np.eye(4),
                  np.array([[0.5, 0.0, 5.0, 1.0, 1.0, 12.0, 0.0]]), ["trk"])
    assert [q.name for q in acc.finalize(tmp_path / "few")] == ["background.pcd.npz"]


def test_stacking_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, imgs, sems, cams, Ks, boxes = scene(n=100)
    for call in (lambda: tstack.points_in_boxes(pts, boxes),
                 lambda: tstack.paint_points(pts, imgs, cams, Ks),
                 lambda: tstack.brightness_adjust_factors(imgs),
                 lambda: tstack.StackAccumulator()):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# ----------------------------------------------------------------- ICP


@pytest.fixture(scope="module")
def world():
    return test_icp.make_world()


def traversals(world, lanes=(-1.0, 1.0), frames=8, seed=3):
    rng = np.random.default_rng(seed)
    scans, gps = {}, {}
    for travel, lane in enumerate(lanes):
        poses = test_icp.drive_poses(frames, lane_y=lane)
        scans[travel] = [test_icp.scan_from(world, poses[f], rng) for f in range(frames)]
        gps[travel] = poses
    return scans, gps


def so_state():
    return hashlib.sha256(JAX_ICP_LIB.read_bytes()).hexdigest(), JAX_ICP_LIB.stat().st_mtime_ns


JAX_ICP_BUILD = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]


@pytest.fixture(scope="module")
def jax_icp_built_here(tmp_path_factory):
    """JAX's ICP core built from its source on this host, with JAX's own
    command and flags (`_load_lib`), into a temporary folder. The
    committed cpp/icp/libicp_core.so is a -march=native build from another
    CPU, and on near-straight tracks the roll is ill-conditioned, so that
    binary's rounding gives other rolls than a build for this CPU. The
    port builds the same source with the same flags here, so the tests
    compare like with like."""
    assert ", ".join(f'"{a}"' for a in JAX_ICP_BUILD) in inspect.getsource(jlr._load_lib)
    so = tmp_path_factory.mktemp("jax_icp") / "libicp_core.so"
    subprocess.run([*JAX_ICP_BUILD, str(jlr._SRC), "-o", str(so)], check=True)
    return so


@pytest.fixture
def jax_icp(jax_icp_built_here, monkeypatch):
    """JAX's registration loads the library built here; the committed one
    is left as it is."""
    monkeypatch.setattr(jlr, "_SO", jax_icp_built_here)
    monkeypatch.setattr(jlr, "_LIB", None)


@pytest.mark.parametrize("gates", [dict(epe_gate=5.0, ate_gate=2.0),
                                   dict(epe_gate=1e-4, ate_gate=2.0)])
def test_register_traversals_matches_jax(world, gates, jax_icp):
    """Refined poses and the error tables within POSE_TOL, the same
    excluded traversals, JAX's ICP built from its source on this host; the
    port builds its own ICP library under build/mtgs_torch/ and leaves
    cpp/icp/libicp_core.so as it was."""
    scans, gps = traversals(world)
    want = jlr.register_traversals(scans, gps, voxel_size=0.8, **gates)
    before = so_state()
    got = tlr.register_traversals(scans, gps, voxel_size=0.8, **gates)
    assert so_state() == before
    assert got[2] == want[2] and (want[2] == [] if gates["epe_gate"] > 1 else want[2] == [0, 1])
    for t in want[0]:
        assert np.abs(got[0][t] - want[0][t]).max() <= POSE_TOL
        for k, v in want[1][t].items():
            assert abs(got[1][t][k] - v) <= POSE_TOL, (t, k)
    lib = image_io.library_path(tlr.SOURCE, tlr.ICP_FLAGS)
    assert lib.parent == ROOT / "build" / "mtgs_torch" and lib.exists()
    assert lib.name.startswith("icp_core_") and tlr.SOURCE == ROOT / "mtgs_torch" / "csrc" / "icp_core.cc"


def test_odometry_and_alignment_match_jax(world, jax_icp):
    rng = np.random.default_rng(1)
    poses = test_icp.drive_poses(2)
    got, want = tlr.LidarOdometry(voxel_size=0.8, min_range=2.0), jlr.LidarOdometry(
        voxel_size=0.8, min_range=2.0)
    for f in range(len(poses)):
        scan = test_icp.scan_from(world, poses[f], rng)
        assert np.abs(got.register_scan(scan) - want.register_scan(scan)).max() <= POSE_TOL
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        got.register_scan(np.zeros((4, 2), np.float32))
    src = rng.normal(size=(50, 3))
    dst = src @ test_icp.drive_poses(20)[-1][:3, :3].T + [3.0, -2.0, 0.5]
    assert np.array_equal(tlr.umeyama_rigid(src, dst), jlr.umeyama_rigid(src, dst))
    noisy = poses.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.1, (len(poses), 3))
    assert tlr.trajectory_errors(noisy, poses) == jlr.trajectory_errors(noisy, poses)


# ------------------------------------------------ stages 5-8, as a whole

W, H = 96, 64


@pytest.fixture(scope="module")
def stage_roots(tmp_path_factory):
    """One 96x64 block with the stage inputs and its raw stage, copied for
    each package."""
    work = tmp_path_factory.mktemp("factory")
    root = work / "jax"
    b = fixture.make_block(moving_vehicle=True)
    fixture.write_images(root, b, W, H)
    fixture.write_runtime_files(root, b, W, H, n_seed=3000, n_vehicle=400, beams=32,
                                azimuths=512)
    raw = fixture.write_stage_inputs(root)
    shutil.copytree(root, work / "torch", symlinks=True)
    jvs.VideoScene(work, "jax").save(raw, "raw")
    tvs.VideoScene(work, "torch").save(raw, "raw")
    return work


def test_stages_5_to_8_match_jax(stage_roots, capsys, jax_icp):
    """`run_pipeline` stages 5-8 on the block: the statuses JAX reports
    (registration and stacking ok; COLMAP and dense depth skipped, the
    fixed-pose model written), the registered stage's poses and error tables
    within POSE_TOL, the same COLMAP pairs, and the same clouds (rows, and
    values within one float32 ulp)."""
    work = stage_roots
    before = so_state()
    got = tpipe.run_pipeline(work, "torch", {}, start=5, stop=8, device="cpu")
    assert so_state() == before
    want = jpipe.run_pipeline(work, "jax", {}, start=5, stop=8)
    assert {k: v.replace("/torch/", "/jax/") for k, v in got.items()} == want
    assert got["lidar_registration"] == got["stack_point_cloud"] == "ok"
    assert got["colmap"].startswith("skipped: fixed-pose model written (12 images")
    assert got["dense_depth"].startswith("skipped: UniDepth is not installed")
    reg_t = tvs.VideoScene(work, "torch").load("registered")
    reg_j = jvs.VideoScene(work, "jax").load("registered")
    for tok, info in reg_j.items():
        assert reg_t[tok]["registration_excluded"] is info["registration_excluded"] is False
        for k, v in info["registration_errors"].items():
            assert abs(reg_t[tok]["registration_errors"][k] - v) <= POSE_TOL
        for a, b in zip(reg_t[tok]["frame_infos"], info["frame_infos"]):
            assert np.abs(np.asarray(a["ego2global"]) - b["ego2global"]).max() <= POSE_TOL
            assert a["skipped"] == b["skipped"] if "skipped" in b else "skipped" not in a
    assert ((work / "torch" / "colmap" / "image_pairs.txt").read_text()
            == (work / "jax" / "colmap" / "image_pairs.txt").read_text())
    clouds = sorted(p.relative_to(work / "jax") for p in (work / "jax").rglob("*.pcd.npz"))
    assert Path("stacked_point_cloud/background.pcd.npz") in clouds
    for rel in clouds:
        assert_same_cloud(tpc.load_pcd(work / "torch" / rel), jpc.load_pcd(work / "jax" / rel))
    assert len(tpc.load_pcd(work / "torch" / clouds[-1])[0]) > 100
    assert tvs.VideoScene(work, "torch").latest_stage() == "final"
