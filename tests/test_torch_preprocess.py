"""The data factory's host modules of mtgs_torch against the JAX package's,
on the same seeded numpy inputs: the staged store and its filters (each
package reading the other's stage pickles), road-block configs in their
three formats (the port's own YAML reader and writer against PyYAML's, and
with PyYAML hidden), traversal splitting, COLMAP interop, the depth codec,
the gated model stages, the pipeline driver's statuses, the preview page
and the preview mosaics. Tolerances are stated where a test is not exact."""

import dataclasses
import math
import pickle
import sqlite3
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.preprocess import colmap as jcm
from mtgs_tpu.preprocess import dense_depth as jdd
from mtgs_tpu.preprocess import export_videos as jev
from mtgs_tpu.preprocess import pipeline as jpipe
from mtgs_tpu.preprocess import roadblock_config as jrb
from mtgs_tpu.preprocess import semantic_masks as jsm
from mtgs_tpu.preprocess import video_scene as jvs
from mtgs_tpu.preprocess import video_split as jsp
from mtgs_tpu.tools import preview as jpreview
from mtgs_torch.data.image_io import read_image, to_rgb
from mtgs_torch.preprocess import colmap as tcm
from mtgs_torch.preprocess import dense_depth as tdd
from mtgs_torch.preprocess import export_videos as tev
from mtgs_torch.preprocess import pipeline as tpipe
from mtgs_torch.preprocess import roadblock_config as trb
from mtgs_torch.preprocess import semantic_masks as tsm
from mtgs_torch.preprocess import video_scene as tvs
from mtgs_torch.preprocess import video_split as tsp
from mtgs_torch.tools import preview as tpreview

QUAT_TOL = 1e-6   # qvec / tvec: float32 quaternion conversions on both sides
SIM3_TOL = 1e-9   # umeyama_sim3: the same float64 numpy on both sides


def deep_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            deep_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def make_vsd(n_videos=3, n_frames=20, step=1.0, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for v in range(n_videos):
        frames = []
        for f in range(n_frames):
            x, y = f * step + rng.normal(0, 0.05), v * 10.0 + rng.normal(0, 0.05)
            e = np.eye(4)
            e[:3, 3] = [x, y, 0.0]
            frames.append(dict(
                can_bus=np.array([x, y, 0.0, 1, 0, 0, 0]),
                ego2global_translation=[x, y, 0.0], ego2global_rotation=[1, 0, 0, 0],
                ego2global=e, lidar_path=f"lidar/{v}_{f}.pcd", token=f"t{v}_{f}"))
        out[f"log-{v}"] = dict(video_token=f"log-{v}", frame_infos=frames)
    return out


# ------------------------------------------------------------ the store


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_staged_store_is_read_across(tmp_path, writer):
    """A stage one package writes, the other reads, with the canonical
    symlink, the older stage and `latest_stage` alike."""
    w, r = (tvs, jvs) if writer == "port" else (jvs, tvs)
    d = make_vsd()
    ws, rs = w.VideoScene(tmp_path, "block"), r.VideoScene(tmp_path, "block")
    ws.save(d, "raw")
    assert rs.pickle_path.is_symlink() and deep_equal(rs.load(), d)
    d2 = {k: v for k, v in d.items() if k != "log-2"}
    ws.save(d2, "registered")
    assert deep_equal(rs.load(), d2) and deep_equal(rs.load("raw"), d)
    assert rs.latest_stage() == ws.latest_stage() == "registered"
    for name in ("undistorted_image_path", "raw_mask_path", "undistorted_mask_path",
                 "undistorted_depth_path", "rgb_point_cloud_path", "sfm_point_cloud_path",
                 "instance_point_cloud_path", "colmap_path", "registration_path"):
        assert getattr(ws, name) == getattr(rs, name), name
    assert tvs.STAGES == jvs.STAGES
    with pytest.raises(ValueError, match="unknown stage"):
        tvs.VideoScene(tmp_path, "block").stage_path("nope")


def test_store_refuses_tensors(tmp_path):
    vs = tvs.VideoScene(tmp_path, "block")
    d = make_vsd(1, 2)
    d["log-0"]["frame_infos"][1]["ego2global"] = torch.eye(4)
    with pytest.raises(TypeError, match=r"frame_infos'\]\[1\]\['ego2global'\]"):
        vs.save(d, "raw")
    assert not vs.stage_path("raw").exists()


@pytest.mark.parametrize("names,kwargs", [
    (["filter_by_video_idx"], dict(filter_by_video_idx=dict(
        video_idxs=[0, dict(idx=2, start_frame=5, end_frame=15)]))),
    (["filter_by_video_idx"], {}),
    (["filter_low_velocity"], {}),
    (["filter_low_velocity"], dict(filter_low_velocity=dict(min_displacement=1.5,
                                                            max_consecutive=3))),
    (["filter_low_velocity", "filter_skipped_frames", "inject_trajectory"], {}),
])
def test_filters_match_jax(names, kwargs):
    for step in (0.0, 0.2, 1.0):
        got = tvs.apply_filters(make_vsd(step=step), names, **kwargs)
        want = jvs.apply_filters(make_vsd(step=step), names, **kwargs)
        assert deep_equal(got, want), (names, step)
    assert set(tvs.FILTERS) == set(jvs.FILTERS)


# ------------------------------------------------------------ configs

REFERENCE_YAML = (
    "!!python/object:nuplan_scripts.utils.config.RoadBlockConfig\n"
    "city: us-ma-boston\n"
    "data_root: ./data/MTGS\n"
    "interval: 1\n"
    "reconstruct_buffer: 0\n"
    "expand_buffer: 0\n"
    "exclude_bad_registration: false\n"
    "use_colmap_ba: false\n"
    "collect_raw: false\n"
    "split: trainval\n"
    "road_block: !!python/tuple\n"
    "- 331120\n"
    "- 4690660\n"
    "- 331190\n"
    "- 4690710\n"
    "road_block_name: road_block-331220_4690660_331190_4690710\n"
    "selected_videos: !!python/tuple\n"
    "- 0\n"
    "- 1\n"
    "- idx: 2\n"
    "  start_frame: 5\n"
    "  end_frame: 50\n"
    "central_tokens:\n"
    "- e8b1c4d6b1a35b44  # the central lidar_pc token\n"
)


def full_config(root):
    # a data root past PyYAML's 80-column width with a space in it: written folded
    return dict(road_block_name="road_block-1_2_3_4", road_block=(1.0, 2.5, 3.0, 4.0),
                city="sg-one-north", data_root=str(root / ("d" * 60) / "data dir"),
                selected_videos=(0, 1, dict(idx=5, start_frame=0, end_frame=40)),
                expand_buffer=30.0, use_colmap_ba=True, central_log="2021.05.12.22.00.38",
                central_tokens=["0123", "yes", "abc"], interval=2,
                exclude_bad_registration=False)


def write_config(kind, tmp_path, pkg):
    if kind == "yaml":
        path = tmp_path / "rb.yaml"
        jrb.save_yaml(jrb.RoadBlockConfig(**full_config(tmp_path)), path)
    elif kind == "reference_tagged":
        path = tmp_path / "ref.yml"
        path.write_text(REFERENCE_YAML)
    else:
        path = tmp_path / f"cfg_{pkg}.py"
        path.write_text(f"from mtgs_{pkg}.preprocess.roadblock_config import RoadBlockConfig\n"
                        "config = RoadBlockConfig(road_block_name='rb', "
                        "road_block=(0, 0, 10, 10), city='sg-one-north')\n")
    return path


@pytest.mark.parametrize("kind", ["yaml", "reference_tagged", "py"])
def test_road_block_config_loads_as_jax(tmp_path, kind):
    """Each format loads to the same fields as JAX's loader, with the same
    stage configs and scene folder."""
    got = trb.load_road_block_config(write_config(kind, tmp_path, "torch"))
    want = jrb.load_road_block_config(write_config(kind, tmp_path, "tpu"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got.road_block) is tuple and type(got.selected_videos) is tuple
    assert got.to_stage_config() == want.to_stage_config()
    assert got.scene_dir == want.scene_dir


def test_save_yaml_writes_pyyamls_text(tmp_path):
    """`save_yaml` writes the text JAX's (PyYAML's safe_dump) writes; each
    package loads the other's file."""
    fields = full_config(tmp_path)
    trb.save_yaml(trb.RoadBlockConfig(**fields), tmp_path / "t.yaml")
    jrb.save_yaml(jrb.RoadBlockConfig(**fields), tmp_path / "j.yaml")
    assert (tmp_path / "t.yaml").read_bytes() == (tmp_path / "j.yaml").read_bytes()
    assert (dataclasses.asdict(jrb.load_road_block_config(tmp_path / "t.yaml"))
            == dataclasses.asdict(trb.load_road_block_config(tmp_path / "j.yaml"))
            == dataclasses.asdict(trb.RoadBlockConfig(**fields)))


def test_road_block_config_without_pyyaml(tmp_path, monkeypatch):
    """With PyYAML unimportable the port reads and writes all three formats."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml  # noqa: F401,F811
    fields = full_config(tmp_path)
    trb.save_yaml(trb.RoadBlockConfig(**fields), tmp_path / "t.yaml")
    assert trb.load_road_block_config(tmp_path / "t.yaml") == trb.RoadBlockConfig(**fields)
    ref = trb.load_road_block_config(write_config("reference_tagged", tmp_path, "torch"))
    assert ref.road_block == (331120, 4690660, 331190, 4690710)
    assert ref.selected_videos == (0, 1, dict(idx=2, start_frame=5, end_frame=50))
    assert trb.load_road_block_config(write_config("py", tmp_path, "torch")).city == "sg-one-north"


YAML_DOCS = [
    "a:\n- - 1\n  - 2\n- - 3\n  - - 4\n    - 5\nb: 1.0e-20\nc: .inf\nd: null\ne: 'a: b'\n",
    "x: {}\ny: []\nz: [1, 2.5, 'a b', [3, 4], {k: v}]\nw: {a: 1, b: [x]}\n",
    "oct: 0123\nhex: 0x1F\nbin: 0b101\nsexa: 1:30\nf: 1.5e+3\ne: 1e5\nu: 1_000\nneg: -.inf\n",
    "yes: no\noff: On\n~: tilde\nq: \"a\\tb\\u00e9 \\\"q\\\"\"\ns: 'it''s'\n",
    "--- !!python/object:x.Y\nk: !!python/tuple\n- 1\n- !!python/tuple [2, 3]\n",
    "list:\n- a: 1\n  b:\n  - 2\n  - c: 3\n- - x\n  - y\n# comment\nlast: -x  # trailing\n",
    "n:\n  m:\n    o: 1\n  p: 2\nq:\n",
    "a: a long plain\n  scalar folded\nb:\n- 'it''s quoted\n  and folded'\n- x: y\n    z # c\n",
]


@pytest.mark.parametrize("doc", range(len(YAML_DOCS)))
def test_yaml_reader_matches_pyyaml(doc):
    """The reader gives what PyYAML's loader, with the JAX package's two
    tag handlers, gives (the loader JAX's `_tolerant_yaml_load` builds)."""
    text = YAML_DOCS[doc]
    want = jrb._tolerant_yaml_load(text)
    got = trb.yaml_load(text)
    assert got == want and type(got) is type(want)
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    # the writer's text reads back the same, through PyYAML and the reader
    plain = as_lists(got)
    assert yaml.safe_load(trb.yaml_dump(plain)) == plain == trb.yaml_load(trb.yaml_dump(plain))


def as_lists(v):
    if isinstance(v, dict):
        return {k: as_lists(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [as_lists(x) for x in v]
    return v


@pytest.mark.parametrize("text,line", [
    ("a: &x 1\n", 1), ("a: 1\nb: *x\n", 2), ("a: |\n  text\n", 1), ("a: !!str x\n", 1),
    ("a: b\n  c: d\n", 2), ('a: "x\n  y"\n', 1), ("a: [1, 2\n", 1), ("a: 1\na: 2\n", 2),
    ("- 1\nb: 2\n", 2), ("a:\n\t- 1\n", 2),
])
def test_yaml_reader_refuses_naming_the_line(text, line):
    with pytest.raises(ValueError, match=f"cfg.yaml:{line}: unsupported YAML"):
        trb.yaml_load(text, "cfg.yaml")


# ---------------------------------------------------------- video split


def test_video_split_matches_jax(tmp_path):
    t = np.linspace(0, 200, 201)
    pos = np.stack([t, np.zeros_like(t)], -1)
    pos[100:130, 1] = 100.0
    block = (40.0, -10.0, 160.0, 10.0)
    for kw in (dict(expand_buffer=5.0, min_frames=5), dict(interval=3, expand_buffer=30.0),
               dict(min_frames=500)):
        got = tsp.split_in_region_videos(pos, block, **kw)
        want = jsp.split_in_region_videos(pos, block, **kw)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert tsp.trajectory_intersects_block(pos, block) == jsp.trajectory_intersects_block(
        pos, block) is True
    assert tsp.trajectory_intersects_block(pos, (300, 0, 400, 1)) is False

    rng = np.random.default_rng(4)
    base = np.stack([np.linspace(0, 100, 50), np.zeros(50), np.zeros(50)], -1)

    def videos():
        return [dict(trajectory=base + [0, dy, 0] + rng.normal(0, 0.1, base.shape),
                     lidar_pc_tokens=[tok]) for dy, tok in
                ((20, "a"), (0, "central"), (1.0, "b"), (3.5, "c"), (-9, "d"))]
    for central in ("central", None, "d"):
        rng = np.random.default_rng(4)
        got = tsp.sort_and_dedupe_videos(videos(), central_token=central)
        rng = np.random.default_rng(4)
        want = jsp.sort_and_dedupe_videos(videos(), central_token=central)
        assert deep_equal(got, want), central

    # the log-info cache: written by each, scanned by each
    meta = tmp_path / "meta_datas" / "trainval"
    meta.mkdir(parents=True)
    for li in range(3):
        infos = [dict(token=f"t{li}_{i}", log_token=f"log{li}", map_location="us-ma-boston",
                      ego2global_translation=[40.0 * li + 3 * i, 0.123 * i, 0.0])
                 for i in range(30)]
        with open(meta / f"2021.05.12.log{li}.pkl", "wb") as f:
            pickle.dump(infos, f)
    assert tsp.generate_log_info_cache(tmp_path, tmp_path / "t.jsonl") == 3
    assert jsp.generate_log_info_cache(tmp_path, tmp_path / "j.jsonl") == 3
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert (tsp.scan_log_cache_for_block(tmp_path / "t.jsonl", block)
            == jsp.scan_log_cache_for_block(tmp_path / "t.jsonl", block))


def test_frame_records_match_jax():
    ts = np.arange(10) * 1e5
    poses = np.stack([jsp.pose_matrix([i * 1.0, 0.3 * i, 0], [0.99, 0.0, 0.0, 0.14])
                      for i in range(10)])
    assert np.array_equal(tsp.pose_matrix([1, 2, 3], [0.9, 0.1, -0.2, 0.3]),
                          jsp.pose_matrix([1, 2, 3], [0.9, 0.1, -0.2, 0.3]))
    calib = jsp.pose_matrix([0.5, 0, 1.5], [0.5, -0.5, 0.5, -0.5])
    for q in (0.0, 2.4e5, 2.6e5, 1e7, -5.0):
        assert np.array_equal(tsp.nearest_ego_pose(ts, poses, q), jsp.nearest_ego_pose(ts, poses, q))
    for shutter in (0.0, 0.1, 1 / 60):
        assert np.array_equal(
            tsp.rolling_shutter_cam_to_ego(2e5, poses[2], ts, poses, calib,
                                           rolling_shutter_s=shutter),
            jsp.rolling_shutter_cam_to_ego(2e5, poses[2], ts, poses, calib,
                                           rolling_shutter_s=shutter))

    def frame(tok, x, y, t):
        can_bus = np.zeros(18)
        can_bus[:3] = [x, y, 1.0]
        can_bus[3:7] = [0.98, 0.0, 0.0, 0.2]
        return dict(token=tok, timestamp=t, log_name="log", log_token="lt",
                    lidar_path=f"{tok}.pcd", can_bus=can_bus,
                    lidar2ego_translation=[0.1, 0.0, 1.8], lidar2ego_rotation=[1, 0, 0, 0])

    cams8 = {f"CAM_{i}": dict(data_path=f"c{i}.jpg") for i in range(8)}
    frames = [frame("a", 120.0, 220.0, 1_000_000), frame("b", 90.0, 220.0, 1_100_000),
              frame("c", 121.0, 221.0, 1_200_000)]
    args = (dict(video_token="v0", log_name="log", log_token="lt"), frames,
            [cams8, cams8, {"CAM_0": {}}])
    kw = dict(road_block=(100.0, 200.0, 140.0, 240.0), reconstruct_buffer=5.0, baseline_z=1.0)
    assert deep_equal(tsp.build_video_record(*args, **kw), jsp.build_video_record(*args, **kw))
    with pytest.raises(RuntimeError, match="nuplan-devkit") as got:
        tsp.build_frame_infos_nuplan({}, {})
    with pytest.raises(RuntimeError) as want:
        jsp.build_frame_infos_nuplan({}, {})
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- colmap


def colmap_model(pkg):
    cams = {1: pkg.Camera(1, "OPENCV", 1920, 1080, np.array(
                [1000.0, 1001.0, 960.0, 540.0, 0.01, -0.01, 0.001, 0.002])),
            2: pkg.Camera(2, "PINHOLE", 640, 480, np.array([500.0, 500.0, 320.0, 240.0]))}
    ims = {7: pkg.Image(7, np.array([0.9, 0.1, -0.2, 0.3]) / np.linalg.norm([0.9, 0.1, -0.2, 0.3]),
                        np.array([0.5, -1.0, 2.0]), 1, "cam/img_000.jpg",
                        np.array([[10.0, 20.0], [30.0, 40.5]]), np.array([3, -1], np.int64)),
           9: pkg.Image(9, np.array([1.0, 0, 0, 0]), np.array([1.5, 0.0, -2.0]), 2, "b.jpg")}
    pts = {3: pkg.Point3D(3, np.array([1.0, 2.0, 3.0]), np.array([255, 128, 0], np.uint8), 0.5,
                          np.array([7, 9], np.uint32), np.array([0, 4], np.uint32))}
    return cams, ims, pts


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_binary_model_is_read_across(tmp_path, writer):
    w, r = (tcm, jcm) if writer == "port" else (jcm, tcm)
    w.write_model(*colmap_model(w), tmp_path)
    cams, ims, pts = r.read_model(tmp_path)
    wc, wi, wp = colmap_model(w)
    assert {k: (c.model, c.width, c.height, c.params.tolist()) for k, c in cams.items()} == {
        k: (c.model, c.width, c.height, c.params.tolist()) for k, c in wc.items()}
    for k, im in wi.items():
        assert (ims[k].name, ims[k].camera_id) == (im.name, im.camera_id)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            assert np.array_equal(getattr(ims[k], f), getattr(im, f)), f
    for k, p in wp.items():
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            assert np.array_equal(getattr(pts[k], f), getattr(p, f)), f
    # the files the port writes are JAX's, byte for byte
    w2 = tmp_path / "again"
    r.write_model(*colmap_model(r), w2)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (w2 / name).read_bytes() == (tmp_path / name).read_bytes(), name


def test_colmap_database_matches_jax(tmp_path):
    rows = {}
    for tag, pkg in (("t", tcm), ("j", jcm)):
        db = pkg.ColmapDatabase(tmp_path / f"{tag}.db")
        db.add_camera(pkg.Camera(1, "PINHOLE", 100, 100, np.array([50.0, 50.0, 50.0, 50.0])))
        db.add_image(pkg.Image(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "a.jpg"))
        db.add_image(pkg.Image(2, np.array([0.5, 0.5, 0.5, 0.5]), np.ones(3), 1, "b.jpg"))
        db.add_keypoints(1, np.array([[1.0, 2.0], [3.0, 4.0]]))
        db.add_matches(2, 1, np.array([[0, 1], [1, 0]]))
        db.close()
        con = sqlite3.connect(str(tmp_path / f"{tag}.db"))
        rows[tag] = {t: con.execute(f"SELECT * FROM {t}").fetchall()
                     for t in ("cameras", "images", "keypoints", "matches")}
        con.close()
    assert rows["t"] == rows["j"]
    assert tcm.image_ids_to_pair_id(5, 3) == jcm.image_ids_to_pair_id(5, 3)


def test_colmap_alignment_matches_jax(tmp_path):
    """`umeyama_sim3` within SIM3_TOL; `apply_sim3_to_model` with qvec and
    tvec within QUAT_TOL (float32 quaternions on both sides)."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3))
    R = tcm._rotmat_f32([0.9, 0.1, -0.2, 0.3]).astype(np.float64)
    dst = 2.5 * src @ R.T + [1.0, -2.0, 3.0] + rng.normal(0, 1e-3, (50, 3))
    got, want = tcm.umeyama_sim3(src, dst), jcm.umeyama_sim3(src, dst)
    assert abs(got[0] - want[0]) <= SIM3_TOL
    assert np.abs(got[1] - want[1]).max() <= SIM3_TOL and np.abs(got[2] - want[2]).max() <= SIM3_TOL
    s, Rs, t = got
    tm, jm = colmap_model(tcm), colmap_model(jcm)
    tcm.apply_sim3_to_model(*tm, s, Rs, t)
    jcm.apply_sim3_to_model(*jm, s, Rs, t)
    for k in tm[1]:
        assert np.abs(tm[1][k].qvec - jm[1][k].qvec).max() <= QUAT_TOL
        assert np.abs(tm[1][k].tvec - jm[1][k].tvec).max() <= QUAT_TOL
    assert np.array_equal(tm[2][3].xyz, jm[2][3].xyz)


def fixed_pose_vsd(n_videos=3, n_frames=4):
    K = np.asarray([[800.0, 0, 960], [0, 800.0, 540], [0, 0, 1]])
    R_c2e = np.asarray([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    rng = np.random.default_rng(5)
    vsd = {}
    for v in range(n_videos):
        frames = []
        for f in range(n_frames):
            yaw = rng.uniform(-0.3, 0.3)
            e = np.eye(4)
            e[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
            e[:3, 3] = [f * 5.0, v * 2.0, 0.0]
            cams = {}
            for cam, yaw_c in (("CAM_F0", 0.0), ("CAM_L0", 1.2), ("CAM_B0", np.pi)):
                c, s = np.cos(yaw_c), np.sin(yaw_c)
                Rz = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                cams[cam] = dict(data_path=f"{cam}/img_{v}_{f}.jpg", cam_intrinsic=K,
                                 distortion=np.asarray([0.1, -0.05, 0.001, 0.002, 0.0]),
                                 sensor2ego_rotation=[float(x) for x in tcm._quat_f32(Rz @ R_c2e)],
                                 sensor2ego_translation=[1.0, 0.0, 1.5])
            frames.append(dict(token=f"t{v}_{f}", ego2global=e, cams=cams,
                               skipped="low_velocity" if (v, f) == (1, 2) else False))
        vsd[f"blk-{v}"] = dict(video_token=f"blk-{v}", vehicle_name=f"veh{v % 2}",
                               frame_infos=frames)
    return vsd


def test_build_fixed_pose_model_matches_jax(tmp_path):
    """The same cameras, images, pairs and image_pairs.txt as JAX's; qvec
    and tvec within QUAT_TOL; the written model and database read back."""
    got = tcm.build_fixed_pose_model(fixed_pose_vsd(), tmp_path / "t", block_size=120.0,
                                     valid_fn=lambda f, c, ci: f["token"] != "t0_3")
    want = jcm.build_fixed_pose_model(fixed_pose_vsd(), tmp_path / "j", block_size=120.0,
                                      valid_fn=lambda f, c, ci: f["token"] != "t0_3")
    assert got[2] == want[2] and len(got[2]) > 10 and got[3] == want[3]
    assert ((tmp_path / "t" / "image_pairs.txt").read_bytes()
            == (tmp_path / "j" / "image_pairs.txt").read_bytes())
    assert {k: (c.model, c.params.tolist()) for k, c in got[0].items()} == {
        k: (c.model, c.params.tolist()) for k, c in want[0].items()}
    assert [(i.image_id, i.name, i.camera_id) for i in got[1].values()] == [
        (i.image_id, i.name, i.camera_id) for i in want[1].values()]
    for k in want[1]:
        assert np.abs(got[1][k].qvec - want[1][k].qvec).max() <= QUAT_TOL
        assert np.abs(got[1][k].tvec - want[1][k].tvec).max() <= QUAT_TOL
    cams, ims, pts = jcm.read_model(tmp_path / "t" / "sparse_model")
    assert len(cams) == len(want[0]) and len(ims) == len(want[1]) and not pts
    con = sqlite3.connect(str(tmp_path / "t" / "database.db"))
    assert con.execute("SELECT COUNT(*) FROM images").fetchone()[0] == len(want[1])
    con.close()
    sq = np.asarray([[0, 0], [2, 0], [2, 2], [0, 2]], np.float64)
    for other in (sq + [1.0, 1.0], sq + [5.0, 0.0], sq[::-1] + [0.5, -0.5]):
        assert tcm.convex_overlap_area(sq, other) == jcm.convex_overlap_area(sq, other)
    e = fixed_pose_vsd()["blk-0"]["frame_infos"][0]["ego2global"]
    K = np.asarray([[800.0, 0, 960], [0, 800.0, 540], [0, 0, 1]])
    assert np.array_equal(tcm.fov_triangle(K, e, 12.0), jcm.fov_triangle(K, e, 12.0))


def test_colmap_binary_gate_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert tcm.colmap_available() is jcm.colmap_available() is False
    for fn, args in (("run_point_triangulator", ("db", "img", "in", tmp_path / "o")),
                     ("run_bundle_adjuster", ("in", tmp_path / "o"))):
        with pytest.raises(RuntimeError) as got:
            getattr(tcm, fn)(*args)
        with pytest.raises(RuntimeError) as want:
            getattr(jcm, fn)(*args)
        assert str(got.value) == str(want.value)


# ------------------------------------------------- depth and semantics


def test_depth_codec_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    d = rng.uniform(0.0, 90.0, (32, 48)).astype(np.float32)
    enc = tdd.encode_depth_png(d)
    assert np.array_equal(enc, jdd.encode_depth_png(d)) and enc.dtype == np.uint8
    assert np.array_equal(tdd.decode_depth_png(enc), jdd.decode_depth_png(enc))
    lidar = np.where(rng.random(d.shape) < 0.3, d + rng.normal(0, 0.5, d.shape), 0.0)
    got = tdd.depth_error_report(tdd.decode_depth_png(enc), lidar)
    want = jdd.depth_error_report(jdd.decode_depth_png(enc), lidar)
    assert got == want
    # the gated writer's PNG: grey + alpha, as PIL writes a [H, W, 2] array
    from mtgs_torch.tools.render import write_png
    write_png(tmp_path / "d.png", enc)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "d.png")), enc)
    assert np.array_equal(read_image(tmp_path / "d.png"), enc)
    empty = tdd.depth_error_report(d, np.zeros_like(d))
    assert empty["n"] == 0 and all(math.isnan(empty[k]) for k in ("abs_rel", "rmse", "delta1"))


def test_model_stages_stay_gated_as_jax(tmp_path):
    """UniDepth and Mask2Former are not on the machine: the two writers
    raise JAX's messages before they read an image or touch a device."""
    assert tdd.unidepth_available() is jdd.unidepth_available() is False
    assert tsm.mask2former_available() is jsm.mask2former_available() is False
    with pytest.raises(RuntimeError) as got:
        tdd.generate_dense_depth([tmp_path / "a.jpg"], tmp_path / "out")
    with pytest.raises(RuntimeError) as want:
        jdd.generate_dense_depth([tmp_path / "a.jpg"], tmp_path / "out")
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError) as got:
        tsm.generate_semantic_masks([tmp_path / "a.jpg"], tmp_path / "out")
    with pytest.raises(RuntimeError) as want:
        jsm.generate_semantic_masks([tmp_path / "a.jpg"], tmp_path / "out")
    assert str(got.value) == str(want.value) and not (tmp_path / "out").exists()
    labels = np.random.default_rng(2).integers(0, 19, (16, 24)).astype(np.uint8)
    for ids in (tsm.VEHICLE_IDS, tsm.PERSON_IDS, [tsm.SKY_ID], range(10)):
        assert np.array_equal(tsm.class_mask(labels, ids), jsm.class_mask(labels, ids))
    assert tsm.CITYSCAPE_LABELS == jsm.CITYSCAPE_LABELS
    grey = labels
    assert np.array_equal(to_rgb(grey), np.asarray(Image.fromarray(grey).convert("RGB")))
    rgba = np.random.default_rng(3).integers(0, 256, (4, 5, 4)).astype(np.uint8)
    assert np.array_equal(to_rgb(rgba), np.asarray(Image.fromarray(rgba).convert("RGB")))


# ------------------------------------------------------------- driver


def test_pipeline_statuses_on_an_empty_root_match_jax(tmp_path, capsys):
    got = tpipe.run_pipeline(tmp_path, "block", {}, device="cpu")
    want = jpipe.run_pipeline(tmp_path, "block", {})
    assert got == want and len(got) == 8
    assert [s for s, _ in tpipe.STAGE_ORDER] == [s for s, _ in jpipe.STAGE_ORDER] == list(got)
    assert tpipe.STAGE_ORDER == jpipe.STAGE_ORDER
    for stage in ("video_split", "export_videos", "collect_raw", "semantic_masks",
                  "dense_depth"):
        assert got[stage].startswith("skipped"), stage
    # a subset, and the CLI on a RoadBlockConfig naming the empty block
    assert (tpipe.run_pipeline(tmp_path, "block", {}, start=2, stop=4, device="cpu")
            == jpipe.run_pipeline(tmp_path, "block", {}, start=2, stop=4))
    cfg = tmp_path / "rb.yaml"
    trb.save_yaml(trb.RoadBlockConfig(road_block_name="block", data_root=str(tmp_path),
                                      road_block=(0.0, 0.0, 10.0, 10.0)), cfg)
    capsys.readouterr()
    rc = tpipe.main(["--config", str(cfg), "--stop", "4", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert rc == jpipe.main(["--config", str(cfg), "--stop", "4"]) == 0
    assert printed == capsys.readouterr().out
    with pytest.raises(RuntimeError, match="skipping previews"):
        tpipe.run_pipeline(tmp_path, "block", {}, start=2, stop=2, skip_unavailable=False,
                           device="cpu")


def test_pipeline_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.run_pipeline(tmp_path, "block", {})
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.main([str(tmp_path), "block"])
    assert not (tmp_path / "block").exists()


# ------------------------------------------------------------ preview


@pytest.mark.parametrize("schema", ["raw", "registered", "can_bus"])
def test_preview_page_is_jaxs_byte_for_byte(tmp_path, schema):
    vsd = make_vsd(n_videos=4, n_frames=20, step=1.3)
    for info in vsd.values():
        for f in info["frame_infos"]:
            if schema != "registered":
                del f["ego2global"]
            if schema == "can_bus":
                del f["ego2global_translation"]
    for idx in (0, 3):
        assert np.array_equal(tpreview.trajectory_xy(vsd[f"log-{idx}"]),
                              jpreview.trajectory_xy(vsd[f"log-{idx}"]))
    kw = dict(selected=[0, {"idx": 2, "start_frame": 5, "end_frame": 15}],
              road_block=(-5, -5, 30, 30))
    for args in (kw, {}):
        got = tpreview.build_preview_html(vsd, tmp_path / "t.html", **args)
        want = jpreview.build_preview_html(vsd, tmp_path / "j.html", **args)
        assert got.read_bytes() == want.read_bytes()
    with pytest.raises(ValueError, match="no trajectories"):
        tpreview.build_preview_html({"a-0": dict(frame_infos=[])}, tmp_path / "x.html")


def test_preview_filter_and_main_match_jax(tmp_path, capsys):
    sel = [0, {"idx": 2, "start_frame": 5, "end_frame": 15}]
    for tag, vs_pkg, pv in (("t", tvs, tpreview), ("j", jvs, jpreview)):
        vs = vs_pkg.VideoScene(tmp_path, tag)
        vs.save(make_vsd(), "raw")
        pv.filter_trajectory(vs, sel)
    assert deep_equal(tvs.VideoScene(tmp_path, "t").load("filtered"),
                      jvs.VideoScene(tmp_path, "j").load("filtered"))
    assert tpreview.main([str(tmp_path), "t", "--out", str(tmp_path / "t.html")]) == 0
    assert jpreview.main([str(tmp_path), "j", "--out", str(tmp_path / "j.html")]) == 0
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    # --apply filters the newest stage (the filtered one) again
    assert tpreview.main([str(tmp_path), "t", "--apply", "[2]"]) == 0
    assert "1 videos kept" in capsys.readouterr().out
    assert list(tvs.VideoScene(tmp_path, "t").load("filtered")) == ["log-2"]


# ---------------------------------------------------- preview mosaics


def segment_distance(p, a, b):
    ab = b - a
    t = np.clip(((p - a) @ ab) / max(float(ab @ ab), 1e-12), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[:, None] * ab), axis=1)


def inset_off_by(got, want, trajs, pos, size):
    """Distance of each pixel where the two insets differ to the nearest
    drawn segment (its endpoints truncated as ImageDraw takes them) or the
    radius-4 dot's edge."""
    bad = np.argwhere(np.any(got != want, -1))[:, ::-1].astype(np.float64)
    allxy = np.concatenate(list(trajs.values()))
    lo, hi = allxy.min(0), allxy.max(0)
    span = float(np.maximum(hi - lo, 1e-6).max())

    def to_px(xy):
        return np.stack([10 + (xy[..., 0] - lo[0]) / span * (size - 20),
                         size - 10 - (xy[..., 1] - lo[1]) / span * (size - 20)], -1)

    dist = np.full(len(bad), np.inf)
    for xy in trajs.values():
        px = np.trunc(to_px(xy))
        for a, b in zip(px[:-1], px[1:]):
            dist = np.minimum(dist, segment_distance(bad, a, b))
    dot = to_px(pos[None])[0]
    return np.minimum(dist, np.maximum(np.linalg.norm(bad - dot, axis=1) - 4.0, 0.0))


INSET_TOL = 2.0  # pixels: the port's raster of the inset against ImageDraw's


def test_export_videos_matches_jax(tmp_path):
    """Camera tiles (PIL's bicubic resize of the decoded JPEGs) bit-equal;
    every inset pixel that differs from ImageDraw's lies within INSET_TOL
    of a drawn segment or the dot; the mosaic's layout is JAX's."""
    rng = np.random.default_rng(0)
    root = tmp_path / "scene"
    (root / "raw_images").mkdir(parents=True)
    vsd = {}
    for v in range(3):
        frames = []
        for f in range(3):
            rel = f"v{v}_{f}.jpg"
            Image.fromarray((rng.random((72, 128, 3)) * 255).astype(np.uint8)).save(
                root / "raw_images" / rel)
            x, y = f * 7.3 + v, v * 10.0 + np.sin(0.3 * f + v) * 5
            frames.append(dict(can_bus=np.array([x, y, 0.0, 1, 0, 0, 0]),
                               ego2global_translation=[x, y, 0.0],
                               cams={"CAM_F0": dict(data_path=rel),
                                     "CAM_L0": dict(data_path=rel),
                                     "CAM_R0": dict(data_path="missing.jpg")}))
        vsd[f"log-{v}"] = dict(video_token=f"log-{v}", frame_infos=frames)
    jvs.VideoScene(tmp_path, "scene").save(vsd, "raw")
    kw = dict(tile_width=96, make_video=False, max_frames=2)
    got = tev.export_traversal_videos(tvs.VideoScene(tmp_path, "scene"),
                                      out_dir=tmp_path / "t", **kw)
    want = jev.export_traversal_videos(jvs.VideoScene(tmp_path, "scene"),
                                       out_dir=tmp_path / "j", **kw)
    assert [p.relative_to(tmp_path / "t") for p in got] == [
        p.relative_to(tmp_path / "j") for p in want]
    assert len(got) == 6
    th = 96 * 72 // 128
    for g, w in zip(got, want):
        a, b = read_image(g), np.asarray(Image.open(w))
        assert a.shape == b.shape == (2 * th, 2 * 96, 3)
        # the three camera tiles (one of them the empty tile) are JAX's bits
        assert np.array_equal(a[:th], b[:th]) and np.array_equal(a[th:, :96], b[th:, :96])
    trajs = {v: jpreview.trajectory_xy(info) for v, info in enumerate(vsd.values())}
    for size in (th, 96, 180):
        for cur in range(3):
            pos = trajs[cur][1]
            t_inset = tev.bev_inset(trajs, cur, pos, size)
            j_inset = np.asarray(jev._bev_inset(trajs, cur, pos, size))
            assert t_inset.shape == j_inset.shape == (size, size, 3)
            assert np.array_equal(t_inset[0, 0], j_inset[0, 0])
            off = inset_off_by(t_inset, j_inset, trajs, pos, size)
            assert off.size == 0 or off.max() <= INSET_TOL, (size, cur, off.max())


def test_bicubic_resize_is_pils(tmp_path):
    """`resize_u8(..., bicubic=True)`: PIL's default `Image.resize` filter,
    bit for bit, down and up, grey and RGB."""
    from mtgs_torch.data.image_io import resize_u8

    rng = np.random.default_rng(7)
    for (h, w), (oh, ow) in (((1080, 1920), (180, 320)), ((37, 65), (90, 160)),
                             ((45, 45), (180, 320)), ((8, 8), (3, 5)), ((30, 40), (13, 77))):
        for shape in ((h, w, 3), (h, w)):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            want = np.asarray(Image.fromarray(img).resize((ow, oh)))
            assert np.array_equal(resize_u8(img, (ow, oh), bicubic=True), want), (shape, oh, ow)
    with pytest.raises(ValueError, match="not both"):
        resize_u8(img, (4, 4), nearest=True, bicubic=True)
