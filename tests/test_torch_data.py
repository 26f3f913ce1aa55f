"""The port's nuPlan data layer against the JAX package's, and its own image
decoders against PIL: `image_io` (JPEG and PNG decoding, luma, resize),
`utils/pointcloud.py`, `data/nuplan.py::parse_scene`,
`data/dataset.py::load_sample` and `data/loader.py` on a 96x64 road block
written by `tests/make_nuplan_fixture.py`, and the committed 1920x1080
fixture's JPEGs against its manifest."""

import dataclasses
import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import make_nuplan_fixture as fixture
from mtgs_tpu.data import dataset as jds
from mtgs_tpu.data import loader as jloader
from mtgs_tpu.data import nuplan as jnuplan
from mtgs_tpu.utils import pointcloud as jpc
from mtgs_torch.data import dataset as tds
from mtgs_torch.data import image_io
from mtgs_torch.data import loader as tloader
from mtgs_torch.data import nuplan as tnuplan
from mtgs_torch.utils import pointcloud as tpc

W, H = 96, 64
JPEG_MAX_SHARE = 1e-3   # pixels off PIL's by one level, at most (none so far)


@pytest.fixture(scope="module")
def mini_block(tmp_path_factory):
    """The fixture's road block at 96x64 (a moving vehicle: dynamic
    instance poses), with a panoptic PNG beside the first frame."""
    root = tmp_path_factory.mktemp("road_block")
    block = fixture.make_block(moving_vehicle=True)
    fixture.write_images(root, block, W, H)
    fixture.write_runtime_files(root, block, W, H, n_seed=3000, n_vehicle=400, beams=16,
                                azimuths=256)
    rng = np.random.default_rng(5)
    pan = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    Image.fromarray(pan).save(root / "panoptic.png")
    return root


def _pil(path):
    return np.asarray(Image.open(path))


def _smooth_noisy(rng, h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(x / 5.0 + k) * np.cos(y / 9.0 - k) for k in range(c)], -1)
    return np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(np.uint8)


def _assert_jpeg_close(path, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((diff > 0).mean())
    print(f"{Path(path).name}: max diff {diff.max()}, share of pixels differing {share:.2e}")
    assert diff.max() <= 1 and share < JPEG_MAX_SHARE


# ------------------------------------------------------------------ JPEG

@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [75, 100])
def test_jpeg_matches_pil(tmp_path, subsampling, quality):
    rng = np.random.default_rng(subsampling * 7 + quality)
    for h, w in [(43, 61), (9, 17), (2, 3)]:
        p = tmp_path / f"{h}x{w}.jpg"
        Image.fromarray(_smooth_noisy(rng, h, w, 3)).save(p, quality=quality,
                                                         subsampling=subsampling)
        _assert_jpeg_close(p, image_io.read_image(p), _pil(p))
        _assert_jpeg_close(p, image_io.to_luma(p), np.asarray(Image.open(p).convert("L")))


@pytest.mark.parametrize("kind", ["grey", "restart_blocks", "restart_rows"])
def test_jpeg_grey_and_restart_intervals(tmp_path, kind):
    rng = np.random.default_rng(3)
    p = tmp_path / f"{kind}.jpg"
    if kind == "grey":
        Image.fromarray(_smooth_noisy(rng, 37, 53, 1)[..., 0]).save(p, quality=90)
    else:
        key = "restart_marker_blocks" if kind == "restart_blocks" else "restart_marker_rows"
        Image.fromarray(_smooth_noisy(rng, 70, 101, 3)).save(p, quality=85, **{key: 2})
        assert b"\xff\xdd" in p.read_bytes()  # a DRI segment
    _assert_jpeg_close(p, image_io.read_image(p), _pil(p))


def test_fixture_jpegs_match_pil_and_the_manifest():
    """All 12 committed 1920x1080 JPEGs: the SHA-256 of the decode equals
    the manifest's (PIL's decode); two are also compared pixel by pixel."""
    man = json.loads((fixture.FIXTURE / "manifest.json").read_text())
    assert len(man["images"]) == fixture.N_TRAVELS * fixture.N_FRAMES
    for k, (rel, entry) in enumerate(sorted(man["images"].items())):
        got = image_io.read_image(fixture.FIXTURE / rel)
        assert got.shape == (fixture.HEIGHT, fixture.WIDTH, 3)
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], rel
        np.testing.assert_allclose(fixture.block_means(got), entry["block_means"], atol=1e-5)
        if k < 2:
            _assert_jpeg_close(rel, got, _pil(fixture.FIXTURE / rel))


def test_unsupported_jpegs_raise(tmp_path):
    img = Image.fromarray(_smooth_noisy(np.random.default_rng(0), 32, 40, 3))
    img.save(tmp_path / "progressive.jpg", quality=80, progressive=True)
    img.convert("CMYK").save(tmp_path / "cmyk.jpg")
    with pytest.raises(ValueError, match="progressive.jpg: unsupported: progressive"):
        image_io.read_image(tmp_path / "progressive.jpg")
    with pytest.raises(ValueError, match="4-component"):
        image_io.read_image(tmp_path / "cmyk.jpg")
    (tmp_path / "cut.jpg").write_bytes((tmp_path / "progressive.jpg").read_bytes()[:2]
                                       + b"\xff\xd9")
    with pytest.raises(ValueError, match="cut.jpg"):
        image_io.read_image(tmp_path / "cut.jpg")
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(64))
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        image_io.read_image(tmp_path / "x.bmp")


# ------------------------------------------------------------------- PNG

def _png_bytes(raw_rows: np.ndarray, w: int, h: int, depth: int, ctype: int, *,
               interlace: int = 0, palette=None, rng=None) -> bytes:
    """A PNG of packed rows [h, stride], each row filtered with a filter
    type drawn from `rng` (0-4) when given, else 0."""
    bpp = max(depth * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] // 8, 1)
    out = []
    prev = np.zeros(raw_rows.shape[1], np.int32)
    for y in range(h):
        row = raw_rows[y].astype(np.int32)
        ft = int(rng.integers(0, 5)) if rng is not None else 0
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 0:
            enc = row
        elif ft == 1:
            enc = row - left
        elif ft == 2:
            enc = row - prev
        elif ft == 3:
            enc = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = row - pred
        out.append(bytes([ft]) + (enc % 256).astype(np.uint8).tobytes())
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    data = zlib.compress(b"".join(out))
    return (image_io.PNG_MAGIC + body + chunk(b"IDAT", data[:len(data) // 2])
            + chunk(b"IDAT", data[len(data) // 2:]) + chunk(b"IEND", b""))


def _pack(values: np.ndarray, depth: int) -> np.ndarray:
    """Rows of samples [h, n] packed at `depth` bits, big-endian as in PNG."""
    h, n = values.shape
    per = 8 // depth
    pad = (-n) % per
    v = np.concatenate([values, np.zeros((h, pad), values.dtype)], 1).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (v.astype(np.uint16) << shifts).sum(-1).astype(np.uint8)


PIL_MODES = ["L", "RGB", "RGBA", "LA", "1", "P", "P-4colours", "I;16"]


@pytest.mark.parametrize("mode", PIL_MODES)
def test_png_written_by_pil_is_decoded_exactly(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    a = rng.integers(0, 256, (37, 53, 4)).astype(np.uint8)
    img = {
        "L": lambda: Image.fromarray(a[..., 0]),
        "RGB": lambda: Image.fromarray(a[..., :3]),
        "RGBA": lambda: Image.fromarray(a),
        "LA": lambda: Image.fromarray(a[..., :2], "LA"),
        "1": lambda: Image.fromarray(a[..., 0] > 128),
        "P": lambda: Image.fromarray(a[..., :3]).convert("P", palette=Image.ADAPTIVE,
                                                         colors=200),
        "P-4colours": lambda: Image.fromarray(a[..., :3]).convert(
            "P", palette=Image.ADAPTIVE, colors=4),
        "I;16": lambda: Image.fromarray(rng.integers(0, 65536, (37, 53)).astype(np.uint16)),
    }[mode]()
    p = tmp_path / "x.png"
    img.save(p)
    want, got = _pil(p), image_io.read_image(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.to_luma(p), np.asarray(Image.open(p).convert("L")))


@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2),
                                         (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (8, 6)])
def test_png_every_filter_depth_and_colour_type(tmp_path, depth, ctype):
    """Hand-written PNGs with random row filters (None, Sub, Up, Average,
    Paeth) at every supported depth and colour type, against PIL."""
    rng = np.random.default_rng(depth * 10 + ctype)
    w, h = 29, 23
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
    if depth == 16:
        vals = rng.integers(0, 65536, (h, w))
        rows = vals.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = rng.integers(0, 256, (h, w * ch)).astype(np.uint8)
    else:
        rows = _pack(rng.integers(0, 1 << depth, (h, w)), depth)
    p = tmp_path / "x.png"
    p.write_bytes(_png_bytes(rows, w, h, depth, ctype, palette=palette, rng=rng))
    want, got = _pil(p), image_io.read_image(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.to_luma(p), np.asarray(Image.open(p).convert("L")))


def test_unsupported_pngs_raise(tmp_path):
    rows = np.zeros((4, 4 * 6), np.uint8)
    (tmp_path / "rgb16.png").write_bytes(_png_bytes(rows, 4, 4, 16, 2))
    with pytest.raises(ValueError, match="rgb16.png: unsupported: PNG colour type 2 at 16"):
        image_io.read_image(tmp_path / "rgb16.png")
    (tmp_path / "adam7.png").write_bytes(_png_bytes(np.zeros((4, 4), np.uint8), 4, 4, 8, 0,
                                                    interlace=1))
    with pytest.raises(ValueError, match="adam7.png: unsupported: interlaced"):
        image_io.read_image(tmp_path / "adam7.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "ok.png")
    cut = (tmp_path / "ok.png").read_bytes()
    (tmp_path / "cut.png").write_bytes(cut[:len(cut) - 30])
    with pytest.raises(ValueError, match="cut.png"):
        image_io.read_image(tmp_path / "cut.png")


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("scale", [0.5, 0.25, 0.37])
def test_resize_matches_pil_float_images(scale):
    rng = np.random.default_rng(int(scale * 100))
    for h, w in [(37, 53), (64, 96), (270, 480)]:
        img = rng.normal(size=(h, w, 3)).astype(np.float32)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        for nearest, mode in ((False, Image.BILINEAR), (True, Image.NEAREST)):
            want = np.stack([np.asarray(Image.fromarray(img[..., c], mode="F").resize(
                (nw, nh), mode)) for c in range(3)], -1)
            got = image_io.resize(img, scale, nearest=nearest)
            assert got.shape == want.shape and got.dtype == np.float32
            if nearest:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        got2d = image_io.resize(img[..., 1], scale)
        np.testing.assert_array_equal(got2d, image_io.resize(img, scale)[..., 1])


# ------------------------------------------------------------ point clouds

def test_pointcloud_io_and_filters_match_jax(mini_block, tmp_path):
    pcd = mini_block / "stacked_point_cloud" / "background.pcd"
    for a, b in zip(tpc.load_pcd(pcd), jpc.load_pcd(pcd)):
        np.testing.assert_array_equal(a, b)
    xyz, rgb = tpc.load_pcd(pcd)
    assert len(xyz) == 3000 and rgb.max() <= 255
    lines = ["VERSION 0.7", "FIELDS x y z intensity", "SIZE 4 4 4 4", "TYPE F F F F",
             "COUNT 1 1 1 1", "WIDTH 5", "HEIGHT 1", "POINTS 5", "DATA ascii"]
    body = "\n".join(" ".join(f"{v:.4f}" for v in r) for r in np.random.default_rng(1).random((5, 4)))
    (tmp_path / "a.pcd").write_text("\n".join(lines) + "\n" + body + "\n")
    np.save(tmp_path / "p.npy", np.concatenate([xyz[:50], rgb[:50]], 1))
    tpc.save_pcd_npz(tmp_path / "p.npz", xyz[:50], rgb[:50])
    for name in ("a.pcd", "p.npy", "p.npz"):
        for a, b in zip(tpc.load_pcd(tmp_path / name), jpc.load_pcd(tmp_path / name)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpc.statistical_outlier_removal(xyz, k=10),
                                  jpc.statistical_outlier_removal(xyz, k=10))
    for a, b in zip(tpc.voxel_downsample(xyz, rgb, 0.5), jpc.voxel_downsample(xyz, rgb, 0.5)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- parsing

def _assert_same(a, b, where=""):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("split,kw", [
    ("train", dict(train_travels=[0, 1], eval_travels=[2])),
    ("val", dict(train_travels=[0, 1], eval_travels=[2], load_points=False)),
    ("train", dict(manual_split=True)),
    ("val", dict(eval_2hz=False, load_points=False)),
])
def test_parse_scene_matches_jax(mini_block, split, kw):
    got = tnuplan.parse_scene(mini_block, cameras=("CAM_F0",), split=split, **kw)
    want = jnuplan.parse_scene(mini_block, cameras=("CAM_F0",), split=split, **kw)
    _assert_same(got, want, "scene")
    assert got.records and got.num_frame_rows == len(got.records)
    if kw.get("load_points", True):
        assert got.seed_xyz is not None and got.instances
        assert not any(i.is_static for i in got.instances)  # the moving vehicle
    if split == "val" and "train_travels" in kw:
        assert got.nearest_train_travel_of_eval[2] in (0, 1)
    assert tnuplan.chamfer_distance(np.zeros((3, 3)), np.ones((2, 3))) == \
        jnuplan.chamfer_distance(np.zeros((3, 3)), np.ones((2, 3)))


# ------------------------------------------------------------- samples

def _sample_close(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if k == "image":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1 / 255 + 1e-6)
        elif k == "K":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(scale_factor=0.37, mask_all_foreground=True),
    dict(scale_factor=1.0, undistort="keep_focal_length", load_panoptic=True),
    dict(fake_data=True),
])
def test_load_sample_matches_jax(mini_block, cfg):
    tscene = tnuplan.parse_scene(mini_block, cameras=("CAM_F0",), load_points=False)
    jscene = jnuplan.parse_scene(mini_block, cameras=("CAM_F0",), load_points=False)
    recs = [0, 5] if not cfg.get("load_panoptic") else [0]
    for i in recs:
        tr, jr = tscene.records[i], jscene.records[i]
        if cfg.get("load_panoptic"):
            tr = dataclasses.replace(tr, panoptic_mask_path=str(mini_block / "panoptic.png"))
            jr = dataclasses.replace(jr, panoptic_mask_path=str(mini_block / "panoptic.png"))
        got = tds.load_sample(tr, tds.SampleConfig(**cfg))
        want = jds.load_sample(jr, jds.SampleConfig(**cfg))
        _sample_close(got, want)
        if cfg.get("load_panoptic"):
            assert {"instance_map", "semantic_map"} <= set(got)
        if not cfg:
            assert {"lidar_depth", "pseudo_depth"} <= set(got)
            assert (got["lidar_depth"] > 0).any() and (got["pseudo_depth"] > 0).any()
            assert 0 < got["mask"].mean() < 1  # ego mask, pedestrian, undistortion border


def test_samplers_match_jax():
    a, b = tloader.CameraSampler(7, seed=3), jloader.CameraSampler(7, seed=3)
    assert [next(a) for _ in range(20)] == [next(b) for _ in range(20)]
    travel = np.array([0, 0, 0, 1, 1, 2])
    a = tloader.TraversalBalancedSampler(travel, seed=4)
    b = jloader.TraversalBalancedSampler(travel, seed=4)
    assert [next(a) for _ in range(50)] == [next(b) for _ in range(50)]


def _batch_close(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        if isinstance(g, torch.Tensor):
            assert g.device.type == "cpu" and g.dtype == torch.float32, f.name
            g = g.numpy()
        np.testing.assert_array_equal(np.asarray(g, w.dtype), w, err_msg=f.name)


@pytest.mark.parametrize("balanced", [False, True])
def test_batches_and_data_iterator_match_jax(mini_block, balanced):
    kw = dict(cameras=("CAM_F0",), train_travels=[0, 1], load_points=False)
    tscene, jscene = tnuplan.parse_scene(mini_block, **kw), jnuplan.parse_scene(mini_block, **kw)
    cfg = dict(scale_factor=0.5)
    tcache = tloader.SampleCache(tscene.records, tds.SampleConfig(**cfg), strategy="on_demand")
    jcache = jloader.SampleCache(jscene.records, jds.SampleConfig(**cfg), strategy="on_demand")
    _batch_close(tloader.batch_from_sample(tscene.records[3], tcache.get(3), device="cpu"),
                 jloader.batch_from_sample(jscene.records[3], jcache.get(3)))
    got = tloader.data_iterator(tscene, tds.SampleConfig(**cfg), balanced=balanced,
                                strategy="prefetch", num_workers=3, seed=2, device="cpu")
    want = jloader.data_iterator(jscene, jds.SampleConfig(**cfg), balanced=balanced,
                                 strategy="on_demand", seed=2)
    for _ in range(5):
        _batch_close(next(got), next(want))


def test_staged_iterator_factory_scales_and_releases(mini_block):
    scene = tnuplan.parse_scene(mini_block, cameras=("CAM_F0",), load_points=False)
    factory = tloader.staged_iterator_factory(scene, tds.SampleConfig(scale_factor=0.5),
                                              strategy="on_demand", device="cpu")
    assert next(factory(0.5)).image.shape == (H // 4, W // 4, 3)
    assert next(factory(1.0)).image.shape == (H // 2, W // 2, 3)
