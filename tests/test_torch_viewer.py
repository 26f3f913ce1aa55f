"""The viewer: mtgs_torch.viewer.server against the JAX package's, and its
HTTP routes; the per-process weight caches of LPIPS and DINOv2; the JPEG
encoder at the viewer's quality.

One small scene (tests/test_torch_export.py's: 300 gaussians with
per-traversal SH rest and adapters, 2 traversals, built with the JAX
package's initialisers and carried across with `scene_from_state_dict`) is
served by both viewers at 32x32 from a camera that looks at it. The JAX
viewer renders one query through its own `render` (one compile of its
`_get_fn("index", 1)`, the XLA backend); the port's `_colorize` of each of
the four outputs is held against JAX's: rgb, accumulation and normal within
2e-3 (the slice's view tolerance), depth within DEPTH_TOL, 1e-3 (the ramp
scales the depth's f32 rounding by depth / (p98 - p02), and a pixel at the
0.5 accumulation edge can move the percentiles; 4.5e-6 here). The port's frames are PIL's
JPEG bytes at quality 85 for the same uint8 frame.
"""

import hashlib
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.viewer import server as jserver
from mtgs_torch.data import image_io
from mtgs_torch.eval import dinov2 as tdino
from mtgs_torch.eval import lpips as tlpips
from mtgs_torch.eval import pipeline as tpipe
from mtgs_torch.tools import export as texport
from mtgs_torch.viewer import server as tserver

import make_jpeg_manifest
from test_torch_export import small_scene, torch_batches
from test_torch_lpips_dinov2 import dinov2_weights, lpips_weights

MANIFEST = json.loads(make_jpeg_manifest.MANIFEST.read_text())
TOL = dict(rgb=2e-3, accumulation=2e-3, normal=2e-3)
DEPTH_TOL = 1e-3
# a camera at the origin looking along +x, at the scene (x in [3, 12])
QUERY = dict(px="0.2", py="-0.1", pz="0.1", yaw=str(np.pi), pitch="0.05", travel="1",
             t="0.3")


def get(url):
    """(status, headers, body) of a GET."""
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def decode(jpeg: bytes, tmp_path) -> np.ndarray:
    p = tmp_path / "frame.jpg"
    p.write_bytes(jpeg)
    return image_io.read_image(p)


@pytest.fixture(scope="module")
def viewers():
    s = small_scene(seed=2)
    params, aux, jcfg = s["jax"]
    t_params, t_aux, tcfg = s["torch"]
    cams = [{"c2w": v["c2w"][:3].reshape(-1).tolist(), "split": "train" if i < 2 else "eval"}
            for i, v in enumerate(s["views"])]
    kw = dict(travels=[0, 1], init_pos=(0.0, 0.0, 0.5), frame_of_travel={0: 0, 1: 2},
              cameras=cams)
    return dict(jax=jserver.ViewerServer(params, aux, jcfg, **kw),
                torch=tserver.ViewerServer(t_params, t_aux, tcfg, device="cpu", **kw),
                views=s["views"])


@pytest.fixture(scope="module")
def jax_outputs(viewers):
    """The JAX viewer's outputs and batch for QUERY, through its own render
    (the one JAX compile of this file)."""
    jsrv = viewers["jax"]
    fn = jsrv._get_fn("index", 1)
    seen = {}

    def spy(params, aux, batch):
        out = fn(params, aux, batch)
        seen.update(out=out, batch=batch)
        return out

    jsrv._render_fns[("index", 1)] = spy
    jpeg = jsrv.render(QUERY)
    return {k: np.asarray(v) for k, v in seen["out"].items()}, seen["batch"], jpeg


def test_page_is_the_jax_page():
    assert tserver._PAGE == jserver._PAGE.replace("mtgs_tpu", "mtgs_torch")
    assert tserver._PAGE.count("mtgs_torch") == 2
    for token in ("output", "frustums", "drawFrustums", "export?format=ply",
                  "export?format=splat", "lowres", "camera_path", "mean", "null"):
        assert token in tserver._PAGE, token


def test_request_matches_jax(viewers, jax_outputs):
    """The port builds the JAX viewer's camera, intrinsics and view."""
    _, jbatch, _ = jax_outputs
    mode, scale, batch, kind = viewers["torch"].request(QUERY)
    assert (mode, scale, kind) == ("index", 1, "rgb")
    np.testing.assert_allclose(batch.c2w, np.asarray(jbatch.c2w), atol=1e-6)
    np.testing.assert_array_equal(batch.K, np.asarray(jbatch.K))
    assert batch.travel_index == int(jbatch.travel_index) == 1
    assert batch.frame_idx == int(jbatch.frame_idx) == 2
    assert batch.timestamp == pytest.approx(float(jbatch.timestamp))
    assert viewers["torch"].request(dict(QUERY, travel="null", lowres="1"))[:2] == ("null", 4)


def test_colorize_matches_jax(viewers, jax_outputs, tmp_path):
    """All four outputs coloured as JAX colours them; the frame is PIL's
    JPEG at quality 85 of the port's uint8 frame."""
    jout, _, jpeg = jax_outputs
    tsrv = viewers["torch"]
    mode, scale, batch, _ = tsrv.request(QUERY)
    tout = tsrv.render_outputs(mode, scale, batch)
    acc = jout["accumulation"][..., 0]
    assert (acc > 0.5).mean() > 0.3, "the camera should see the scene"
    for kind in tserver.OUTPUTS:
        got = tsrv._colorize(tout, kind).numpy()
        want = jserver.ViewerServer._colorize(jout, kind)
        assert got.shape == want.shape == (32, 32, 3), kind
        err = float(np.abs(got - want).max())
        assert err <= TOL.get(kind, DEPTH_TOL), (kind, err)
    frame = tsrv.frame(tout, "rgb")
    assert frame.dtype == np.uint8 and frame.shape == (32, 32, 3)
    ours = tsrv.render(QUERY)
    assert ours == image_io.encode_jpeg(frame, quality=85)
    assert ours == make_jpeg_manifest.pil_jpeg(frame, quality=85)
    # JAX's PIL frame and the port's decode within a few levels of each other
    diff = np.abs(decode(jpeg, tmp_path).astype(int) - decode(ours, tmp_path).astype(int))
    assert diff.max() <= 8 and diff.mean() < 0.5, (diff.max(), diff.mean())


def test_colorize_empty_view_falls_back():
    """No pixel covered: the depth ramp spans (0, 1)."""
    out = dict(depth=torch.full((4, 4, 1), 0.25), accumulation=torch.zeros((4, 4, 1)))
    got = tserver.ViewerServer._colorize(out, "depth")
    want = jserver.ViewerServer._colorize({k: v.numpy() for k, v in out.items()}, "depth")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)


def test_export_matches_the_export_tool_and_jax(viewers, tmp_path):
    tsrv = viewers["torch"]
    fns = dict(ply=texport.export_ply, splat=texport.export_splat,
               pcd=texport.export_point_cloud)
    for fmt, fn in fns.items():
        body, name = tsrv.export(fmt)
        path = fn(tsrv.params.background, tsrv.aux.background, tmp_path / name)
        assert body == path.read_bytes(), fmt
        assert (name, viewers["jax"].export(fmt)[1]) == (name, name)
    assert tsrv.export("ply")[0] == viewers["jax"].export("ply")[0]
    with pytest.raises(ValueError, match="unknown export format xyz"):
        tsrv.export("xyz")


@pytest.fixture(scope="module")
def served(viewers):
    srv = viewers["torch"].make_server(0, "127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_routes(viewers, served, tmp_path):
    """Every route: the page, /meta, /render for each output, rung and
    traversal choice (JPEGs of the rung's size, byte-equal to render()),
    /export, 404 and 500."""
    tsrv = viewers["torch"]
    status, headers, body = get(served + "/")
    assert status == 200 and headers["Content-Type"] == "text/html"
    assert body.decode() == tserver._PAGE
    status, _, body = get(served + "/meta")
    meta = json.loads(body)
    assert status == 200 and meta["travels"] == [0, 1]
    assert meta["init_cam"] == {"pos": [0.0, 0.0, 0.5], "yaw": 0.0, "pitch": 0.0}
    assert meta["cameras"] == tsrv.cameras and len(meta["cameras"]) == 4
    for travel in ("0", "1", "mean", "null"):
        for lowres, size in (("0", 32), ("1", 8)):
            for output in tserver.OUTPUTS:
                q = dict(QUERY, travel=travel, lowres=lowres, output=output)
                status, headers, body = get(served + "/render?" + urllib.parse.urlencode(q))
                assert status == 200 and headers["Content-Type"] == "image/jpeg", q
                assert body[:2] == b"\xff\xd8" and body == tsrv.render(q), q
                assert decode(body, tmp_path).shape == (size, size, 3), q
    for fmt in ("ply", "splat", "pcd"):
        status, headers, body = get(served + f"/export?format={fmt}")
        want, name = tsrv.export(fmt)
        assert status == 200 and body == want
        assert headers["Content-Disposition"] == f'attachment; filename="{name}"'
    status, _, body = get(served + "/export?format=xyz")
    assert status == 500 and body == b"unknown export format xyz"
    status, _, body = get(served + "/render?travel=abc")
    assert status == 500 and b"abc" in body
    assert get(served + "/nope")[0] == 404


def test_concurrent_renders_are_serialised(viewers, served):
    """Eight clients at once: every frame equals the frame rendered alone."""
    q = urllib.parse.urlencode(dict(QUERY, output="depth"))
    want = viewers["torch"].render(dict(QUERY, output="depth"))
    got = [None] * 8

    def client(i):
        got[i] = get(served + "/render?" + q)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(g[0] == 200 and g[2] == want for g in got)


def test_viewer_raises_without_a_card(viewers, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tsrv = viewers["torch"]
    with pytest.raises(RuntimeError, match="cuda"):
        tserver.ViewerServer(tsrv.params, tsrv.aux, tsrv.cfg)


@pytest.mark.parametrize("entry", MANIFEST["arrays"], ids=lambda e: e["name"])
def test_encode_jpeg_quality_85_matches_pil_and_the_manifest(entry):
    """The viewer's quality: PIL's bytes and the manifest's q85 hashes; the
    default stays PIL's default (quality 75)."""
    img = make_jpeg_manifest.make_array(entry)
    data = image_io.encode_jpeg(img, quality=85)
    assert data == make_jpeg_manifest.pil_jpeg(img, quality=85)
    assert hashlib.sha256(data).hexdigest() == entry["q85"]["sha256"]
    assert len(data) == entry["q85"]["bytes"]
    assert image_io.encode_jpeg(img) == image_io.encode_jpeg(img, quality=75)


@pytest.mark.parametrize("quality", [1, 10, 49, 50, 90, 100])
def test_encode_jpeg_qualities_match_pil(quality):
    img = np.random.default_rng(quality).integers(0, 256, (19, 35, 3), np.uint8)
    assert image_io.encode_jpeg(img, quality) == make_jpeg_manifest.pil_jpeg(img, quality)
    for bad in (0, 101):
        with pytest.raises(ValueError, match="quality"):
            image_io.encode_jpeg(img, bad)


def test_second_evaluate_scene_reads_no_weight_file(tmp_path, monkeypatch):
    """evaluate_scene twice in one process with both weight files present:
    each loader runs once (the second call reads no file), and the two
    results are equal. A corrupt file raises naming it, on both calls: a
    failed load is not cached."""
    s = small_scene(seed=1)
    t_params, t_aux, tcfg = s["torch"]
    rng = np.random.default_rng(5)
    np.savez(tmp_path / "lpips.npz", **lpips_weights(rng))
    np.savez(tmp_path / "dinov2.npz", **dinov2_weights(rng))
    monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    monkeypatch.setenv("MTGS_DINOV2_WEIGHTS", str(tmp_path / "dinov2.npz"))
    reads = dict(lpips=0, dinov2=0)

    def counted(mod, name):
        load = mod.load_weights

        def call(*a, **kw):
            reads[name] += 1
            return load(*a, **kw)
        monkeypatch.setattr(mod, "load_weights", call)

    counted(tlpips, "lpips")
    counted(tdino, "dinov2")
    tlpips.cached_weights.cache_clear()
    tdino.cached_weights.cache_clear()
    try:
        first = tpipe.evaluate_scene(t_params, t_aux, tcfg, torch_batches(s["views"]),
                                     device="cpu")
        assert reads == dict(lpips=1, dinov2=1)
        second = tpipe.evaluate_scene(t_params, t_aux, tcfg, torch_batches(s["views"]),
                                      device="cpu")
        assert reads == dict(lpips=1, dinov2=1)
        assert {"lpips", "dinov2_sim"} <= set(first)
        assert {k: v for k, v in first.items() if k != "fps"} == \
            {k: v for k, v in second.items() if k != "fps"}

        (tmp_path / "junk.npz").write_bytes(b"not an npz")
        monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(tmp_path / "junk.npz"))
        for _ in range(2):
            with pytest.raises(ValueError, match="junk.npz: cannot read LPIPS"):
                tpipe.evaluate_scene(t_params, t_aux, tcfg, torch_batches(s["views"]),
                                     device="cpu")
        assert reads["lpips"] == 3
        monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
        monkeypatch.setenv("MTGS_DINOV2_WEIGHTS", str(tmp_path / "junk.npz"))
        for _ in range(2):
            with pytest.raises(ValueError, match="junk.npz: cannot read DINOv2"):
                tpipe.evaluate_scene(t_params, t_aux, tcfg, torch_batches(s["views"]),
                                     device="cpu")
        assert reads == dict(lpips=3, dinov2=3)
    finally:
        tlpips.cached_weights.cache_clear()
        tdino.cached_weights.cache_clear()
