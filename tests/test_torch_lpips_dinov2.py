"""LPIPS and DINOv2 scoring, PIL-exact uint8 resampling and the JPEG encoder:
mtgs_torch vs the JAX package and PIL.

No pretrained weights are in the repo, so both forwards are held against
JAX's on seeded random weights: LPIPS at AlexNet's widths on 64x64 images
within rel 1e-4, abs 1e-6 (tests/test_lpips.py's tolerance), DINOv2 at a
narrow width (D 32, 2 layers, 4 heads) with the released 37x37 position grid
within atol 2e-4, rtol 1e-3 (tests/test_dinov2_jax.py's). The metric
callables and `evaluate_scene` with both metrics on read the same `.npz`
files as JAX's (1e-5; 1e-4 through `evaluate_scene`). `resize_u8` and
`write_jpeg` are bit- and byte-equal to PIL; tests/fixtures/jpeg_manifest.json
holds PIL's hashes for the arrays `chip_smoke.py` checks on the card.
"""

import functools
import hashlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
import mtgs_tpu.eval as jeval
from mtgs_tpu.eval import dinov2 as jdino_metric
from mtgs_tpu.eval import dinov2_jax as jdino
from mtgs_tpu.eval import lpips_jax as jlpips
from mtgs_tpu.eval import pipeline as jpipe
import mtgs_torch.eval as teval
from mtgs_torch.data import image_io
from mtgs_torch.eval import dinov2 as tdino
from mtgs_torch.eval import lpips as tlpips
from mtgs_torch.eval import pipeline as tpipe

import make_jpeg_manifest
from test_torch_export import jax_batches, small_scene, torch_batches


def lpips_weights(rng):
    params, in_ch = {}, 3
    for i, (out_ch, k, _, _, _) in enumerate(jlpips._ALEX):
        params[f"conv{i}_w"] = (rng.standard_normal((out_ch, in_ch, k, k)) * 0.1).astype(
            np.float32)
        params[f"conv{i}_b"] = (rng.standard_normal(out_ch) * 0.1).astype(np.float32)
        params[f"lin{i}_w"] = rng.random(out_ch).astype(np.float32)
        in_ch = out_ch
    return params


def dinov2_weights(rng, D=32, heads=4, layers=2, grid=37, patch=14):
    """Canonical-layout weights: LayerNorms near 1, LayerScale 0.1-1."""
    f = lambda *s, scale=0.1: (rng.standard_normal(s) * scale).astype(np.float32)
    w = dict(patch_w=f(D, 3, patch, patch, scale=0.05), patch_b=f(D), cls=f(D),
             pos=f(1 + grid * grid, D), norm_w=1 + f(D), norm_b=f(D),
             heads=np.asarray(heads), patch=np.asarray(patch))
    for i in range(layers):
        w.update({f"L{i}_{k}": f(D, D, scale=D ** -0.5) for k in ("q_w", "k_w", "v_w", "o_w")})
        w.update({f"L{i}_{k}": f(D) for k in ("q_b", "k_b", "v_b", "o_b", "n1_b", "n2_b",
                                                "fc2_b")})
        w.update({f"L{i}_n1_w": 1 + f(D), f"L{i}_n2_w": 1 + f(D),
                  f"L{i}_ls1": rng.uniform(0.1, 1, D).astype(np.float32),
                  f"L{i}_ls2": rng.uniform(0.1, 1, D).astype(np.float32),
                  f"L{i}_fc1_w": f(4 * D, D, scale=D ** -0.5), f"L{i}_fc1_b": f(4 * D),
                  f"L{i}_fc2_w": f(D, 4 * D, scale=(4 * D) ** -0.5)})
    return w


def tensors(w):
    return {k: (int(v) if k in ("heads", "patch") else torch.from_numpy(v)) for k, v in w.items()}


@pytest.fixture
def clear_jax_caches():
    jlpips._jitted.cache_clear()
    jdino.get_dinov2_jax.cache_clear()
    yield
    jlpips._jitted.cache_clear()
    jdino.get_dinov2_jax.cache_clear()


def test_eval_package_exports_match():
    names = [n for n in dir(jeval) if not n.startswith("_") and n[0] != n[0].upper()
             and callable(getattr(jeval, n))]
    assert {"evaluate_scene", "image_metrics", "masked_psnr"} <= set(names)
    for n in names + ["EvalConfig"]:
        assert hasattr(teval, n), n
    assert tpipe.EvalConfig() == tpipe.EvalConfig(color_corrected=True, lpips=True, dinov2=True)


def test_lpips_forward_matches_jax():
    rng = np.random.default_rng(0)
    params = lpips_weights(rng)
    img1 = rng.random((64, 64, 3)).astype(np.float32)
    img2 = np.clip(img1 + 0.1 * rng.standard_normal((64, 64, 3)), 0, 1).astype(np.float32)
    img1[0, 0] = [1.5, -0.2, 0.5]  # clipped to [0, 1] first
    tp = tensors(params)
    got = float(tlpips.lpips_forward(tp, torch.from_numpy(img1), torch.from_numpy(img2)))
    want = float(jax.jit(functools.partial(jlpips.lpips_forward, params))(img1, img2))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-6), (got, want)
    assert got > 0
    assert abs(float(tlpips.lpips_forward(tp, torch.from_numpy(img1),
                                          torch.from_numpy(img1)))) < 1e-8


def test_lpips_loaders(tmp_path, monkeypatch, clear_jax_caches):
    """A missing file gives None in both packages; a file at
    MTGS_LPIPS_WEIGHTS gives both the same metric; a malformed one raises in
    the port, naming the file (JAX's loader returns None there)."""
    monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert tlpips.get_lpips(device="cpu") is None and jlpips.get_lpips_jax() is None
    rng = np.random.default_rng(1)
    params = lpips_weights(rng)
    params["lin0_w"] = params["lin0_w"].reshape(1, -1, 1, 1)  # the richzhang layout reads too
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **params)
    monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(path))
    fn, jfn = tlpips.get_lpips(device="cpu"), jlpips.get_lpips_jax()
    a = rng.random((48, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.05, 0, 1).astype(np.float32)
    assert fn(torch.from_numpy(a), b) == pytest.approx(jfn(a, b), rel=1e-4, abs=1e-6)

    bad = dict(params, conv2_w=params["conv2_w"][:, :100])
    np.savez(tmp_path / "bad.npz", **bad)
    (tmp_path / "junk.npz").write_bytes(b"not an npz")
    for name, match in (("bad.npz", "conv2_w has shape"), ("junk.npz", "cannot read")):
        monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(tmp_path / name))
        with pytest.raises(ValueError, match=match) as e:
            tlpips.get_lpips(device="cpu")
        assert name in str(e.value)


def test_dinov2_forward_matches_jax():
    rng = np.random.default_rng(2)
    w = dinov2_weights(rng)
    img = rng.normal(size=(518, 518, 3)).astype(np.float32)
    got = tdino.dinov2_forward(tensors(w), torch.from_numpy(img)).numpy()
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    want = np.asarray(jax.jit(functools.partial(jdino.dinov2_forward, jw))(jnp.asarray(img)))
    assert got.shape == want.shape == (37 * 37, 32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    for hw in ((504, 518), (520, 518)):
        with pytest.raises(ValueError, match="grid"):
            tdino.dinov2_forward(tensors(w), torch.zeros(hw + (3,)))


def test_convert_state_dict_matches_jax():
    """`convert_state_dict` on a transformers `Dinov2Model` state dict gives
    what JAX's `convert_transformers` gives for that model (a stand-in with
    its state dict and config: transformers is not needed to convert)."""
    rng = np.random.default_rng(3)
    w = dinov2_weights(rng, D=16, heads=2, layers=3, grid=2)
    names = dict(n1_w="norm1.weight", n1_b="norm1.bias",
                 q_w="attention.attention.query.weight", q_b="attention.attention.query.bias",
                 k_w="attention.attention.key.weight", k_b="attention.attention.key.bias",
                 v_w="attention.attention.value.weight", v_b="attention.attention.value.bias",
                 o_w="attention.output.dense.weight", o_b="attention.output.dense.bias",
                 ls1="layer_scale1.lambda1", n2_w="norm2.weight", n2_b="norm2.bias",
                 fc1_w="mlp.fc1.weight", fc1_b="mlp.fc1.bias", fc2_w="mlp.fc2.weight",
                 fc2_b="mlp.fc2.bias", ls2="layer_scale2.lambda1")
    sd = {"embeddings.patch_embeddings.projection.weight": w["patch_w"],
          "embeddings.patch_embeddings.projection.bias": w["patch_b"],
          "embeddings.cls_token": w["cls"][None, None],
          "embeddings.position_embeddings": w["pos"][None],
          "embeddings.mask_token": w["cls"][None],
          "layernorm.weight": w["norm_w"], "layernorm.bias": w["norm_b"]}
    for i in range(3):
        sd.update({f"encoder.layer.{i}.{n}": w[f"L{i}_{k}"] for k, n in names.items()})
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    model = types.SimpleNamespace(
        state_dict=lambda: sd,
        config=types.SimpleNamespace(num_attention_heads=2, patch_size=14))
    got = tdino.convert_state_dict(sd, heads=2, patch=14)
    want = jdino.convert_transformers(model)
    assert got.keys() == want.keys() == w.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]) and np.array_equal(got[k], w[k]), k


def test_dinov2_metric_matches_jax(tmp_path, monkeypatch, clear_jax_caches):
    """The full metric (resize and crop through PIL's 8-bit path, the
    forward, mask-weighted cosines) against `get_dinov2_jax` on one .npz."""
    rng = np.random.default_rng(4)
    monkeypatch.setenv("MTGS_DINOV2_WEIGHTS", str(tmp_path / "absent.npz"))
    assert tdino.get_dinov2(device="cpu") is None and jdino.get_dinov2_jax() is None
    jdino.get_dinov2_jax.cache_clear()
    path = tmp_path / "dinov2.npz"
    np.savez(path, **dinov2_weights(rng))
    monkeypatch.setenv("MTGS_DINOV2_WEIGHTS", str(path))
    fn, jfn = tdino.get_dinov2(device="cpu"), jdino.get_dinov2_jax()
    pred = rng.uniform(-0.1, 1.1, (40, 60, 3)).astype(np.float32)
    gt = np.clip(pred + 0.1 * rng.normal(size=pred.shape), 0, 1).astype(np.float32)
    mask = np.ones((40, 60), np.float32)
    mask[:, :25] = 0.0
    for m in (mask, None):
        assert fn(torch.from_numpy(pred), gt, m) == pytest.approx(jfn(pred, gt, m), abs=1e-5)
    assert fn(pred, pred) == pytest.approx(1.0, abs=1e-5)
    assert fn(pred, gt, np.zeros((40, 60), np.float32)) is None
    assert jfn(pred, gt, np.zeros((40, 60), np.float32)) is None

    bad = dinov2_weights(rng)
    bad["L1_fc2_w"] = bad["L1_fc2_w"][:, :5]
    np.savez(tmp_path / "bad.npz", **bad)
    monkeypatch.setenv("MTGS_DINOV2_WEIGHTS", str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="bad.npz: DINOv2 L1_fc2_w has shape"):
        tdino.get_dinov2(device="cpu")


@pytest.mark.parametrize("hw", [(540, 960), (64, 96), (700, 500), (518, 518)])
def test_resize_center_crop_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    img = rng.uniform(-0.2, 1.2, hw + (3,)).astype(np.float32)
    mask = (rng.random(hw) > 0.3).astype(np.float32)
    got = tdino._resize_center_crop(img, nearest=False)
    assert got.shape == (518, 518, 3) and got.dtype == np.float32
    assert np.array_equal(got, jdino_metric._resize_center_crop(img, nearest=False))
    assert np.array_equal(tdino._resize_center_crop(mask, nearest=True),
                          jdino_metric._resize_center_crop(mask, nearest=True))
    assert np.array_equal(tdino.patch_weights(mask), jdino_metric.patch_weights(mask))


@pytest.mark.parametrize("src, dst", [((540, 960), (921, 518)), ((37, 45), (13, 7)),
                                      ((13, 7), (45, 37)), ((61, 83), (83, 61)),
                                      ((1, 9), (4, 3)), ((50, 50), (50, 71))])
@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("nearest", [False, True])
def test_resize_u8_matches_pil(src, dst, channels, nearest):
    rng = np.random.default_rng(src[0] * 1000 + dst[0])
    img = rng.integers(0, 256, src + ((channels,) if channels else ()), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(
        dst, Image.Resampling.NEAREST if nearest else Image.Resampling.BILINEAR))
    got = image_io.resize_u8(img, dst, nearest)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


MANIFEST = json.loads(make_jpeg_manifest.MANIFEST.read_text())


@pytest.mark.parametrize("entry", MANIFEST["arrays"], ids=lambda e: e["name"])
def test_write_jpeg_matches_pil_and_the_manifest(tmp_path, entry):
    img = make_jpeg_manifest.make_array(entry)
    path = image_io.write_jpeg(tmp_path / "x.jpg", img)
    data = path.read_bytes()
    assert data == make_jpeg_manifest.pil_jpeg(img)
    assert hashlib.sha256(data).hexdigest() == entry["sha256"] and len(data) == entry["bytes"]
    decoded = image_io.read_image(path)
    assert decoded.shape == img.shape


@pytest.mark.parametrize("hw", [(1, 1), (2, 17), (15, 9), (16, 16), (17, 33), (23, 1)])
def test_write_jpeg_edges_match_pil(hw):
    """Partial MCUs: odd heights pair the last row with itself, the last
    column and row are replicated, dummy blocks carry the previous DC."""
    img = np.random.default_rng(hw[0] * 100 + hw[1]).integers(0, 256, hw + (3,), np.uint8)
    assert image_io.encode_jpeg(img) == make_jpeg_manifest.pil_jpeg(img)
    with pytest.raises(ValueError, match="RGB uint8"):
        image_io.encode_jpeg(img[..., 0])


def test_evaluate_scene_with_metrics_matches_jax(tmp_path, monkeypatch, clear_jax_caches):
    """Both packages' evaluate_scene with lpips and dinov2_sim on, reading
    the same weight files: every key within the slice test's tolerances,
    the two perceptual metrics (and their trv{t}_ keys) within 1e-4; with the
    files absent both metrics are omitted."""
    s = small_scene(seed=1)
    params, aux, jcfg = s["jax"]
    t_params, t_aux, tcfg = s["torch"]
    rng = np.random.default_rng(5)
    np.savez(tmp_path / "lpips.npz", **lpips_weights(rng))
    np.savez(tmp_path / "dinov2.npz", **dinov2_weights(rng))
    monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    monkeypatch.setenv("MTGS_DINOV2_WEIGHTS", str(tmp_path / "dinov2.npz"))
    want = jpipe.evaluate_scene(params, aux, jcfg, jax_batches(s["views"]))
    got = tpipe.evaluate_scene(t_params, t_aux, tcfg, torch_batches(s["views"]), device="cpu")
    assert set(got) == set(want)
    assert {"lpips", "dinov2_sim", "trv1_lpips", "trv0_dinov2_sim"} <= set(got)
    for k, w in want.items():
        if k in ("fps", "num_images"):
            continue
        if "lpips" in k or "dinov2" in k:
            tol = 1e-4
        else:
            tol = 1e-3 if k.endswith("ssim") else 0.05 if "psnr" in k else 1e-3 * max(1, abs(w))
        assert abs(got[k] - w) <= tol, (k, got[k], w)
    monkeypatch.setenv("MTGS_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("MTGS_DINOV2_WEIGHTS", str(tmp_path / "absent.npz"))
    plain = tpipe.evaluate_scene(t_params, t_aux, tcfg, torch_batches(s["views"]), device="cpu")
    assert set(got) - set(plain) == {"lpips", "dinov2_sim", "trv0_lpips", "trv1_lpips",
                                     "trv0_dinov2_sim", "trv1_dinov2_sim"}
    for k in plain:
        if k != "fps":
            assert plain[k] == got[k], k
