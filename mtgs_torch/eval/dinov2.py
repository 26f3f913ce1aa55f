"""DINOv2 ViT forward and the `dinov2_sim` metric; port of
`mtgs_tpu/eval/dinov2_jax.py` and `mtgs_tpu/eval/dinov2.py`.

The reference scores renders with the mask-weighted mean of per-patch
cosine similarities of DINOv2 ViT-B/14 patch tokens (`mtgs/utils/dinov2.py`
in OpenDriveLab/MTGS): both images are resized so the short side is 518
(PIL's 8-bit bilinear resize), center-cropped to 518x518, normalized with
mean = std = 0.5 and embedded; each of the 37x37 patch similarities is
weighted by the visible fraction of its 14x14 patch under the mask (nearest
resized, cropped alike).

Architecture (transformers `Dinov2Model`, facebook/dinov2-base): patch
embedding (14x14, stride 14, here one matmul over unfolded patches) ->
prepend CLS -> + position embeddings -> pre-norm blocks (multi-head
attention with qkv biases written as matmul + softmax, LayerScale, residual;
LayerNorm -> MLP with exact GELU -> LayerScale, residual; LayerNorm eps
1e-6) -> final LayerNorm; the metric uses the patch tokens (CLS dropped).
Matmuls run in f32 with TF32 off.

No weights ship with the repo and none are downloaded: `get_dinov2`
returns None while no weight file exists and raises, naming the file, when
one exists but does not load. The transformers fallback of the JAX package
is not ported (transformers is not a dependency of the port);
`convert_state_dict` turns a `Dinov2Model` state dict into the canonical
layout.

Canonical `.npz` keys (the JAX package's, so one file serves both):
  patch_w [D, 3, P, P], patch_b [D], cls [D], pos [1 + G*G, D]
  L{i}_{n1_w,n1_b,q_w,q_b,k_w,k_b,v_w,v_b,o_w,o_b,ls1,
        n2_w,n2_b,fc1_w,fc1_b,fc2_w,fc2_b,ls2}
  norm_w [D], norm_b [D]; meta: heads [], patch [].
"""

from __future__ import annotations

import functools
import math
import os
import zipfile
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mtgs_torch import resolve_device
from mtgs_torch.data.image_io import resize_u8

_SIDE = 518
_PATCH = 14
_GRID = _SIDE // _PATCH  # 37

DEFAULT_WEIGHTS = os.path.expanduser("~/.cache/mtgs_tpu/dinov2_vitb14.npz")

_LAYER_KEYS = ("n1_w", "n1_b", "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b", "ls1",
               "n2_w", "n2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ls2")


def _ln(x, w, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def dinov2_forward(weights: Mapping, img_hwc: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] normalized image -> [G*G, D] patch tokens. H and W must be
    multiples of the patch size whose grid has as many cells as the position
    embeddings (518 -> 37x37 for the released ViT-B/14); ValueError if not."""
    pw = weights["patch_w"]
    D, _, P, _ = pw.shape
    H, W = img_hwc.shape[:2]
    gh, gw = H // P, W // P
    n_pos = weights["pos"].shape[0] - 1
    if H % P or W % P or gh * gw != n_pos:
        raise ValueError(f"input {H}x{W} (patch {P}) does not give the position-embedding "
                         f"grid of {n_pos} patches")
    heads = int(weights["heads"])
    hd = D // heads

    x = img_hwc.reshape(gh, P, gw, P, 3).permute(0, 2, 4, 1, 3).reshape(gh * gw, 3 * P * P)
    x = x @ pw.reshape(D, 3 * P * P).T + weights["patch_b"]
    x = torch.cat([weights["cls"][None, :], x], dim=0) + weights["pos"]

    i = 0
    while f"L{i}_n1_w" in weights:
        w = {k: weights[f"L{i}_{k}"] for k in _LAYER_KEYS}
        h = _ln(x, w["n1_w"], w["n1_b"])
        T = h.shape[0]
        q = (h @ w["q_w"].T + w["q_b"]).reshape(T, heads, hd).transpose(0, 1)
        k = (h @ w["k_w"].T + w["k_b"]).reshape(T, heads, hd).transpose(0, 1)
        v = (h @ w["v_w"].T + w["v_b"]).reshape(T, heads, hd).transpose(0, 1)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1)  # [heads, T, T]
        o = (att @ v).transpose(0, 1).reshape(T, D)
        x = x + (o @ w["o_w"].T + w["o_b"]) * w["ls1"]
        h = _ln(x, w["n2_w"], w["n2_b"])
        h = F.gelu(h @ w["fc1_w"].T + w["fc1_b"])
        x = x + (h @ w["fc2_w"].T + w["fc2_b"]) * w["ls2"]
        i += 1
    x = _ln(x, weights["norm_w"], weights["norm_b"])
    return x[1:]  # drop CLS


def convert_state_dict(sd: Mapping, heads: int, patch: int) -> Dict[str, np.ndarray]:
    """A transformers `Dinov2Model` state dict (tensors or arrays) -> the
    canonical npz dict."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in sd.items()}
    out = {
        "patch_w": sd["embeddings.patch_embeddings.projection.weight"],
        "patch_b": sd["embeddings.patch_embeddings.projection.bias"],
        "cls": sd["embeddings.cls_token"][0, 0],
        "pos": sd["embeddings.position_embeddings"][0],
        "norm_w": sd["layernorm.weight"],
        "norm_b": sd["layernorm.bias"],
        "heads": np.asarray(heads),
        "patch": np.asarray(patch),
    }
    names = dict(n1_w="norm1.weight", n1_b="norm1.bias",
                 q_w="attention.attention.query.weight", q_b="attention.attention.query.bias",
                 k_w="attention.attention.key.weight", k_b="attention.attention.key.bias",
                 v_w="attention.attention.value.weight", v_b="attention.attention.value.bias",
                 o_w="attention.output.dense.weight", o_b="attention.output.dense.bias",
                 ls1="layer_scale1.lambda1", n2_w="norm2.weight", n2_b="norm2.bias",
                 fc1_w="mlp.fc1.weight", fc1_b="mlp.fc1.bias", fc2_w="mlp.fc2.weight",
                 fc2_b="mlp.fc2.bias", ls2="layer_scale2.lambda1")
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        out.update({f"L{i}_{k}": sd[f"encoder.layer.{i}.{n}"] for k, n in names.items()})
        i += 1
    return out


def _check_shapes(w: Dict[str, np.ndarray], path) -> None:
    """Raises ValueError naming `path` where a key is missing or a shape
    does not fit the patch embedding's width D and each layer's MLP width."""
    def need(key, shape=None):
        if key not in w:
            raise ValueError(f"{path}: DINOv2 weights lack {key}")
        if shape is not None and w[key].shape != shape:
            raise ValueError(f"{path}: DINOv2 {key} has shape {w[key].shape}, expected {shape}")

    need("patch_w")
    need("heads")
    need("L0_n1_w")
    if w["patch_w"].ndim != 4 or w["patch_w"].shape[1] != 3:
        raise ValueError(f"{path}: DINOv2 patch_w has shape {w['patch_w'].shape}")
    D, heads = w["patch_w"].shape[0], int(w["heads"])
    if heads < 1 or D % heads:
        raise ValueError(f"{path}: DINOv2 width {D} is not split by {heads} heads")
    for k in ("patch_b", "cls", "norm_w", "norm_b"):
        need(k, (D,))
    need("pos")
    if w["pos"].ndim != 2 or w["pos"].shape[1] != D:
        raise ValueError(f"{path}: DINOv2 pos has shape {w['pos'].shape}")
    i = 0
    while f"L{i}_n1_w" in w:
        need(f"L{i}_fc1_w")
        hidden = w[f"L{i}_fc1_w"].shape[0]
        shapes = dict(q_w=(D, D), k_w=(D, D), v_w=(D, D), o_w=(D, D), fc1_w=(hidden, D),
                      fc1_b=(hidden,), fc2_w=(D, hidden))
        for k in _LAYER_KEYS:
            need(f"L{i}_{k}", shapes.get(k, (D,)))
        i += 1


def weights_path() -> str:
    """`MTGS_DINOV2_WEIGHTS`, else the JAX package's default cache path."""
    return os.environ.get("MTGS_DINOV2_WEIGHTS", DEFAULT_WEIGHTS)


def load_weights(path=None, device="cuda") -> Optional[Dict]:
    """The canonical `.npz` as f32 tensors on `device` (`heads` and `patch`
    as ints), or None if the file does not exist; raises ValueError naming
    the file if it does not load or a shape is wrong."""
    dev = resolve_device(device)
    path = path or weights_path()
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            arrays = {k: np.asarray(z[k]) for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise ValueError(f"{path}: cannot read DINOv2 weights ({e})") from e
    _check_shapes(arrays, path)
    out = {k: torch.as_tensor(v.astype(np.float32), device=dev) for k, v in arrays.items()
           if k not in ("heads", "patch")}
    out["heads"] = int(arrays["heads"])
    if "patch" in arrays:
        out["patch"] = int(arrays["patch"])
    return out


@functools.lru_cache(maxsize=None)
def cached_weights(path: str, device: torch.device) -> Dict:
    """`load_weights` once per (resolved path, device) in a process, as the
    JAX package loads its network once; a load that raises is not cached."""
    return load_weights(path, device)


def _resize_center_crop(img: np.ndarray, nearest: bool) -> np.ndarray:
    """Short-side resize to 518 then center crop 518x518 (HW or HWC), as the
    JAX package does it through PIL: RGB clipped to [0, 1] and truncated to
    uint8, a mask (HW) scaled by 255 and truncated without a clip; returns
    float32 in [0, 1]."""
    h, w = img.shape[:2]
    scale = _SIDE / min(h, w)
    nh, nw = max(round(h * scale), _SIDE), max(round(w * scale), _SIDE)
    if img.ndim == 2:
        u8 = (img * 255).astype(np.uint8)
    else:
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    out = resize_u8(u8, (nw, nh), nearest)
    left, top = (nw - _SIDE) // 2, (nh - _SIDE) // 2
    return out[top:top + _SIDE, left:left + _SIDE].astype(np.float32) / 255.0


def patch_weights(mask_hw: np.ndarray) -> np.ndarray:
    """Per-patch visible-pixel fraction, flattened [1369]."""
    m = _resize_center_crop(mask_hw.astype(np.float32), nearest=True) > 0.5
    patches = m.astype(np.float32).reshape(_GRID, _PATCH, _GRID, _PATCH)
    return (patches.sum((1, 3)) / (_PATCH * _PATCH)).reshape(-1)


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).astype(
        np.float32)


def get_dinov2(device="cuda") -> Optional[Callable[..., Optional[float]]]:
    """A (pred_hwc, gt_hwc, mask_hw=None) -> similarity callable on
    `device` if a weight file exists (`weights_path()`), else None; the
    callable returns None for a fully masked view. Raises without a card
    unless the CPU is asked for, and on a weight file that does not load.
    The file is read once per process (`cached_weights`)."""
    dev = resolve_device(device)
    path = weights_path()
    if not os.path.exists(path):
        return None
    weights = cached_weights(os.path.realpath(path), dev)

    def features(img) -> torch.Tensor:
        x = _resize_center_crop(_host(img), nearest=False)
        return dinov2_forward(weights, torch.as_tensor((x - 0.5) / 0.5, device=dev))

    def run(pred_hwc, gt_hwc, mask_hw=None) -> Optional[float]:
        if mask_hw is None:
            w = np.ones((_GRID * _GRID,), np.float32)
        else:
            w = patch_weights(_host(mask_hw))
        tw = float(w.sum())
        if tw <= 1e-6:
            return None  # a fully masked view: omitted, not averaged in
        with torch.no_grad():
            f1, f2 = features(pred_hwc), features(gt_hwc)
            cos = torch.sum(f1 * f2, -1) / torch.clamp(
                torch.linalg.norm(f1, dim=-1) * torch.linalg.norm(f2, dim=-1), min=1e-8)
        return float((cos.cpu().numpy() * w).sum() / tw)

    return run
