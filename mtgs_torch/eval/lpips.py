"""AlexNet-LPIPS forward with a local-weights loader; port of
`mtgs_tpu/eval/lpips_jax.py` and `mtgs_tpu/eval/lpips.py::get_lpips`.

The reference scores LPIPS with torchmetrics' AlexNet variant
(`mtgs/scene_model/mtgs_scene_graph.py:323-325` in OpenDriveLab/MTGS);
this is that computation (richzhang/PerceptualSimilarity LPIPS v0.1, as
`LearnedPerceptualImagePatchSimilarity(net_type="alex", normalize=True)`
wraps it) in plain torch:

  x in [0,1] -> 2x-1 -> (x - shift) / scale          (ScalingLayer)
  AlexNet features, taps after each of the 5 ReLUs
  per tap: channel-unit-normalize both images' features (eps 1e-10),
           d = (f1 - f2)^2, 1x1 non-negative conv (`lin` weights),
           spatial mean; sum the 5 layer scores.

Convolutions run in f32 with TF32 off (the pins of `mtgs_torch/__init__.py`).
No weights ship with the repo and none are downloaded: `get_lpips` returns
None while no weight file exists, and raises, naming the file, when one
exists but does not load. The torchmetrics fallback of the JAX package is
not ported (torchmetrics is not a dependency of the port).

Canonical `.npz` keys (the JAX package's, so one file serves both):
  conv{i}_w [O, I, kh, kw], conv{i}_b [O]   for i in 0..4
  lin{i}_w  [C_i]                           for i in 0..4
"""

from __future__ import annotations

import functools
import os
import zipfile
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mtgs_torch import resolve_device

# torchvision AlexNet feature extractor layout consumed by LPIPS:
# (out_ch, kernel, stride, pad, maxpool_before)
_ALEX = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS = os.path.expanduser("~/.cache/mtgs_tpu/lpips_alex.npz")


def lpips_forward(params: Dict[str, torch.Tensor], img1: torch.Tensor,
                  img2: torch.Tensor) -> torch.Tensor:
    """LPIPS distance (a 0-d tensor) between two [H, W, 3] images in [0, 1];
    both go through the network as one batch of two."""
    dev = params["conv0_w"].device
    shift = torch.as_tensor(_SHIFT, device=dev)
    scale = torch.as_tensor(_SCALE, device=dev)
    x = torch.stack([torch.as_tensor(img1, dtype=torch.float32, device=dev),
                     torch.as_tensor(img2, dtype=torch.float32, device=dev)])
    x = (torch.clamp(x, 0.0, 1.0) * 2.0 - 1.0 - shift) / scale
    x = x.permute(0, 3, 1, 2).contiguous()  # [2, 3, H, W]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (_, _, stride, pad, pool_before) in enumerate(_ALEX):
        if pool_before:
            x = F.max_pool2d(x, 3, 2)  # floor mode, no padding
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"], stride=stride,
                            padding=pad))
        n = x / (torch.sqrt(torch.sum(x * x, 1, keepdim=True)) + 1e-10)
        d = (n[0] - n[1]) ** 2  # [C, h, w]
        total = total + torch.mean(torch.sum(d * params[f"lin{i}_w"][:, None, None], 0))
    return total


def load_weights(path, device="cuda") -> Dict[str, torch.Tensor]:
    """Canonical `.npz` weights (module docstring) as f32 tensors on
    `device`; raises ValueError naming the file if it does not load or a
    shape is wrong."""
    dev = resolve_device(device)
    try:
        with np.load(path) as z:
            arrays = {k: np.asarray(z[k], np.float32) for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise ValueError(f"{path}: cannot read LPIPS weights ({e})") from e
    params = {}
    in_ch = 3
    for i, (out_ch, k, _, _, _) in enumerate(_ALEX):
        want = {f"conv{i}_w": (out_ch, in_ch, k, k), f"conv{i}_b": (out_ch,),
                f"lin{i}_w": (out_ch,)}
        for key, shape in want.items():
            if key not in arrays:
                raise ValueError(f"{path}: LPIPS weights lack {key}")
            a = arrays[key].reshape(-1) if key.startswith("lin") else arrays[key]
            if a.shape != shape:
                raise ValueError(f"{path}: LPIPS {key} has shape {a.shape}, expected {shape}")
            params[key] = torch.as_tensor(a, device=dev)
        in_ch = out_ch
    return params


def convert_torch_checkpoints(alexnet_pth: str, lpips_pth: str, out_npz: str) -> None:
    """One-time converter: a torchvision `alexnet` state dict and an LPIPS
    `lin` state dict -> the canonical npz."""
    alex = torch.load(alexnet_pth, map_location="cpu", weights_only=True)
    lin = torch.load(lpips_pth, map_location="cpu", weights_only=True)
    conv_ids = [0, 3, 6, 8, 10]  # torchvision features.* indices
    payload = {}
    for i, ci in enumerate(conv_ids):
        payload[f"conv{i}_w"] = alex[f"features.{ci}.weight"].numpy()
        payload[f"conv{i}_b"] = alex[f"features.{ci}.bias"].numpy()
        # richzhang layout: lin{i}.model.1.weight [1, C, 1, 1]
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lin:
                payload[f"lin{i}_w"] = lin[key].numpy().reshape(-1)
                break
        else:
            raise KeyError(f"lin weights for tap {i} not found")
    os.makedirs(os.path.dirname(out_npz) or ".", exist_ok=True)
    np.savez(out_npz, **payload)


def weights_path() -> str:
    """`MTGS_LPIPS_WEIGHTS`, else the JAX package's default cache path."""
    return os.environ.get("MTGS_LPIPS_WEIGHTS", DEFAULT_WEIGHTS)


@functools.lru_cache(maxsize=None)
def cached_weights(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """`load_weights` once per (resolved path, device) in a process, as the
    JAX package loads its network once; a load that raises is not cached."""
    return load_weights(path, device)


def get_lpips(device="cuda") -> Optional[Callable[..., float]]:
    """A (pred_hwc, gt_hwc) -> float callable on `device` if a weight file
    exists (`weights_path()`), else None. Raises without a card unless the
    CPU is asked for, and on a weight file that does not load. The file is
    read once per process (`cached_weights`)."""
    dev = resolve_device(device)
    path = weights_path()
    if not os.path.exists(path):
        return None
    params = cached_weights(os.path.realpath(path), dev)

    def run(pred_hwc, gt_hwc) -> float:
        with torch.no_grad():
            return float(lpips_forward(params, pred_hwc, gt_hwc))

    return run
