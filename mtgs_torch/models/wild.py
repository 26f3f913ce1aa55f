"""WildGaussians-style appearance: a per-image embedding and a colour MLP;
port of `mtgs_tpu/models/wild.py`.

A per-train-image 32-d embedding, concatenated with each gaussian's base
colour and its first 24 flattened SH-rest values, goes through a 3-layer
MLP that outputs a per-gaussian colour offset and multiplier:
`color = rgb * (1 + mul) + offset`, both scaled by 0.01 and not clamped.
The WildGaussians preset uses it on the multicolour nodes instead of the
view-dependent SH colour.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mtgs_torch import resolve_device
from mtgs_torch.core import prng, xla_math
from mtgs_torch.core.sh import sh_to_rgb

EMBED_DIM = 32
HIDDEN = 128
IN_DIM = EMBED_DIM + 3 + 6 * 4  # embedding + rgb + 24 rest values


@dataclass
class WildAppearanceParams:
    embeddings: torch.Tensor   # [num_images, EMBED_DIM]
    w1: torch.Tensor           # [IN_DIM, HIDDEN]
    b1: torch.Tensor
    w2: torch.Tensor           # [HIDDEN, HIDDEN]
    b2: torch.Tensor
    w3: torch.Tensor           # [HIDDEN, 6]
    b3: torch.Tensor


def init_wild(key: torch.Tensor, num_images: int, *, device="cuda") -> WildAppearanceParams:
    """Embeddings normal * 0.01, He-normal hidden layers, a near-zero head
    (normal * 1e-3), zero biases: JAX's draws from `split(key, 4)` (a
    `core.prng` key), made on the key's device and placed on `device` (the
    card unless it says otherwise)."""
    dev = resolve_device(device)
    k = prng.split(key, 4)
    he = lambda kk, i, o: prng.normal(kk, (i, o)) * xla_math.sqrt(torch.tensor(2.0 / i))
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    return WildAppearanceParams(
        embeddings=(prng.normal(k[0], (num_images, EMBED_DIM)) * 0.01).to(dev),
        w1=he(k[1], IN_DIM, HIDDEN).to(dev), b1=zeros(HIDDEN),
        w2=he(k[2], HIDDEN, HIDDEN).to(dev), b2=zeros(HIDDEN),
        w3=(prng.normal(k[3], (HIDDEN, 6)) * 1e-3).to(dev), b3=zeros(6),
    )


def wild_colors(params: WildAppearanceParams, features_dc: torch.Tensor,
                features_rest: torch.Tensor, image_idx) -> torch.Tensor:
    """Per-gaussian colours [N, 3] with the image's appearance MLP applied:
    features_dc [N, 3], features_rest [N, K-1, 3], image_idx the image row."""
    rgb = torch.clamp(sh_to_rgb(features_dc), 0.0, 1.0)
    rest = features_rest.reshape(features_rest.shape[0], -1)[:, :24]
    emb = params.embeddings[image_idx].expand(rgb.shape[0], EMBED_DIM)
    x = torch.cat([rgb, rest, emb], dim=-1)
    h = torch.relu(x @ params.w1 + params.b1)
    h = torch.relu(h @ params.w2 + params.b2)
    out = (h @ params.w3 + params.b3) * 0.01
    offset, mul = out[:, :3], out[:, 3:]
    return rgb * (1.0 + mul) + offset
