"""Deformation MLP for pedestrian/cyclist nodes; port of
`mtgs_tpu/models/deform.py`.

An 8x256 ReLU MLP with a mid-skip (the reference's
`ConditionalDeformNetwork`), fed NeRF positional encodings of the
normalized canonical xyz and the normalized timestamp plus a
per-instance embedding, predicting (delta_xyz, delta_quat, delta_scale).
It runs batched over all stacked deformable instances. The products stay
full f32 (the package pins TF32 off).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from mtgs_torch import resolve_device
from mtgs_torch.core import prng, xla_math

X_MULTIRES = 10
T_MULTIRES = 10
HIDDEN = 256
DEPTH = 8
SKIP = DEPTH // 2


def posenc(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """NeRF positional encoding with the input first: [..., d] ->
    [..., d * (1 + 2 * num_freqs)], laid out as x, sin at each frequency
    (all d components), then cos at each frequency. The frequencies are
    exact powers of two, so x * 2^k is exact in f32."""
    freqs = torch.tensor([2.0 ** k for k in range(num_freqs)], dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]  # [..., F, d]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-2).reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1)


def _in_dim(embed_dim: int) -> int:
    return 3 * (1 + 2 * X_MULTIRES) + 1 * (1 + 2 * T_MULTIRES) + embed_dim


@dataclass
class DeformMLPParams:
    """Weights of the conditional deformation network."""

    w: Tuple[torch.Tensor, ...]    # DEPTH hidden weights [fan_in, HIDDEN]
    b: Tuple[torch.Tensor, ...]    # DEPTH hidden biases [HIDDEN]
    w_xyz: torch.Tensor            # [HIDDEN, 3]
    b_xyz: torch.Tensor
    w_quat: torch.Tensor           # [HIDDEN, 4]
    b_quat: torch.Tensor
    w_scale: torch.Tensor          # [HIDDEN, 3]
    b_scale: torch.Tensor


def init_deform_mlp(key: torch.Tensor, embed_dim: int = 16, *,
                    device="cuda") -> DeformMLPParams:
    """He-normal hidden layers, zero biases and near-identity heads
    (normal * 1e-4): JAX's draws from `split(key, DEPTH + 3)` (a
    `core.prng` key), made on the key's device and placed on `device` (the
    card unless it says otherwise)."""
    dev = resolve_device(device)
    d_in = _in_dim(embed_dim)
    dims = [d_in] + [HIDDEN] * DEPTH
    keys = prng.split(key, DEPTH + 3)
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    ws, bs = [], []
    for i in range(DEPTH):
        fan_in = dims[i] + (d_in if i == SKIP else 0)
        w = prng.normal(keys[i], (fan_in, HIDDEN)) * xla_math.sqrt(torch.tensor(2.0 / fan_in))
        ws.append(w.to(dev))
        bs.append(zeros(HIDDEN))
    head = lambda k, n: (prng.normal(k, (HIDDEN, n)) * 1e-4).to(dev)  # near-identity start
    return DeformMLPParams(
        w=tuple(ws), b=tuple(bs),
        w_xyz=head(keys[-3], 3), b_xyz=zeros(3),
        w_quat=head(keys[-2], 4), b_quat=zeros(4),
        w_scale=head(keys[-1], 3), b_scale=zeros(3),
    )


def deform_mlp(mlp: DeformMLPParams, x: torch.Tensor, t: torch.Tensor,
               cond: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The deform net on x [..., 3] (normalized canonical positions), t
    [..., 1] (normalized timestamps) and cond [..., E] (instance
    embeddings) -> (delta_xyz [..., 3], delta_quat [..., 4], delta_scale
    [..., 3]). At the skip layer the hidden state comes before the input."""
    inp = torch.cat([posenc(x, X_MULTIRES), posenc(t, T_MULTIRES), cond], dim=-1)
    h = inp
    for i in range(DEPTH):
        if i == SKIP:
            h = torch.cat([h, inp], dim=-1)
        h = torch.relu(h @ mlp.w[i] + mlp.b[i])
    return h @ mlp.w_xyz + mlp.b_xyz, h @ mlp.w_quat + mlp.b_quat, h @ mlp.w_scale + mlp.b_scale


def apply_deform(mlp: DeformMLPParams, canonical_means: torch.Tensor,
                 embeddings: torch.Tensor, timestamp: torch.Tensor, *,
                 xyz_bound: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deformation offsets of all stacked instances: canonical_means
    [I, cap, 3] (a constant: the reference freezes canonical xyz once
    deformation starts), embeddings [I, E], timestamp [] normalized."""
    I, cap, _ = canonical_means.shape
    x = canonical_means.detach() * (2.0 / xyz_bound)
    t = torch.as_tensor(timestamp, dtype=x.dtype, device=x.device).expand(I, cap, 1)
    cond = embeddings[:, None, :].expand(I, cap, embeddings.shape[-1])
    return deform_mlp(mlp, x, t, cond)
