"""Fourier (IDFT) time-conditioned dc colours for rigid nodes, instance
velocities and trajectory edits; port of `mtgs_tpu/models/fourier.py`.
The edits return new tensors and leave their inputs as they were."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mtgs_torch.core.quat import quat_mult, quat_normalize, quat_rotate


def idft_basis(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[...] -> [..., dim]: even entries cos(t k 2pi/dim), odd entries
    sin(t (k+1) 2pi/dim)."""
    k = torch.arange(dim, device=t.device)
    even = k % 2 == 0
    freq = torch.where(even, k, k + 1).to(torch.float32) * (2.0 * math.pi / dim)
    ang = t[..., None] * freq
    return torch.where(even, torch.cos(ang), torch.sin(ang))


def fourier_features_dc(coeffs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-frame dc [n, 3] from coefficients [n, F, 3] at normalised time t."""
    basis = idft_basis(t.reshape(1), coeffs.shape[1])[0]
    return torch.einsum("nfc,f->nc", coeffs, basis)


def init_fourier_dc(features_dc: torch.Tensor, fourier_dim: int) -> torch.Tensor:
    """Static dc [..., 3] lifted to IDFT coefficients [..., fourier_dim, 3]
    that give it back at every t: basis entry 0 is cos(0) = 1, so
    coefficient 0 carries the dc and the higher harmonics start at zero (the
    reference's reshape-init of `features_dc`, `rigid_node.py:75-86`)."""
    coeffs = features_dc.new_zeros(features_dc.shape[:-1] + (fourier_dim, 3))
    coeffs[..., 0, :] = features_dc
    return coeffs


def instance_velocities(quats: torch.Tensor, trans: torch.Tensor, timestamps: torch.Tensor,
                        frame_idx: int, means_local: torch.Tensor) -> torch.Tensor:
    """Finite-difference world velocity [I, cap, 3] of each gaussian of
    instances with per-frame poses quats [I, F, 4], trans [I, F, 3] at a
    frame (`rigid_node.py:168-204`): (x_w(f+1) - x_w(f-1)) / (t+ - t-),
    one-sided at the trajectory's ends."""
    F = trans.shape[1]
    f = int(frame_idx)
    f0, f1 = min(max(f - 1, 0), F - 1), min(max(f + 1, 0), F - 1)

    def world(i):
        q = quat_normalize(quats[:, i])[:, None, :]
        return quat_rotate(q, means_local) + trans[:, i][:, None, :]

    dt = timestamps[f1] - timestamps[f0]
    dt = torch.where(torch.abs(dt) < 1e-9, torch.ones_like(dt), dt)
    return (world(f1) - world(f0)) / dt


def edit_translate(trans: torch.Tensor, instance: int, offset) -> torch.Tensor:
    """Shift one instance's whole trajectory (`rigid_node.py:398-407`)."""
    out = trans.clone()
    out[instance] += torch.as_tensor(offset, dtype=trans.dtype, device=trans.device)
    return out


def edit_rotate(quats: torch.Tensor, trans: torch.Tensor, instance: int, rot_quat,
                pivot) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate one instance's trajectory about a pivot (`rigid_node.py:409-421`)."""
    rot = torch.as_tensor(rot_quat, dtype=quats.dtype, device=quats.device)[None, :]
    pivot = torch.as_tensor(pivot, dtype=trans.dtype, device=trans.device)
    new_q, new_t = quats.clone(), trans.clone()
    new_q[instance] = quat_mult(rot, quats[instance])
    new_t[instance] = quat_rotate(rot, trans[instance] - pivot) + pivot
    return new_q, new_t
