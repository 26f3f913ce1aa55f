"""Fourier (IDFT) time-conditioned dc colours for rigid nodes; port of
`mtgs_tpu/models/fourier.py::idft_basis`, `fourier_features_dc` and
`init_fourier_dc`."""

from __future__ import annotations

import math

import torch


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
