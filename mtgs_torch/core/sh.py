"""Real spherical harmonics (degree <= 3); port of `mtgs_tpu/core/sh.py`.

Convention matches the standard 3DGS tables: color = clamp(SH·basis + 0.5).
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def num_sh_bases(degree: int) -> int:
    """Number of SH basis functions for a max degree (0->1, 1->4, 2->9, 3->16)."""
    return (degree + 1) ** 2


def rgb_to_sh(rgb):
    """RGB in [0,1] to the DC SH coefficient (tensor or numpy array)."""
    return (rgb - 0.5) / _C0


def sh_to_rgb(sh):
    """The DC SH coefficient to RGB (tensor or numpy array)."""
    return sh * _C0 + 0.5


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis at unit directions: [..., 3] -> [..., num_sh_bases]."""
    if not 0 <= degree <= 3:
        raise ValueError(f"SH degree must be in [0,3], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colour at view directions, as gsplat's `spherical_harmonics`:
    only the first num_sh_bases(degree) of coeffs [..., K, C] are used;
    dirs [..., 3] need not be normalized (1e-12 floor). Returns [..., C]
    offset by +0.5 (the 3DGS convention), not clamped."""
    n = num_sh_bases(degree)
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    basis = sh_basis(degree, d)
    return (basis[..., :, None] * coeffs[..., :n, :]).sum(-2) + 0.5
