"""Quaternion math (wxyz convention), batched over leading dims.

Port of `mtgs_tpu/core/quat.py`.
"""

from __future__ import annotations

import math

import torch

from mtgs_torch.core import prng, xla_math


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize along the last axis; eps-safe at exact-zero (padded) rows."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps * eps)
    return q / norm


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (normalized internally) -> [..., 3, 3] rotation matrices."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    rows = [
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrices -> [..., 4] unit quaternions, w >= 0.

    Branch-free Shepperd form, as the JAX function: all four candidate
    quaternions are computed and the one with the largest pivot (trace,
    m00, m11, m22) is kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                      1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5  # candidate magnitudes
    d = 4.0 * qw
    cands = torch.stack([
        torch.stack([qw[..., 0], (m21 - m12) / d[..., 0], (m02 - m20) / d[..., 0],
                     (m10 - m01) / d[..., 0]], dim=-1),
        torch.stack([(m21 - m12) / d[..., 1], qw[..., 1], (m01 + m10) / d[..., 1],
                     (m02 + m20) / d[..., 1]], dim=-1),
        torch.stack([(m02 - m20) / d[..., 2], (m01 + m10) / d[..., 2], qw[..., 2],
                     (m12 + m21) / d[..., 2]], dim=-1),
        torch.stack([(m10 - m01) / d[..., 3], (m02 + m20) / d[..., 3], (m12 + m21) / d[..., 3],
                     qw[..., 3]], dim=-1),
    ], dim=-2)  # [..., 4 candidates, 4]
    best = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)  # canonical sign: w >= 0
    return quat_normalize(q)


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1*q2. [..., 4] x [..., 4] -> [..., 4]."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v by quaternions q. [..., 4], [..., 3] -> [..., 3]."""
    q = quat_normalize(q)
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor,
          eps: float = 1e-7) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions, with the
    antipodal sign flip and a lerp fallback for nearly-parallel inputs."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    if t.ndim == q0.ndim - 1:
        t = t[..., None]
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    dot_c = torch.clamp(dot, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot_c, 0.0, 1.0 - eps))
    sin_theta = torch.sin(theta)
    near = dot > 1.0 - eps
    w0 = torch.where(near, 1.0 - t,
                     torch.sin((1.0 - t) * theta) / torch.clamp(sin_theta, min=eps))
    w1 = torch.where(near, t, torch.sin(t * theta) / torch.clamp(sin_theta, min=eps))
    return quat_normalize(w0 * q0 + w1 * q1)


def random_quats(key: torch.Tensor, n: int) -> torch.Tensor:
    """Uniformly random unit quaternions [n, 4] (Shoemake's method), float32,
    drawn as JAX draws them from `split(key, 3)` (a `core.prng` key) on the
    key's device, with XLA's CPU sqrt, sin and cos (`core.xla_math`), so
    the quaternions are JAX's bit for bit."""
    k1, k2, k3 = prng.split(key, 3)
    u = prng.uniform(k1, (n,))
    v = prng.uniform(k2, (n,)) * 2.0 * math.pi
    w = prng.uniform(k3, (n,)) * 2.0 * math.pi
    a, b = xla_math.sqrt(1.0 - u), xla_math.sqrt(u)
    return torch.stack([a * xla_math.sin(v), a * xla_math.cos(v),
                        b * xla_math.sin(w), b * xla_math.cos(w)], dim=-1)


def rotate_vector_to_vector(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] sending direction v1 to direction v2
    (Rodrigues), with a branch-free antiparallel case: a rotation by pi
    about an axis orthogonal to v1."""
    a = v1 / torch.clamp(torch.linalg.norm(v1, dim=-1, keepdim=True), min=eps)
    b = v2 / torch.clamp(torch.linalg.norm(v2, dim=-1, keepdim=True), min=eps)
    v = _cross(a, b)
    c = torch.sum(a * b, dim=-1)   # cos
    s2 = torch.sum(v * v, dim=-1)  # sin^2
    vx, vy, vz = v.unbind(-1)
    zeros = torch.zeros_like(vx)
    K = torch.stack([torch.stack([zeros, -vz, vy], dim=-1),
                     torch.stack([vz, zeros, -vx], dim=-1),
                     torch.stack([-vy, vx, zeros], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=v1.dtype, device=v1.device).expand(K.shape)
    factor = torch.where(s2 > eps, (1.0 - c) / torch.clamp(s2, min=eps),
                         torch.full_like(s2, 0.5))
    R = eye + K + factor[..., None, None] * (K @ K)
    x_axis = torch.tensor([1.0, 0, 0], dtype=a.dtype, device=a.device)
    y_axis = torch.tensor([0, 1.0, 0], dtype=a.dtype, device=a.device)
    ortho = _cross(a, torch.where(torch.abs(a[..., :1]) < 0.9, x_axis, y_axis))
    ortho = ortho / torch.clamp(torch.linalg.norm(ortho, dim=-1, keepdim=True), min=eps)
    R_pi = 2.0 * ortho[..., :, None] * ortho[..., None, :] - eye
    anti = (c < -1.0 + 1e-6)[..., None, None]
    return torch.where(anti, R_pi, R)
