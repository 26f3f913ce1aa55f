"""Padded gaussian parameter nodes; port of `mtgs_tpu/models/gaussians.py`.

Each node holds raw (pre-activation) parameters padded to a capacity,
with a float `alive` mask beside them:
    means        [cap, 3]   world positions
    scales       [cap, 3]   log-scales ([cap, 1] for isotropic marbles)
    quats        [cap, 4]   wxyz, normalized on use
    features_dc  [cap, 3]   SH degree-0 coefficients
    features_rest[cap, K-1, 3] or [cap, T, K-1, 3] (per traversal)
    opacities    [cap, 1]   logits
    features_adapters [cap, T, 3]  per-traversal dc offsets (T = 0: mono)
    fourier_dc   [cap, F, 3] Fourier dc coefficients (F = 0: off)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.core.quat import quat_normalize
from mtgs_torch.core.sh import num_sh_bases, rgb_to_sh


@dataclass
class GaussianNodeParams:
    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacities: torch.Tensor
    features_adapters: torch.Tensor
    fourier_dc: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def multicolor(self) -> bool:
        return self.features_adapters.shape[-2] > 0

    @property
    def fourier(self) -> bool:
        return self.fourier_dc is not None and self.fourier_dc.shape[-2] > 0

    @property
    def multi_feature_rest(self) -> bool:
        return self.features_rest.ndim == self.features_adapters.ndim + 1


@dataclass
class NodeAux:
    alive: torch.Tensor        # [cap] float 0/1
    num_alive: torch.Tensor    # [] int32


def stack_nodes(nodes):
    """Same-shaped nodes (any dataclass of tensors and Nones) stacked along
    a new leading axis, as rigid instances are."""
    first = nodes[0]
    return dataclasses.replace(first, **{
        f.name: None if getattr(first, f.name) is None
        else torch.stack([getattr(n, f.name) for n in nodes])
        for f in dataclasses.fields(first)})


def node_capacity(n: int, granule: int = 4096) -> int:
    """Round a live count up to the padded array capacity."""
    return max(granule, ((n + granule - 1) // granule) * granule)


def knn_mean_distance(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance to the k nearest neighbours (host-side, scipy)."""
    from scipy.spatial import cKDTree

    if len(points) <= k:
        return np.full((len(points),), 0.1, dtype=np.float32)
    tree = cKDTree(points)
    d, _ = tree.query(points, k=k + 1)  # the first hit is the point itself
    return d[:, 1:].mean(axis=1).astype(np.float32)


def init_node_from_points(
    xyz: np.ndarray,
    rgb: np.ndarray,
    *,
    capacity: Optional[int] = None,
    sh_degree: int = 3,
    num_traversals: int = 0,
    multi_feature_rest: bool = False,
    init_opacity: float = 0.1,
    seed: int = 0,
    isotropic: bool = False,
    fourier_dim: int = 0,
    device="cuda",
) -> tuple[GaussianNodeParams, NodeAux]:
    """Seed a node from a coloured point cloud (rgb in 0..255): SH dc from
    RGB, kNN mean distance as isotropic log-scale, Shoemake random quats
    from a numpy generator, opacity logit(init_opacity). The same numpy
    draws as the JAX function, so both packages build the same node. On
    the card unless `device` says otherwise; raises without one."""
    device = resolve_device(device)
    n = len(xyz)
    cap = capacity or node_capacity(n)
    if n > cap:
        raise ValueError(f"{n} points exceed capacity {cap}")
    dim_sh = num_sh_bases(sh_degree)
    rng = np.random.default_rng(seed)

    means = np.zeros((cap, 3), np.float32)
    means[:n] = xyz
    dc = np.zeros((cap, 3), np.float32)
    dc[:n] = rgb_to_sh(np.asarray(rgb, np.float32) / np.float32(255.0))

    if num_traversals > 0 and multi_feature_rest:
        rest = np.zeros((cap, num_traversals, dim_sh - 1, 3), np.float32)
    else:
        rest = np.zeros((cap, dim_sh - 1, 3), np.float32)
    adapters = np.zeros((cap, num_traversals, 3), np.float32)

    scales = np.full((cap, 1 if isotropic else 3), -5.0, np.float32)
    if n > 0:
        avg = np.maximum(knn_mean_distance(np.asarray(xyz)), 1e-7)
        scales[:n] = np.log(avg)[:, None]

    u, v, w = rng.random((3, cap)).astype(np.float32)
    quats = np.stack(
        [
            np.sqrt(1 - u) * np.sin(2 * np.pi * v),
            np.sqrt(1 - u) * np.cos(2 * np.pi * v),
            np.sqrt(u) * np.sin(2 * np.pi * w),
            np.sqrt(u) * np.cos(2 * np.pi * w),
        ],
        axis=-1,
    ).astype(np.float32)

    logit = float(np.log(init_opacity / (1.0 - init_opacity)))
    opac = np.full((cap, 1), logit, np.float32)
    fourier = np.zeros((cap, fourier_dim, 3), np.float32)
    if fourier_dim > 0:
        fourier[:, 0, :] = dc

    t = lambda a: torch.as_tensor(a, device=device)
    params = GaussianNodeParams(
        means=t(means), scales=t(scales), quats=t(quats), features_dc=t(dc),
        features_rest=t(rest), opacities=t(opac), features_adapters=t(adapters),
        fourier_dc=t(fourier),
    )
    alive = np.zeros((cap,), np.float32)
    alive[:n] = 1.0
    aux = NodeAux(alive=t(alive), num_alive=torch.tensor(n, dtype=torch.int32,
                                                          device=device))
    return params, aux


def init_skybox_node(
    *,
    num_points: int = 100_000,
    radius: float = 1000.0,
    skybox_type: str = "spheric",
    scene_extent: float = 100.0,
    sh_degree: int = 3,
    num_traversals: int = 0,
    multi_feature_rest: bool = False,
    seed: int = 1,
    device="cuda",
) -> tuple[GaussianNodeParams, NodeAux]:
    """Skybox shell init: points on/in a far shell, phi in [pi/4, pi/2],
    white colour. On the card unless `device` says otherwise."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    radius = max(radius, scene_extent * 2.0)
    if skybox_type == "spheric":
        radii = np.full(num_points, radius)
    elif skybox_type == "volumetric":
        radii = rng.random(num_points) * radius
    else:  # homocentric shell
        radii = scene_extent + rng.random(num_points) * (radius - scene_extent)
    theta = rng.random(num_points) * 2 * np.pi
    phi = rng.random(num_points) * np.pi / 4 + np.pi / 4
    xyz = np.stack(
        [
            radii * np.sin(phi) * np.cos(theta),
            radii * np.sin(phi) * np.sin(theta),
            radii * np.cos(phi),
        ],
        axis=-1,
    ).astype(np.float32)
    rgb = np.full((num_points, 3), 255.0, np.float32)
    return init_node_from_points(
        xyz, rgb, capacity=node_capacity(num_points), sh_degree=sh_degree,
        num_traversals=num_traversals, multi_feature_rest=multi_feature_rest,
        seed=seed, device=device,
    )


def get_scales(p: GaussianNodeParams) -> torch.Tensor:
    s = torch.exp(p.scales)
    if s.shape[-1] == 1:  # isotropic marbles: broadcast the tied scale
        s = s.expand(s.shape[0], 3)
    return s


def get_opacities(p: GaussianNodeParams, aux: NodeAux) -> torch.Tensor:
    return torch.sigmoid(p.opacities[:, 0]) * aux.alive


def get_quats(p: GaussianNodeParams) -> torch.Tensor:
    return quat_normalize(p.quats)
