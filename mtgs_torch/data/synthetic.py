"""Synthetic multi-traversal scenes; port of `mtgs_tpu/data/synthetic.py`.

A procedurally generated street (textured ground, building rows beside a
clear carriageway, roadside clusters, a far backdrop ring) plus a moving
rigid "vehicle", rendered through the port's own `rasterize` into a
multi-traversal dataset: per-traversal colour gains exercise the
appearance adapters, the vehicle the rigid instance node, and the
rendered depth stands in for LiDAR.

The ground truth is drawn as the JAX package draws it: `core.prng`'s copy
of `jax.random` from `key(seed)`, split and transformed with JAX's
primitives, shapes and keys, and with XLA's CPU sin, cos and exp
(`core.xla_math`), on the CPU (so a seed gives the same scene on the CPU
and on the card, bit for bit JAX's). The seed subsample and its noise, the
instance pose noise and the batch order are numpy draws in both packages.
So one seed gives the JAX package's scene. `SyntheticScene` holds numpy
arrays only, so a scene cache written by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.core import prng, xla_math
from mtgs_torch.core.camera import camera_to_gsplat_viewmat
from mtgs_torch.core.quat import quat_mult, quat_rotate
from mtgs_torch.raster import RasterizeConfig, rasterize
from mtgs_torch.train.optim import tree_map
from mtgs_torch.train.trainer import Batch


@dataclasses.dataclass
class SyntheticScene:
    """Ground-truth renders of a multi-traversal drive plus model seeds."""

    width: int
    height: int
    n_travels: int
    n_frames: int                 # frames per traversal
    images: np.ndarray            # [T, F, H, W, 3]
    depths: np.ndarray            # [T, F, H, W, 1]
    masks: np.ndarray             # [T, F, H, W, 1]
    c2ws: np.ndarray              # [T, F, 4, 4]
    K: np.ndarray                 # [3, 3]
    timestamps: np.ndarray        # [T, F] normalized per traversal
    # seeds for model init
    seed_xyz: np.ndarray          # [n, 3]
    seed_rgb: np.ndarray          # [n, 3] 0..255
    instance_xyz: np.ndarray      # [m, 3] local frame
    instance_rgb: np.ndarray      # [m, 3]
    instance_quats: np.ndarray    # [F_total, 4] per global frame row
    instance_trans: np.ndarray    # [F_total, 3]
    instance_present: np.ndarray  # [F_total]
    instance_size: np.ndarray     # [3]

    @property
    def frame_rows(self) -> int:
        return self.n_travels * self.n_frames

    def frame_row(self, travel: int, frame: int) -> int:
        return travel * self.n_frames + frame


def _numpy(*tensors):
    return tuple(t.numpy() for t in tensors)


def _gt_gaussians(key: torch.Tensor, n_bg: int, extent: float,
                  ground_scale: float = 0.4, color_noise: float = 0.0):
    """A structured street scene with clear air along the camera path:
    ground 45%, buildings 35% (boxes along both road sides, the nearest
    facade >= 3.5 m from the road's centre line), roadside clusters 15%,
    a far backdrop ring 5%; `color_noise` adds per-gaussian speckle that
    the reconstruction can only resolve by densifying. Every array is
    drawn from `key` (a `core.prng` key on the CPU) with JAX's primitive,
    bounds, shape and key, and computed in float32 as JAX's eager ops do
    (sin, cos and exp as XLA's CPU code computes them). Returns
    float32 numpy (means [n, 3], quats [n, 4], linear scales [n, 3],
    opacities [n], colors [n, 3])."""
    ks = prng.split(key, 16)
    n_ground = int(n_bg * 0.45)
    n_build = int(n_bg * 0.35)
    n_obj = int(n_bg * 0.15)
    n_back = n_bg - n_ground - n_build - n_obj
    full = lambda shape, v: torch.full(shape, v, dtype=torch.float32)
    unit_quats = lambda n: torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1)
    sign = lambda k, n: torch.where(prng.bernoulli(k, 0.5, (n,)), 1.0, -1.0)

    # ground carpet: flattened gaussians on z = 0, smooth colour field
    gx = prng.uniform(ks[0], (n_ground,), -extent, extent)
    gy = prng.uniform(ks[1], (n_ground,), -extent, extent)
    ground = torch.stack([gx, gy, torch.zeros_like(gx)], -1)
    gcol = torch.stack([0.5 + 0.4 * xla_math.sin(gx * 0.7), 0.5 + 0.4 * xla_math.cos(gy * 0.9),
                        0.4 + 0.3 * xla_math.sin((gx + gy) * 0.5)], -1)
    gscale = torch.stack([full((n_ground,), ground_scale), full((n_ground,), ground_scale),
                          full((n_ground,), min(0.05, ground_scale / 4))], -1)
    gquat = unit_quats(n_ground)

    # buildings: boxes along both road sides
    nb = max(4, int(extent / 4))
    bker = prng.split(ks[2], 6)
    bx = prng.uniform(bker[0], (nb,), -extent, extent)
    side = sign(bker[1], nb)
    by = side * prng.uniform(bker[2], (nb,), min(7.0, extent * 0.45), min(15.0, extent * 0.9))
    bw = prng.uniform(bker[3], (nb, 3), 1.5, 4.0) * torch.tensor([1.0, 1.0, 2.0])  # half-extents
    # keep the carriageway clear: the nearest facade stays >= ~2.5 m from
    # the camera lanes (|y| <= 1)
    by = side * torch.maximum(torch.abs(by), bw[:, 1] + 3.5)
    bcol = prng.uniform(bker[4], (nb, 3), 0.15, 0.9)
    which = prng.randint(ks[3], (n_build,), 0, nb).long()
    off = prng.uniform(ks[4], (n_build, 3), -1.0, 1.0)
    build = torch.stack([bx, by, bw[:, 2]], -1)[which] + off * bw[which]  # fill the box
    build[:, 2] = torch.maximum(build[:, 2], torch.tensor(0.05))
    # facade stripes: the buildings' own high-frequency texture
    stripe = 0.15 * xla_math.sin(build[:, 2] * 4.0)[:, None]
    bcols = torch.clamp(bcol[which] + stripe, 0.02, 1.0)
    bscale = xla_math.exp(prng.normal(ks[5], (n_build, 3)) * 0.25 - 1.35)
    bquat = prng.normal(ks[6], (n_build, 4))

    # roadside objects: small clusters (trees, poles) near the road
    ncl = max(6, n_obj // 400)
    oker = prng.split(ks[7], 5)
    cx = prng.uniform(oker[0], (ncl,), -extent, extent)
    cy = sign(oker[1], ncl) * prng.uniform(oker[2], (ncl,), 4.5, 7.0)
    cz = prng.uniform(oker[3], (ncl,), 0.8, 2.5)
    ccol = prng.uniform(oker[4], (ncl, 3), 0.1, 0.8)
    ow = prng.randint(ks[8], (n_obj,), 0, ncl).long()
    objs = torch.stack([cx, cy, cz], -1)[ow] + 0.6 * prng.normal(ks[9], (n_obj, 3))
    objs[:, 2] = torch.abs(objs[:, 2]) + 0.1
    ocols = torch.clamp(ccol[ow] + 0.1 * prng.normal(ks[10], (n_obj, 3)), 0.02, 1.0)
    oscale = xla_math.exp(prng.normal(ks[11], (n_obj, 3)) * 0.3 - 1.6)
    oquat = prng.normal(ks[12], (n_obj, 4))

    # far backdrop: a coarse ring past the block edge (horizon content;
    # the sub-pixel far-field regime)
    th = prng.uniform(ks[13], (n_back,), 0.0, 2 * math.pi)
    rr = extent * (1.3 + 0.4 * prng.uniform(ks[14], (n_back,)))
    bz = prng.uniform(ks[15], (n_back,), 0.0, extent * 0.25)
    back = torch.stack([rr * xla_math.cos(th), rr * xla_math.sin(th), bz], -1)
    backcol = torch.stack([0.35 + 0.3 * xla_math.sin(th * 3), 0.4 + 0.2 * xla_math.cos(th * 5),
                           0.5 + 0.2 * xla_math.sin(th * 2 + 1.0)], -1)
    backscale = full((n_back, 3), extent * 0.02)
    backquat = unit_quats(n_back)

    means = torch.cat([ground, build, objs, back])
    colors = torch.cat([gcol, bcols, ocols, backcol])
    if color_noise > 0:
        noise = prng.uniform(prng.fold_in(key, 17), (n_bg, 3), -1.0, 1.0)
        colors = torch.clamp(colors + color_noise * noise, 0.0, 1.0)
    scales = torch.cat([gscale, bscale, oscale, backscale])
    quats = torch.cat([gquat, bquat, oquat, backquat])
    return _numpy(means, quats, scales, full((n_bg,), 0.9), colors)


def _instance_gaussians(key: torch.Tensor, m: int):
    """A box-ish cluster (the 'vehicle') in its local frame, size ~ (4, 2,
    1.5), drawn from `key` as JAX draws it; float32 numpy (xyz, quats,
    linear scales, opacities, colors)."""
    ks = prng.split(key, 3)
    xyz = prng.uniform(ks[0], (m, 3), -0.5, 0.5) * torch.tensor([4.0, 2.0, 1.5])
    col = torch.tensor([[0.85, 0.15, 0.1]]).repeat(m, 1) + 0.1 * prng.normal(ks[1], (m, 3))
    scales = xla_math.exp(prng.normal(ks[2], (m, 3)) * 0.2 - 1.8)
    quats = torch.tensor([[1.0, 0, 0, 0]]).repeat(m, 1)
    return _numpy(xyz, quats, scales, torch.full((m,), 0.95), torch.clamp(col, 0, 1))


def make_synthetic_scene(
    seed: int = 0,
    *,
    width: int = 96,
    height: int = 64,
    n_travels: int = 2,
    n_frames: int = 4,
    n_bg: int = 1500,
    n_instance: int = 150,
    extent: float = 12.0,
    n_seed: int | None = None,
    ground_scale: float = 0.4,
    color_noise: float = 0.0,
    gt_max_intersections: int = 1 << 17,
    truncate_gt: bool = False,
    device="cuda",
) -> SyntheticScene:
    """Draw the ground truth from `seed` and render every (traversal,
    frame) view on `device` (the card unless the caller asks for the CPU).

    `n_seed` caps the seed-point subsample (default 1200); `ground_scale`
    and `color_noise` set the ground truth's texture frequency. The renders
    are RGB+ED at `gt_max_intersections` with no autograd; a view whose
    pairs exceed that capacity raises (it would be truncated), unless
    `truncate_gt`: then it keeps the truncated render, its farthest pairs
    dropped, as JAX's `make_synthetic_scene` does."""
    dev = resolve_device(device)
    kb, ki = prng.split(prng.key(seed))
    bg = _gt_gaussians(kb, n_bg, extent, ground_scale, color_noise)
    ixyz, iquat, iscale, iopac, icol = _instance_gaussians(ki, n_instance)

    K = np.array(
        [[0.9 * width, 0, width / 2], [0, 0.9 * width, height / 2], [0, 0, 1.0]],
        np.float32,
    )
    cfg = RasterizeConfig(width=width, height=height, max_intersections=gt_max_intersections,
                          render_mode="RGB+ED")

    F_total = n_travels * n_frames
    images = np.zeros((n_travels, n_frames, height, width, 3), np.float32)
    depths = np.zeros((n_travels, n_frames, height, width, 1), np.float32)
    c2ws = np.zeros((n_travels, n_frames, 4, 4), np.float32)
    timestamps = np.zeros((n_travels, n_frames), np.float32)
    inst_quats = np.zeros((F_total, 4), np.float32)
    inst_trans = np.zeros((F_total, 3), np.float32)
    inst_present = np.ones((F_total,), np.float32)

    # per-traversal colour gain (what the adapters must absorb)
    gains = 1.0 + 0.15 * np.linspace(-1, 1, n_travels)[:, None] * np.array([[1.0, -0.5, 0.3]])

    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    bg_means, bg_quats, bg_scales, bg_opac, bg_cols = (t(a) for a in bg)
    i_xyz, i_quat, i_scale, i_opac, i_col = (t(a) for a in (ixyz, iquat, iscale, iopac, icol))
    K_t = t(K)

    with torch.no_grad():
        for tr in range(n_travels):
            lane_y = -1.0 + 2.0 * tr / max(n_travels - 1, 1)
            cols_bg = bg_cols * t(gains[tr])
            for f in range(n_frames):
                # the camera drives along +x, 1.6 m up; its scene-frame axes:
                # x right (-y world), y up (z world), z backward (-x world)
                c2w = np.eye(4, dtype=np.float32)
                c2w[:3, 0] = [0, -1, 0]
                c2w[:3, 1] = [0, 0, 1]
                c2w[:3, 2] = [-1, 0, 0]
                c2w[:3, 3] = [-8.0 + 3.0 * f, lane_y, 1.6]
                c2ws[tr, f] = c2w
                timestamps[tr, f] = f / max(n_frames - 1, 1)
                row = tr * n_frames + f

                # the instance drives the other way
                itr = np.array([6.0 - 2.5 * f, 1.5 - lane_y * 0.5, 0.75], np.float32)
                ang = 0.05 * f
                iq = np.array([np.cos(ang / 2), 0, 0, np.sin(ang / 2)], np.float32)
                inst_quats[row] = iq
                inst_trans[row] = itr

                iq_t = t(iq)[None]
                means = torch.cat([bg_means, quat_rotate(iq_t, i_xyz) + t(itr)])
                quats = torch.cat([bg_quats, quat_mult(iq_t, i_quat)])
                scales = torch.cat([bg_scales, i_scale])
                opacs = torch.cat([bg_opac, i_opac])
                cols = torch.clamp(torch.cat([cols_bg, i_col]), 0, 1)

                r, a, info = rasterize(means, quats, scales, opacs, cols,
                                       camera_to_gsplat_viewmat(t(c2w)), K_t, cfg)
                n_isect = int(info["n_intersections"])
                if n_isect > gt_max_intersections and not truncate_gt:
                    raise ValueError(
                        f"ground-truth view (travel {tr}, frame {f}) has {n_isect} "
                        f"intersections > gt_max_intersections {gt_max_intersections}: "
                        "it would be truncated")
                images[tr, f] = torch.clamp(r[..., :3], 0, 1).cpu().numpy()
                depths[tr, f] = torch.where(a > 0.5, r[..., -1:], 0.0).cpu().numpy()

    masks = np.ones((n_travels, n_frames, height, width, 1), np.float32)

    rng = np.random.default_rng(seed + 1)
    # noisy seed points (the "LiDAR+SfM" stand-in)
    sub = rng.choice(n_bg, size=min(n_bg, n_seed or 1200), replace=False)
    seed_xyz = bg[0][sub] + rng.normal(0, 0.05, (len(sub), 3)).astype(np.float32)
    seed_rgb = np.clip(bg[4][sub] * 255.0 + rng.normal(0, 10, (len(sub), 3)), 0, 255)

    return SyntheticScene(
        width=width, height=height, n_travels=n_travels, n_frames=n_frames,
        images=images, depths=depths, masks=masks, c2ws=c2ws, K=K,
        timestamps=timestamps,
        seed_xyz=seed_xyz.astype(np.float32), seed_rgb=seed_rgb.astype(np.float32),
        instance_xyz=ixyz, instance_rgb=np.clip(icol * 255, 0, 255),
        instance_quats=inst_quats, instance_trans=inst_trans,
        instance_present=inst_present, instance_size=np.array([4.0, 2.0, 1.5], np.float32),
    )


def make_batch(scene: SyntheticScene, t: int, f: int, scale: float = 1.0,
               device="cuda") -> Batch:
    """The (traversal t, frame f) view at `scale` as a Batch on `device`:
    the image by an area mean over k = round(1/scale), depth and mask by
    stride (averaging sparse zeros would corrupt the supervision; the
    reference resizes per type, custom_dataset.py:279-304), K[:2] scaled;
    the depth is both the LiDAR and the pseudo depth."""
    dev = resolve_device(device)
    k = int(round(1.0 / scale))
    img, dep, mask = scene.images[t, f], scene.depths[t, f], scene.masks[t, f]
    H, W = img.shape[:2]
    if k > 1:
        img = img.reshape(H // k, k, W // k, k, 3).mean(axis=(1, 3))
        dep, mask = dep[::k, ::k], mask[::k, ::k]
    K = scene.K.copy()
    K[:2] *= scale
    row = scene.frame_row(t, f)
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    depth = on(dep)
    return Batch(image=on(img), mask=on(mask), c2w=on(scene.c2ws[t, f]), K=on(K), cam_idx=0,
                 image_idx=row, travel_index=t, frame_idx=row,
                 timestamp=float(scene.timestamps[t, f]), lidar_depth=depth,
                 pseudo_depth=depth)


def batch_iterator(scene: SyntheticScene, seed: int = 0, device="cuda") -> Iterator[Batch]:
    """Shuffled epoch iterator over the (traversal, frame) views, each
    view's tensors made once on `device`."""
    dev = resolve_device(device)
    pairs = [(t, f) for t in range(scene.n_travels) for f in range(scene.n_frames)]

    def epochs():
        rng = np.random.default_rng(seed)
        batches = {}
        while True:
            for i in rng.permutation(len(pairs)):
                if i not in batches:
                    batches[i] = make_batch(scene, *pairs[i], device=dev)
                yield batches[i]

    return epochs()


def build_scene_model(scene: SyntheticScene, *, with_instances: bool = True,
                      with_skybox: bool = False, capacity: int | None = None,
                      wild_appearance: bool = False, skybox_points: int = 2048,
                      device="cuda"):
    """SceneParams/SceneAux seeded from a synthetic scene, on `device`: a
    multicolour background with per-traversal SH rest, an optional skybox,
    the vehicle as one rigid instance with noisy initial poses (pose
    optimisation must recover them) and, with wild_appearance, the
    WildGaussians embeddings and MLP (one embedding per frame row)."""
    from mtgs_torch.models.gaussians import (
        init_node_from_points, init_skybox_node, node_capacity,
    )
    from mtgs_torch.models.scene_graph import InstanceAux, InstanceParams, init_scene

    dev = resolve_device(device)
    bg = init_node_from_points(
        scene.seed_xyz, scene.seed_rgb,
        capacity=capacity or node_capacity(len(scene.seed_xyz)),
        num_traversals=scene.n_travels, multi_feature_rest=True, device=dev,
    )
    sky = None
    if with_skybox:
        sky = init_skybox_node(
            num_points=skybox_points, radius=300.0, scene_extent=20.0,
            num_traversals=scene.n_travels, multi_feature_rest=True, device=dev,
        )
    inst = None
    if with_instances:
        node, naux = init_node_from_points(
            scene.instance_xyz, scene.instance_rgb,
            capacity=node_capacity(len(scene.instance_xyz), granule=1024), device=dev,
        )
        # noisy initial poses
        rng = np.random.default_rng(7)
        q0 = scene.instance_quats + rng.normal(0, 0.01, scene.instance_quats.shape)
        t0 = scene.instance_trans + rng.normal(0, 0.05, scene.instance_trans.shape)
        on = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype,
                                                            device=dev)
        params = InstanceParams(node=tree_map(lambda a: a[None], node),
                                quats=on(q0)[None], trans=on(t0)[None])
        iaux = InstanceAux(
            alive=naux.alive[None],
            num_alive=naux.num_alive[None],
            present=on(scene.instance_present)[None],
            is_static=torch.zeros((1,), dtype=torch.float32, device=dev),
            frame_timestamps=on(scene.timestamps.reshape(-1)),
            travel_of_frame=on(np.repeat(np.arange(scene.n_travels), scene.n_frames),
                               torch.int32),
            sizes=on(scene.instance_size)[None],
        )
        inst = (params, iaux)

    return init_scene(bg, sky, inst, num_cameras=1, num_images=scene.frame_rows,
                      wild_appearance=wild_appearance, device=dev)
