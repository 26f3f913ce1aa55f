"""The benchmark's inputs, drawn from the seed on the device: the gaussians
of a road block, the cameras of its views and the training targets.

The layout is `bench.py`'s (a ground carpet, structures and a far shell,
lognormal scales), scaled to a configuration's node sizes, with a
skybox shell and rigid instances (cars on the road) where the
configuration has them. Every tensor is plain torch, made in a few large
calls with one `torch.Generator` on the device, so the same seed gives the
same inputs on the same device. Nothing here imports the program: the
harness wraps these tensors into the program's containers and the
reference reads them as they are.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch

SH_REST = 15  # SH degree 3: 16 bases, the dc one kept apart
C0 = 0.28209479177387814
MASK64 = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named stream of a run's seed; any
    whole seed (the driver's exceed 32 bits) maps into torch's 64 bits."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919) & MASK64)
    return g


def capacity(n: int, granule: int) -> int:
    """A node's padded capacity: n rounded up to the granule (the
    program's convention; pad rows are dead)."""
    return max(granule, -(-n // granule) * granule)


def _lognormal(g, n, mu, sigma, dev):
    return torch.exp(mu + sigma * torch.randn((n, 3), generator=g, device=dev))


def _uniform(g, shape, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)


def _node(g, means, log_scales, n_cap, traversals, multi_rest, dev):
    """The raw parameters of one node: live rows first, dead pad rows
    (alive 0, zero opacity logit) after them."""
    n = means.shape[0]
    pad = n_cap - n

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x

    rgb = torch.rand((n, 3), generator=g, device=dev)
    opac = _uniform(g, (n, 1), 0.3, 0.95, dev)
    rest_shape = (n, traversals, SH_REST, 3) if multi_rest else (n, SH_REST, 3)
    return dict(
        means=padded(means),
        scales=padded(log_scales),
        quats=padded(torch.randn((n, 4), generator=g, device=dev)),
        features_dc=padded((rgb - 0.5) / C0),
        features_rest=padded(0.05 * torch.randn(rest_shape, generator=g, device=dev)),
        opacities=padded(torch.log(opac / (1.0 - opac))),
        features_adapters=padded(0.05 * torch.randn((n, traversals, 3), generator=g,
                                                    device=dev)),
        alive=padded(torch.ones((n,), device=dev)),
    )


def make_scene(cfg: dict, seed: int, device) -> Dict[str, object]:
    """The raw scene of a configuration (`cfg["scene"]`) for a seed: dicts
    of tensors for the background, the skybox and the instances, the
    exposure affines and the camera-pose deltas."""
    sc, lay = cfg["scene"], cfg["scene"]["layout"]
    dev = torch.device(device)
    g = generator(seed, 1, dev)
    T = sc["traversals"]
    colour_t = T if sc["multicolor"] else 0
    n = sc["background"]
    n_ground = int(n * lay["ground_share"])
    n_struct = int(n * lay["struct_share"])
    n_far = n - n_ground - n_struct
    (x0, x1), (gy0, gy1) = lay["road_x"], lay["ground_y"]
    ground = torch.stack([_uniform(g, (n_ground,), x0, x1, dev),
                          _uniform(g, (n_ground,), gy0, gy1, dev),
                          torch.zeros((n_ground,), device=dev)], -1)
    struct = torch.stack([_uniform(g, (n_struct,), x0, x1, dev),
                          _uniform(g, (n_struct,), *lay["struct_y"], dev),
                          _uniform(g, (n_struct,), *lay["struct_z"], dev)], -1)
    far = _shell(g, n_far, lay["far_radius"], dev)
    log_s = torch.log(torch.cat([
        _lognormal(g, n_ground, *lay["ground_log_scale"], dev),
        _lognormal(g, n_struct, *lay["struct_log_scale"], dev),
        _lognormal(g, n_far, *lay["far_log_scale"], dev)]))
    bg = _node(g, torch.cat([ground, struct, far]), log_s,
               capacity(n, sc["granule"]), colour_t, sc["multi_feature_rest"], dev)

    sky = None
    if sc["skybox"] > 0:
        m = sc["skybox"]
        sky = _node(g, _shell(g, m, lay["sky_radius"], dev),
                    torch.log(_lognormal(g, m, *lay["sky_log_scale"], dev)),
                    capacity(m, sc["granule"]), colour_t, sc["multi_feature_rest"], dev)

    rows = T * sc["frames_per_traversal"]
    inst = None
    if sc["instances"] > 0:
        inst = _instances(g, sc, lay, rows, dev)
    appearance = torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)], 1)
    appearance = appearance[None] + 1e-3 * torch.randn((1, 3, 4), generator=g, device=dev)
    camera_opt = 1e-4 * torch.randn((rows, 6), generator=g, device=dev)
    return dict(background=bg, skybox=sky, instances=inst, appearance=appearance,
                camera_opt=camera_opt, traversals=T, rows=rows)


def _shell(g, n, radius, dev):
    theta = _uniform(g, (n,), 0.0, 2 * math.pi, dev)
    phi = _uniform(g, (n,), math.pi / 4, math.pi / 2, dev)
    return radius * torch.stack([torch.sin(phi) * torch.cos(theta),
                                 torch.sin(phi) * torch.sin(theta), torch.cos(phi)], -1)


def _instances(g, sc, lay, rows, dev):
    """Rigid cars on the road: local gaussians in a box (some outside it,
    as a trained car has), one pose a frame row, driving along +x."""
    I, m = sc["instances"], sc["instance_size"]
    cap = capacity(m, sc["instance_granule"])
    size = torch.tensor(lay["car_size"], device=dev)
    local = (torch.rand((I, m, 3), generator=g, device=dev) - 0.5) * size * 1.2
    log_s = torch.log(_lognormal(g, I * m, *lay["car_log_scale"], dev)).reshape(I, m, 3)
    node = _node(g, local.reshape(I * m, 3), log_s.reshape(I * m, 3), I * m, 0, False, dev)
    node = {k: v.reshape((I, m) + tuple(v.shape[1:])) for k, v in node.items()}
    pad = cap - m
    if pad:
        node = {k: torch.cat([v, v.new_zeros((I, pad) + tuple(v.shape[2:]))], 1)
                for k, v in node.items()}
    x_start = _uniform(g, (I, 1), lay["road_x"][0] + 15.0, lay["road_x"][1] - 30.0, dev)
    lane = torch.tensor(lay["car_lanes"], device=dev)[torch.arange(I, device=dev) % len(
        lay["car_lanes"])]
    speed = _uniform(g, (I, 1), 0.0, 1.0, dev)
    frame = torch.arange(rows, device=dev, dtype=torch.float32)[None]
    trans = torch.stack([x_start + speed * frame, lane[:, None].expand(I, rows),
                         torch.full((I, rows), size[2].item() / 2, device=dev)], -1)
    yaw = 0.02 * torch.randn((I, 1), generator=g, device=dev).expand(I, rows)
    quats = torch.stack([torch.cos(yaw / 2), torch.zeros_like(yaw), torch.zeros_like(yaw),
                         torch.sin(yaw / 2)], -1)
    T, F = sc["traversals"], sc["frames_per_traversal"]
    return dict(
        node=node, quats=quats, trans=trans,
        present=torch.ones((I, rows), device=dev),
        is_static=torch.zeros((I,), device=dev),
        frame_timestamps=torch.arange(rows, device=dev, dtype=torch.float32) * 0.1,
        travel_of_frame=torch.arange(T, device=dev, dtype=torch.int32).repeat_interleave(F),
        sizes=size[None].expand(I, 3).contiguous())


def make_views(cfg: dict, width: int, height: int) -> List[dict]:
    """Front cameras along the road, one a (traversal, frame): `bench.py`'s
    pose (looking along +x, 1.6 m up) moved forward frame by frame, each
    traversal in its own lane, its focal length scaled with the width."""
    cam = cfg["scene"]["cameras"]
    F = cfg["scene"]["frames_per_traversal"]
    f = cam["focal_960"] * width / 960.0
    K = torch.tensor([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    views = []
    for t in range(cfg["scene"]["traversals"]):
        for i in range(F):
            c2w = torch.eye(4)
            c2w[:3, 0] = torch.tensor([0.0, -1.0, 0.0])
            c2w[:3, 1] = torch.tensor([0.0, 0.0, 1.0])
            c2w[:3, 2] = torch.tensor([-1.0, 0.0, 0.0])
            c2w[:3, 3] = torch.tensor([cam["x0"] + cam["dx"] * i,
                                       cam["lanes"][t % len(cam["lanes"])], cam["height"]])
            row = t * F + i
            views.append(dict(c2w=c2w, K=K.clone(), cam_idx=0, image_idx=row,
                              travel_index=t, frame_idx=row, timestamp=0.1 * row))
    return views


def make_targets(view: dict, width: int, height: int, seed: int, index: int,
                 device) -> Dict[str, torch.Tensor]:
    """A view's training targets, made by the benchmark alone: a smooth
    sky-and-road image with low-frequency noise, an ego-hood mask, a
    ground-plane depth field (dense, as the pseudo depth) and its sparse
    LiDAR sampling (every fourth row, half the columns)."""
    dev = torch.device(device)
    g = generator(seed, 1000 + index, dev)
    H, W = height, width
    y = torch.arange(H, device=dev, dtype=torch.float32)[:, None].expand(H, W)
    f, cy = float(view["K"][1, 1]), float(view["K"][1, 2])
    below = (y + 0.5 - cy).clamp(min=1e-3)
    ground = (1.6 * f / below).clamp(max=80.0)
    far = 20.0 + 60.0 * torch.rand((1, W), generator=g, device=dev).expand(H, W)
    depth = torch.where(y + 0.5 > cy + 8.0, ground, far)
    coarse = torch.rand((1, 3, 9, 17), generator=g, device=dev)
    noise = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                            align_corners=False)[0].permute(1, 2, 0)
    sky = torch.tensor([0.55, 0.65, 0.8], device=dev).expand(H, W, 3)
    road = torch.full((H, W, 3), 0.35, device=dev)
    image = (torch.where((y > cy)[..., None], road, sky) * 0.7 + 0.3 * noise).clamp(0, 1)
    mask = (y < 0.9 * H).to(torch.float32)[..., None]
    rows = (torch.arange(H, device=dev) % 4 == 0)[:, None]
    cols = torch.rand((H, W), generator=g, device=dev) < 0.5
    lidar = torch.where(rows & cols, depth, torch.zeros_like(depth))[..., None]
    pseudo = depth[..., None] * (1.0 + 0.02 * (noise[..., :1] - 0.5))
    return dict(image=image, mask=mask, lidar_depth=lidar, pseudo_depth=pseudo)


def alive_by_node(raw: dict) -> Dict[str, torch.Tensor]:
    """Each node's live-row mask, by the leaf-path prefix of its leaves."""
    out = {"background": raw["background"]["alive"]}
    if raw["skybox"] is not None:
        out["skybox"] = raw["skybox"]["alive"]
    if raw["instances"] is not None:
        out["instances.node"] = raw["instances"]["node"]["alive"]
    return out


def adam_moments(path: str, shape: Tuple[int, ...], alive: Dict[str, torch.Tensor],
                 grad_rms: Dict[str, float], spec: dict, seed: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam's moments (mu, nu) of one leaf at the run's start step, as a
    long run holds them, drawn from the seed: each element's gradient
    scale s is the leaf's first-gradient RMS (`grad_rms`, the
    configuration's) times a lognormal factor exp(spec["log_spread"] z1);
    nu = s^2 and mu = spec["mu_share"] s z2. Dead rows hold zeros (as the
    refine's surgery leaves them). A leaf with no elements has none."""
    dev = torch.device(device)
    if math.prod(shape) == 0:
        z = torch.zeros(shape, device=dev)
        return z, z.clone()
    g = generator(seed, 5000 + zlib.crc32(path.encode()) % 1_000_003, dev)
    s = grad_rms[path] * torch.exp(spec["log_spread"] * torch.randn(shape, generator=g,
                                                                    device=dev))
    mu = spec["mu_share"] * s * torch.randn(shape, generator=g, device=dev)
    nu = s * s
    del s
    node = path.rsplit(".", 1)[0]
    if node in alive:
        a = alive[node]
        live = a.reshape(tuple(a.shape) + (1,) * (len(shape) - a.ndim)).to(mu.dtype)
        mu.mul_(live)
        nu.mul_(live)
    return mu, nu


def view_order(n_views: int, seed: int) -> List[int]:
    """The order in which a run visits the views: a permutation drawn from
    the seed (on the host, so every device agrees), each view once a cycle."""
    g = torch.Generator()
    g.manual_seed(int(seed) & MASK64)
    return torch.randperm(n_views, generator=g).tolist()


def sample_views(n_views: int, k: int, seed: int) -> List[int]:
    """The views whose outputs a render run checks: k of them, drawn from
    the seed."""
    return sorted(view_order(n_views, seed + 1)[:k])
