"""A plain rasterizer of 3D gaussians, written from gsplat v1.4's rules.

EWA projection (the field-of-view clamped Jacobian, a 0.3 px blur, the
antialiased opacity compensation, a 3-sigma radius), tile lists sorted by
depth, and the front-to-back blend: alpha = min(0.999, o exp(-sigma)),
skipped where sigma < 0 or alpha < 1/255, and a pixel stops before the
gaussian that would take its transmittance to 1e-4 or below. Everything
is float32 and straightforward torch; the products that are matrix
products are written as such (`Prec.mm`), so a lower matmul precision
shows. The blend runs over blocks of tiles and chunks of each tile's
list, so a scene of millions of gaussians fits, with or without autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_MIN = 1e-4


@dataclass(frozen=True)
class Prec:
    """The reference's matmul precision: float32, or (`tf32`) each
    operand's mantissa rounded to TF32's 10 bits first, as a tensor core
    in TF32 mode reads them (the control of the comparison)."""

    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = _ToTF32.apply(a), _ToTF32.apply(b)
        return torch.matmul(a, b)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _ToTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return to_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return to_tf32(g)


def normalize(x: torch.Tensor, eps2: float) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + eps2)


def rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit wxyz quaternions [..., 4] -> rotation matrices [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


@dataclass
class Projected:
    means2d: torch.Tensor    # [N, 2]
    conics: torch.Tensor     # [N, 3] (a, b, c) of the inverse blurred 2D covariance
    depths: torch.Tensor     # [N] camera z
    radii: torch.Tensor      # [N] float, 0 where culled
    comp: torch.Tensor       # [N] antialiasing compensation (1 when classic)
    valid: torch.Tensor      # [N] bool


def project(means, quats, scales, viewmat, K, width: int, height: int, *, antialiased: bool,
            prec: Prec, near: float = 0.01, far: float = 1e10) -> Projected:
    """gsplat's `fully_fused_projection` for one camera (cv frame)."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    pc = prec.mm(means, R.T) + t
    x, y, z = pc.unbind(-1)
    n = means.shape[0]
    M = prec.mm(R.expand(n, 3, 3), rotmat(normalize(quats, 1e-24))) * scales[:, None, :]
    cov = prec.mm(M, M.transpose(1, 2))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    lim_xp = (width - cx) / fx + 0.3 * (0.5 * width / fx)
    lim_xn = cx / fx + 0.3 * (0.5 * width / fx)
    lim_yp = (height - cy) / fy + 0.3 * (0.5 * height / fy)
    lim_yn = cy / fy + 0.3 * (0.5 * height / fy)
    z_ok = z > near
    zs = torch.where(z_ok, z, torch.ones_like(z))
    tx = zs * torch.clamp(x / zs, -lim_xn, lim_xp)
    ty = zs * torch.clamp(y / zs, -lim_yn, lim_yp)
    zero = torch.zeros_like(zs)
    J = torch.stack([torch.stack([fx / zs, zero, -fx * tx / (zs * zs)], -1),
                     torch.stack([zero, fy / zs, -fy * ty / (zs * zs)], -1)], -2)
    cov2 = prec.mm(prec.mm(J, cov), J.transpose(1, 2))
    a, b, c = cov2[:, 0, 0], cov2[:, 0, 1], cov2[:, 1, 1]
    det0 = a * c - b * b
    ab, cb = a + 0.3, c + 0.3
    det = ab * cb - b * b
    if antialiased:
        ratio = det0 / torch.clamp(det, min=1e-32)
        pos = ratio > 0
        comp = torch.where(pos, torch.sqrt(torch.where(pos, ratio, torch.ones_like(ratio))),
                           torch.zeros_like(ratio))
    else:
        comp = torch.ones_like(det)
    det_ok = det > 1e-16
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([cb * inv, -b * inv, ab * inv], -1)
    mid = 0.5 * (ab + cb)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det,
                                                                        min=0.01))))
    m2d = torch.stack([fx * x / zs + cx, fy * y / zs + cy], -1)
    valid = z_ok & (z < far) & det_ok & (radius > 0)
    valid &= (m2d[:, 0] + radius > 0) & (m2d[:, 0] - radius < width)
    valid &= (m2d[:, 1] + radius > 0) & (m2d[:, 1] - radius < height)
    radii = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(m2d, conics, z, radii.detach(), comp, valid)


def tile_rects(m2d, radii, conics, op_eff, live, width, height, tile, *, support_margin):
    """Each gaussian's tile rectangle (x0, x1, y0, y1), ends exclusive:
    gsplat's 3-sigma box, cut where `support_margin` is given to the box of
    the pixels whose alpha can reach 1/255 (widened by that margin in
    pixels and 2%, so the cut drops no pixel the blend would use).
    Gaussians with no tile get an empty rectangle."""
    tiles_x, tiles_y = -(-width // tile), -(-height // tile)
    rx = ry = radii
    if support_margin is not None:
        a, b, c = conics.unbind(-1)
        det = torch.clamp(a * c - b * b, min=1e-24)
        s_cut = torch.log(torch.clamp(op_eff, min=1e-12) * 255.0) * 1.02
        pos = s_cut > 0

        def ext(d):
            e = torch.sqrt(torch.clamp(2.0 * s_cut * d / det, min=0.0)) + support_margin
            return torch.where(pos, e, torch.zeros_like(e))

        rx, ry = torch.minimum(radii, ext(c)), torch.minimum(radii, ext(a))
        live = live & (op_eff >= ALPHA_MIN)
    x0 = torch.clamp(torch.floor((m2d[:, 0] - rx) / tile), 0, tiles_x).long()
    x1 = torch.clamp(torch.ceil((m2d[:, 0] + rx) / tile), 0, tiles_x).long()
    y0 = torch.clamp(torch.floor((m2d[:, 1] - ry) / tile), 0, tiles_y).long()
    y1 = torch.clamp(torch.ceil((m2d[:, 1] + ry) / tile), 0, tiles_y).long()
    x1 = torch.where(live, x1, x0)
    return x0, x1, y0, y1


@dataclass
class TileLists:
    """Every (tile, gaussian) pair, sorted by tile and, within a tile, by
    depth (ties by index): `gauss` [P], each tile's `start` and `count`."""

    gauss: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor


@torch.no_grad()
def tile_lists(proj: Projected, op_eff, width, height, tile, *,
               support_margin: Optional[float] = 1.0) -> TileLists:
    live = proj.valid & (op_eff > 0)
    x0, x1, y0, y1 = tile_rects(proj.means2d, proj.radii, proj.conics, op_eff, live, width,
                                height, tile, support_margin=support_margin)
    tiles_x, n_tiles = -(-width // tile), -(-width // tile) * -(-height // tile)
    sx, sy = (x1 - x0).clamp(min=0), (y1 - y0).clamp(min=0)
    cnt = sx * sy
    n = cnt.shape[0]
    rank = torch.empty(n, dtype=torch.long, device=cnt.device)
    rank[torch.sort(proj.depths.detach(), stable=True).indices] = torch.arange(
        n, device=cnt.device)
    g = torch.repeat_interleave(torch.arange(n, device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(g.shape[0], device=cnt.device) - first[g]
    ly, lx = local // sx[g], local % sx[g]
    tiles = (y0[g] + ly) * tiles_x + x0[g] + lx
    order = torch.argsort(tiles * n + rank[g])
    tiles, g = tiles[order], g[order]
    count = torch.bincount(tiles, minlength=n_tiles)
    return TileLists(g, torch.cumsum(count, 0) - count, count)


def blend_block(table, gauss, start, count, tile_ids, tile: int, tiles_x: int, c: int,
                prec: Prec, chunk: int, stats: Optional[dict] = None):
    """Front-to-back blend of some tiles. table [N, 6 + c]: mx, my, conic
    a, b, c, opacity, c colour channels; tile b of `tile_ids` blends the
    rows gauss[start[b] : start[b] + count[b]], in that order. Returns
    (accum [B, PIX, c], t_final [B, PIX]). `stats`, where given, counts the work these tiles
    need (`work.blend_forward_work`): "pair_support", the (pixel, gaussian)
    pairs a pixel still open reaches inside the splat's 1/255 support;
    "pair_blends", those composited; "pair_clamped", those composited at
    alpha 0.999; "pairs_read", each tile's gaussians that some pixel of it
    composites or terminates on, the least a blend must read."""
    dev = table.device
    B = tile_ids.shape[0]
    P = tile * tile
    p = torch.arange(P, device=dev)
    px = ((tile_ids % tiles_x) * tile)[:, None] + (p % tile)[None] + 0.5
    py = ((tile_ids // tiles_x) * tile)[:, None] + (p // tile)[None] + 0.5
    px, py = px.to(torch.float32), py.to(torch.float32)
    T = torch.ones((B, P), device=dev)
    done = torch.zeros((B, P), dtype=torch.bool, device=dev)
    acc = torch.zeros((B, P, c), device=dev)
    kmax = int(count.max()) if B else 0
    for k0 in range(0, kmax, chunk):
        lane = k0 + torch.arange(min(chunk, kmax - k0), device=dev)
        ok = lane[None] < count[:, None]
        idx = gauss[torch.where(ok, start[:, None] + lane[None], 0)]
        r = table[idx]                                   # [B, k, 6 + c]
        dx = r[:, None, :, 0] - px[:, :, None]
        dy = r[:, None, :, 1] - py[:, :, None]
        sigma = 0.5 * (r[:, None, :, 2] * dx * dx + r[:, None, :, 4] * dy * dy) \
            + r[:, None, :, 3] * dx * dy
        raw = r[:, None, :, 5] * torch.exp(-sigma)
        contrib = (sigma >= 0) & (raw >= ALPHA_MIN) & ok[:, None, :] & ~done[..., None]
        alpha = torch.where(contrib, torch.clamp(raw, max=ALPHA_MAX), torch.zeros_like(raw))
        om = 1.0 - alpha
        nxt = T[..., None] * torch.cumprod(om, -1)
        keep = nxt > T_MIN
        before = torch.cat([T[..., None], nxt[..., :-1]], -1)
        w = alpha * before * keep
        if stats is not None:
            _count(stats, contrib, keep, raw)
        acc = acc + prec.mm(w, r[:, :, 6:])
        T = T * torch.prod(torch.where(keep, om, torch.ones_like(om)), -1)
        done = done | (contrib & ~keep).any(-1)
        if bool(done.all()):
            break
    return acc, T


@torch.no_grad()
def _count(stats, contrib, keep, raw):
    blends = contrib & keep
    add = dict(pair_support=int(contrib.sum()), pair_blends=int(blends.sum()),
               pair_clamped=int((blends & (raw > ALPHA_MAX)).sum()),
               pairs_read=int(contrib.any(1).sum()))
    for k, v in add.items():
        stats[k] = stats.get(k, 0) + v


def tile_blocks(count: torch.Tensor, budget: int, pix: int, chunk: Optional[int] = None):
    """Tiles grouped into blocks of similar list length, longest first.
    Without autograd (`chunk` given) a block's [B, PIX, chunk] temporaries
    hold at most `budget` elements; with autograd, which keeps every
    chunk's, its [B, PIX, longest list]."""
    order = torch.argsort(count, descending=True).tolist()
    lengths = count.tolist()
    blocks, i = [], 0
    while i < len(order):
        lanes = chunk if chunk is not None else max(lengths[order[i]], 1)
        per = max(1, budget // (pix * lanes))
        blocks.append(torch.tensor(order[i:i + per], device=count.device))
        i += per
    return blocks


def assemble(parts, tile: int, width: int, height: int, c: int):
    """Per-tile (ids, accum, t_final) blocks -> accum [H, W, c], t [H, W]."""
    tiles_x, tiles_y = -(-width // tile), -(-height // tile)
    dev = parts[0][1].device
    acc = torch.zeros((tiles_x * tiles_y, tile * tile, c), device=dev)
    t = torch.ones((tiles_x * tiles_y, tile * tile), device=dev)
    for ids, a, tt in parts:
        acc[ids] = a
        t[ids] = tt
    acc = acc.reshape(tiles_y, tiles_x, tile, tile, c).permute(0, 2, 1, 3, 4)
    t = t.reshape(tiles_y, tiles_x, tile, tile).permute(0, 2, 1, 3)
    acc = acc.reshape(tiles_y * tile, tiles_x * tile, c)[:height, :width]
    t = t.reshape(tiles_y * tile, tiles_x * tile)[:height, :width]
    return acc, t


def to_image_grad(g_acc, g_t, ids, tile: int, width: int, height: int):
    """The image cotangents of one block of tiles, tile-major: the
    inverse of `assemble` for those tiles (pixels past the image get 0)."""
    tiles_x = -(-width // tile)
    ty, tx = ids // tiles_x, ids % tiles_x
    p = torch.arange(tile * tile, device=ids.device)
    yy = ty[:, None] * tile + p[None] // tile
    xx = tx[:, None] * tile + p[None] % tile
    inside = (yy < height) & (xx < width)
    yy, xx = yy.clamp(max=height - 1), xx.clamp(max=width - 1)
    ga = g_acc[yy, xx] * inside[..., None]
    gt = g_t[yy, xx] * inside
    return ga, gt
