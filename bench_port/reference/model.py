"""The plain MTGS forward of one view and its losses.

The scene graph as the MTGS method states it: a background and a skybox
whose colour is SH of degree 3 with a per-traversal dc adapter and
per-traversal SH rest, rigid instances posed per frame and gated by
presence, every node's opacity a sigmoid masked by its live rows;
gaussian normals (the shortest axis, turned to the camera) as three more
colour channels; the camera pose delta (SO(3) x R^3) applied while
training; the rasterizer of `raster.py` with expected depth; a
per-camera exposure affine. Then the preset's losses: masked L1 and SSIM,
inverse-L1 LiDAR depth, depth NCC, normals against the pseudo depth's
normals with total variation, and the shape, box and pose regularisers.

`params` is a dict of leaf tensors named by the program's dotted paths;
`aux` the fixed per-row tensors (live masks, instance presence and boxes).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from bench_port.reference import raster
from bench_port.reference.raster import Prec, normalize, rotmat

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
      0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
      -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
DEGREE = (0,) + (1,) * 3 + (2,) * 5 + (3,) * 7


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """The 16 real SH bases of degree <= 3 at unit directions [N, 3]."""
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, C0), -C1 * y, C1 * z, -C1 * x,
        C2[0] * x * y, C2[1] * y * z, C2[2] * (2 * zz - xx - yy), C2[3] * x * z,
        C2[4] * (xx - yy),
        C3[0] * y * (3 * xx - yy), C3[1] * x * y * z, C3[2] * y * (4 * zz - xx - yy),
        C3[3] * z * (2 * zz - 3 * xx - 3 * yy), C3[4] * x * (4 * zz - xx - yy),
        C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)], -1)


def sh_colour(means, dc, rest, cam_pos, sh_mask, prec: Prec):
    """clamp(SH . basis + 0.5, 0, 1); the view direction carries no
    gradient to the means."""
    d = normalize(means.detach() - cam_pos, 1e-24)
    coeffs = torch.cat([dc[:, None, :], rest], 1)                 # [N, 16, 3]
    basis = (sh_basis(d) * sh_mask)[:, None, :]                   # [N, 1, 16]
    return torch.clamp(prec.mm(basis, coeffs)[:, 0] + 0.5, 0.0, 1.0)


def quat_mult(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def pose_delta(tangent: torch.Tensor) -> torch.Tensor:
    """exp of an SO(3) x R^3 tangent [6] as a 4x4 (rotation by Rodrigues)."""
    w, t = tangent[:3], tangent[3:]
    sq = (w * w).sum()
    small = sq < 1e-14
    one = torch.ones_like(sq)
    theta = torch.sqrt(torch.where(small, one, sq))
    a = torch.where(small, one, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 * one, (1 - torch.cos(theta)) / torch.where(small, one, sq))
    z = torch.zeros_like(sq)
    Kx = torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                      torch.stack([-w[1], w[0], z])])
    R = torch.eye(3, device=w.device) + a * Kx + b * (Kx @ Kx)
    top = torch.cat([R, t[:, None]], 1)
    return torch.cat([top, torch.tensor([[0.0, 0, 0, 1]], device=w.device)], 0)


def gather(params: Dict[str, torch.Tensor], aux: dict, view: dict, cam_pos, sh_mask,
           prec: Prec):
    """The world-space gaussians of one view: means, unit quats, linear
    scales, opacities and colours, node after node."""
    outs = []
    t = view["travel_index"]
    for node in ("background", "skybox"):
        if f"{node}.means" not in params:
            continue
        p = lambda k: params[f"{node}.{k}"]
        dc, rest = p("features_dc"), p("features_rest")
        if p("features_adapters").shape[1] > 0:
            dc = dc + p("features_adapters")[:, t]
            if rest.ndim == 4:
                rest = rest[:, t]
        opac = torch.sigmoid(p("opacities")[:, 0]) * aux[f"{node}.alive"]
        outs.append((p("means"), normalize(p("quats"), 1e-24), torch.exp(p("scales")), opac,
                     sh_colour(p("means"), dc, rest, cam_pos, sh_mask, prec)))
    if "instances.node.means" in params:
        p = lambda k: params[f"instances.node.{k}"]
        f = view["frame_idx"]
        static = aux["instances.is_static"][:, None]
        anchor = torch.argmax(aux["instances.present"], 1)
        rows = torch.arange(anchor.shape[0], device=anchor.device)
        q = params["instances.quats"]
        tr = params["instances.trans"]
        q = normalize(static * q[rows, anchor] + (1 - static) * q[:, f], 1e-24)
        tr = static * tr[rows, anchor] + (1 - static) * tr[:, f]
        gate = aux["instances.present"][:, f]
        I, cap = p("means").shape[:2]
        R = rotmat(q)                                            # [I, 3, 3]
        means = prec.mm(p("means"), R.transpose(1, 2)) + tr[:, None, :]
        quats = quat_mult(q[:, None, :].expand(I, cap, 4), normalize(p("quats"), 1e-24))
        opac = torch.sigmoid(p("opacities")[..., 0]) * aux["instances.node.alive"] \
            * gate[:, None]
        means = means.reshape(I * cap, 3)
        outs.append((means, quats.reshape(I * cap, 4), torch.exp(p("scales")).reshape(
            I * cap, 3), opac.reshape(I * cap), sh_colour(
            means, p("features_dc").reshape(I * cap, 3),
            p("features_rest").reshape(I * cap, -1, 3), cam_pos, sh_mask, prec)))
    return [torch.cat([o[i] for o in outs]) for i in range(5)]


def camera_normals(scales, quats, means, cam_pos, c2w_rot, prec: Prec):
    """Each gaussian's shortest axis, turned toward the camera, in the
    camera's (scene-frame) axes."""
    R = rotmat(normalize(quats, 1e-24))
    axis = F.one_hot(torch.argmin(scales, -1), 3).to(scales.dtype)
    n = normalize((R * axis[:, None, :]).sum(-1), 1e-24)
    v = normalize(cam_pos - means.detach(), 1e-24)
    sign = torch.where((n * v).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return prec.mm(n * sign, c2w_rot)


def view_matrix(c2w: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Scene-frame camera-to-world -> the cv-frame world-to-camera."""
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=c2w.device))
    R = prec.mm(c2w[:3, :3], flip)
    top = torch.cat([R.T, -prec.mm(R.T, c2w[:3, 3:4])], 1)
    return torch.cat([top, torch.tensor([[0.0, 0, 0, 1]], device=c2w.device)], 0)


def sh_mask(step: int, sh_degree: int, interval: int, device) -> torch.Tensor:
    n = min(step // interval, sh_degree)
    return torch.tensor([float(d <= n) for d in DEGREE], device=device)


class ViewForward:
    """One view's forward up to the blend's inputs, kept for the blend and
    its backward: the table rows, the tile lists and what the image needs."""

    def __init__(self, params, aux, cfg: dict, view: dict, step: int, width: int,
                 height: int, training: bool, prec: Prec, gather_fn=None):
        preset = cfg["preset"]
        dev = params["background.means"].device
        self.cfg, self.prec, self.width, self.height = cfg, prec, width, height
        self.tile = preset["tile_size"]
        c2w = view["c2w"].to(dev)
        if training:
            c2w = prec.mm(c2w, pose_delta(params["camera_opt"][view["image_idx"]]))
        self.c2w = c2w
        cam_pos = c2w[:3, 3]
        mask = sh_mask(step, preset["sh_degree"], cfg["sh_degree_interval"], dev)
        means, quats, scales, opac, colours = (gather_fn or gather)(params, aux, view, cam_pos,
                                                                    mask, prec)
        self.scales, self.opac = scales, opac
        if preset["predict_normals"]:
            colours = torch.cat([colours, camera_normals(scales, quats, means, cam_pos,
                                                         c2w[:3, :3], prec)], -1)
        K = view["K"].to(dev)
        self.K = K
        proj = raster.project(means, quats, scales, view_matrix(c2w, prec), K, width, height,
                              antialiased=preset["rasterize_mode"] == "antialiased",
                              prec=prec)
        self.proj = proj
        op_eff = opac * proj.comp
        self.table = torch.cat([proj.means2d, proj.conics, op_eff[:, None], colours,
                                proj.depths[:, None]], -1)
        self.c = self.table.shape[1] - 6
        self.lists = raster.tile_lists(proj, op_eff.detach(), width, height, self.tile)
        self.appearance = params["appearance"][view["cam_idx"]]

    def blocks(self, budget: int, chunk=None):
        return raster.tile_blocks(self.lists.count, budget, self.tile * self.tile, chunk)

    @torch.no_grad()
    def blend(self, budget: int = 1 << 26, chunk: int = 2048, stats: Optional[dict] = None):
        """accum [H, W, c] and transmittance [H, W], without autograd."""
        tiles_x = -(-self.width // self.tile)
        table = self.table.detach()
        lists = self.lists
        parts = [(ids, *raster.blend_block(table, lists.gauss, lists.start[ids],
                                           lists.count[ids], ids, self.tile, tiles_x, self.c,
                                           self.prec, chunk, stats))
                 for ids in self.blocks(budget, chunk)]
        return raster.assemble(parts, self.tile, self.width, self.height, self.c)

    def outputs(self, acc, t):
        """The view's images from the blend's accumulators (differentiable
        in both and in the exposure affine)."""
        alpha = (1.0 - t)[..., None]
        rgb = torch.clamp(acc[..., :3], 0.0, 1.0)   # black background
        M = self.appearance
        rgb_app = torch.clamp(self.prec.mm(rgb, M[:, :3].T) + M[:, 3], 0.0, 1.0)
        depth = acc[..., -1:] / torch.clamp(alpha, min=1e-10)
        depth = torch.where(alpha > 1e-6, depth, depth.detach().max())
        out = dict(rgb=rgb, rgb_appearance=rgb_app, depth=depth, accumulation=alpha)
        if self.cfg["preset"]["predict_normals"]:
            n = normalize(acc[..., 3:6], 1e-12)
            out["normal"] = (n + 1.0) / 2.0
        return out


# ------------------------------------------------------------------ losses

def masked_mean(x, m):
    m = torch.broadcast_to(m.to(x.dtype), x.shape)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def _window(size=11, sigma=1.5):
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).to(torch.float32).tolist()


def _blur(img, win):
    H, W, _ = img.shape
    k = len(win)
    a = sum(win[i] * img[i:i + H - k + 1] for i in range(k))
    return sum(win[i] * a[:, i:i + W - k + 1] for i in range(k))


def ssim(x, y, mask):
    win = _window()
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mx, my = _blur(x, win), _blur(y, win)
    sxx = _blur(x * x, win) - mx * mx
    syy = _blur(y * y, win) - my * my
    sxy = _blur(x * y, win) - mx * my
    s = ((2 * mx * my + C1) / (mx * mx + my * my + C1)) * ((2 * sxy + C2) / (sxx + syy + C2))
    return masked_mean(s, mask[5:-5, 5:-5])


def _patches(img, patch, stride):
    pad = patch // 2
    H, W = img.shape
    oh = (H + 2 * pad - patch) // stride + 1
    ow = (W + 2 * pad - patch) // stride + 1
    x = F.pad(img, (pad, (ow - 1) * stride + patch - W - pad,
                    pad, (oh - 1) * stride + patch - H - pad))
    return x.unfold(0, patch, stride).unfold(1, patch, stride).reshape(oh * ow, -1)


def ncc(pred, gt, mask, patch, stride):
    pd, gd = _patches(pred[..., 0], patch, stride), _patches(gt[..., 0], patch, stride)
    valid = (_patches(mask[..., 0].to(pred.dtype), patch, stride).amin(1) > 0.5).to(pred.dtype)

    def norm(p):
        c = p - p.mean(1, keepdim=True)
        return c / torch.sqrt((c * c).mean(1, keepdim=True) + 1e-8)

    v = (norm(pd) * norm(gd)).mean(1)
    return 1.0 - (v * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def depth_normals(depth, K):
    """(1 + n) / 2 of the normals of a depth map's back-projected points
    (central differences), flipped into the scene frame; zero border."""
    d = depth[..., 0]
    H, W = d.shape
    u = (torch.arange(W, device=d.device) + 0.5 - K[0, 2]) / K[0, 0]
    v = (torch.arange(H, device=d.device) + 0.5 - K[1, 2]) / K[1, 1]
    pts = torch.stack([u[None, :] * d, v[:, None] * d, d], -1)
    n = torch.cross(pts[1:-1, 2:] - pts[1:-1, :-2], pts[:-2, 1:-1] - pts[2:, 1:-1], dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    n = F.pad(n, (0, 0, 1, 1, 1, 1)) * torch.tensor([1.0, -1.0, -1.0], device=d.device)
    return (1.0 + n) / 2.0


def tv(img):
    return (img[:, :-1] - img[:, 1:]).abs().mean() + (img[:-1] - img[1:]).abs().mean()


def losses(cfg: dict, fwd: ViewForward, out: dict, targets: dict, params: dict, aux: dict,
           step: int) -> Dict[str, torch.Tensor]:
    """The preset's losses of one view, by name."""
    w = cfg["preset"]["loss"]
    gt, mask = targets["image"], targets["mask"]
    pred = out["rgb_appearance"]
    L = {"l1": (1 - w["ssim_lambda"]) * masked_mean((gt - pred).abs(), mask)}
    if w["ssim_lambda"] > 0:
        L["ssim"] = w["ssim_lambda"] * (1 - ssim(gt, pred, mask))
    if w["depth_lambda"] > 0:
        lid = targets["lidar_depth"]
        dm = (lid > 0.1) & (lid < 80.0) & (mask > 0)
        p = torch.clamp(out["depth"], min=0.01)
        L["depth"] = w["depth_lambda"] * masked_mean(
            (1.0 / (lid + 1e-5) - 1.0 / (p + 1e-5)).abs(), dm)
    pseudo = targets.get("pseudo_depth")
    if w["ncc_lambda"] > 0 and pseudo is not None:
        dm = (pseudo > 0.1) & (pseudo < 80.0) & (mask > 0)
        L["ncc"] = w["ncc_lambda"] * ncc(out["depth"], pseudo, dm, w["ncc_patch_size"],
                                         w["ncc_stride"])
    if w["use_normal_loss"] and "normal" in out:
        d = pseudo if pseudo is not None else targets["lidar_depth"]
        nm = (d > 0.1) & (d < 50.0) & (mask > 0)
        nl = masked_mean((depth_normals(d, fwd.K) - out["normal"]).abs(), nm)
        if w["use_normal_tv_loss"]:
            nl = nl + tv(out["normal"])
        L["normal"] = w["normal_lambda"] * nl
    alive = (fwd.opac > 0).to(fwd.scales.dtype)
    if w["two_d_gaussians"]:
        L["two_d_reg"] = masked_mean(fwd.scales.amin(-1), alive)
    if w["sharp_shape_reg_lambda"] > 0:
        s = torch.sort(fwd.scales, -1, descending=True).values
        other = s[..., 1] if w["two_d_gaussians"] else s[..., 2]
        ratio = s[..., 0] / torch.clamp(other, min=1e-12)
        every = float(step % w["sharp_shape_reg_step_interval"] == 0)
        L["sharp_shape"] = every * (w["sharp_shape_reg_lambda"] * masked_mean(
            torch.clamp(ratio, min=w["sharp_shape_max_ratio"]) - w["sharp_shape_max_ratio"],
            alive))
    if w["oob_lambda"] > 0 and "instances.node.means" in params:
        bound = aux["instances.sizes"][:, None, :] / 2.0 + w["oob_tolerance"]
        oob = (params["instances.node.means"].detach().abs() > bound).any(-1)
        oob = oob.to(torch.float32) * aux["instances.node.alive"]
        pen = -torch.log(1.0 - torch.sigmoid(params["instances.node.opacities"][..., 0]) + 1e-6)
        L["oob"] = w["oob_lambda"] * (pen * oob).sum() / torch.clamp(oob.sum(), min=1.0)
    co = params["camera_opt"]
    norm = lambda x: torch.sqrt((x * x).sum(-1) + 1e-12)
    L["camera_opt"] = w["camera_opt_trans_penalty"] * norm(co[:, 3:]).mean() \
        + w["camera_opt_rot_penalty"] * norm(co[:, :3]).mean()
    return L


LEAVES = ("means", "scales", "quats", "features_dc", "features_rest", "opacities",
          "features_adapters")


def flat_scene(raw: dict):
    """(params, aux) of a raw scene (`bench_port.scene.make_scene`): the
    parameters as copies named by the program's leaf paths, and the fixed
    per-row tensors."""
    params, aux = {}, {}
    for node in ("background", "skybox"):
        if raw[node] is not None:
            params.update({f"{node}.{k}": raw[node][k].clone() for k in LEAVES})
            aux[f"{node}.alive"] = raw[node]["alive"]
    if raw["instances"] is not None:
        r = raw["instances"]
        params.update({f"instances.node.{k}": r["node"][k].clone() for k in LEAVES})
        params["instances.quats"] = r["quats"].clone()
        params["instances.trans"] = r["trans"].clone()
        aux["instances.node.alive"] = r["node"]["alive"]
        for k in ("present", "is_static", "sizes"):
            aux[f"instances.{k}"] = r[k]
    params["appearance"] = raw["appearance"].clone()
    params["camera_opt"] = raw["camera_opt"].clone()
    return params, aux
