"""The plain training step of the MTGS presets and the plain view render.

A step: the view's forward (`model.ViewForward`), the blend without
autograd, the losses and their gradient with respect to the blend's
accumulators, then the blend again block by block of tiles with autograd,
each block's accumulator gradient pulled back to its (tile, gaussian)
rows, those rows summed into the gaussians' table gradient (and their
|d means2d| into the densify signal, summed over tiles), and the table
gradient pulled back through the projection and the scene graph to the
parameters. Then Adam per parameter group, with the preset's table of
learning rates and schedules (nerfstudio's exponential decay), and the
densify statistics.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from bench_port.reference import model
from bench_port.reference.raster import Prec, blend_block, to_image_grad

BUDGET = 1 << 25   # elements of a block's [B, PIX, longest list] under autograd
CHUNK = 2048


def schedule(spec: dict, count: int, max_steps: int) -> float:
    """A group's learning rate at Adam's step count (float64 on the host)."""
    lr, warm = spec["lr"], spec.get("warmup_steps", 0)
    if warm > 0:
        lr0 = spec["lr_pre_warmup"] + (lr - spec["lr_pre_warmup"]) * math.sin(
            0.5 * math.pi * min(max(count / warm, 0.0), 1.0))
    else:
        lr0 = lr
    if spec.get("lr_final") is None or lr <= 0:
        return lr0
    t = min(max((count - warm) / max(max_steps - warm, 1), 0.0), 1.0)
    return lr0 * math.exp(math.log(lr) * (1 - t) + math.log(spec["lr_final"]) * t) / lr


def group_of(path: str, params: Dict[str, torch.Tensor]) -> str:
    """The optimizer group of a parameter path (MTGS.py's table): a node's
    colour leaves are the multicolour groups where it has adapters."""
    if path in ("appearance", "camera_opt"):
        return path
    if path == "instances.quats":
        return "ins_rotation"
    if path == "instances.trans":
        return "ins_translation"
    node, leaf = path.rsplit(".", 1)
    multi = params[f"{node}.features_adapters"].shape[-2] > 0
    if leaf == "features_adapters":
        return "multicolor.features_adapters"
    if leaf in ("features_dc", "features_rest"):
        return ("multicolor." if multi else "") + leaf
    return leaf


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-15) with one learning rate per group;
    a step with a non-finite gradient changes nothing."""

    def __init__(self, params: Dict[str, torch.Tensor], groups: dict, count: int,
                 max_steps: int, moments=None):
        self.groups, self.count, self.max_steps = groups, count, max_steps
        self.mu, self.nu = {}, {}
        for k, v in params.items():
            if moments is None:
                self.mu[k], self.nu[k] = torch.zeros_like(v), torch.zeros_like(v)
            else:
                self.mu[k], self.nu[k] = moments(k, tuple(v.shape))

    @torch.no_grad()
    def step(self, params, grads):
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            return False
        c = self.count + 1
        bc1, bc2 = 1 - 0.9 ** c, 1 - 0.999 ** c
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = 0.1 * g + 0.9 * self.mu[k]
            self.nu[k] = 0.001 * g * g + 0.999 * self.nu[k]
            lr = schedule(self.groups[group_of(k, params)], self.count, self.max_steps)
            p.sub_(lr * ((self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-15)))
        self.count = c
        return True


def _leaves(params):
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


def step_grads(cfg: dict, params: Dict[str, torch.Tensor], aux: dict, view: dict,
               targets: dict, step: int, width: int, height: int, prec: Prec, gather=None):
    """One view's loss, its gradient for every parameter and the densify
    signal: (total, losses, grads, absgrad [N, 2], radii [N], opacities
    [N], compensations [N])."""
    fwd = model.ViewForward(params, aux, cfg, view, step, width, height, True, prec, gather)
    acc, t = fwd.blend(chunk=CHUNK)
    acc, t = acc.requires_grad_(True), t.requires_grad_(True)
    out = fwd.outputs(acc, t)
    L = model.losses(cfg, fwd, out, targets, params, aux, step)
    total = sum(L.values())
    leaves = list(params.values())
    g_direct = torch.autograd.grad(total, leaves + [acc, t], allow_unused=True,
                                   retain_graph=True)
    g_acc, g_t = (torch.zeros_like(x) if g is None else g
                  for x, g in zip((acc, t), g_direct[-2:]))
    table = fwd.table.detach()
    g_table = torch.zeros_like(table)
    absgrad = torch.zeros((table.shape[0], 2), device=table.device)
    tiles_x = -(-width // fwd.tile)
    for ids in fwd.blocks(BUDGET):
        # each (tile, gaussian) pair gets a row of its own, so its gradient
        # is the pair's: summed into the gaussian's, and |d means2d| into
        # the densify signal
        count = fwd.lists.count[ids]
        owner = torch.cat([fwd.lists.gauss[s:s + c] for s, c in
                           zip(fwd.lists.start[ids].tolist(), count.tolist())])
        rows = table[owner].requires_grad_(True)
        a, tt = blend_block(rows, torch.arange(owner.shape[0], device=owner.device),
                            torch.cumsum(count, 0) - count, count, ids, fwd.tile, tiles_x,
                            fwd.c, prec, CHUNK)
        ga, gt = to_image_grad(g_acc, g_t, ids, fwd.tile, width, height)
        (g_rows,) = torch.autograd.grad([a, tt], [rows], [ga, gt], allow_unused=True)
        if g_rows is None:
            continue
        g_table.index_add_(0, owner, g_rows)
        absgrad.index_add_(0, owner, g_rows[:, :2].abs())
    g_back = torch.autograd.grad(fwd.table, leaves, g_table, allow_unused=True)
    grads = {}
    for (k, p), a, b in zip(params.items(), g_direct[:-2], g_back):
        g = torch.zeros_like(p)
        for x in (a, b):
            if x is not None:
                g = g + x
        grads[k] = g
    return (total.detach(), {k: v.detach() for k, v in L.items()}, grads, absgrad,
            fwd.proj.radii, fwd.opac.detach(), fwd.proj.comp.detach())


def densify(state: dict, absgrad, radii, opac, wh):
    """The densify statistics' update of one step (all gaussians in order)."""
    visible = ((radii > 0) & (opac > 0)).to(torch.float32)
    scale = torch.tensor([wh[0] * 0.5, wh[1] * 0.5], device=absgrad.device)
    g = torch.linalg.norm(absgrad * scale, dim=-1)
    state["xys_grad_norm"] = state["xys_grad_norm"] + g * visible
    state["vis_counts"] = state["vis_counts"] + visible
    state["max_2dsize"] = torch.maximum(state["max_2dsize"], radii * visible)
    return state


def train_steps(cfg: dict, params: Dict[str, torch.Tensor], aux: dict, views: List[dict],
                targets: List[dict], start_step: int, width: int, height: int, prec: Prec,
                moments=None, gather=None):
    """Steps of the preset over the given views from `start_step` (Adam's
    count at the step, its moments `moments(path, shape)` -> (mu, nu), or
    zero). Returns per step the loss, the first step's gradients, and the
    parameters and densify statistics after the last step."""
    params = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, cfg["optimizer"], start_step, cfg["max_steps"], moments)
    losses, first = [], None
    dens = None
    for i, (view, tg) in enumerate(zip(views, targets)):
        total, _, grads, absgrad, radii, opac, _ = step_grads(
            cfg, _leaves(params), aux, view, tg, start_step + i, width, height, prec, gather)
        losses.append(float(total))
        if first is None:
            first = grads
        opt.step(params, grads)
        if dens is None:
            dens = {k: torch.zeros_like(opac) for k in ("xys_grad_norm", "vis_counts",
                                                         "max_2dsize")}
        dens = densify(dens, absgrad, radii, opac, (width, height))
    return dict(losses=losses, grads=first, params=params, densify=dens)


@torch.no_grad()
def render(cfg: dict, params, aux, view: dict, step: int, width: int, height: int,
           prec: Prec, stats=None, gather=None) -> Dict[str, torch.Tensor]:
    """The serving forward of one view (no pose delta): rgb, rgb_appearance,
    depth, accumulation and, with normals, normal."""
    fwd = model.ViewForward(params, aux, cfg, view, step, width, height, False, prec, gather)
    acc, t = fwd.blend(stats=stats)
    return fwd.outputs(acc, t)
