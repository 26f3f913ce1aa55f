"""Adaptive density control: split / duplicate / cull on padded arrays;
port of `mtgs_tpu/train/control.py`.

Per step, `accumulate_stats` folds the absgrad densify signal, radii and
compensations into a node's `DensifyState`. Every `refine_every` steps,
`refine_node` builds the candidate table [keep rows | n_split split
children | dup rows], moves the valid rows to the front in order, and
gathers parameters and Adam moments once (children start with zero
moments). The caller picks the output capacity with
`count_refine_candidates`, so no candidate is dropped; torch has no
static shapes to keep, so growing a node is just a larger gather.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from mtgs_torch.core.quat import quat_rotate
from mtgs_torch.models.gaussians import GaussianNodeParams, NodeAux

_SH_DEGREE_OF_BASIS = (0,) + (1,) * 3 + (2,) * 5 + (3,) * 7


@dataclass(frozen=True)
class ControlConfig:
    """Densify control settings (the JAX `ControlConfig`, same defaults)."""

    densify_from_iter: int = 500
    refine_every: int = 100
    stop_split_at: int = 15000
    reset_alpha_every: int = 30
    continue_cull_post_densification: bool = False
    cull_alpha_thresh: float = 0.005
    cull_scale_thresh: float = 0.5
    densify_size_thresh: float = 0.2
    densify_grad_thresh: float = 0.001
    n_split_samples: int = 2
    clone_sample_means: bool = True
    stop_screen_size_at: int = 15000
    cull_screen_size: float = 150.0
    split_screen_size: float = 100.0
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    use_abs_grad: bool = True
    # far-background cull exemption: the scale threshold is multiplied by
    # far_scale_factor for gaussians farther than far_dist from the origin
    far_dist: float = 100.0
    far_scale_factor: float = 40.0


@dataclass
class DensifyState:
    """Per-node running statistics between refine steps ([cap] each, or
    [I, cap] for stacked instances). `last_comp` is the last observed
    antialiasing compensation (1 until observed); it is carried through
    refines, not zeroed."""

    xys_grad_norm: torch.Tensor
    vis_counts: torch.Tensor
    max_2dsize: torch.Tensor
    last_comp: torch.Tensor

    @classmethod
    def zeros(cls, shape, device="cpu") -> "DensifyState":
        z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(xys_grad_norm=z(), vis_counts=z(), max_2dsize=z(),
                   last_comp=torch.ones(shape, dtype=torch.float32, device=device))


def accumulate_stats(state: DensifyState, absgrad, radii, opacities, image_wh,
                     comps=None) -> DensifyState:
    """Per-step stat update. absgrad [..., cap, 2] (this step's absgrad
    slice), radii and opacities (effective, 0 for gated-out) [..., cap];
    gradients scaled to NDC by (w/2, h/2). The compensation is tracked
    wherever the projection is on screen (radii > 0), visible or not."""
    w, h = image_wh
    visible = ((radii > 0) & (opacities > 0)).to(torch.float32)
    scale = torch.tensor([w * 0.5, h * 0.5], dtype=absgrad.dtype, device=absgrad.device)
    g = torch.linalg.norm(absgrad * scale, dim=-1)
    last_comp = state.last_comp if comps is None else torch.where(
        radii > 0, comps.to(torch.float32), state.last_comp)
    return DensifyState(
        xys_grad_norm=state.xys_grad_norm + g * visible,
        vis_counts=state.vis_counts + visible,
        max_2dsize=torch.maximum(state.max_2dsize, radii.to(torch.float32) * visible),
        last_comp=last_comp,
    )


class RefineOut(NamedTuple):
    params: GaussianNodeParams
    aux: NodeAux
    mu: GaussianNodeParams
    nu: GaussianNodeParams
    state: DensifyState
    n_split: torch.Tensor
    n_dup: torch.Tensor
    n_cull: torch.Tensor
    overflow: torch.Tensor   # candidates dropped for capacity


def _node_map(fn, *nodes: GaussianNodeParams) -> GaussianNodeParams:
    return dataclasses.replace(nodes[0], **{
        f.name: None if getattr(nodes[0], f.name) is None
        else fn(*(getattr(n, f.name) for n in nodes))
        for f in dataclasses.fields(nodes[0])})


def _refine_masks(params: GaussianNodeParams, aux: NodeAux, state: DensifyState,
                  cfg: ControlConfig, *, do_densify: bool, do_cull_big: bool,
                  use_screen_size: bool):
    """The split / dup / cull decision masks of the reference's refine."""
    alive = aux.alive > 0
    avg_grad = state.xys_grad_norm / torch.clamp(state.vis_counts, min=1.0)
    high = (avg_grad > cfg.densify_grad_thresh) & alive
    scale_max = torch.exp(params.scales).amax(dim=-1)
    big = scale_max > cfg.densify_size_thresh
    if do_densify:
        # screen-size oversize widens the split criterion but still needs
        # a high accumulated gradient
        big_split = big
        if use_screen_size:
            big_split = big_split | (state.max_2dsize > cfg.split_screen_size)
        splits = high & big_split
        dups = high & ~big
    else:
        splits = torch.zeros_like(alive)
        dups = torch.zeros_like(alive)
    # raw-alpha cull, as the reference; split originals are removed
    opac = torch.sigmoid(params.opacities[:, 0])
    culls = (opac < cfg.cull_alpha_thresh) & alive
    if do_cull_big:
        far = torch.linalg.norm(params.means, dim=-1) > cfg.far_dist
        thresh = torch.where(far, cfg.far_scale_factor, 1.0) * cfg.cull_scale_thresh
        toobig = scale_max > thresh
        if use_screen_size:
            toobig = toobig | (state.max_2dsize > cfg.cull_screen_size)
        culls = culls | (toobig & alive)
    culls = culls | splits
    keep = alive & ~culls
    # children inherit the parent's opacity: sub-threshold ones are not emitted
    alpha_ok = opac >= cfg.cull_alpha_thresh
    return keep, splits, dups, culls, alpha_ok, alive


def count_refine_candidates(params: GaussianNodeParams, aux: NodeAux, state: DensifyState,
                            cfg: ControlConfig, *, do_densify: bool, do_cull_big: bool,
                            use_screen_size: bool) -> torch.Tensor:
    """Number of rows the next `refine_node` pass wants to emit ([] int32)."""
    keep, splits, dups, _, alpha_ok, _ = _refine_masks(
        params, aux, state, cfg, do_densify=do_densify, do_cull_big=do_cull_big,
        use_screen_size=use_screen_size)
    ns = cfg.n_split_samples
    return (keep.sum() + ns * (splits & alpha_ok).sum() + (dups & alpha_ok).sum()).to(torch.int32)


def refine_node(eps: torch.Tensor, params: GaussianNodeParams, aux: NodeAux,
                mu: GaussianNodeParams, nu: GaussianNodeParams, state: DensifyState,
                cfg: ControlConfig, *, do_densify: bool, do_cull_big: bool,
                use_screen_size: bool, out_cap: Optional[int] = None) -> RefineOut:
    """One refinement pass over one node.

    eps [out_cap, 3]: the standard-normal noise of the split/dup samples
    (mean + R (scale * eps)); the caller draws it. out_cap (>= capacity)
    is the output capacity: params, moments, alive mask and densify state
    grow to it in the same gather.
    """
    cap = params.capacity
    out_cap = cap if out_cap is None else out_cap
    if out_cap < cap:
        raise ValueError(f"out_cap {out_cap} < capacity {cap}")
    if tuple(eps.shape) != (out_cap, 3):
        raise ValueError(f"eps must be [{out_cap}, 3], got {list(eps.shape)}")
    dev = params.means.device
    keep, splits, dups, culls, alpha_ok, alive = _refine_masks(
        params, aux, state, cfg, do_densify=do_densify, do_cull_big=do_cull_big,
        use_screen_size=use_screen_size)

    # candidate table: [keep rows | split children | dup rows]
    ns = cfg.n_split_samples
    slot = torch.arange(cap, device=dev)
    cand_src = slot.repeat(2 + ns)
    cand_kind = torch.cat([torch.zeros(cap, dtype=torch.int64, device=dev),
                           torch.ones(ns * cap, dtype=torch.int64, device=dev),
                           torch.full((cap,), 2, dtype=torch.int64, device=dev)])
    cand_valid = torch.cat([keep] + [splits & alpha_ok] * ns + [dups & alpha_ok])
    pad = out_cap - cand_valid.shape[0]
    if pad > 0:  # a large out_cap can exceed the table: pad with invalid rows
        cand_src = torch.cat([cand_src, torch.zeros(pad, dtype=torch.int64, device=dev)])
        cand_kind = torch.cat([cand_kind, torch.zeros(pad, dtype=torch.int64, device=dev)])
        cand_valid = torch.cat([cand_valid, torch.zeros(pad, dtype=torch.bool, device=dev)])

    # stable partition: valid rows first, in order
    order = torch.sort((~cand_valid).to(torch.int8), stable=True).indices
    n_valid = cand_valid.sum()
    take = order[:out_cap]
    src = cand_src[take]
    kind = cand_kind[take]
    row_alive = torch.arange(out_cap, device=dev) < torch.clamp(n_valid, max=out_cap)

    gp = _node_map(lambda a: a[src], params)
    sampled = gp.means + quat_rotate(gp.quats, torch.exp(gp.scales) * eps)
    is_split = kind == 1
    sample_mean = is_split | ((kind == 2) & cfg.clone_sample_means)
    new_means = torch.where(sample_mean[:, None], sampled, gp.means)
    new_scales = torch.where(is_split[:, None], gp.scales - math.log(1.6), gp.scales)
    new_params = dataclasses.replace(gp, means=new_means, scales=new_scales)
    # dead rows zeroed; identity quat w, and opacity/scale logits pushed
    # far negative so dead rows stay inert
    alive_f = row_alive.to(params.means.dtype)
    new_params = _node_map(lambda a: a * alive_f.reshape((out_cap,) + (1,) * (a.ndim - 1)),
                           new_params)
    dead = 1.0 - alive_f
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=params.quats.dtype, device=dev)
    new_params = dataclasses.replace(
        new_params,
        quats=new_params.quats + dead[:, None] * ident,
        opacities=new_params.opacities - dead[:, None] * 10.0,
        scales=new_params.scales - dead[:, None] * 10.0,
    )

    keep_state = ((kind == 0) & row_alive).to(params.means.dtype)
    mask_state = lambda a: a[src] * keep_state.reshape((out_cap,) + (1,) * (a.ndim - 1))
    new_aux = NodeAux(alive=alive_f,
                      num_alive=torch.clamp(n_valid, max=out_cap).to(torch.int32))
    # grad stats restart each refine window; the observed compensation
    # rides the gather (dead rows: 1.0, "none observed")
    carried = torch.where(row_alive, state.last_comp[src], torch.ones_like(alive_f))
    new_state = DensifyState.zeros(out_cap, device=dev)
    new_state.last_comp = carried
    return RefineOut(
        params=new_params, aux=new_aux, mu=_node_map(mask_state, mu),
        nu=_node_map(mask_state, nu), state=new_state,
        n_split=splits.sum(), n_dup=dups.sum(), n_cull=(culls & alive).sum(),
        overflow=torch.clamp(n_valid - out_cap, min=0),
    )


def reset_opacities(params: GaussianNodeParams, mu: GaussianNodeParams,
                    nu: GaussianNodeParams, cfg: ControlConfig,
                    last_comp: Optional[torch.Tensor] = None
                    ) -> Tuple[GaussianNodeParams, GaussianNodeParams, GaussianNodeParams]:
    """Opacity reset: clamp the logits so the effective (compensated)
    alpha lands at 2 * cull_alpha_thresh, and zero the opacity moments.
    With `last_comp` ([cap] or [..., cap]), a gaussian whose compensation
    is too small for any alpha <= 0.995 to stay above the 1.3/255 blend
    support keeps its logit (dimming it would strand it without
    gradient)."""
    reset_val = 2.0 * cfg.cull_alpha_thresh
    if last_comp is None:
        target = torch.tensor(reset_val, dtype=params.opacities.dtype,
                              device=params.opacities.device)
        new_op = torch.minimum(params.opacities, torch.log(target / (1.0 - target)))
    else:
        support_eps = 1.3 / 255.0
        cap = 0.995
        target = torch.clamp(reset_val / torch.clamp(last_comp, min=1e-9), reset_val, cap)
        target = target.to(params.opacities.dtype)
        logit = torch.log(target / (1.0 - target))[..., None]
        can_support = (last_comp * cap >= support_eps)[..., None]
        new_op = torch.where(can_support, torch.minimum(params.opacities, logit),
                             params.opacities)
    new = dataclasses.replace(params, opacities=new_op)
    mu = dataclasses.replace(mu, opacities=torch.zeros_like(mu.opacities))
    nu = dataclasses.replace(nu, opacities=torch.zeros_like(nu.opacities))
    return new, mu, nu


def sh_degree_mask(step: int, cfg: ControlConfig, device="cpu") -> torch.Tensor:
    """[16] 0/1 mask enabling SH bases up to min(step // interval, sh_degree)."""
    n = min(int(step) // cfg.sh_degree_interval, cfg.sh_degree)
    degs = torch.tensor(_SH_DEGREE_OF_BASIS, device=device)
    return (degs <= n).to(torch.float32)
