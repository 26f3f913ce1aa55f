"""The multi-traversal gaussian scene graph.

Port of `mtgs_tpu/models/scene_graph.py`: every node is a padded block
and composition is a concatenation

    [ background | skybox | instance 0 | ... | deformable 0 | ... ]

with frame/traversal gating folded into opacity (an absent instance has
opacity 0 and is dropped before binning). Rigid and deformable instances
are stacked: their node tensors carry a leading instance axis. Deformable
(pedestrian/cyclist) instances add the deformation MLP of
`models/deform.py` once `SceneConfig.deform_enabled` is set; with
`SceneParams.wild` the background and skybox take their colours from the
WildGaussians appearance MLP of `models/wild.py` instead of SH.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from mtgs_torch import resolve_device
from mtgs_torch.core import prng
from mtgs_torch.core.quat import quat_mult, quat_normalize, quat_rotate, slerp
from mtgs_torch.core.sh import sh_basis
from mtgs_torch.models import deform as deform_lib
from mtgs_torch.models import wild as wild_lib
from mtgs_torch.models.gaussians import (
    GaussianNodeParams, NodeAux, get_opacities, get_quats, get_scales,
)


@dataclass
class InstanceParams:
    """Stacked rigid instances: node tensors carry a leading [I] axis."""

    node: GaussianNodeParams            # [I, cap, ...]
    quats: torch.Tensor                 # [I, F, 4] per-frame pose rotations
    trans: torch.Tensor                 # [I, F, 3] per-frame pose translations


@dataclass
class InstanceAux:
    alive: torch.Tensor                 # [I, cap]
    num_alive: torch.Tensor             # [I]
    present: torch.Tensor               # [I, F] float 0/1
    is_static: torch.Tensor             # [I] float 0/1 (single-pose mode)
    frame_timestamps: torch.Tensor      # [F]
    travel_of_frame: torch.Tensor       # [F] int traversal id per frame row
    sizes: torch.Tensor                 # [I, 3]


@dataclass
class DeformableParams:
    """Stacked deformable (pedestrian/cyclist) instances and their shared MLP."""

    node: GaussianNodeParams            # [I, cap, ...] canonical gaussians
    quats: torch.Tensor                 # [I, F, 4]
    trans: torch.Tensor                 # [I, F, 3]
    embeddings: torch.Tensor            # [I, embed_dim]
    mlp: deform_lib.DeformMLPParams


@dataclass
class SceneParams:
    """The learnable tree, in the JAX SceneParams' field order (the order
    `optim.named_leaves` walks)."""

    background: GaussianNodeParams
    skybox: Optional[GaussianNodeParams]
    instances: Optional[InstanceParams]
    deformables: Optional[DeformableParams]
    appearance: torch.Tensor            # [num_cams, 3, 4] exposure affine
    camera_opt: torch.Tensor            # [num_images, 6] SO3xR3 deltas
    # WildGaussians: a per-image embedding and colour MLP replacing SH view
    # dependence on the multicolour nodes; None for the other methods
    wild: Optional[wild_lib.WildAppearanceParams] = None


@dataclass
class SceneAux:
    background: NodeAux
    skybox: Optional[NodeAux]
    instances: Optional[InstanceAux]
    deformables: Optional[InstanceAux] = None


@dataclass(frozen=True)
class SceneConfig:
    sh_degree: int = 3
    travel_mode: str = "index"          # "index" | "mean" | "null"
    interp_poses: bool = False
    # the deformation MLP is live (and the canonical means frozen); the
    # Trainer sets it once at TrainerConfig.deform_enable_step
    deform_enabled: bool = False
    deform_xyz_bound: float = 4.0


@dataclass
class ViewInputs:
    """Per-render inputs (0-d tensors or Python numbers)."""

    travel_index: int
    frame_idx: int
    timestamp: torch.Tensor             # [] float
    cam_pos: torch.Tensor               # [3]
    sh_mask: torch.Tensor               # [16] 0/1 degree-ramp mask
    image_idx: int = 0


def node_segments(params: SceneParams) -> List[Tuple[str, int, int]]:
    """(name, start, end) of each node's rows in the concatenation
    [background | skybox | instance 0 | ... | deformable 0 | ...]."""
    segs = []
    off = 0
    caps = [("background", params.background.capacity)]
    if params.skybox is not None:
        caps.append(("skybox", params.skybox.capacity))
    if params.instances is not None:
        n_inst, icap = params.instances.node.means.shape[:2]
        caps += [(f"instance_{i}", icap) for i in range(n_inst)]
    if params.deformables is not None:
        n_def, dcap = params.deformables.node.means.shape[:2]
        caps += [(f"deformable_{i}", dcap) for i in range(n_def)]
    for name, cap in caps:
        segs.append((name, off, off + cap))
        off += cap
    return segs


def _multicolor_features(p: GaussianNodeParams, travel_index, mode: str):
    """Per-traversal (features_dc, features_rest), with the eval fallbacks
    for unseen traversals ("mean", "null")."""
    if not p.multicolor:
        return p.features_dc, p.features_rest
    if mode == "index":
        dc = p.features_dc + p.features_adapters[:, travel_index]
        rest = p.features_rest[:, travel_index] if p.multi_feature_rest else p.features_rest
    elif mode == "mean":
        dc = p.features_dc + p.features_adapters.mean(dim=1)
        rest = p.features_rest.mean(dim=1) if p.multi_feature_rest else p.features_rest
    elif mode == "null":
        dc = p.features_dc
        # only a per-traversal rest is nulled; a shared rest stays
        rest = (torch.zeros_like(p.features_rest[:, 0]) if p.multi_feature_rest
                else p.features_rest)
    else:
        raise ValueError(f"unknown travel_mode {mode}")
    return dc, rest


def _eval_colors(means, features_dc, features_rest, cam_pos, sh_mask):
    """Masked-degree SH colour evaluation, clamped to [0, 1]. The view
    direction carries no gradient to the means (the JAX package's
    stop_gradient)."""
    coeffs = torch.cat([features_dc[..., None, :], features_rest], dim=-2)
    dirs = means.detach() - cam_pos
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True) + 1e-24)
    basis = sh_basis(3, dirs) * sh_mask
    k = coeffs.shape[-2]
    rgb = (basis[..., :k, None] * coeffs).sum(-2) + 0.5
    return torch.clamp(rgb, 0.0, 1.0)


def _instance_pose(inst_quats, inst_trans, aux: InstanceAux, view: ViewInputs,
                   interp: bool):
    """Per-instance pose for this view -> (quat [I,4], trans [I,3], gate [I]):
    gathered at frame_idx, or slerped between the frames of this view's
    traversal that bracket its timestamp; static instances keep the pose
    of their first present frame."""
    if interp:
        ts = aux.frame_timestamps
        same_travel = aux.travel_of_frame == view.travel_index
        diffs = view.timestamp - ts
        big = torch.full_like(diffs, 1e9)
        prev_f = torch.argmin(torch.where(same_travel & (diffs >= 0), diffs, big))
        next_f = torch.argmin(torch.where(same_travel & (diffs <= 0), -diffs, big))
        denom = ts[next_f] - ts[prev_f]
        small = torch.abs(denom) < 1e-9
        t = torch.where(small, torch.zeros_like(denom),
                        (view.timestamp - ts[prev_f])
                        / torch.where(small, torch.ones_like(denom), denom))
        q0 = inst_quats[:, prev_f]
        q1 = inst_quats[:, next_f]
        q = slerp(q0, q1, t.expand(q0.shape[:-1]))
        tr = inst_trans[:, prev_f] * (1 - t) + inst_trans[:, next_f] * t
        gate = aux.present[:, prev_f] * aux.present[:, next_f]
    else:
        q = inst_quats[:, view.frame_idx]
        tr = inst_trans[:, view.frame_idx]
        gate = aux.present[:, view.frame_idx]
    static = aux.is_static[:, None]
    anchor = torch.argmax(aux.present, dim=1)  # first present row
    rows = torch.arange(inst_quats.shape[0], device=inst_quats.device)
    q = static * inst_quats[rows, anchor] + (1 - static) * q
    tr = static * inst_trans[rows, anchor] + (1 - static) * tr
    return quat_normalize(q), tr, gate


def _collect_instances(node: GaussianNodeParams, alive, pose_q, pose_t, gate,
                       view: ViewInputs, local_offsets=None):
    """World-space gaussians of stacked instances, flattened to [I*cap, ...].
    local_offsets: the deformation MLP's (dxyz [I,cap,3], dquat [I,cap,4],
    dscale [I,cap,3]), applied in the instance frame."""
    I, cap = node.means.shape[:2]
    means_l = node.means
    quats_l = quat_normalize(node.quats)
    scales_l = torch.exp(node.scales)
    if local_offsets is not None:
        dxyz, dquat, dscale = local_offsets
        means_l = means_l + dxyz
        quats_l = quat_normalize(quats_l + dquat)
        scales_l = scales_l * torch.exp(dscale)
    means_w = quat_rotate(pose_q[:, None, :], means_l) + pose_t[:, None, :]
    quats_w = quat_mult(pose_q[:, None, :], quats_l)
    opac = torch.sigmoid(node.opacities[..., 0]) * alive * gate[:, None]

    dc, rest = node.features_dc, node.features_rest
    if node.fourier:
        from mtgs_torch.models.fourier import fourier_features_dc

        dc = fourier_features_dc(
            node.fourier_dc.reshape(I * cap, *node.fourier_dc.shape[2:]),
            view.timestamp,
        ).reshape(I, cap, 3)
    colors = _eval_colors(
        means_w.reshape(I * cap, 3), dc.reshape(I * cap, 3),
        rest.reshape(I * cap, *rest.shape[2:]), view.cam_pos, view.sh_mask,
    )
    return (means_w.reshape(I * cap, 3), quats_w.reshape(I * cap, 4),
            scales_l.reshape(I * cap, 3), opac.reshape(I * cap), colors)


def collect_gaussians(params: SceneParams, aux: SceneAux, cfg: SceneConfig,
                      view: ViewInputs) -> Dict[str, torch.Tensor]:
    """Concatenate all nodes' world-space gaussians for one view: means
    [N,3], quats [N,4], scales [N,3], opacities [N], colors [N,3]."""
    def node_colors(p, dc, rest):
        if params.wild is not None:
            # WildGaussians: the image's embedding and the MLP instead of SH
            # (no degree ramp, no view direction)
            r3 = rest if rest.ndim == 3 else rest[:, 0]
            return wild_lib.wild_colors(params.wild, dc, r3, view.image_idx)
        return _eval_colors(p.means, dc, rest, view.cam_pos, view.sh_mask)

    outs = []
    for name in ("background", "skybox"):
        p = getattr(params, name)
        if p is None:
            continue
        dc, rest = _multicolor_features(p, view.travel_index, cfg.travel_mode)
        outs.append((
            p.means, get_quats(p), get_scales(p), get_opacities(p, getattr(aux, name)),
            node_colors(p, dc, rest),
        ))
    if params.instances is not None:
        q, t, gate = _instance_pose(params.instances.quats, params.instances.trans,
                                    aux.instances, view, cfg.interp_poses)
        outs.append(_collect_instances(params.instances.node, aux.instances.alive,
                                       q, t, gate, view))
    if params.deformables is not None:
        d = params.deformables
        q, t, gate = _instance_pose(d.quats, d.trans, aux.deformables, view, cfg.interp_poses)
        node, offsets = d.node, None
        if cfg.deform_enabled:
            # the canonical xyz are frozen once deformation starts: no
            # gradient through the render or the MLP's input (the trainer
            # also zeroes their Adam update)
            node = dataclasses.replace(node, means=node.means.detach())
            offsets = deform_lib.apply_deform(d.mlp, node.means, d.embeddings, view.timestamp,
                                              xyz_bound=cfg.deform_xyz_bound)
        outs.append(_collect_instances(node, aux.deformables.alive, q, t, gate, view,
                                       offsets))
    means, quats, scales, opac, colors = (
        torch.cat([o[i] for o in outs], dim=0) for i in range(5))
    return dict(means=means, quats=quats, scales=scales, opacities=opac, colors=colors)


def init_scene(
    background: Tuple[GaussianNodeParams, NodeAux],
    skybox: Optional[Tuple[GaussianNodeParams, NodeAux]] = None,
    instances: Optional[Tuple[InstanceParams, InstanceAux]] = None,
    deformables: Optional[Tuple[DeformableParams, InstanceAux]] = None,
    *,
    num_cameras: int = 1,
    num_images: int = 1,
    wild_appearance: bool = False,
    device="cuda",
) -> Tuple[SceneParams, SceneAux]:
    """Assemble SceneParams/SceneAux from per-node inits; the appearance,
    camera-opt and (with wild_appearance) WildGaussians leaves on the card
    unless `device` says otherwise. The wild weights are JAX's draws from
    `key(0)`, made on the CPU, so a scene is the same on the CPU and the card."""
    from mtgs_torch.models.appearance import init_exposure

    device = resolve_device(device)
    wild = None
    if wild_appearance:
        wild = wild_lib.init_wild(prng.key(0), num_images, device=device)
    params = SceneParams(
        background=background[0],
        skybox=None if skybox is None else skybox[0],
        instances=None if instances is None else instances[0],
        deformables=None if deformables is None else deformables[0],
        appearance=init_exposure(num_cameras, device=device),
        camera_opt=torch.zeros((num_images, 6), dtype=torch.float32, device=device),
        wild=wild,
    )
    auxs = SceneAux(
        background=background[1],
        skybox=None if skybox is None else skybox[1],
        instances=None if instances is None else instances[1],
        deformables=None if deformables is None else deformables[1],
    )
    return params, auxs


# ------------------------------------------------------------- scene edit

def _instance_block(params: SceneParams, deformable: bool):
    field = "deformables" if deformable else "instances"
    block = getattr(params, field)
    if block is None:
        raise ValueError(f"scene has no {field}")
    return field, block


def translate_instance(params: SceneParams, instance: int, offset, *,
                       deformable: bool = False) -> SceneParams:
    """A copy of `params` with one rigid (or deformable) instance moved by
    `offset` (world frame) in every frame: the per-frame world pose moves,
    the local means stay."""
    field, block = _instance_block(params, deformable)
    off = torch.as_tensor(offset, dtype=torch.float32, device=block.trans.device).reshape(3)
    trans = block.trans.detach().clone()
    trans[instance] += off
    return dataclasses.replace(params, **{field: dataclasses.replace(block, trans=trans)})


def rotate_instance(params: SceneParams, instance: int, quat, *,
                    deformable: bool = False) -> SceneParams:
    """A copy of `params` with one instance rotated about its own origin by
    `quat` (wxyz) in every frame: the per-frame pose rotation is
    pre-multiplied, the translations stay."""
    field, block = _instance_block(params, deformable)
    q = quat_normalize(torch.as_tensor(quat, dtype=torch.float32,
                                       device=block.quats.device).reshape(4))
    quats = block.quats.detach().clone()
    quats[instance] = quat_mult(q[None, :], quats[instance])
    return dataclasses.replace(params, **{field: dataclasses.replace(block, quats=quats)})
