"""The training engine; port of `mtgs_tpu/train/trainer.py`.

* `render_view` — the full forward of one camera: camera-opt ->
  scene-graph collect -> normals -> rasterize -> background -> exposure.
  With training=False it is the serving forward (no autograd graph).
* `loss_and_grads` / `train_step` — one training step: losses,
  parameter gradients and the absgrad densify signal from one backward
  pass, the non-finite-gradient guard, Adam, densify statistics, metrics.
  Nothing in a step waits on the device: the guard and the metrics stay
  device tensors.
* `Trainer` — the host loop: steps, and on the JAX package's schedule the
  refine pass (node capacity grown to the counted candidates) and the
  opacity reset, with `max_intersections` grown past `isect_grow_frac`;
  optionally the multi-resolution ladder (`resolution_stages` with a
  `data_factory`), which switches the render size, the intersection
  buffer and the data at each stage boundary; and at
  `deform_enable_step` the one-time switch that makes the deformable
  nodes' MLP live and freezes their canonical means.

With `mesh=` (a `mtgs_torch.parallel.Mesh`, one process per rank) a
step renders its one camera with the tiles split over the mesh axis
`mesh_axis` (`rasterize(mesh=...)`); every rank runs the same step on the
same view and keeps the same state. Camera data parallelism and the 2D
(data, tile) step are `mtgs_torch.parallel.data_parallel` and `mesh2d`.

Nothing is re-jitted at a stage switch, a capacity growth or the
deformation switch: torch keeps shapes dynamic, so the JAX package's
re-jit and speculative compile have no counterpart. Its mesh rounding of
the intersection buffer is kept (`Trainer._isect_granule`).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch

from mtgs_torch import resolve_device
from mtgs_torch.core import prng
from mtgs_torch.core.camera import camera_to_gsplat_viewmat
from mtgs_torch.core.quat import quat_to_rotmat
from mtgs_torch.models.appearance import apply_exposure
from mtgs_torch.models.gaussians import NodeAux, node_capacity, stack_nodes
from mtgs_torch.models.scene_graph import (
    SceneAux, SceneConfig, SceneParams, ViewInputs, collect_gaussians, node_segments,
)
from mtgs_torch.raster import RasterizeConfig, rasterize
from mtgs_torch.train import control as ctrl
from mtgs_torch.train import losses as loss_lib
from mtgs_torch.train.camera_opt import apply_camera_opt, camera_opt_penalty
from mtgs_torch.train.optim import (
    AdamState, OptimConfig, adam_init, adam_update, default_groups, named_leaves,
)
from mtgs_torch.utils.observability import StepTimer


# the stacked node kinds: a leading instance axis, refined one instance at a time
STACKED = ("instances", "deformables")


@dataclass(frozen=True)
class TrainerConfig:
    """The JAX TrainerConfig's fields that the port runs (same defaults)."""

    width: int = 960
    height: int = 540
    tile_size: int = 32
    max_intersections: int = 1 << 21
    rasterize_mode: str = "antialiased"
    # the rasterizer's fused path where it fits (else, and when False, the classic path)
    fused: bool = True
    max_steps: int = 30001
    predict_normals: bool = True
    background_color: float = 0.0
    # capacity growth: a node grows to max(needed, cap * grow_factor),
    # rounded to grow_granule; the intersection buffer grows by
    # isect_grow_factor once n_intersections passes isect_grow_frac of it
    auto_grow: bool = True
    grow_granule: int = 4096
    grow_factor: float = 1.5
    isect_grow_frac: float = 0.85
    isect_grow_factor: float = 1.5
    loss: loss_lib.LossConfig = field(default_factory=loss_lib.LossConfig)
    control: ctrl.ControlConfig = field(default_factory=ctrl.ControlConfig)
    # the step from which the deformable nodes deform (their canonical xyz
    # frozen from then on); None: never
    deform_enable_step: Optional[int] = None
    # per-node control overrides (None: inherit `control`; the skybox
    # then gets no far-background cull exemption)
    skybox_control: Optional[ctrl.ControlConfig] = None
    instances_control: Optional[ctrl.ControlConfig] = None
    deformables_control: Optional[ctrl.ControlConfig] = None
    scene: SceneConfig = field(default_factory=SceneConfig)

    def node_control(self, node: str) -> ctrl.ControlConfig:
        """The resolved ControlConfig of a node kind."""
        if node == "skybox":
            if self.skybox_control is not None:
                return self.skybox_control
            return dataclasses.replace(self.control, far_dist=1e8, far_scale_factor=1.0)
        if node == "instances":
            return self.instances_control or self.control
        if node == "deformables":
            return self.deformables_control or self.control
        return self.control

    def raster_config(self) -> RasterizeConfig:
        return RasterizeConfig(
            width=self.width, height=self.height, tile_size=self.tile_size,
            max_intersections=self.max_intersections,
            rasterize_mode=self.rasterize_mode, render_mode="RGB+ED", fused=self.fused,
        )

    def replace(self, **kw) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class Batch:
    """One camera view. Arrays may be tensors or numpy arrays."""

    image: torch.Tensor                 # [H, W, 3] in [0, 1]
    mask: torch.Tensor                  # [H, W, 1] 0/1
    c2w: torch.Tensor                   # [4, 4] scene-frame camera-to-world
    K: torch.Tensor                     # [3, 3]
    cam_idx: int                        # physical camera id
    image_idx: int                      # image row (camera_opt index)
    travel_index: int
    frame_idx: int
    timestamp: float
    lidar_depth: Optional[torch.Tensor] = None    # [H, W, 1]
    pseudo_depth: Optional[torch.Tensor] = None   # [H, W, 1]


@dataclass
class TrainState:
    params: SceneParams
    adam: AdamState
    densify: Dict[str, ctrl.DensifyState]
    step: int = 0


def _on(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _check_scene_device(params: SceneParams, dev: torch.device) -> None:
    d = params.background.means.device
    if d.type != dev.type or (dev.index is not None and d.index != dev.index):
        raise ValueError(f"scene lives on {d} but render device is {dev}")


def render_view(
    params: SceneParams,
    aux: SceneAux,
    cfg: TrainerConfig,
    batch: Batch,
    step: int,
    *,
    training: bool = False,
    absgrad_sink: Optional[torch.Tensor] = None,
    travel_mode: Optional[str] = None,
    apply_cam_opt: Optional[bool] = None,
    device="cuda",
    mesh=None,
    mesh_axis: str = "tile",
    inside_shard_map: bool = False,
) -> Dict[str, torch.Tensor]:
    """Full forward pass for one camera. training=False is the serving
    forward, run without autograd; apply_cam_opt (default: training)
    applies the image's trained pose delta. mesh / mesh_axis: render this
    camera with its tiles split over the ranks of `mesh_axis` (every rank
    calls with the same view; `rasterize`'s mesh docs); inside_shard_map:
    the 2D step's row render (`rasterize`)."""
    dev = resolve_device(device)
    _check_scene_device(params, dev)
    with torch.set_grad_enabled(training and torch.is_grad_enabled()):
        return _render_view(params, aux, cfg, batch, step, training, absgrad_sink,
                            travel_mode, apply_cam_opt, dev,
                            dict(mesh=mesh, shard_axis=mesh_axis,
                                 inside_shard_map=inside_shard_map))


def _render_view(params, aux, cfg, batch, step, training, absgrad_sink,
                 travel_mode, apply_cam_opt, dev, shard_kw):
    c2w = _on(batch.c2w, dev)
    K = _on(batch.K, dev)
    if training if apply_cam_opt is None else apply_cam_opt:
        c2w = apply_camera_opt(c2w, params.camera_opt[int(batch.image_idx)])
    scene_cfg = cfg.scene
    if travel_mode is not None:
        scene_cfg = dataclasses.replace(scene_cfg, travel_mode=travel_mode)

    view = ViewInputs(
        travel_index=int(batch.travel_index),
        frame_idx=int(batch.frame_idx),
        timestamp=_on(batch.timestamp, dev),
        cam_pos=c2w[:3, 3],
        sh_mask=ctrl.sh_degree_mask(step, cfg.control, dev),
        image_idx=int(batch.image_idx),
    )
    g = collect_gaussians(params, aux, scene_cfg, view)

    colors = g["colors"]
    if cfg.predict_normals:
        normals = loss_lib.gaussian_camera_normals(
            g["scales"], quat_to_rotmat(g["quats"]), g["means"], c2w[:3, 3], c2w[:3, :3])
        colors = torch.cat([colors, normals], dim=-1)

    viewmat = camera_to_gsplat_viewmat(c2w)
    render, alpha, info = rasterize(
        g["means"], g["quats"], g["scales"], g["opacities"], colors,
        viewmat, K, cfg.raster_config(), absgrad_sink=absgrad_sink, **shard_kw)

    bg = torch.full((3,), cfg.background_color, dtype=render.dtype, device=dev)
    rgb = torch.clamp(render[..., :3] + (1.0 - alpha) * bg, 0.0, 1.0)
    rgb_appearance = apply_exposure(params.appearance, rgb, int(batch.cam_idx))

    depth = render[..., -1:]
    # threshold 1e-6 (not 0): below it the ED normalisation divided by the
    # 1e-10 clamp, not alpha; such pixels take the (gradient-free) largest
    # depth, like empty ones
    depth = torch.where(alpha > 1e-6, depth, depth.detach().max())

    out = dict(
        rgb=rgb, rgb_appearance=rgb_appearance, depth=depth, accumulation=alpha,
        background=bg, radii=info["radii"], means2d=info["means2d"],
        compensations=info["compensations"],
        n_intersections=info["n_intersections"], gaussians=g,
    )
    if cfg.predict_normals:
        n = render[..., 3:6]
        # epsilon-safe normalise: empty pixels have exactly-zero normals
        n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
        out["normal"] = (n + 1.0) / 2.0
    return out


def _scene_losses(params: SceneParams, aux: SceneAux, out, cfg: TrainerConfig,
                  step: int) -> Dict[str, torch.Tensor]:
    """Parameter-space regularisers and the camera-opt penalty."""
    losses: Dict[str, torch.Tensor] = {}
    lcfg = cfg.loss
    g = out["gaussians"]
    alive = (g["opacities"] > 0).to(g["scales"].dtype)
    if lcfg.two_d_gaussians:
        losses["two_d_reg"] = loss_lib.two_d_reg(g["scales"], alive)
    if lcfg.sharp_shape_reg_lambda > 0:
        # applied every sharp_shape_reg_step_interval steps only
        every = float(step % lcfg.sharp_shape_reg_step_interval == 0)
        losses["sharp_shape"] = every * (lcfg.sharp_shape_reg_lambda * loss_lib.sharp_shape_reg(
            g["scales"], alive, lcfg.sharp_shape_max_ratio, lcfg.two_d_gaussians))
    if lcfg.oob_lambda > 0 and params.instances is not None:
        losses["oob"] = lcfg.oob_lambda * loss_lib.oob_loss(
            params.instances.node.means, params.instances.node.opacities,
            aux.instances.alive, aux.instances.sizes, lcfg.oob_tolerance)
    if lcfg.adapter_lambda > 0:
        total = params.background.features_adapters.abs().sum()
        if params.skybox is not None:
            total = total + params.skybox.features_adapters.abs().sum()
        losses["adapter"] = lcfg.adapter_lambda * total
    losses["camera_opt"] = camera_opt_penalty(
        params.camera_opt, lcfg.camera_opt_trans_penalty, lcfg.camera_opt_rot_penalty)
    return losses


def _total_capacity(params: SceneParams) -> int:
    return node_segments(params)[-1][2]


def loss_and_grads(params: SceneParams, aux: SceneAux, cfg: TrainerConfig, batch: Batch,
                   step: int, *, device="cuda", mesh=None, mesh_axis: str = "tile",
                   inside_shard_map: bool = False):
    """Loss, parameter gradients and the absgrad densify signal of one
    view, from one backward pass: the absgrad sink is one more input of
    the same `torch.autograd.grad`. Marks every parameter leaf as
    requiring grad. Returns (total, losses, out, sink_grad [N, 2], grads:
    {leaf path: gradient}), all detached. With `mesh`, the view's tiles
    are split over `mesh_axis` (`render_view`); every rank gets the
    single-rank gradients."""
    dev = resolve_device(device)
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    sink = torch.zeros((_total_capacity(params), 2), dtype=torch.float32, device=dev,
                       requires_grad=True)
    f32 = lambda x: None if x is None else _on(x, dev)
    with torch.enable_grad():
        out = render_view(params, aux, cfg, batch, step, training=True,
                          absgrad_sink=sink, device=dev, mesh=mesh, mesh_axis=mesh_axis,
                          inside_shard_map=inside_shard_map)
        losses = loss_lib.compute_losses(
            cfg.loss, gt_img=f32(batch.image), pred_img=out["rgb"],
            pred_img_appearance=out["rgb_appearance"], mask=f32(batch.mask),
            pred_depth=out["depth"], gt_lidar_depth=f32(batch.lidar_depth),
            gt_pseudo_depth=f32(batch.pseudo_depth), pred_normal=out.get("normal"),
            K=f32(batch.K))
        losses.update(_scene_losses(params, aux, out, cfg, step))
        total = sum(losses.values())
        gs = torch.autograd.grad(total, [p for _, p in leaves] + [sink], allow_unused=True)
    grads = {path: torch.zeros_like(p) if gr is None else gr
             for (path, p), gr in zip(leaves, gs[:-1])}
    sink_grad = torch.zeros_like(sink) if gs[-1] is None else gs[-1]
    out = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
    out["gaussians"] = {k: v.detach() for k, v in out["gaussians"].items()}
    return (total.detach(), {k: v.detach() for k, v in losses.items()}, out, sink_grad,
            grads)


def _accumulate_all(params: SceneParams, densify: Dict[str, ctrl.DensifyState], sink_grad,
                    radii, opac, wh, comps=None) -> Dict[str, ctrl.DensifyState]:
    """Route each node's slice of absgrad / radii / compensations into its
    densify statistics; each stacked block (rigid, deformable) is one
    batched update."""
    new = dict(densify)
    segs = node_segments(params)
    for name, s, e in segs:
        if name in ("background", "skybox"):
            new[name] = ctrl.accumulate_stats(
                densify[name], sink_grad[s:e], radii[s:e], opac[s:e], wh,
                None if comps is None else comps[s:e])
    for kind, row in (("instances", "instance_"), ("deformables", "deformable_")):
        block = [(s, e) for name, s, e in segs if name.startswith(row)]
        if not block:
            continue
        s0, e1 = block[0][0], block[-1][1]
        n_inst = len(block)
        cap = (e1 - s0) // n_inst
        new[kind] = ctrl.accumulate_stats(
            densify[kind], sink_grad[s0:e1].reshape(n_inst, cap, 2),
            radii[s0:e1].reshape(n_inst, cap), opac[s0:e1].reshape(n_inst, cap), wh,
            None if comps is None else comps[s0:e1].reshape(n_inst, cap))
    return new


def _make_densify(params: SceneParams) -> Dict[str, ctrl.DensifyState]:
    dev = params.background.means.device
    densify = {"background": ctrl.DensifyState.zeros(params.background.capacity, dev)}
    if params.skybox is not None:
        densify["skybox"] = ctrl.DensifyState.zeros(params.skybox.capacity, dev)
    for kind in STACKED:
        block = getattr(params, kind)
        if block is not None:
            densify[kind] = ctrl.DensifyState.zeros(tuple(block.node.means.shape[:2]), dev)
    return densify


def init_train_state(params: SceneParams) -> TrainState:
    return TrainState(params=params, adam=adam_init(params), densify=_make_densify(params))


def train_step(state: TrainState, aux: SceneAux, cfg: TrainerConfig, batch: Batch,
               optim_config: OptimConfig, *, device="cuda", mesh=None,
               mesh_axis: str = "tile") -> Dict[str, torch.Tensor]:
    """One training step on one view, updating `state` in place (params,
    Adam moments and count, densify statistics, step). Returns the
    metrics as device tensors. With `mesh`, the view's tiles are split
    over `mesh_axis` and every rank takes the same step."""
    dev = resolve_device(device)
    total, losses, out, sink_grad, grads = loss_and_grads(
        state.params, aux, cfg, batch, state.step, device=dev, mesh=mesh,
        mesh_axis=mesh_axis)
    # gradient-skip guard: a non-finite gradient would be smeared over
    # every parameter by one Adam update; such a step leaves params and
    # optimizer state as they were and is counted in the metrics
    finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
    sink_grad = torch.where(finite, sink_grad, 0.0)
    # while deformation is on, the canonical xyz keep their values: their
    # gradient is already zero, and a zero update stops Adam's momentum
    # from drifting them
    frozen = ()
    if cfg.scene.deform_enabled and state.params.deformables is not None:
        frozen = ("deformables.node.means",)
    adam_update(state.params, grads, state.adam, optim_config, finite, frozen)
    state.densify = _accumulate_all(
        state.params, state.densify, sink_grad, out["radii"], out["gaussians"]["opacities"],
        (cfg.width, cfg.height), comps=out["compensations"])

    metrics = dict(losses)
    mse = loss_lib.masked_mean((_on(batch.image, dev) - out["rgb_appearance"]) ** 2,
                               _on(batch.mask, dev))
    metrics["psnr"] = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
    metrics["total_loss"] = total
    metrics["nonfinite_grad_step"] = (~finite).to(torch.float32)
    metrics["n_intersections"] = out["n_intersections"].reshape(())
    # the JAX package's count: background, skybox and rigid instances (the
    # deformables are left out)
    count = aux.background.alive.sum()
    if aux.skybox is not None:
        count = count + aux.skybox.alive.sum()
    if aux.instances is not None:
        count = count + aux.instances.alive.sum()
    metrics["gaussian_count"] = count
    state.step += 1
    return metrics


def _node_slice(node, i):
    return dataclasses.replace(node, **{
        f.name: None if getattr(node, f.name) is None else getattr(node, f.name)[i]
        for f in dataclasses.fields(node)})


class Trainer:
    """Host-side control loop (ref `CustomTrainer.train`)."""

    def __init__(self, cfg: TrainerConfig, params: SceneParams, aux: SceneAux,
                 data: Optional[Iterator[Batch]] = None,
                 optim_config: Optional[OptimConfig] = None, seed: int = 0, device="cuda",
                 data_factory=None, resolution_stages=None, mesh=None,
                 mesh_axis: str = "tile"):
        """`resolution_stages` enables the multi-resolution training ladder
        (ref `custom_datamanager.py:143-152`): (start_step, scale) pairs; at
        each stage boundary `data_factory(scale)` supplies the stage's batch
        iterator and the render size and intersection buffer follow it
        (`_set_resolution_stage`).

        `mesh` / `mesh_axis` split every step's rasterization over the
        ranks of the mesh axis (one camera's tiles: the whole pipeline,
        `rasterize(mesh=...)`); every rank runs this loop on the same data
        with the same `seed`, and their states stay alike."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        _check_scene_device(params, self.device)
        self.cfg = cfg
        self.aux = aux
        self.data = data
        # the full-resolution config the stages scale (its intersection
        # buffer grows with the stage's)
        self._base_cfg = cfg
        self._data_factory = data_factory
        self.resolution_stages = sorted(resolution_stages) if resolution_stages else None
        if self.resolution_stages is not None and data_factory is None:
            raise ValueError("resolution_stages requires data_factory")
        if data is None and self.resolution_stages is None:
            raise ValueError("need `data` unless resolution_stages is set")
        self._cur_scale = None
        self._pending_batch = None
        self.loop_stats = dict(dispatch_s=0.0, refine_s=0.0, sync_s=0.0, steps=0)
        self.optim_config = optim_config or OptimConfig(groups=default_groups(cfg.max_steps))
        self.state = init_train_state(params)
        # the split/dup noise of refine passes: JAX's key chain (each refine
        # splits it in five, the first carried on)
        self.key = prng.key(seed, device=self.device)
        self.growth_events: List[dict] = []
        self.refine_overflow = 0
        self.refine_events: List[dict] = []
        self.reset_steps: List[int] = []

    # ------------------------------------------------------------- refine

    def _nodes(self):
        """(kind, params node, aux node, densify) of every node kind;
        each stacked block (rigid, deformable) as one [I, cap] node."""
        p, a, d = self.state.params, self.aux, self.state.densify
        nodes = [("background", p.background, a.background, d["background"])]
        if p.skybox is not None:
            nodes.append(("skybox", p.skybox, a.skybox, d["skybox"]))
        for kind in STACKED:
            block, ba = getattr(p, kind), getattr(a, kind)
            if block is not None:
                nodes.append((kind, block.node,
                              NodeAux(alive=ba.alive, num_alive=ba.num_alive), d[kind]))
        return nodes

    @torch.no_grad()
    def _plan_growth(self, flags) -> Dict[str, int]:
        """Output capacity per node kind: the counted refine candidates,
        grown by grow_factor and rounded to grow_granule where they exceed
        the capacity (one host sync per refine)."""
        do_densify, do_cull_big, use_screen = flags
        kw = dict(do_densify=do_densify, do_cull_big=do_cull_big, use_screen_size=use_screen)
        caps = {}
        for kind, node, aux, dstate in self._nodes():
            cc = self.cfg.node_control(kind)
            if kind in STACKED:
                n_inst = node.means.shape[0]
                needed = max(int(ctrl.count_refine_candidates(
                    _node_slice(node, i), _node_slice(aux, i), _node_slice(dstate, i), cc,
                    **kw)) for i in range(n_inst))
                cap = node.means.shape[1]
            else:
                needed = int(ctrl.count_refine_candidates(node, aux, dstate, cc, **kw))
                cap = node.capacity
            new = cap
            if self.cfg.auto_grow and needed > cap:
                new = node_capacity(max(needed, int(cap * self.cfg.grow_factor)),
                                    self.cfg.grow_granule)
                self.growth_events.append(dict(step=self.state.step, node=kind, old=cap, new=new))
            caps[kind] = new
        return caps

    @torch.no_grad()
    def refine(self, flags) -> dict:
        """One refine pass over every node (split / dup / cull), growing
        nodes to the planned capacities; Adam moments follow the rows."""
        do_densify, do_cull_big, use_screen = flags
        out_caps = self._plan_growth(flags)
        st = self.state
        mu, nu = st.adam.mu, st.adam.nu
        info = dict(step=st.step, overflow=0, n_split=0, n_dup=0, n_cull=0)
        kw = dict(do_densify=do_densify, do_cull_big=do_cull_big, use_screen_size=use_screen)

        # JAX's draws: background k1, skybox k2, instance i split(k3, I)[i],
        # deformable i split(k4, I)[i], each normal(key, (out_cap, 3))
        self.key, *node_keys = prng.split(self.key, 5)
        node_keys = dict(zip(("background", "skybox") + STACKED, node_keys))

        def run(kind, node, aux, mu_n, nu_n, dstate, key):
            eps = prng.normal(key, (out_caps[kind], 3)).to(node.means.dtype)
            r = ctrl.refine_node(eps, node, aux, mu_n, nu_n, dstate,
                                 self.cfg.node_control(kind), out_cap=out_caps[kind], **kw)
            for k in ("overflow", "n_split", "n_dup", "n_cull"):
                info[k] += int(getattr(r, k))
            return r

        params, aux = st.params, self.aux
        r = run("background", params.background, aux.background, mu.background,
                nu.background, st.densify["background"], node_keys["background"])
        params = dataclasses.replace(params, background=r.params)
        mu = dataclasses.replace(mu, background=r.mu)
        nu = dataclasses.replace(nu, background=r.nu)
        aux = dataclasses.replace(aux, background=r.aux)
        st.densify["background"] = r.state
        if params.skybox is not None:
            r = run("skybox", params.skybox, aux.skybox, mu.skybox, nu.skybox,
                    st.densify["skybox"], node_keys["skybox"])
            params = dataclasses.replace(params, skybox=r.params)
            mu = dataclasses.replace(mu, skybox=r.mu)
            nu = dataclasses.replace(nu, skybox=r.nu)
            aux = dataclasses.replace(aux, skybox=r.aux)
            st.densify["skybox"] = r.state
        # stacked blocks refine one instance at a time (the canonical means
        # sampled on a deformable split stay canonical)
        for kind in STACKED:
            block = getattr(params, kind)
            if block is None:
                continue
            ia, mb, nb = getattr(aux, kind), getattr(mu, kind), getattr(nu, kind)
            n_inst = block.node.means.shape[0]
            keys = prng.split(node_keys[kind], n_inst)
            outs = [run(kind, _node_slice(block.node, i),
                        NodeAux(alive=ia.alive[i], num_alive=ia.num_alive[i]),
                        _node_slice(mb.node, i), _node_slice(nb.node, i),
                        _node_slice(st.densify[kind], i), keys[i])
                    for i in range(n_inst)]
            params = dataclasses.replace(params, **{kind: dataclasses.replace(
                block, node=stack_nodes([o.params for o in outs]))})
            mu = dataclasses.replace(mu, **{kind: dataclasses.replace(
                mb, node=stack_nodes([o.mu for o in outs]))})
            nu = dataclasses.replace(nu, **{kind: dataclasses.replace(
                nb, node=stack_nodes([o.nu for o in outs]))})
            aux = dataclasses.replace(aux, **{kind: dataclasses.replace(
                ia, alive=torch.stack([o.aux.alive for o in outs]),
                num_alive=torch.stack([o.aux.num_alive for o in outs]))})
            st.densify[kind] = stack_nodes([o.state for o in outs])
        st.params = params
        st.adam = dataclasses.replace(st.adam, mu=mu, nu=nu)
        self.aux = aux
        return info

    @torch.no_grad()
    def reset_opacities(self) -> None:
        """The periodic opacity reset of every node (with its Adam
        opacity moments zeroed)."""
        st = self.state
        cc = self.cfg.control
        params, mu, nu = st.params, st.adam.mu, st.adam.nu
        for kind in ("background", "skybox"):
            node = getattr(params, kind)
            if node is None:
                continue
            p, m, v = ctrl.reset_opacities(node, getattr(mu, kind), getattr(nu, kind), cc,
                                           st.densify[kind].last_comp)
            params = dataclasses.replace(params, **{kind: p})
            mu = dataclasses.replace(mu, **{kind: m})
            nu = dataclasses.replace(nu, **{kind: v})
        for kind in STACKED:
            block = getattr(params, kind)
            if block is None:
                continue
            mb, nb = getattr(mu, kind), getattr(nu, kind)
            p, m, v = ctrl.reset_opacities(block.node, mb.node, nb.node, cc,
                                           st.densify[kind].last_comp)
            params = dataclasses.replace(params, **{kind: dataclasses.replace(block, node=p)})
            mu = dataclasses.replace(mu, **{kind: dataclasses.replace(mb, node=m)})
            nu = dataclasses.replace(nu, **{kind: dataclasses.replace(nb, node=v)})
        st.params = params
        st.adam = dataclasses.replace(st.adam, mu=mu, nu=nu)

    # --------------------------------------------------------------- loop

    def step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return train_step(self.state, self.aux, self.cfg, batch, self.optim_config,
                          device=self.device, mesh=self.mesh, mesh_axis=self.mesh_axis)

    def _isect_granule(self) -> int:
        """The rounding unit of max_intersections (JAX `_isect_granule`): the
        fused gate's 512, times the mesh axis's size where the step shards
        the rasterizer over it (the band plan needs I % (n * 512); without
        it a run would leave the sharded plan after its first growth or
        ladder stage). A mesh without that axis (the data-parallel step's)
        does not shard the rasterizer."""
        g = 512
        if self.mesh is not None:
            g *= self.mesh.shape.get(self.mesh_axis, 1)
        return g

    def _set_resolution_stage(self, scale: float) -> None:
        """Switch to a ladder stage: the stage's data iterator, its render
        size taken from its first batch (kept as the next one to train
        on), and the base intersection buffer scaled by scale^2 (at least
        2^14, rounded up to `_isect_granule`)."""
        base = self._base_cfg
        self.data = self._data_factory(scale)
        first = next(self.data)
        h, w = first.image.shape[:2]
        self._pending_batch = first
        gran = self._isect_granule()
        isect = max(int(base.max_intersections * scale * scale), 1 << 14)
        isect = ((isect + gran - 1) // gran) * gran
        self.cfg = base.replace(width=w, height=h, max_intersections=isect)
        self._cur_scale = scale

    def train(self, num_steps: int, log_every: int = 100, callback=None, writer=None):
        """Run `num_steps` steps; refine and reset on the reference's
        schedule, switching ladder stages at their start steps and turning
        deformation on at deform_enable_step (at once on a resume past
        it). Returns the per-step metrics (device tensors). `loop_stats`
        holds this call's host seconds of step dispatch, refine (with its
        syncs) and the callback's metric syncs, and its step count.
        `writer` is an optional `mtgs_torch.utils.observability.Writer`
        given every step's metrics plus step_ms / rays_per_s (ref:
        nerfstudio writer events); with one, every step waits for the
        device, as the metrics are read back."""
        cc = self.cfg.control
        timer = StepTimer(pixels_per_step=self.cfg.width * self.cfg.height)
        history = []
        self.loop_stats = dict(dispatch_s=0.0, refine_s=0.0, sync_s=0.0, steps=0)
        for i in range(num_steps):
            step = self.state.step
            if (self.cfg.deform_enable_step is not None and not self.cfg.scene.deform_enabled
                    and step >= self.cfg.deform_enable_step
                    and self.state.params.deformables is not None):
                # the one-time switch, also in the base config the ladder scales
                on = lambda c: c.replace(scene=dataclasses.replace(c.scene, deform_enabled=True))
                self.cfg, self._base_cfg = on(self.cfg), on(self._base_cfg)
            if self.resolution_stages is not None:
                scale = self.resolution_stages[0][1]
                for start, s in self.resolution_stages:
                    if step >= start:
                        scale = s
                if scale != self._cur_scale:
                    self._set_resolution_stage(scale)
                    timer = StepTimer(pixels_per_step=self.cfg.width * self.cfg.height)
            if self._pending_batch is not None:
                batch, self._pending_batch = self._pending_batch, None
            else:
                batch = next(self.data)
            t0 = time.perf_counter()
            metrics = self.step(batch)
            self.loop_stats["dispatch_s"] += time.perf_counter() - t0
            self.loop_stats["steps"] += 1
            sref = step + 1
            t0 = time.perf_counter()
            if sref > cc.densify_from_iter and sref % cc.refine_every == 0:
                do_densify = sref < cc.stop_split_at
                do_cull_big = sref > cc.refine_every * cc.reset_alpha_every
                use_screen = sref < cc.stop_screen_size_at
                if do_densify or cc.continue_cull_post_densification:
                    info = self.refine((do_densify, do_cull_big, use_screen))
                    self.refine_events.append(info)
                    if info["overflow"] > 0:
                        self.refine_overflow += info["overflow"]
                    # intersection-buffer growth, checked at the refine cadence
                    # (every step would cost a host sync)
                    n_isect = int(metrics["n_intersections"])
                    if (self.cfg.auto_grow
                            and n_isect > self.cfg.isect_grow_frac * self.cfg.max_intersections):
                        gran = self._isect_granule()
                        new = int(self.cfg.max_intersections * self.cfg.isect_grow_factor)
                        new = ((new + gran - 1) // gran) * gran
                        self.growth_events.append(dict(
                            step=sref, node="max_intersections",
                            old=self.cfg.max_intersections, new=new))
                        self.cfg = self.cfg.replace(max_intersections=new)
                        # later ladder stages start from the grown buffer
                        self._base_cfg = self._base_cfg.replace(max_intersections=int(
                            self._base_cfg.max_intersections * self.cfg.isect_grow_factor))
                reset_interval = cc.reset_alpha_every * cc.refine_every
                if sref < cc.stop_split_at and sref % reset_interval == cc.refine_every:
                    self.reset_opacities()
                    self.reset_steps.append(sref)
            self.loop_stats["refine_s"] += time.perf_counter() - t0
            if writer is not None:
                timing = timer.tick()
                writer.put_dict({**{k: float(v) for k, v in metrics.items()}, **timing}, step)
            if callback is not None and (step % log_every == 0 or i == num_steps - 1):
                t0 = time.perf_counter()
                values = {k: float(v) for k, v in metrics.items()}
                self.loop_stats["sync_s"] += time.perf_counter() - t0
                callback(step, values)
            history.append(metrics)
        if writer is not None:
            writer.flush()
        return history
