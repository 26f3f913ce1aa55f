"""Per-parameter-group Adam with nerfstudio-style schedules; port of
`mtgs_tpu/train/optim.py`.

The JAX package runs one `optax.scale_by_adam(eps=1e-15)` over the whole
SceneParams tree followed by a per-leaf learning rate from the leaf's
group schedule; this is the same as per-group Adam(lr), with the moments
mu/nu shaped exactly like the parameters, so the refine surgery on them
is a plain map. This module is that functional Adam on the port's
dataclass trees: `AdamState.mu`/`nu` are SceneParams of moment tensors,
and one global `count` drives both bias correction and the schedules (as
optax's two counters, which advance together). `adam_update` writes the
parameters and moments in place, which saves a copy of each; a step with
a non-finite gradient leaves all of them, the count included, as they
were, and a path in its `frozen` set keeps its value while its moments
advance (the canonical means of deforming nodes).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Collection, Dict, Iterator, Optional, Tuple

import torch

from mtgs_torch.models.scene_graph import SceneParams


@dataclass(frozen=True)
class GroupSpec:
    """One param group's lr schedule (nerfstudio ExponentialDecay semantics)."""

    lr: float
    lr_final: Optional[float] = None    # None => constant lr
    max_steps: int = 30001
    warmup_steps: int = 0
    lr_pre_warmup: float = 0.0

    def schedule(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """step (a 0-d tensor) -> lr, an f32 0-d tensor on step's device."""
        def sched(step: torch.Tensor) -> torch.Tensor:
            step = step.to(torch.float32)
            if self.warmup_steps > 0:
                s = torch.clamp(step / self.warmup_steps, 0.0, 1.0)
                lr0 = self.lr_pre_warmup + (self.lr - self.lr_pre_warmup) * torch.sin(
                    0.5 * math.pi * s)
            else:
                lr0 = torch.full_like(step, self.lr)
            if self.lr_final is None or self.lr <= 0:
                return lr0
            t = torch.clamp((step - self.warmup_steps)
                            / max(self.max_steps - self.warmup_steps, 1), 0.0, 1.0)
            decay = torch.exp(math.log(self.lr) * (1 - t) + math.log(self.lr_final) * t) / self.lr
            return lr0 * decay

        return sched


def default_groups(max_steps: int = 30001) -> Dict[str, GroupSpec]:
    """The MTGS optimizer table (`mtgs/config/MTGS.py:121-187`)."""
    return {
        "means": GroupSpec(8e-4, 8e-6, max_steps),
        "features_dc": GroupSpec(0.0025),
        "features_rest": GroupSpec(0.0025 / 20),
        "opacities": GroupSpec(0.05),
        "scales": GroupSpec(0.005),
        "quats": GroupSpec(0.001),
        "multicolor.features_dc": GroupSpec(0.0025 / 20),
        "multicolor.features_adapters": GroupSpec(0.0),
        "multicolor.features_rest": GroupSpec(0.0025 / 20),
        "camera_opt": GroupSpec(1e-4, 5e-7, max_steps, warmup_steps=max(1, max_steps // 20),
                                lr_pre_warmup=0.0),
        "appearance": GroupSpec(1e-3, 1e-4, max_steps, warmup_steps=max(1, max_steps // 6),
                                lr_pre_warmup=1e-5),
        "ins_rotation": GroupSpec(1e-5, 5e-6, max_steps),
        "ins_translation": GroupSpec(5e-4, 1e-4, max_steps),
        "deform_network": GroupSpec(1.6e-4, 1.6e-6, max_steps),
        "embeddings": GroupSpec(1.6e-4),
    }


@dataclass(frozen=True)
class OptimConfig:
    groups: Dict[str, GroupSpec]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15


# ---------------------------------------------------------------- trees

def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every tensor of a dataclass tree, in field
    order (the order of `jax.tree.leaves` on the JAX pytree); a tuple's
    items are named by their index (`deformables.mlp.w.0`); None fields
    are skipped."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    if isinstance(tree, tuple):
        for i, x in enumerate(tree):
            yield from named_leaves(x, f"{prefix}.{i}")
        return
    for f in dataclasses.fields(tree):
        yield from named_leaves(getattr(tree, f.name), f"{prefix}.{f.name}" if prefix else f.name)


def tree_map(fn, tree, *rest):
    """A dataclass tree of fn(leaf, *leaves of `rest` at the same place)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(tree)})


def _node_labels(prefix: str, multicolor: bool) -> Dict[str, str]:
    mc = "multicolor." if multicolor else ""
    return {f"{prefix}.means": "means", f"{prefix}.scales": "scales",
            f"{prefix}.quats": "quats", f"{prefix}.opacities": "opacities",
            f"{prefix}.features_dc": mc + "features_dc",
            f"{prefix}.features_rest": mc + "features_rest",
            f"{prefix}.features_adapters": "multicolor.features_adapters",
            # Fourier dc coefficients are the node's features_dc in the reference
            f"{prefix}.fourier_dc": "features_dc"}


def param_labels(params: SceneParams) -> Dict[str, str]:
    """Group name of every parameter leaf, by its dotted path."""
    labels = {"appearance": "appearance", "camera_opt": "camera_opt"}
    labels.update(_node_labels("background", params.background.multicolor))
    if params.skybox is not None:
        labels.update(_node_labels("skybox", params.skybox.multicolor))
    if params.instances is not None:
        labels.update(_node_labels("instances.node", params.instances.node.multicolor))
        labels.update({"instances.quats": "ins_rotation", "instances.trans": "ins_translation"})
    if params.deformables is not None:
        # the deformable node takes the mono-colour labels whatever its shape
        labels.update(_node_labels("deformables.node", False))
        labels.update({"deformables.quats": "ins_rotation",
                       "deformables.trans": "ins_translation",
                       "deformables.embeddings": "embeddings"})
        labels.update({path: "deform_network"
                       for path, _ in named_leaves(params.deformables.mlp, "deformables.mlp")})
    if params.wild is not None:
        labels.update({path: "appearance" for path, _ in named_leaves(params.wild, "wild")})
    return {path: labels[path] for path, _ in named_leaves(params)}


# ----------------------------------------------------------------- Adam

@dataclass
class AdamState:
    mu: SceneParams
    nu: SceneParams
    count: torch.Tensor     # [] int32, on the parameters' device


def adam_init(params: SceneParams) -> AdamState:
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)
    return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=params.background.means.device))


@torch.no_grad()
def adam_update(params: SceneParams, grads: Dict[str, torch.Tensor], state: AdamState,
                config: OptimConfig, finite: torch.Tensor,
                frozen: Collection[str] = ()) -> None:
    """One Adam step in place (optax.scale_by_adam, then -lr of the leaf's
    group at the step count). `finite` is a 0-d bool tensor: where it is
    false the gradients are taken as zero and params, moments and count
    all keep their values; it is read on the device, so the step needs no
    host sync. The leaves named in `frozen` get a zero update; their
    moments advance as any other's."""
    labels = param_labels(params)
    scheds = {k: v.schedule() for k, v in config.groups.items()}
    lrs = {k: scheds[k](state.count) for k in set(labels.values())}
    c = (state.count + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(config.b1, c)
    bc2 = 1.0 - torch.pow(config.b2, c)
    mus = dict(named_leaves(state.mu))
    nus = dict(named_leaves(state.nu))
    for path, p in named_leaves(params):
        g = torch.where(finite, grads[path], 0.0)
        mu, nu = mus[path], nus[path]
        mu_new = (1.0 - config.b1) * g + config.b1 * mu
        nu_new = (1.0 - config.b2) * (g * g) + config.b2 * nu
        u = -lrs[labels[path]] * ((mu_new / bc1) / (torch.sqrt(nu_new / bc2) + config.eps))
        if path not in frozen:
            p.add_(torch.where(finite, u, 0.0))
        mu.copy_(torch.where(finite, mu_new, mu))
        nu.copy_(torch.where(finite, nu_new, nu))
    state.count += finite.to(torch.int32)
