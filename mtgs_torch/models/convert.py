"""Carry a scene's state across from the JAX package.

`scene_from_state_dict(params_sd, aux_sd, device)` takes the JAX
`SceneParams` / `SceneAux` as plain nested dicts of numpy arrays — what
`jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))`
gives (keys background, skybox, instances, deformables, appearance,
camera_opt, wild; a missing node is None; a tuple, such as the deform
MLP's `w`, is a dict keyed "0", "1", ...) — and returns the port's
(SceneParams, SceneAux) on `device`.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from mtgs_torch.models.deform import DeformMLPParams
from mtgs_torch.models.gaussians import GaussianNodeParams, NodeAux
from mtgs_torch.models.scene_graph import (
    DeformableParams, InstanceAux, InstanceParams, SceneAux, SceneParams,
)
from mtgs_torch.models.wild import WildAppearanceParams

_NODE_FIELDS = ("means", "scales", "quats", "features_dc", "features_rest",
                "opacities", "features_adapters")
_INSTANCE_AUX_FIELDS = ("alive", "num_alive", "present", "is_static", "frame_timestamps",
                        "travel_of_frame", "sizes")


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)  # a copy: JAX arrays are read-only


def _node(sd: Mapping, device) -> GaussianNodeParams:
    fourier = sd.get("fourier_dc")
    return GaussianNodeParams(
        **{k: _t(sd[k], device) for k in _NODE_FIELDS},
        fourier_dc=None if fourier is None else _t(fourier, device),
    )


def _node_aux(sd: Optional[Mapping], device) -> Optional[NodeAux]:
    if sd is None:
        return None
    return NodeAux(alive=_t(sd["alive"], device), num_alive=_t(sd["num_alive"], device))


def _instance_aux(sd: Optional[Mapping], device) -> Optional[InstanceAux]:
    if sd is None:
        return None
    return InstanceAux(**{k: _t(sd[k], device) for k in _INSTANCE_AUX_FIELDS})


def _tuple(sd: Mapping, device) -> Tuple[torch.Tensor, ...]:
    """A tuple of arrays from its state-dict form, a dict keyed "0", "1", ..."""
    return tuple(_t(sd[str(i)], device) for i in range(len(sd)))


def _deform_mlp(sd: Mapping, device) -> DeformMLPParams:
    return DeformMLPParams(w=_tuple(sd["w"], device), b=_tuple(sd["b"], device), **{
        k: _t(sd[k], device) for k in ("w_xyz", "b_xyz", "w_quat", "b_quat", "w_scale",
                                       "b_scale")})


def scene_from_state_dict(params_sd: Mapping, aux_sd: Mapping,
                          device="cuda") -> Tuple[SceneParams, SceneAux]:
    """JAX state dicts (numpy leaves) -> the port's scene on `device`."""
    from mtgs_torch import resolve_device

    dev = resolve_device(device)
    inst = None
    if params_sd.get("instances") is not None:
        ip = params_sd["instances"]
        inst = InstanceParams(node=_node(ip["node"], dev), quats=_t(ip["quats"], dev),
                              trans=_t(ip["trans"], dev))
    deform = None
    if params_sd.get("deformables") is not None:
        dp = params_sd["deformables"]
        deform = DeformableParams(
            node=_node(dp["node"], dev), quats=_t(dp["quats"], dev), trans=_t(dp["trans"], dev),
            embeddings=_t(dp["embeddings"], dev), mlp=_deform_mlp(dp["mlp"], dev))
    wild = None
    if params_sd.get("wild") is not None:
        wild = WildAppearanceParams(**{f: _t(params_sd["wild"][f], dev) for f in (
            "embeddings", "w1", "b1", "w2", "b2", "w3", "b3")})
    params = SceneParams(
        background=_node(params_sd["background"], dev),
        skybox=None if params_sd.get("skybox") is None else _node(params_sd["skybox"], dev),
        instances=inst,
        deformables=deform,
        appearance=_t(params_sd["appearance"], dev),
        camera_opt=_t(params_sd["camera_opt"], dev),
        wild=wild,
    )
    aux = SceneAux(
        background=_node_aux(aux_sd["background"], dev),
        skybox=_node_aux(aux_sd.get("skybox"), dev),
        instances=_instance_aux(aux_sd.get("instances"), dev),
        deformables=_instance_aux(aux_sd.get("deformables"), dev),
    )
    return params, aux
