"""Carry a scene's state across from the JAX package.

`scene_from_state_dict(params_sd, aux_sd, device)` takes the JAX
`SceneParams` / `SceneAux` as plain nested dicts of numpy arrays — what
`jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))`
gives (keys background, skybox, instances, deformables, appearance,
camera_opt, wild; a missing node is None) — and returns the port's
(SceneParams, SceneAux) on `device`.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from mtgs_torch.models.gaussians import GaussianNodeParams, NodeAux
from mtgs_torch.models.scene_graph import (
    InstanceAux, InstanceParams, SceneAux, SceneParams,
)

_NODE_FIELDS = ("means", "scales", "quats", "features_dc", "features_rest",
                "opacities", "features_adapters")


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


def scene_from_state_dict(params_sd: Mapping, aux_sd: Mapping,
                          device="cuda") -> Tuple[SceneParams, SceneAux]:
    """JAX state dicts (numpy leaves) -> the port's scene on `device`."""
    from mtgs_torch import resolve_device

    dev = resolve_device(device)
    for key in ("deformables", "wild"):
        if params_sd.get(key) is not None:
            raise NotImplementedError(f"scene has {key}: not ported yet")
    inst = None
    inst_aux = None
    if params_sd.get("instances") is not None:
        ip = params_sd["instances"]
        inst = InstanceParams(node=_node(ip["node"], dev), quats=_t(ip["quats"], dev),
                              trans=_t(ip["trans"], dev))
        ia = aux_sd["instances"]
        inst_aux = InstanceAux(**{k: _t(ia[k], dev) for k in (
            "alive", "num_alive", "present", "is_static", "frame_timestamps",
            "travel_of_frame", "sizes")})
    params = SceneParams(
        background=_node(params_sd["background"], dev),
        skybox=None if params_sd.get("skybox") is None else _node(params_sd["skybox"], dev),
        instances=inst,
        appearance=_t(params_sd["appearance"], dev),
        camera_opt=_t(params_sd["camera_opt"], dev),
    )
    aux = SceneAux(
        background=_node_aux(aux_sd["background"], dev),
        skybox=_node_aux(aux_sd.get("skybox"), dev),
        instances=inst_aux,
    )
    return params, aux
