"""Checkpoints: save, resume and rotate training state, and import the
reference's; port of `mtgs_tpu/train/checkpoint.py` (`save_checkpoint`,
`load_checkpoint`, `load_checkpoint_partial`, `save_checkpoint_rotating`,
`pad_scene_to_caps`, `node_from_torch_params`, `import_torch_checkpoint`,
`scene_from_torch_checkpoint`).

The payload is the JAX package's: params, densify statistics, step, aux
and, unless stripped, the optimizer state (Adam's moments and count). Like
JAX's, it carries no random key: a rebuilt `Trainer` starts its refine
key chain anew from its seed. The format is torch-native: a checkpoint is a
directory holding one `torch.save` file of nested dicts, one level per
dataclass field (a tuple, such as the deform MLP's `w`, is a dict keyed
"0", "1", ..., as in flax's state dicts), so a leaf's dotted path in it is
its `optim.named_leaves` name; an absent node is None, the step an int. It is
read back with `torch.load(weights_only=True)`.

`load_checkpoint` restores into a template's structure and device and
raises on any shape or dtype mismatch, as orbax does: a resume into
grown capacities first pads the freshly built scene with
`pad_scene_to_caps`; `checkpoint_caps` reads a checkpoint's node
capacities and whether it carries the optimizer (`checkpoint_layout`).

The importer reads the reference's nerfstudio checkpoints (MTGS in
OpenDriveLab/MTGS: `gaussian_models.<node>.gauss_params.<param>` keys) into
a renderable scene; it loads them with `weights_only=True`.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mtgs_torch import resolve_device
from mtgs_torch.models.gaussians import GaussianNodeParams, NodeAux, node_capacity, stack_nodes
from mtgs_torch.train.optim import tree_map

PAYLOAD = "state.pt"


def payload_path(path) -> Path:
    """The file holding a checkpoint directory's payload."""
    return Path(path) / PAYLOAD


def _to_tree(x):
    """A dataclass / dict / tuple tree as nested dicts of CPU tensors, ints
    and None."""
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple):
        return {str(i): _to_tree(v) for i, v in enumerate(x)}
    if dataclasses.is_dataclass(x):
        return {f.name: _to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _to_tree(v) for k, v in x.items()}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _from_tree(saved, template, where: str):
    """`saved` restored into `template`'s structure, dtypes and devices."""
    if template is None or saved is None:
        if template is not None or saved is not None:
            raise ValueError(f"{where}: the checkpoint has {type(saved).__name__}, "
                             f"the template {type(template).__name__}")
        return None
    if isinstance(template, torch.Tensor):
        if (not isinstance(saved, torch.Tensor) or saved.shape != template.shape
                or saved.dtype != template.dtype):
            got = (tuple(saved.shape), saved.dtype) if isinstance(saved, torch.Tensor) \
                else type(saved).__name__
            raise ValueError(f"{where}: the checkpoint has {got}, the template "
                             f"{(tuple(template.shape), template.dtype)}")
        return saved.to(template.device)
    if isinstance(template, (bool, int, float)):
        return type(template)(saved)
    if dataclasses.is_dataclass(template):
        items = {f.name: getattr(template, f.name) for f in dataclasses.fields(template)}
    elif isinstance(template, tuple):
        items = {str(i): v for i, v in enumerate(template)}
    else:
        items = template
    if not isinstance(saved, dict) or set(saved) != set(items):
        raise ValueError(f"{where}: the checkpoint's keys "
                         f"{sorted(saved) if isinstance(saved, dict) else saved!r} are not "
                         f"the template's {sorted(items)}")
    out = {k: _from_tree(saved[k], t, f"{where}.{k}" if where else k) for k, t in items.items()}
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **out)
    return tuple(out.values()) if isinstance(template, tuple) else out


def save_checkpoint(path, state, aux, *, keep_optimizer: bool = True) -> None:
    """Save a TrainState and its SceneAux to the directory `path`
    (written to a temporary file first, then renamed into place)."""
    payload = {
        "params": _to_tree(state.params),
        "densify": _to_tree(state.densify),
        "step": int(state.step),
        "aux": _to_tree(aux),
    }
    if keep_optimizer:
        payload["opt_state"] = _to_tree(state.adam)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (PAYLOAD + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, payload_path(path))


def _read(path) -> Dict[str, Any]:
    return torch.load(payload_path(path), map_location="cpu", weights_only=True)


def load_checkpoint(path, template: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a payload saved by `save_checkpoint` into `template` (a
    dict with the same keys: "params", "densify", "step", "aux" and, if
    saved, "opt_state"), on the template's devices. Raises if a key, a
    node, a shape or a dtype differs."""
    return _from_tree(_read(path), dict(template), "")


def load_checkpoint_partial(path, template: Dict[str, Any]) -> Dict[str, Any]:
    """Restore only the top-level keys of `template` (e.g. params and aux
    for rendering, ignoring the optimizer and densify state)."""
    saved = _read(path)
    missing = sorted(set(template) - set(saved))
    if missing:
        raise ValueError(f"checkpoint {path} has no {missing}")
    return _from_tree({k: saved[k] for k in template}, dict(template), "")


def checkpoint_layout(path) -> Dict[str, Any]:
    """What a checkpoint holds besides its values: {"caps": its node
    capacities in `pad_scene_to_caps`'s form (a freshly built scene padded
    to them loads a checkpoint taken after a capacity growth), "step",
    "has_optimizer"}."""
    saved = _read(path)
    params = saved["params"]
    stacked = lambda block: None if block is None else int(block["node"]["means"].shape[1])
    caps = dict(
        background=int(params["background"]["means"].shape[0]),
        skybox=None if params.get("skybox") is None
        else int(params["skybox"]["means"].shape[0]),
        instances=stacked(params.get("instances")),
        deformables=stacked(params.get("deformables")),
    )
    return dict(caps=caps, step=int(saved["step"]), has_optimizer="opt_state" in saved)


def _pad_axis(a: torch.Tensor, cap: int, axis: int) -> torch.Tensor:
    if a.shape[axis] == cap:
        return a
    shape = list(a.shape)
    shape[axis] = cap - a.shape[axis]
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def pad_scene_to_caps(params, aux, caps: Dict[str, Optional[int]]):
    """Re-pad node capacities of a freshly built scene so its shapes match
    a checkpoint whose nodes have grown since init. `caps` maps a node
    name ("background", "skybox", "instances", "deformables") to its
    capacity (None or absent: unchanged). Padded rows are zeros and dead;
    the load that follows overwrites every tensor anyway."""
    pad_node = lambda node, cap, axis: tree_map(lambda a: _pad_axis(a, cap, axis), node)
    rep = dataclasses.replace

    c = caps.get("background")
    if c is not None and c != params.background.capacity:
        params = rep(params, background=pad_node(params.background, c, 0))
        aux = rep(aux, background=rep(aux.background,
                                      alive=_pad_axis(aux.background.alive, c, 0)))
    c = caps.get("skybox")
    if c is not None and params.skybox is not None and c != params.skybox.capacity:
        params = rep(params, skybox=pad_node(params.skybox, c, 0))
        aux = rep(aux, skybox=rep(aux.skybox, alive=_pad_axis(aux.skybox.alive, c, 0)))
    for kind in ("instances", "deformables"):  # stacked: capacity on axis 1
        c, block = caps.get(kind), getattr(params, kind)
        if c is not None and block is not None and c != block.node.means.shape[1]:
            params = rep(params, **{kind: rep(block, node=pad_node(block.node, c, 1))})
            a = getattr(aux, kind)
            aux = rep(aux, **{kind: rep(a, alive=_pad_axis(a.alive, c, 1))})
    return params, aux


def save_checkpoint_rotating(out_dir, state, aux, step: int, *, keep: int = 1,
                             keep_optimizer: bool = True, retries: int = 3,
                             backoff_s: float = 2.0) -> Path:
    """`step-{step:09d}` save with retries on OSError (exponential backoff)
    and latest-`keep` retention: older `step-*` checkpoints are deleted."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"step-{step:09d}"
    delay = backoff_s
    for attempt in range(retries):
        try:
            save_checkpoint(path, state, aux, keep_optimizer=keep_optimizer)
            break
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(delay)
            delay *= 2
    for old in sorted(out_dir.glob("step-*"))[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return path


# ------------------------------------------------------------ reference import

def _pad_to(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + arr.shape[1:], np.float32)
    out[: len(arr)] = arr
    return out


def node_from_torch_params(gp: Dict[str, np.ndarray], *, capacity: Optional[int] = None,
                           device="cuda") -> Tuple[GaussianNodeParams, NodeAux]:
    """A padded node from a reference `gauss_params` dict (means, scales,
    quats, features_dc, features_rest, opacities[, features_adapters]).
    Rigid nodes with Fourier colours store features_dc as [n, F_dim, 3]
    IDFT coefficients (ref rigid_node.py:75-86); their first coefficient is
    the static dc."""
    dev = resolve_device(device)
    n = len(gp["means"])
    cap = capacity or node_capacity(n)
    adapters = gp.get("features_adapters")
    if adapters is None:
        adapters = np.zeros((n, 0, 3), np.float32)
    dc = gp["features_dc"]
    if dc.ndim == 3:
        fourier, dc = dc, dc[:, 0, :]
    else:
        fourier = np.zeros((n, 0, 3), np.float32)
    t = lambda a: torch.as_tensor(_pad_to(a, cap), device=dev)
    params = GaussianNodeParams(
        means=t(gp["means"]), scales=t(gp["scales"]), quats=t(gp["quats"]),
        features_dc=t(dc), features_rest=t(gp["features_rest"]),
        opacities=t(gp["opacities"]), features_adapters=t(adapters), fourier_dc=t(fourier),
    )
    alive = np.zeros((cap,), np.float32)
    alive[:n] = 1.0
    return params, NodeAux(alive=torch.as_tensor(alive, device=dev),
                           num_alive=torch.tensor(n, dtype=torch.int32, device=dev))


_NODE_KEY = re.compile(r"gaussian_models\.(.+?)\.gauss_params\.(\w+)$")
_POSE_KEY = re.compile(r"gaussian_models\.(.+?)\.(instance_quats|instance_trans)$")


def import_torch_checkpoint(path) -> Dict[str, Any]:
    """A reference MTGS checkpoint as node parameter dicts: {'step': int,
    'nodes': {node: {param: np.ndarray}}, and where present 'appearance'
    and 'camera_opt'}; node names follow the reference's
    `gaussian_models.<name>.gauss_params.<param>` keys."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    state = ckpt.get("pipeline", ckpt)
    nodes: Dict[str, Dict[str, np.ndarray]] = {}
    extras: Dict[str, np.ndarray] = {}
    for key, val in state.items():
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        m = _NODE_KEY.search(key) or _POSE_KEY.search(key)
        if m:
            nodes.setdefault(m.group(1), {})[m.group(2)] = arr
        elif "appearance_model" in key and key.endswith("exposure_params"):
            extras["appearance"] = arr
        elif key.endswith("camera_optimizer.pose_adjustment"):
            extras["camera_opt"] = arr
    return {"step": int(ckpt.get("step", 0)), "nodes": nodes, **extras}


def scene_from_torch_checkpoint(path, *, num_cameras: int = 8,
                                num_images: Optional[int] = None, device="cuda"):
    """A renderable (SceneParams, SceneAux, step) from a reference MTGS
    checkpoint, on `device`. Node mapping:

      * `background` / `skybox` -> multicolour nodes;
      * nodes with `instance_quats`/`instance_trans` -> stacked rigid
        instances (off-frame poses parked at z = 1e5 become present = 0, the
        reference's gating, `rigid_node.py:94-96`); Fourier dc coefficients
        are lifted to one F_dim across instances;
      * `exposure_params` -> the per-camera appearance affine;
        `pose_adjustment` -> camera_opt rows.

    What the dataparser knows and the checkpoint does not (frame
    timestamps, traversal of each frame, box sizes) gets neutral defaults:
    enough for frame-indexed rendering, not for slerp interpolation."""
    from mtgs_torch.models.appearance import init_exposure
    from mtgs_torch.models.fourier import init_fourier_dc
    from mtgs_torch.models.scene_graph import InstanceAux, InstanceParams, SceneAux, SceneParams

    dev = resolve_device(device)
    out = import_torch_checkpoint(path)
    nodes = dict(out["nodes"])
    bg_p, bg_a = node_from_torch_params(nodes.pop("background"), device=dev)
    sky = nodes.pop("skybox", None)
    sky_p, sky_a = (None, None) if sky is None else node_from_torch_params(sky, device=dev)

    rigid = {k: v for k, v in nodes.items() if "instance_quats" in v}
    inst_params = inst_aux = None
    if rigid:
        names = sorted(rigid)
        F = max(rigid[n]["instance_quats"].shape[0] for n in names)
        cap = max(node_capacity(len(rigid[n]["means"])) for n in names)
        built = [node_from_torch_params(rigid[n], capacity=cap, device=dev) for n in names]
        fdim = max(p.fourier_dc.shape[-2] for p, _ in built)
        if fdim > 0:
            built = [(p if p.fourier_dc.shape[-2] == fdim else dataclasses.replace(
                p, fourier_dc=init_fourier_dc(p.features_dc, fdim)), a) for p, a in built]
        node = stack_nodes([p for p, _ in built])

        def pad_f(arr, fill):
            a = np.full((F,) + arr.shape[1:], fill, np.float32)
            a[: len(arr)] = arr
            return a

        quats = torch.as_tensor(np.stack([pad_f(rigid[n]["instance_quats"], 0.0)
                                          for n in names]), device=dev)
        trans = torch.as_tensor(np.stack([pad_f(rigid[n]["instance_trans"], 1e5)
                                          for n in names]), device=dev)
        inst_params = InstanceParams(node=node, quats=quats, trans=trans)
        inst_aux = InstanceAux(
            alive=torch.stack([a.alive for _, a in built]),
            num_alive=torch.stack([a.num_alive for _, a in built]),
            present=(trans[..., 2].abs() < 1e4).to(torch.float32),
            is_static=torch.zeros((len(names),), dtype=torch.float32, device=dev),
            frame_timestamps=torch.linspace(0.0, 1.0, F, device=dev),
            travel_of_frame=torch.zeros((F,), dtype=torch.int32, device=dev),
            sizes=torch.ones((len(names), 3), dtype=torch.float32, device=dev),
        )

    appearance = out.get("appearance")
    appearance = (init_exposure(num_cameras, device=dev) if appearance is None
                  else torch.as_tensor(appearance, dtype=torch.float32, device=dev))
    camera_opt = out.get("camera_opt")
    camera_opt = (torch.zeros((num_images or 1, 6), dtype=torch.float32, device=dev)
                  if camera_opt is None
                  else torch.as_tensor(camera_opt, dtype=torch.float32, device=dev))
    params = SceneParams(background=bg_p, skybox=sky_p, instances=inst_params,
                         deformables=None, appearance=appearance, camera_opt=camera_opt)
    aux = SceneAux(background=bg_a, skybox=sky_a, instances=inst_aux)
    return params, aux, out["step"]
