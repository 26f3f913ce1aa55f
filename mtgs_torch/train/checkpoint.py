"""Checkpoints: save, resume and rotate training state; port of
`mtgs_tpu/train/checkpoint.py` (`save_checkpoint`, `load_checkpoint`,
`load_checkpoint_partial`, `save_checkpoint_rotating`,
`pad_scene_to_caps`).

The payload is the JAX package's: params, densify statistics, step, aux
and, unless stripped, the optimizer state (Adam's moments and count). Like
JAX's, it carries no generator state: a rebuilt `Trainer` re-seeds its
refine generator. The format is torch-native: a checkpoint is a
directory holding one `torch.save` file of nested dicts, one level per
dataclass field, so a leaf's dotted path in it is its
`optim.named_leaves` name; an absent node is None, the step an int. It is
read back with `torch.load(weights_only=True)`.

`load_checkpoint` restores into a template's structure and device and
raises on any shape or dtype mismatch, as orbax does: a resume into
grown capacities first pads the freshly built scene with
`pad_scene_to_caps`.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from mtgs_torch.train.optim import tree_map

PAYLOAD = "state.pt"


def payload_path(path) -> Path:
    """The file holding a checkpoint directory's payload."""
    return Path(path) / PAYLOAD


def _to_tree(x):
    """A dataclass / dict tree as nested dicts of CPU tensors, ints and None."""
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
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
    fields = ([f.name for f in dataclasses.fields(template)]
              if dataclasses.is_dataclass(template) else list(template))
    if not isinstance(saved, dict) or set(saved) != set(fields):
        raise ValueError(f"{where}: the checkpoint's keys "
                         f"{sorted(saved) if isinstance(saved, dict) else saved!r} are not "
                         f"the template's {sorted(fields)}")
    out = {k: _from_tree(saved[k], (getattr(template, k) if dataclasses.is_dataclass(template)
                                    else template[k]), f"{where}.{k}" if where else k)
           for k in fields}
    return dataclasses.replace(template, **out) if dataclasses.is_dataclass(template) else out


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
    c = caps.get("instances")
    if (c is not None and params.instances is not None
            and c != params.instances.node.means.shape[1]):
        params = rep(params, instances=rep(params.instances,
                                           node=pad_node(params.instances.node, c, 1)))
        aux = rep(aux, instances=rep(aux.instances,
                                     alive=_pad_axis(aux.instances.alive, c, 1)))
    if caps.get("deformables") is not None and params.deformables is not None:
        raise NotImplementedError("deformable nodes are not ported yet")
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
