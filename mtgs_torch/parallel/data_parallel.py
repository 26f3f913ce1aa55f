"""Camera data-parallel training; port of `mtgs_tpu/parallel/data_parallel.py`.

Each rank of the mesh axis `data` trains on its own camera view: the
parameters are replicated, every rank runs the full forward and backward
of its view, and the gradients, losses, total loss and PSNR are averaged
over the axis (`pmean`); of the densify statistics, the gradient norms and
visibility counts are summed, the largest 2D size is max-reduced and the
last compensation takes the new maximum where it is above 0 (a rank that
did not see a gaussian reports 0). Every rank then applies the same Adam
update to the same state, so no parameter is ever broadcast: the states
stay alike bit for bit, as long as every rank runs the same host loop
(`DPTrainer`: the refine noise comes from one key chain seeded alike, which
the step passes through untouched, as JAX's does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from mtgs_torch import resolve_device
from mtgs_torch.parallel.collectives import pmax, pmean, psum
from mtgs_torch.train import control as ctrl
from mtgs_torch.train import losses as loss_lib
from mtgs_torch.train.optim import OptimConfig, adam_update
from mtgs_torch.train.trainer import (
    Batch, Trainer, TrainerConfig, TrainState, _accumulate_all, _on, loss_and_grads,
)


def shard_batch(batch_stack: Batch, mesh, axis: str = "data") -> Batch:
    """This rank's view of a batch whose fields carry a leading axis of size
    mesh.shape[axis] (one view per rank of the axis): each field's row
    `mesh.index(axis)` (JAX places the rows on the mesh's devices)."""
    n, i = mesh.size(axis), mesh.index(axis)

    def row(v):
        if v is None:
            return None
        if len(v) != n:
            raise ValueError(f"a stacked batch field has {len(v)} rows for a mesh axis "
                             f"'{axis}' of {n} ranks")
        return v[i]

    return Batch(**{f.name: row(getattr(batch_stack, f.name))
                    for f in dataclasses.fields(Batch)})


def _zero_densify(densify: Dict[str, ctrl.DensifyState]) -> Dict[str, ctrl.DensifyState]:
    return {k: ctrl.DensifyState(**{f.name: torch.zeros_like(getattr(d, f.name))
                                    for f in dataclasses.fields(d)})
            for k, d in densify.items()}


def reduce_densify(densify, local, data_group) -> Dict[str, ctrl.DensifyState]:
    """The running densify statistics plus this step's statistics of every
    rank of `data_group` (`local`, accumulated from zero): gradient norms
    and visibility counts summed, the 2D size max-reduced, the last
    compensation the new maximum where it is above 0, else the old."""
    kinds = list(densify)
    sums = psum([t for k in kinds for t in (local[k].xys_grad_norm, local[k].vis_counts)],
                data_group)
    maxes = pmax([t for k in kinds for t in (local[k].max_2dsize, local[k].last_comp)],
                 data_group)
    out = {}
    for j, k in enumerate(kinds):
        old = densify[k]
        c_new = maxes[2 * j + 1]
        out[k] = ctrl.DensifyState(
            xys_grad_norm=old.xys_grad_norm + sums[2 * j],
            vis_counts=old.vis_counts + sums[2 * j + 1],
            max_2dsize=torch.maximum(old.max_2dsize, maxes[2 * j]),
            last_comp=torch.where(c_new > 0, c_new, old.last_comp))
    return out


def data_parallel_update(state: TrainState, aux, cfg: TrainerConfig, batch: Batch,
                         optim_config: OptimConfig, data_group, grad_out: tuple,
                         dev) -> Dict[str, torch.Tensor]:
    """The reductions over `data_group` and the update that follow one
    view's `loss_and_grads` output `grad_out` on every rank (shared by the
    data-parallel and the 2D step). Updates `state` in place; returns the
    metrics, alike on every rank."""
    total, losses, out, sink_grad, grads = grad_out
    keys, lkeys = list(grads), list(losses)
    mse = loss_lib.masked_mean((_on(batch.image, dev) - out["rgb_appearance"]) ** 2,
                               _on(batch.mask, dev))
    psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
    red = pmean([grads[k] for k in keys] + [losses[k] for k in lkeys] + [total, psnr],
                data_group)
    grads = dict(zip(keys, red[:len(keys)]))
    metrics = dict(zip(lkeys, red[len(keys):len(keys) + len(lkeys)]))
    metrics["total_loss"], metrics["psnr"] = red[-2], red[-1]
    adam_update(state.params, grads, state.adam, optim_config,
                torch.ones((), dtype=torch.bool, device=dev))
    local = _accumulate_all(state.params, _zero_densify(state.densify), sink_grad,
                            out["radii"], out["gaussians"]["opacities"],
                            (cfg.width, cfg.height), comps=out["compensations"])
    state.densify = reduce_densify(state.densify, local, data_group)
    (metrics["n_intersections"],) = pmax([out["n_intersections"].reshape(())], data_group)
    count = aux.background.alive.sum()
    if aux.skybox is not None:
        count = count + aux.skybox.alive.sum()
    if aux.instances is not None:
        count = count + aux.instances.alive.sum()
    metrics["gaussian_count"] = count
    state.step += 1
    return metrics


def make_dp_train_step(cfg: TrainerConfig, optim_config: OptimConfig, mesh,
                       axis: str = "data", device="cuda"):
    """The data-parallel train step (JAX `make_dp_train_step`):
    step_fn(state, aux, batch_stack) -> metrics, `batch_stack` carrying a
    leading axis of mesh.shape[axis] views (`shard_batch` takes this
    rank's). Every rank of the mesh calls it alike; `state` is updated in
    place, the same on every rank."""
    dev = resolve_device(device)
    group = mesh.group(axis)

    def step_fn(state: TrainState, aux, batch_stack: Batch) -> Dict[str, torch.Tensor]:
        batch = shard_batch(batch_stack, mesh, axis)
        grad_out = loss_and_grads(state.params, aux, cfg, batch, state.step, device=dev)
        return data_parallel_update(state, aux, cfg, batch, optim_config, group, grad_out,
                                    dev)

    return step_fn


class DPTrainer(Trainer):
    """The data-parallel Trainer (JAX `DPTrainer`): `Trainer`'s host loop —
    refine, capacity growth, opacity reset, intersection-buffer growth,
    the ladder — around the data-parallel step. `data` yields batches
    whose fields carry a leading axis of mesh.shape[axis] views. Every
    rank of the mesh runs it with the same arguments and `seed`."""

    def __init__(self, cfg: TrainerConfig, params, aux, data, mesh, axis: str = "data",
                 **kw):
        super().__init__(cfg, params, aux, data, mesh=mesh, mesh_axis="tile", **kw)
        self.dp_axis = axis

    def step(self, batch_stack: Batch) -> Dict[str, torch.Tensor]:
        return make_dp_train_step(self.cfg, self.optim_config, self.mesh, self.dp_axis,
                                  device=self.device)(self.state, self.aux, batch_stack)
