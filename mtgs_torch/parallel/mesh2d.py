"""Cameras x tiles: the train step over a 2D (data, tile) mesh; port of
`mtgs_tpu/parallel/mesh2d.py`.

Axis `data`: one camera per row of the mesh. Axis `tile`: within a row,
the view's rasterization runs the gaussian-ownership pipeline
(`raster/dist_fused.py`, or unsharded where its plan does not apply:
never the band or the layered plan, as under JAX's enclosing shard_map),
and the band renders are gathered so that every rank of a row holds its
camera's full image. The image losses then run alike on the row's ranks.

JAX divides the row's replication of the loss out of the gradients with
one pmean over both axes (`mesh2d.py:60-65`). In the port `rasterize`
does the tile half itself (`parallel/collectives.py::replicated`): every
rank of a row leaves `loss_and_grads` with its camera's gradients, alike
along the row, so this step averages over `data` only, as the
data-parallel step does; the densify statistics, alike along the row,
are reduced over `data` only too.
"""

from __future__ import annotations

from typing import Dict

from mtgs_torch import resolve_device
from mtgs_torch.parallel.data_parallel import data_parallel_update, shard_batch
from mtgs_torch.train.optim import OptimConfig
from mtgs_torch.train.trainer import Batch, TrainerConfig, TrainState, loss_and_grads


def make_2d_train_step(cfg: TrainerConfig, optim_config: OptimConfig, mesh,
                       data_axis: str = "data", tile_axis: str = "tile", device="cuda"):
    """The train step over a 2D mesh (JAX `make_2d_train_step`):
    step_fn(state, aux, batch_stack) -> metrics, the batch carrying a
    leading axis of mesh.shape[data_axis] views. Every rank calls it alike;
    `state` is updated in place, the same on every rank."""
    dev = resolve_device(device)

    def step_fn(state: TrainState, aux, batch_stack: Batch) -> Dict:
        batch = shard_batch(batch_stack, mesh, data_axis)
        grad_out = loss_and_grads(state.params, aux, cfg, batch, state.step, device=dev,
                                  mesh=mesh, mesh_axis=tile_axis, inside_shard_map=True)
        return data_parallel_update(state, aux, cfg, batch, optim_config,
                                    mesh.group(data_axis), grad_out, dev)

    return step_fn
