"""Tile-sharded rendering: one view's tiles split over the ranks of a mesh
axis; port of `mtgs_tpu/parallel/tile_parallel.py`.

Implemented in `mtgs_torch.raster.rasterize(mesh=...)`, which picks the
sharded pipeline as the JAX package does; this module keeps the original
entry point as a thin alias.
"""

from __future__ import annotations

from mtgs_torch.raster.rasterize import RasterizeConfig, rasterize


def rasterize_tile_sharded(means, quats, scales, opacities, colors, viewmat, K,
                           config: RasterizeConfig, mesh, axis: str = "data", **kwargs):
    """Tile-sharded render; the outputs of `rasterize` (render, alpha, info),
    differentiable (parameter gradients, tap2d, absgrad), alike on every
    rank of the axis."""
    return rasterize(means, quats, scales, opacities, colors, viewmat, K, config,
                     mesh=mesh, shard_axis=axis, **kwargs)
