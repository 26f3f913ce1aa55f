"""The rasterizer: projection, binning, the fused differentiable pipeline
and the hand-written CUDA kernels (`expand_fused`, `blend_forward`,
`blend_backward`, `dense_segment_sum`) with their plain PyTorch twins."""

from mtgs_torch.raster.rasterize import RasterizeConfig, rasterize

__all__ = ["RasterizeConfig", "rasterize"]
