"""The rasterizer: projection, binning, fused forward pipeline and the
hand-written CUDA kernels (`expand_fused`, `blend_forward`) with their
plain PyTorch twins."""

from mtgs_torch.raster.rasterize import RasterizeConfig, rasterize

__all__ = ["RasterizeConfig", "rasterize"]
