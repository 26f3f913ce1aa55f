"""The rasterizer: projection, binning, the fused and classic
differentiable pipelines and the hand-written CUDA kernels
(`expand_fused`, `blend_forward`, `blend_backward`, `dense_segment_sum`,
`expand_pairs`, `rows_to_attr_major`, `attr_major_to_rows`) with their
plain PyTorch twins."""

from mtgs_torch.raster.rasterize import RasterizeConfig, rasterize

__all__ = ["RasterizeConfig", "rasterize"]
