"""Command-level tools; port of `mtgs_tpu/tools/` (the renderers, the
training campaign, the per-road-block trainer, gaussian export, the
train-step bench and the rasterizer stage profile so far)."""
