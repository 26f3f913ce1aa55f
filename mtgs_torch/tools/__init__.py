"""Command-level tools; port of `mtgs_tpu/tools/` (the renderers, the
training campaign, the per-road-block trainer and the multi-block farm,
gaussian export, the train-step bench, the rasterizer stage profile, the
traversal preview, the fused-against-classic validation, the eval / render
/ viewer smoke, the growth demo, the sharded scaling bench and the
index-movement microbench)."""
