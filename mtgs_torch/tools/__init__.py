"""Command-level tools; port of `mtgs_tpu/tools/` (the renderers, the
training campaign and the per-road-block trainer so far)."""
