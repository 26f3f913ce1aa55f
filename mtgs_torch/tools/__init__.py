"""Command-level tools; port of `mtgs_tpu/tools/` (the renderers so far)."""
