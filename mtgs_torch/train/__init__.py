"""Render-path pieces of the trainer: config, batch, render_view, the SSIM
and normal helpers the eval path uses."""
