"""Training: render_view, losses, per-group Adam, density control,
camera-pose optimisation, the training step and the host loop."""
