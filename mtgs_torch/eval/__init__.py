"""Metric suite and the per-traversal evaluation pipeline."""
