"""Gaussian scene-graph nodes, instances, appearance and state conversion."""
