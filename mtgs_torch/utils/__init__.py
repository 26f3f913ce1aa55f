"""Host utilities: point-cloud IO and filtering; observability (metric
writers, step timing, traces)."""
