"""The share of a view's wall time in which no kernel, copy or fill ran on the
card: the traced views' device-busy seconds a view (torch.profiler, the
device's activity alone) against the wall seconds a view of the run's
untraced views before the trace, which the profiler does not slow."""

LAYER = "device (host to device)"
UNIT, MOVES, KIND = "%", "view_ms", "render"


def read(ctx):
    if ctx.kind != KIND or ctx.unit_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.units / ctx.unit_s)
