"""The share of a step's wall time in which no kernel, copy or fill ran on the
card: the traced steps' device-busy seconds a step (torch.profiler, the
device's activity alone) against the wall seconds a step of the run's
untraced steps before the trace, which the profiler does not slow."""

LAYER = "device (host to device)"
UNIT, MOVES, KIND = "%", "step_ms", "train"


def read(ctx):
    if ctx.kind != KIND or ctx.unit_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.units / ctx.unit_s)
