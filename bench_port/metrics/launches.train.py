"""CUDA kernels launched a step in the traced window."""

LAYER = "device (host to device)"
UNIT, MOVES, KIND = "launches", "step_ms", "train"


def read(ctx):
    if ctx.kind != KIND or ctx.trace.launches == 0:
        return None
    return ctx.trace.launches / ctx.units
