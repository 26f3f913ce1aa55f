"""CUDA kernels launched a view in the traced window."""

LAYER = "device (host to device)"
UNIT, MOVES, KIND = "launches", "view_ms", "render"


def read(ctx):
    if ctx.kind != KIND or ctx.trace.launches == 0:
        return None
    return ctx.trace.launches / ctx.units
