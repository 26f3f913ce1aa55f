"""The least time the backward blend of the traced steps' views needs
(`work.blend_backward_work` on the reference's blend statistics, the
card's peaks) over the device time of the blend-backward kernel a step."""

LAYER = "kernels: csrc/blend_backward.cu"
UNIT, MOVES, KIND = "%", "step_ms", "train"
KERNELS = ("blend_backward_kernel",)


def read(ctx):
    if ctx.kind != KIND:
        return None
    t = ctx.trace.kernel_seconds(KERNELS) / ctx.units
    if t <= 0:
        return None
    return 100.0 * ctx.least_seconds(*ctx.work["blend_backward"]) / t
