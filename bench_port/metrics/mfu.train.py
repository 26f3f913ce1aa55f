"""The float32 operations a step needs (`work.step_flops`) over the wall
time a step of the run's untraced steps at the card's 67 TFLOP/s float32
peak (the program runs float32 with TF32 off)."""

from bench_port.work import PEAK_F32_FLOPS

LAYER = "whole step"
UNIT, MOVES, KIND = "%", "step_ms", "train"


def read(ctx):
    if ctx.kind != KIND or ctx.unit_s <= 0:
        return None
    return 100.0 * ctx.work["flops"] / (ctx.unit_s * PEAK_F32_FLOPS)
