"""Host milliseconds a training step spends inside `Trainer.step`
(`Trainer.loop_stats["dispatch_s"]`), over the untraced steps of the run."""

LAYER = "training loop, train/trainer.py::Trainer.train"
UNIT, MOVES, KIND = "ms", "step_ms", "train"


def read(ctx):
    if ctx.kind != KIND or not ctx.dispatch_s:
        return None
    return 1e3 * sum(ctx.dispatch_s) / len(ctx.dispatch_s)
