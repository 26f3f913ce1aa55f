"""Host milliseconds from the call of `render_view` to its return, before
any wait on the card (the benchmark's own span), over the untraced views."""

LAYER = "view forward, train/trainer.py::render_view"
UNIT, MOVES, KIND = "ms", "view_ms", "render"


def read(ctx):
    if ctx.kind != KIND or not ctx.dispatch_s:
        return None
    return 1e3 * sum(ctx.dispatch_s) / len(ctx.dispatch_s)
