"""``kernels_per_step.fit``: the operations the device ran in the traced
window (kernels, copies and fills: one record each in the profiler's
trace), over the Newton steps of the fits traced."""

from glmbench.metrics._steps import traced_steps


def read(ctx):
    steps = traced_steps(ctx)
    if ctx.get("trace") is None or steps == 0:
        return None
    return ctx["trace"]["device_ops"] / steps
