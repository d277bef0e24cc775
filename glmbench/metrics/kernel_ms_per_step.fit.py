"""``kernel_ms_per_step.fit``: device milliseconds of every operation in
the traced window (the sum of their durations), over the Newton steps of
the fits traced."""

from glmbench.metrics._steps import traced_steps


def read(ctx):
    steps = traced_steps(ctx)
    if ctx.get("trace") is None or steps == 0:
        return None
    return 1e-3 * ctx["trace"]["device_us"] / steps
