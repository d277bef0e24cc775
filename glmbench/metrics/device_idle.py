"""``device_idle.fit`` and ``device_idle.ops``: the share of the traced
window, in %, in which no operation ran on the device: 1 - (the union of
the operations' intervals) / (the window), from the profiler's trace."""

from glmbench.metrics._trace import idle_share


def read(ctx):
    return idle_share(ctx)
