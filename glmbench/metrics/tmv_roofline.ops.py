"""``tmv_roofline.ops``: the tmv's least time (``_roofline.py``, from
the design's shapes) over its mean device time, in %: the device time of
the kernels launched inside the benchmark's ``tmv`` span, from the trace."""

from glmbench.metrics._roofline import share


def read(ctx):
    return share("tmv", ctx)
