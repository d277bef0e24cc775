"""``matvec_roofline.ops``: the matvec's least time (``_roofline.py``, from
the design's shapes) over its mean device time, in %: the device time of
the kernels launched inside the benchmark's ``matvec`` span, from the trace."""

from glmbench.metrics._roofline import share


def read(ctx):
    return share("matvec", ctx)
