"""``matvec_roofline.sparse_wide``: the matvec's least time on a sparse design
(``_sparse_roofline.py``, from the configuration) over its mean device time,
in %: the device time of the kernels launched inside the benchmark's
``matvec`` span, from the trace."""

from glmbench.metrics._sparse_roofline import share


def read(ctx):
    return share("matvec", ctx)
