"""``kernels_per_step.std_fit``: ``kernels_per_step.fit``'s reading in the
cell ``sparse_wide_std.fit``: the operations the device ran in the traced
window over the Newton steps of the fits traced."""

from glmbench.spec import metric_reader

read = metric_reader("kernels_per_step.fit").read
