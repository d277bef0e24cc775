"""``sandwich_roofline.sparse_wide_std``: the least time of the whole
standardized sandwich ``Zᵀ diag(d) Z``, ``Z = X diag(mult) + 1 shiftᵀ``, over
its mean device time in %: the device time of the kernels launched inside
the benchmark's ``sandwich`` span, from the trace.

The least time follows the user's inputs, whatever implements them:
``_sparse_roofline.op_counts("sandwich")`` for X's CSR, d and the (k, k)
output, written once; three k-vectors more (shift, mult and ``Xᵀ d``, the
vector the corrections are built from), and ``6 k²`` operations more, for
``M ∘ T`` and the three rank-1 corrections.
"""

from glmbench.metrics import _sparse_roofline
from glmbench.metrics._roofline import peaks


def op_counts(n: int, k: int, nnz: int) -> tuple:
    """(bytes, operations) of the standardized sandwich."""
    nbytes, ops = _sparse_roofline.op_counts("sandwich", n, k, nnz)
    return nbytes + 3 * k * _sparse_roofline.VALUE_BYTES, ops + 6 * k * k


def least_seconds(config: dict, device_name: str):
    """The least time on the card, or None without the card's peaks."""
    peak = peaks(device_name)
    if peak is None:
        return None
    nbytes, ops = op_counts(config["rows"], config["cols"], _sparse_roofline.nonzeros(config))
    return max(nbytes / peak["bytes_per_s"], ops / peak["flops_per_s"])


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "sandwich" not in trace["span_device_us"]:
        return None
    calls, device_us = trace["span_device_us"]["sandwich"]
    least = least_seconds(ctx["config"], ctx["device_name"])
    if least is None or calls == 0 or device_us <= 0:
        return None
    return 100.0 * least * calls / (device_us * 1e-6)
