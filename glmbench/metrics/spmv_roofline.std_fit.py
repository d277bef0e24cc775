"""``spmv_roofline.std_fit``: the least time of every ``spmv`` call of the
traced fits over the device time of the ``spmv_tiles`` and ``spmv_carries``
kernels in the trace, in %.

A call's least time is the larger of its bytes over the card's bandwidth
and its ``2 nnz`` operations over its peak rate (``_roofline.peaks``).  The
bytes are ``_sparse_roofline.py``'s counts of the CSR (``X @ v``) and CSC
(``X.T @ r``) layouts at the call's dtype: ``nnz`` values and int32 indices,
the pointers (int32, or int64 for an ``int64`` instantiation), the vector
gathered and the vector written, each byte once.  On the Hessian-vector
route every product is one matvec and one transpose-matvec, so each call
counts the mean of the two layouts' bytes: in float64 for the step's
predictor and gradient, in float32 in the CG solve.  The calls of each
instantiation are the wrapper's launch counts, which the loop records for
each request (``spmv_launches``).
"""

import re

from glmbench.metrics._roofline import peaks
from glmbench.metrics._sparse_roofline import INDEX_BYTES, nonzeros

KERNELS = re.compile(r"spmv_(?:tiles|carries)<")


def call_bytes(op: str, n: int, k: int, nnz: int, value_bytes: int,
               pointer_bytes: int = INDEX_BYTES) -> int:
    """Bytes of one ``op`` in {"matvec", "tmv"} on an ``n × k`` layout of
    ``nnz`` entries with ``value_bytes`` values."""
    entries = nnz * (value_bytes + INDEX_BYTES)
    if op == "matvec":
        return entries + (n + 1) * pointer_bytes + (k + n) * value_bytes
    if op == "tmv":
        return entries + (k + 1) * pointer_bytes + (n + k) * value_bytes
    raise ValueError(f"no counts for {op!r}")


def least_seconds(instantiation: str, config: dict, device_name: str):
    """The least time of one call of ``instantiation`` (a key of the
    wrapper's ``launches``, such as ``spmv<float>``) on the configuration's
    layouts, or None without the card's peaks."""
    peak = peaks(device_name)
    if peak is None:
        return None
    n, k, nnz = config["rows"], config["cols"], nonzeros(config)
    value_bytes = 8 if "double" in instantiation else 4
    pointer_bytes = 8 if "int64" in instantiation else INDEX_BYTES
    nbytes = 0.5 * sum(call_bytes(op, n, k, nnz, value_bytes, pointer_bytes)
                       for op in ("matvec", "tmv"))
    return max(nbytes / peak["bytes_per_s"], 2 * nnz / peak["flops_per_s"])


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    device_us = sum(us for name, us in trace["by_name"].items() if KERNELS.search(name))
    calls = {}
    for rec in ctx["records"]:
        if rec.get("traced"):
            for name, count in rec.get("spmv_launches", {}).items():
                calls[name] = calls.get(name, 0) + count
    least = 0.0
    for name, count in calls.items():
        if count:
            one = least_seconds(name, ctx["config"], ctx["device_name"])
            if one is None:
                return None
            least += count * one
    if least <= 0 or device_us <= 0:
        return None
    return 100.0 * least / (device_us * 1e-6)
