"""Least times of the matrix operations on a sparse design, from its
configuration alone.

The counts follow the user's inputs, whatever implements them: a
scipy-style CSR or CSC matrix of ``nnz`` float64 values with int32 indices
and int32 pointers, each input byte read once and each output byte written
once.  For ``n`` rows and ``k`` columns:

- ``X @ v`` (CSR): reads the values and column indices (``12 nnz``), the row
  pointers (``4 (n + 1)``) and v (``8 k``); writes ``8 n``;
- ``X.T @ r`` (CSC): reads the values and row indices, the column pointers
  (``4 (k + 1)``) and r (``8 n``); writes ``8 k``;
- ``X.T diag(d) X``: reads the CSR (``12 nnz + 4 (n + 1)``) and d (``8 n``);
  writes the (k, k) matrix (``8 k²``).

Operations count one multiply and one add a product: ``2 nnz`` for a
matvec or tmv, and for the sandwich ``n μ (μ + 1)`` with ``μ = nnz / n``
nonzeros a row, once for each pair of them (``_roofline.py``'s count, with
``μ`` for the nonzeros a row).  The card's peaks are ``_roofline.peaks``.
"""

from glmbench.metrics._roofline import peaks

VALUE_BYTES, INDEX_BYTES = 8, 4


def nonzeros(config: dict) -> int:
    """The nonzeros of the configuration's design: ``scipy.sparse.random``'s
    count, ``round(density · rows · cols)``."""
    return int(round(config["density"] * config["rows"] * config["cols"]))


def op_counts(op: str, n: int, k: int, nnz: int) -> tuple:
    """(bytes, operations) of ``op`` in {"matvec", "tmv", "sandwich"}."""
    x_bytes = nnz * (VALUE_BYTES + INDEX_BYTES)
    if op == "matvec":
        return x_bytes + (n + 1) * INDEX_BYTES + k * VALUE_BYTES + n * VALUE_BYTES, 2 * nnz
    if op == "tmv":
        return x_bytes + (k + 1) * INDEX_BYTES + n * VALUE_BYTES + k * VALUE_BYTES, 2 * nnz
    if op == "sandwich":
        mu = nnz / n
        return (x_bytes + (n + 1) * INDEX_BYTES + n * VALUE_BYTES + k * k * VALUE_BYTES,
                n * mu * (mu + 1))
    raise ValueError(f"no counts for {op!r}")


def least_seconds(op: str, config: dict, device_name: str):
    """The least time of ``op`` on the card for the configuration, or None
    without the card's peaks."""
    peak = peaks(device_name)
    if peak is None:
        return None
    nbytes, ops = op_counts(op, config["rows"], config["cols"], nonzeros(config))
    return max(nbytes / peak["bytes_per_s"], ops / peak["flops_per_s"])


def share(op: str, ctx: dict):
    """The op's share of its roofline in %, from the trace: its least time
    over its mean device time in the benchmark's span ``op``; None where the
    trace has none."""
    trace = ctx.get("trace")
    if trace is None or op not in trace["span_device_us"]:
        return None
    calls, device_us = trace["span_device_us"][op]
    least = least_seconds(op, ctx["config"], ctx["device_name"])
    if least is None or calls == 0 or device_us <= 0:
        return None
    return 100.0 * least * calls / (device_us * 1e-6)
