"""Least times of the matrix operations, from their shapes alone.

A least time is the larger of two quotients: the bytes the operation must
move over the card's memory bandwidth, and its operations over the card's
peak rate (FP64 on the tensor cores, the kernels' precision).  Counts
follow the user's inputs, whatever implements them: each input byte is read
once and each output byte written once.  For a split design of ``n`` rows,
``kd`` dense float64 columns and categoricals of ``levels`` (codes int32):

- ``X @ v``: reads X and the codes, v (k values); writes n values;
- ``X.T @ r``: reads X, the codes and r (n values); writes k values;
- ``X.T diag(d) X``: reads X, the codes and d; writes the (k, k) matrix.

Operations count one multiply and one add for each product of two entries
of a row: ``2 n kd`` for a matvec or tmv (a categorical adds one entry a
row), and for the sandwich ``2 n c (c + 1) / 2`` with ``c = kd + len(levels)``
nonzeros a row, once for each pair of them.
"""

# Published peaks (NVIDIA's H100 SXM data sheet, dense): HBM3 bandwidth and
# FP64 with tensor cores.  Keyed by a part of the name torch gives the card.
PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}


def peaks(device_name: str):
    """The card's peaks, or None for a card the table does not hold."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def op_counts(op: str, n: int, kd: int, levels: list, value_bytes: int = 8,
              code_bytes: int = 4) -> tuple:
    """(bytes, operations) of ``op`` in {"matvec", "tmv", "sandwich"}."""
    k = kd + sum(levels)
    c = kd + len(levels)
    x_bytes = n * kd * value_bytes + n * len(levels) * code_bytes
    if op == "matvec":
        return x_bytes + k * value_bytes + n * value_bytes, 2 * n * c
    if op == "tmv":
        return x_bytes + n * value_bytes + k * value_bytes, 2 * n * c
    if op == "sandwich":
        return x_bytes + n * value_bytes + k * k * value_bytes, n * c * (c + 1)
    raise ValueError(f"no counts for {op!r}")


def least_seconds(op: str, config: dict, device_name: str):
    """The least time of ``op`` on the card for the configuration's shapes,
    or None without the card's peaks."""
    peak = peaks(device_name)
    if peak is None:
        return None
    nbytes, ops = op_counts(op, config["rows"], config["dense_cols"], config["cat_levels"])
    return max(nbytes / peak["bytes_per_s"], ops / peak["flops_per_s"])


def share(op: str, ctx: dict):
    """The op's share of its roofline in %, from the trace: its least time
    over its mean device time in its span; None where the trace has none."""
    trace = ctx.get("trace")
    if trace is None or op not in trace["span_device_us"]:
        return None
    calls, device_us = trace["span_device_us"][op]
    least = least_seconds(op, ctx["config"], ctx["device_name"])
    if least is None or calls == 0 or device_us <= 0:
        return None
    return 100.0 * least * calls / (device_us * 1e-6)
