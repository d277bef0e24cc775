"""The roofline counts and the trace arithmetic, from shapes and from
synthetic events."""

import pytest

from glmbench import spec
from glmbench.metrics import _roofline, _trace

H100 = "NVIDIA H100 80GB HBM3"


def test_dense_cat_roofline_counts():
    shape = spec.find("dense_cat.ops")["config"]
    nbytes, _ = _roofline.op_counts("sandwich", shape["rows"], 5, [1000, 1000])
    # 120 MB of X, 24 MB of codes, 24 MB of d, 32 MB of output
    assert nbytes == 120_000_000 + 24_000_000 + 24_000_000 + 2005 * 2005 * 8
    assert _roofline.least_seconds("sandwich", shape, H100) == pytest.approx(0.0598e-3, rel=2e-3)
    nbytes, _ = _roofline.op_counts("tmv", shape["rows"], 5, [1000, 1000])
    assert nbytes == 168_000_000 + 2005 * 8
    assert _roofline.least_seconds("tmv", shape, H100) == pytest.approx(0.05016e-3, rel=2e-3)
    assert _roofline.least_seconds("matvec", shape, H100) == pytest.approx(0.05016e-3, rel=2e-3)
    assert _roofline.least_seconds("sandwich", shape, "some other card") is None


def test_roofline_share_is_none_without_a_trace_and_a_percentage_with_one():
    shape = spec.find("dense_cat.ops")["config"]
    ctx = {"trace": None, "config": shape, "device_name": H100}
    assert _roofline.share("sandwich", ctx) is None
    ctx["trace"] = {"span_device_us": {"sandwich": (10, 5980.0)}}
    assert _roofline.share("sandwich", ctx) == pytest.approx(10.0, rel=2e-3)
    assert _roofline.share("tmv", ctx) is None


def test_union_and_gaps():
    busy, merged = _trace.union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert busy == 4 and merged == [[0, 3], [5, 6]]
    assert _trace.idle_gaps(merged, -1, 8) == [(-1, 0), (3, 5), (6, 8)]


def test_summary_names_idle_gaps_by_the_hosts_activity():
    device = [(10, 20, "kernel_a", 9), (30, 35, "kernel_b", 29), (36, 40, "kernel_a", 35.5)]
    host = [(0, 50, "glmbench/fit"), (22, 28, "aten::item"), (35, 36, "cudaLaunchKernel")]
    s = _trace.summarize(device, host, 0, 50)
    assert s["busy_us"] == 19 and s["window_us"] == 50 and s["device_ops"] == 3
    assert s["by_name"] == {"kernel_a": 14, "kernel_b": 5}
    assert s["idle_by_host"] == {"fit: python": 10 + 10, "fit: aten::item": 10,
                                 "fit: cudaLaunchKernel": 1}
    assert s["span_device_us"] == {"fit": (1, 19)}
    b = _trace.breakdown(s)
    assert b["device_ops"][0] == ["kernel_a", 14e-6]
    assert len(b["idle_gaps"]) == 3


def test_device_time_goes_to_the_span_open_at_launch():
    """A kernel runs after its span has closed: its time is the span's that
    launched it, the innermost one."""
    host = [(0, 10, "glmbench/matvec"), (10, 20, "glmbench/sandwich"),
            (12, 14, "glmbench/inner"), (20, 30, "glmbench/tmv")]
    device = [(9, 15, "gemv", 5), (15, 25, "segsum", 11), (25, 26, "cast", 13),
              (26, 28, "gemv", 21)]
    s = _trace.summarize(device, host, 0, 30)
    assert s["span_device_us"] == {"matvec": (1, 6), "sandwich": (1, 10), "inner": (1, 1),
                                   "tmv": (1, 2)}
    assert s["busy_us"] == 19
