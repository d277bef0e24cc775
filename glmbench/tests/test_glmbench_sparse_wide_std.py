"""The ``sparse_wide_std.ops`` cell's own pieces: the standardized
sandwich's roofline counts, the data module, the reference, and whole runs
of the cell on the CPU at a small size (the rows and the columns cut, so
that a run takes seconds), with the inner sandwich on the pair plan (the
route at this size) and on the sparse Gram kernel's plain version (the
route the cell takes at its own size), and with faults planted in
``StandardizedMatrix``, the class the cell runs."""

import io
import json

import numpy as np
import pytest
import torch

from glmbench import spec
from glmbench.harness import main
from glmbench.metrics import _sparse_roofline
from tabmat_torch.models import sparse as port_sparse
from tabmat_torch.models.sparse import SparseMatrix
from tabmat_torch.models.standardized import StandardizedMatrix, _outer
from tabmat_torch.utils import to_numpy

H100 = "NVIDIA H100 80GB HBM3"
CELL = "sparse_wide_std.ops"
SEED = 3_000_000_027
SMALL = {"rows": 2000, "cols": 400}


def _reader():
    return spec.metric_reader("sandwich_roofline.sparse_wide_std")


def test_the_cell_reports_its_per_layer_metrics_and_ops_ms():
    found = spec.find(CELL)
    config = found["config"]
    assert config["reduced"] == [] and found["cell"]["chips"] == 1
    assert (config["rows"], config["cols"], config["density"], config["dtype"]) == (
        40_000, 10_000, 0.01, "float64")
    assert config["standardize"] == {"weights": "1/n", "center_predictors": True,
                                     "scale_predictors": True}
    assert set(config["limits"].values()) == {1e-9}
    assert {m["name"] for m in found["per_layer"]} == {
        "sandwich_roofline.sparse_wide_std", "device_idle.sparse_wide_std"}
    assert {m["name"] for m in found["end_to_end"]} == {"setup_s", "ops_ms", "ops_ms_p95"}
    mix = found["mix"]
    assert (mix["loop"], mix["pool"], mix["trace_requests"], mix["check_samples"]) == (
        "ops", 16, 60, 4)
    assert spec.metric_reader("device_idle.sparse_wide_std").__file__.endswith("device_idle.py")


def test_standardized_roofline_counts_by_hand():
    # 10 rows, 4 columns, 20 nonzeros: the plain sandwich's counts, three
    # 4-vectors of 8 bytes and 6 · 4² operations more
    plain = _sparse_roofline.op_counts("sandwich", 10, 4, 20)
    assert _reader().op_counts(10, 4, 20) == (plain[0] + 96, plain[1] + 96)


def test_standardized_roofline_at_the_cells_size():
    config = spec.find(CELL)["config"]
    nbytes, ops = _reader().op_counts(40_000, 10_000, 4_000_000)
    assert nbytes == 48_000_000 + 160_004 + 320_000 + 800_000_000 + 240_000
    assert ops == 40_000 * 100 * 101 + 6 * 10_000**2
    # bound by the bytes: the (k, k) output written once
    assert _reader().least_seconds(config, H100) == pytest.approx(0.25335e-3, rel=1e-4)
    assert _reader().least_seconds(config, "some other card") is None


def test_standardized_roofline_is_none_without_a_trace_and_a_percentage_with_one():
    config = spec.find(CELL)["config"]
    ctx = {"trace": None, "config": config, "device_name": H100}
    assert _reader().read(ctx) is None
    least = _reader().least_seconds(config, H100)
    ctx["trace"] = {"span_device_us": {"sandwich": (4, 4 * least * 1e6 * 25)}}
    assert _reader().read(ctx) == pytest.approx(4.0)
    ctx["trace"] = {"span_device_us": {"matvec": (4, 1.0)}}
    assert _reader().read(ctx) is None


def _run(control=False, seconds=0.3):
    out = io.StringIO()
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", str(seconds), "--trace", "0"]
    rc = main(argv + (["--control"] if control else []), device="cpu", overrides=SMALL, out=out)
    return rc, json.loads(out.getvalue().splitlines()[-1])


@pytest.fixture(params=["pair", "gram"])
def route(request, monkeypatch):
    """The inner sandwich on the pair plan (the route at this size), or past
    both budgets on the Gram kernel's plain version, the route the cell
    takes at its own size."""
    if request.param == "gram":
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_SEGMENTS", 0)
        monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_COLS", 0)
    return request.param


def _fails(result, *names):
    """The run is not correct, and exactly the checks ``names`` fail."""
    checks = result["checks"]
    failing = {name for name, check in checks.items() if check["value"] > check["limit"]}
    return result["correct"] is False and failing == set(names)


def test_a_small_run_is_correct(route):
    rc, result = _run()
    assert rc == 0 and result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"matvec_relerr", "tmv_relerr", "sandwich_relerr"}
    assert all(c["value"] <= 1e-13 for c in result["checks"].values()), result["checks"]
    assert set(result["metrics"]) == {"setup_s", "ops_ms", "ops_ms_p95"}


def test_the_control_is_not_correct(route):
    rc, result = _run(control=True)
    assert rc == 0 and _fails(result, "matvec_relerr", "tmv_relerr", "sandwich_relerr"), \
        result["checks"]


def _planted(monkeypatch, fault):
    """Wrap ``StandardizedMatrix._expand``, the sandwich's rank-1 expansion,
    with ``fault(self, out, term1, d_mat, d)``."""
    expand = StandardizedMatrix._expand

    def faulty(self, term1, d_mat, d, rows, cols):
        out = expand(self, term1, d_mat, d, rows, cols)
        return fault(self, out, term1, d_mat, d)

    monkeypatch.setattr(StandardizedMatrix, "_expand", faulty)


def test_a_shift_left_out_of_one_rank1_term_is_caught(route, monkeypatch):
    def fault(self, out, term1, d_mat, d):
        _, shift, mult = self._params(d)
        return out - _outer(shift, d_mat * mult)  # outer(shift, mult * t) left out

    _planted(monkeypatch, fault)
    rc, result = _run()
    assert rc == 0 and _fails(result, "sandwich_relerr"), result["checks"]


def test_mult_on_one_side_only_is_caught(route, monkeypatch):
    def fault(self, out, term1, d_mat, d):
        _, _, mult = self._params(d)
        return out - term1 * _outer(mult, mult) + term1 * mult[:, None]

    _planted(monkeypatch, fault)
    rc, result = _run()
    assert rc == 0 and _fails(result, "sandwich_relerr"), result["checks"]


def test_means_with_the_weights_left_out_are_caught(route, monkeypatch):
    """The column means as plain sums over the rows, the weights left out.
    (A mean over the rows, ``Σ x / n``, is the weighted mean itself at the
    cell's weights of 1/n: no check could tell them apart.)"""
    monkeypatch.setattr(SparseMatrix, "_get_col_means",
                        lambda self, weights: to_numpy(self.transpose_matvec(
                            np.ones_like(np.asarray(weights)))))
    rc, result = _run()
    assert rc == 0 and _fails(result, "matvec_relerr", "tmv_relerr", "sandwich_relerr"), \
        result["checks"]


def test_a_float32_sandwich_is_caught(route, monkeypatch):
    sandwich = StandardizedMatrix.sandwich

    def rounded(self, d, rows=None, cols=None):
        return sandwich(self, d, rows, cols).to(torch.float32).to(torch.float64)

    monkeypatch.setattr(StandardizedMatrix, "sandwich", rounded)
    rc, result = _run()
    assert rc == 0 and _fails(result, "sandwich_relerr"), result["checks"]
