"""The ``sparse_wide.ops`` cell's own pieces: the sparse roofline counts,
the generator, the reference, and whole runs of the cell on the CPU at a
small size (the rows and the columns cut, so that a run takes seconds),
through the pair plan and through the row panels it takes on the card,
with faults planted in ``SparseMatrix``, the class the cell runs."""

import io
import json

import numpy as np
import pytest
import torch
from scipy import sparse as sps

from glmbench import spec
from glmbench.data import sparse_wide
from glmbench.harness import main
from glmbench.metrics import _sparse_roofline
from glmbench.reference.sparse import SparseDesign
from tabmat_torch.models import sparse as port_sparse
from tabmat_torch.models.sparse import SparseMatrix

H100 = "NVIDIA H100 80GB HBM3"
CELL = "sparse_wide.ops"
SEED = 3_000_000_019
SMALL = {"rows": 2000, "cols": 400}


def test_the_cell_reports_its_four_per_layer_metrics_and_ops_ms():
    found = spec.find(CELL)
    assert found["config"]["reduced"] == [] and found["cell"]["chips"] == 1
    assert {m["name"] for m in found["per_layer"]} == {
        "sandwich_roofline.sparse_wide", "matvec_roofline.sparse_wide",
        "tmv_roofline.sparse_wide", "device_idle.sparse_wide"}
    assert {m["name"] for m in found["end_to_end"]} == {"setup_s", "ops_ms", "ops_ms_p95"}
    assert found["mix"]["trace_requests"] == 10 and found["mix"]["check_samples"] == 4


def test_sparse_roofline_counts_by_hand():
    # 10 rows, 4 columns, 20 nonzeros: 2 a row
    assert _sparse_roofline.nonzeros({"rows": 10, "cols": 4, "density": 0.5}) == 20
    assert _sparse_roofline.op_counts("matvec", 10, 4, 20) == (240 + 44 + 32 + 80, 40)
    assert _sparse_roofline.op_counts("tmv", 10, 4, 20) == (240 + 20 + 80 + 32, 40)
    assert _sparse_roofline.op_counts("sandwich", 10, 4, 20) == (240 + 44 + 80 + 128, 60)
    with pytest.raises(ValueError):
        _sparse_roofline.op_counts("solve", 10, 4, 20)


def test_sparse_roofline_least_times_at_the_cells_size():
    config = spec.find(CELL)["config"]
    assert _sparse_roofline.nonzeros(config) == int(0.01 * 40_000 * 10_000) == 4_000_000
    # 48 MB of CSR, 160 kB of pointers, 320 kB of d, 800 MB of output
    nbytes, ops = _sparse_roofline.op_counts("sandwich", 40_000, 10_000, 4_000_000)
    assert nbytes == 48_000_000 + 160_004 + 320_000 + 800_000_000 and ops == 40_000 * 100 * 101
    assert _sparse_roofline.least_seconds("sandwich", config, H100) == pytest.approx(
        0.25328e-3, rel=1e-4)
    assert _sparse_roofline.least_seconds("matvec", config, H100) == pytest.approx(
        14.496e-6, rel=1e-4)
    assert _sparse_roofline.least_seconds("tmv", config, H100) == pytest.approx(
        14.460e-6, rel=1e-4)
    assert _sparse_roofline.least_seconds("tmv", config, "some other card") is None


def test_sparse_roofline_share_is_none_without_a_trace_and_a_percentage_with_one():
    config = spec.find(CELL)["config"]
    ctx = {"trace": None, "config": config, "device_name": H100}
    assert _sparse_roofline.share("sandwich", ctx) is None
    least = _sparse_roofline.least_seconds("sandwich", config, H100)
    ctx["trace"] = {"span_device_us": {"sandwich": (4, 4 * least * 1e6 * 100)}}
    assert _sparse_roofline.share("sandwich", ctx) == pytest.approx(1.0)
    assert _sparse_roofline.share("matvec", ctx) is None
    for op in ("sandwich", "matvec", "tmv"):
        reader = spec.metric_reader(f"{op}_roofline.sparse_wide")
        assert reader.__file__.endswith(f"{op}_roofline.sparse_wide.py")
        assert reader.read({"trace": None, "config": config, "device_name": H100}) is None


@pytest.mark.parametrize("shape", [(1000, 300, 0.01), (777, 50, 0.03)])
def test_generator_is_deterministic_by_seed_with_scipys_nonzeros(shape):
    rows, cols, density = shape
    config = {"rows": rows, "cols": cols, "density": density}
    a, b = (sparse_wide.make(config, 2**31 + 5, 1)[0]["csc"] for _ in range(2))
    c = sparse_wide.make(config, 2**31 + 6, 1)[0]["csc"]
    assert a.format == "csc" and a.dtype == np.float64 and a.has_sorted_indices
    # scipy rounds density · rows · cols: 1165.5 is 1166 at the second shape
    assert a.nnz == _sparse_roofline.nonzeros(config) == round(density * rows * cols)
    assert (a != b).nnz == 0
    assert (a != c).nnz > 0
    assert a.data.min() >= 0.0 and a.data.max() < 1.0


def test_reference_matches_scipy():
    X = sparse_wide.make({"rows": 5000, "cols": 120, "density": 0.05}, 9, 1)[0]["csc"]
    ref = SparseDesign(X.indptr, X.indices, X.data, X.shape, device="cpu")
    rng = np.random.default_rng(1)
    d, v, r = rng.random(5000) + 0.05, rng.standard_normal(120), rng.standard_normal(5000)
    H = (X.T @ sps.diags(d) @ X).toarray()
    assert np.abs(ref.hessian(d) - H).max() <= 1e-14 * np.abs(H).max()
    assert np.abs(ref.matvec(v) - X @ v).max() <= 1e-14 * np.abs(X @ v).max()
    assert np.abs(ref.tmv(r) - X.T @ r).max() <= 1e-14 * np.abs(X.T @ r).max()


def _run(control=False, seconds=0.3):
    out = io.StringIO()
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", str(seconds), "--trace", "0"]
    rc = main(argv + (["--control"] if control else []), device="cpu", overrides=SMALL, out=out)
    return rc, json.loads(out.getvalue().splitlines()[-1])


@pytest.fixture(params=["pair", "panels"])
def route(request, monkeypatch):
    """The pair plan (the route at this size), or row panels of 300 rows,
    the route the cell takes at its own size."""
    if request.param == "panels":
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
        monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_ELEMENTS", 300 * SMALL["cols"])
    return request.param


def test_a_small_run_is_correct(route):
    rc, result = _run()
    assert rc == 0 and result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"matvec_relerr", "tmv_relerr", "sandwich_relerr"}
    assert set(result["metrics"]) == {"setup_s", "ops_ms", "ops_ms_p95"}


def test_the_control_is_not_correct(route):
    rc, result = _run(control=True)
    assert rc == 0 and result["correct"] is False
    assert all(c["value"] > c["limit"] for c in result["checks"].values()), result["checks"]


def _half_rows(x):
    keep = torch.zeros_like(x)
    keep[: x.shape[0] // 2] = 2.0
    return x * keep


def test_half_the_rows_left_out_is_caught(route, monkeypatch):
    tmv, sandwich = SparseMatrix.transpose_matvec, SparseMatrix.sandwich
    monkeypatch.setattr(SparseMatrix, "transpose_matvec",
                        lambda self, r, **kw: tmv(self, _half_rows(r), **kw))
    monkeypatch.setattr(SparseMatrix, "sandwich",
                        lambda self, d, **kw: sandwich(self, _half_rows(d), **kw))
    rc, result = _run()
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["matvec_relerr"]["value"] <= 1e-9
    assert result["checks"]["tmv_relerr"]["value"] > 1e-9
    assert result["checks"]["sandwich_relerr"]["value"] > 1e-9


def test_an_altered_sandwich_entry_is_caught(route, monkeypatch):
    sandwich = SparseMatrix.sandwich

    def altered(self, d, rows=None, cols=None):
        S = sandwich(self, d, rows, cols).clone()
        S[0, 0] *= 1 + 1e-6
        return S

    monkeypatch.setattr(SparseMatrix, "sandwich", altered)
    rc, result = _run()
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["sandwich_relerr"]["value"] > 1e-9
