"""The port's ``SparseMatrix`` on a cut-down ``sparse_wide`` design against
the benchmark's plain reference (``glmbench/reference/sparse.py``), and the
spans and counters of ``models/sparse.py``.

The design is the benchmark's generator (``glmbench/data/sparse_wide.py``)
at a few thousand rows by a few hundred columns.  The sandwich takes each
of its three routes: the pair plan (the default at this size), the
densified matrix (the pair plan's budget at 0) and row panels (both
budgets cut, the panels' element budget chosen for a ragged last panel, a
last panel of one row, and panels of one row each).  Tolerances: float64
relerr ≤ 1e-12, float32 ≤ 1e-5 of the largest entry.
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sps

import tabmat_torch as tt
from glmbench.data import sparse_wide
from glmbench.reference.sparse import SparseDesign
from tabmat_torch import _trace
from tabmat_torch.models import sparse as port_sparse

N, K, DENSITY = 3001, 300, 0.02
SEED = 2**31 + 11
TOL = {np.float64: 1e-12, np.float32: 1e-5}
# the panels' element budget → rows of each panel, in order
PANELS = {
    700 * K: [700, 700, 700, 700, 201],  # a ragged last panel
    1000 * K: [1000, 1000, 1000, 1],  # a last panel of one row
    0: [1] * N,  # panels of one row each
}


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    _trace.disable()
    _trace.take()
    yield
    _trace.disable()
    _trace.take()


@pytest.fixture(scope="module")
def design():
    """(the generator's CSC, the reference on the CPU)."""
    X = sparse_wide.make({"rows": N, "cols": K, "density": DENSITY}, SEED, 1)[0]["csc"]
    return X, SparseDesign(X.indptr, X.indices, X.data, X.shape, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    return {"v": rng.standard_normal(K), "r": rng.standard_normal(N),
            "d": rng.random(N) + 0.05, "rows": np.sort(rng.choice(N, N // 3, replace=False)),
            "cols": np.array([7, 0, 299, 150, 151, 42])}


def _relerr(got, want) -> float:
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _route(monkeypatch, route: str, panel_budget: int = 700 * K):
    if route in ("dense", "panels"):
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
    if route == "panels":
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_SEGMENTS", 0)
        monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_COLS", K - 1)
        monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_ELEMENTS", panel_budget)


def _matrix(X, dtype=np.float64):
    return tt.SparseMatrix(X.astype(dtype), device="cpu")


def _ref_for(X, dtype):
    """The reference of the design in ``dtype``'s values, computed in float64."""
    Xd = X.astype(dtype).astype(np.float64)
    return SparseDesign(Xd.indptr, Xd.indices, Xd.data, Xd.shape, device="cpu")


def test_reference_matches_scipy(design, inputs):
    X, ref = design
    d, v, r = inputs["d"], inputs["v"], inputs["r"]
    want = (X.T @ sps.diags(d) @ X).toarray()
    assert _relerr(ref.hessian(d), want) <= 1e-14
    assert _relerr(ref.matvec(v), X @ v) <= 1e-14
    assert _relerr(ref.tmv(r), X.T @ r) <= 1e-14


def test_design_has_the_generators_nonzeros(design):
    X, _ = design
    assert X.nnz == int(DENSITY * N * K) and X.has_sorted_indices


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("route", ["pair", "dense", "panels"])
def test_sandwich_by_route(design, inputs, monkeypatch, route, dtype):
    X, _ = design
    _route(monkeypatch, route)
    m = _matrix(X, dtype)
    ref = _ref_for(X, dtype)
    d = inputs["d"].astype(dtype)
    S = m.sandwich(d)
    assert (m._pair is not None and m._pair != ()) == (route == "pair")
    assert (m._dense is not None) == (route == "dense")
    assert S.dtype == dtype
    assert _relerr(S, ref.hessian(d.astype(np.float64))) <= TOL[dtype]


@pytest.mark.parametrize("budget", sorted(PANELS), ids=["one_row_each", "ragged", "one_row_last"])
def test_panel_sandwich_at_each_panel_budget(design, inputs, monkeypatch, budget):
    X, ref = design
    _route(monkeypatch, "panels", budget)
    m = _matrix(X)
    S = m.sandwich(torch.as_tensor(inputs["d"]))
    assert torch.is_tensor(S) and S.dtype == torch.float64
    assert _relerr(S, ref.hessian(inputs["d"])) <= TOL[np.float64]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("route", ["pair", "dense", "panels"])
@pytest.mark.parametrize("restrict", ["rows", "cols", "rows_cols"])
def test_sandwich_rows_and_cols(design, inputs, monkeypatch, route, dtype, restrict):
    X, _ = design
    _route(monkeypatch, route)
    m, ref = _matrix(X, dtype), _ref_for(X, dtype)
    d = inputs["d"].astype(dtype)
    kw = {}
    dm = d.astype(np.float64)
    if "rows" in restrict:
        kw["rows"] = inputs["rows"]
        mask = np.zeros(N)
        mask[inputs["rows"]] = 1.0
        dm = dm * mask
    want = ref.hessian(dm)
    if "cols" in restrict:
        kw["cols"] = inputs["cols"]
        want = want[np.ix_(inputs["cols"], inputs["cols"])]
    assert _relerr(m.sandwich(d, **kw), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_matvec_and_transpose_matvec(design, inputs, dtype):
    X, _ = design
    m, ref = _matrix(X, dtype), _ref_for(X, dtype)
    v, r = inputs["v"].astype(dtype), inputs["r"].astype(dtype)
    assert _relerr(m.matvec(v), ref.matvec(v.astype(np.float64))) <= TOL[dtype]
    assert _relerr(m.transpose_matvec(r), ref.tmv(r.astype(np.float64))) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_matvec_and_transpose_matvec_restricted(design, inputs, dtype):
    X, _ = design
    m, ref = _matrix(X, dtype), _ref_for(X, dtype)
    v, r = inputs["v"].astype(dtype), inputs["r"].astype(dtype)
    rows, cols = inputs["rows"], inputs["cols"]
    col_mask = np.zeros(K)
    col_mask[cols] = 1.0
    assert _relerr(m.matvec(v, cols=cols),
                   ref.matvec(v.astype(np.float64) * col_mask)) <= TOL[dtype]
    row_mask = np.zeros(N)
    row_mask[rows] = 1.0
    want = ref.tmv(r.astype(np.float64) * row_mask)
    assert _relerr(m.transpose_matvec(r, rows=rows), want) <= TOL[dtype]
    assert _relerr(m.transpose_matvec(r, rows=rows, cols=cols), want[cols]) <= TOL[dtype]


# -- spans and counters -------------------------------------------------------


def _record(m, d):
    _trace.enable()
    S = m.sandwich(d)
    _trace.disable()
    return S, _trace.take()


def _children(spans, i):
    return [s["name"] for s in spans if s["parent"] == i]


@pytest.mark.parametrize("route", ["pair", "dense", "panels"])
def test_each_route_has_its_span_under_the_sandwich(design, inputs, monkeypatch, route):
    X, _ = design
    _route(monkeypatch, route)
    _, taken = _record(_matrix(X), inputs["d"])
    spans = taken["spans"]
    assert spans[0]["name"] == "sparse.sandwich" and spans[0]["parent"] is None
    assert _children(spans, 0) == [f"sparse.sandwich.{route}"]
    for s in spans[1:]:
        p = spans[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert s["root"] == spans[0]["root"]
    if route != "panels":
        assert len(spans) == 2 and "sparse_panels" not in taken["counters"]


@pytest.mark.parametrize("budget", sorted(PANELS), ids=["one_row_each", "ragged", "one_row_last"])
def test_one_panel_span_and_count_per_panel(design, inputs, monkeypatch, budget):
    X, _ = design
    _route(monkeypatch, "panels", budget)
    _, taken = _record(_matrix(X), inputs["d"])
    spans = taken["spans"]
    panels = [i for i, s in enumerate(spans) if s["name"] == "sparse.panel"]
    assert len(panels) == len(PANELS[budget])
    assert {spans[i]["parent"] for i in panels} == {1}
    assert spans[1]["name"] == "sparse.sandwich.panels"
    starts = [spans[i]["start_ns"] for i in panels]
    assert starts == sorted(starts)
    assert taken["counters"]["sparse_panels"] == len(PANELS[budget])
    assert taken["counters"]["sparse_panel_bytes"] == 8 * K * sum(PANELS[budget])


def test_panel_counters_with_cols_count_the_restricted_width(design, inputs, monkeypatch):
    X, _ = design
    _route(monkeypatch, "panels", 1000 * K)
    cols = inputs["cols"]
    _trace.enable()
    _matrix(X, np.float32).sandwich(inputs["d"].astype(np.float32), cols=cols)
    counters = _trace.take()["counters"]
    # a narrower matrix fits more rows a panel: 50,000 rows at 6 columns
    assert counters == {"sparse_panels": 1, "sparse_panel_bytes": 4 * len(cols) * N}


def test_matvec_and_tmv_spans(design, inputs):
    X, _ = design
    m = _matrix(X)
    _trace.enable()
    m.matvec(inputs["v"])
    m.transpose_matvec(inputs["r"])
    spans = _trace.take()["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == [("sparse.matvec", None),
                                                       ("sparse.tmv", None)]


@pytest.mark.parametrize("route", ["pair", "dense", "panels"])
def test_nothing_recorded_when_off(design, inputs, monkeypatch, route):
    X, _ = design
    _route(monkeypatch, route)
    m = _matrix(X)
    m.sandwich(inputs["d"])
    m.matvec(inputs["v"])
    m.transpose_matvec(inputs["r"])
    assert _trace.take() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("route", ["pair", "dense", "panels"])
def test_results_bit_for_bit_with_tracing_on(design, inputs, monkeypatch, route):
    X, _ = design
    _route(monkeypatch, route)
    m = _matrix(X)
    d = torch.as_tensor(inputs["d"])
    off = (m.sandwich(d), m.matvec(inputs["v"]), m.transpose_matvec(inputs["r"]))
    _trace.enable()
    on = (m.sandwich(d), m.matvec(inputs["v"]), m.transpose_matvec(inputs["r"]))
    _trace.disable()
    assert torch.equal(on[0], off[0])
    np.testing.assert_array_equal(on[1], off[1])
    np.testing.assert_array_equal(on[2], off[2])
