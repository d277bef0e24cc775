"""The port's ``SparseMatrix`` on a cut-down ``sparse_wide`` design against
the benchmark's plain reference (``glmbench/reference/sparse.py``), and the
spans and counters of ``models/sparse.py``.

The design is the benchmark's generator (``glmbench/data/sparse_wide.py``)
at a few thousand rows by a few hundred columns.  The sandwich takes each
of its four routes: the pair plan (the default at this size), the
densified matrix (the pair plan's budget at 0), the sparse Gram kernel
(both budgets cut; its plain version on the CPU) and row panels (both
budgets cut and layouts with int64 bounds, ``sparse_ops.INT32_MAX`` cut to
0, which the Gram kernel has no instantiation for; the panels' element
budget chosen for a ragged last panel, a last panel of one row, and panels
of one row each).  Tolerances: float64 relerr ≤ 1e-12,
float32 ≤ 1e-5 of the largest entry.
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
from tabmat_torch.ops import sparse_gram_kernel, sparse_ops

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


ROUTES = ["pair", "dense", "gram", "panels"]


def _route(monkeypatch, route: str, panel_budget: int = 700 * K):
    if route != "pair":
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
    if route in ("gram", "panels"):
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_SEGMENTS", 0)
        monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_COLS", K - 1)
        monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_ELEMENTS", panel_budget)
    if route == "panels":  # int64 bounds: the Gram kernel is int32 alone
        monkeypatch.setattr(sparse_ops, "INT32_MAX", 0)


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
@pytest.mark.parametrize("route", ROUTES)
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
@pytest.mark.parametrize("route", ROUTES)
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


@pytest.mark.parametrize("route", ROUTES)
def test_each_route_has_its_span_under_the_sandwich(design, inputs, monkeypatch, route):
    X, _ = design
    _route(monkeypatch, route)
    _, taken = _record(_matrix(X), inputs["d"])
    spans = taken["spans"]
    assert spans[0]["name"] == "sparse.sandwich" and spans[0]["parent"] is None
    # the first sandwich's route decision builds the pair plan where it fits
    built = ["plan.build"] if route == "pair" else []
    assert _children(spans, 0) == built + [f"sparse.sandwich.{route}"]
    for s in spans[1:]:
        p = spans[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert s["root"] == spans[0]["root"]
    if route != "panels":
        assert len(spans) == 2 + len(built) and "sparse_panels" not in taken["counters"]
    assert taken["counters"].get("plans_built", 0) == len(built)
    assert taken["counters"].get("sparse_gram", 0) == (route == "gram")


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


@pytest.mark.parametrize("route", ROUTES)
def test_nothing_recorded_when_off(design, inputs, monkeypatch, route):
    X, _ = design
    _route(monkeypatch, route)
    m = _matrix(X)
    m.sandwich(inputs["d"])
    m.matvec(inputs["v"])
    m.transpose_matvec(inputs["r"])
    assert _trace.take() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("route", ROUTES)
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


# -- the sparse Gram route ------------------------------------------------------


def _past_both_budgets(monkeypatch):
    """The pair plan's and the densified matrix's budgets cut, the layouts'
    int32 bounds left as they are."""
    monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
    monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_SEGMENTS", 0)
    monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_COLS", 0)


def _route_taken(m, d, **kw):
    _trace.enable()
    S = m.sandwich(d, **kw)
    _trace.disable()
    return S, _trace.take()["spans"][1]["name"].rsplit(".", 1)[1]


@pytest.mark.parametrize("density", [0.01, 0.6], ids=["one_percent", "nearly_dense"])
def test_gram_serves_int32_layouts_at_any_density(monkeypatch, density):
    """Past both budgets a layout with int32 bounds takes the Gram kernel,
    whatever its within-row pairs: a 1% matrix and a nearly dense one."""
    _past_both_budgets(monkeypatch)
    X = sparse_wide.make({"rows": 1000, "cols": 200, "density": density}, SEED, 1)[0]["csc"]
    m = _matrix(X)
    d = np.random.default_rng(2).random(1000)
    S, taken = _route_taken(m, d)
    assert taken == "gram" and m._csr_parts()[1].bounds.dtype == torch.int32
    A = X.toarray()
    assert _relerr(S, (A * d[:, None]).T @ A) <= TOL[np.float64]


def test_route_turns_at_int32_bounds(design, inputs, monkeypatch):
    """The Gram kernel serves a layout of exactly ``INT32_MAX`` entries (one
    more takes the panels: ``test_int64_bounds_stay_on_the_panels``)."""
    X, _ = design
    _past_both_budgets(monkeypatch)
    monkeypatch.setattr(sparse_ops, "INT32_MAX", X.nnz)
    m = _matrix(X)
    assert _route_taken(m, inputs["d"])[1] == "gram"
    assert m._csr_parts()[1].bounds.dtype == torch.int32


def test_restricted_columns_decide_on_their_own_bounds(design, inputs, monkeypatch):
    """With ``cols`` the route weighs the restricted matrix's entries: a
    matrix past ``INT32_MAX`` takes the Gram kernel for columns within it."""
    X, ref = design
    _past_both_budgets(monkeypatch)
    cols = inputs["cols"]
    sub_nnz = X[:, cols].nnz
    want = ref.hessian(inputs["d"])[np.ix_(cols, cols)]
    for limit, route in ((sub_nnz, "gram"), (sub_nnz - 1, "panels")):
        monkeypatch.setattr(sparse_ops, "INT32_MAX", limit)
        m = _matrix(X)
        assert _route_taken(m, inputs["d"])[1] == "panels"
        S, taken = _route_taken(m, inputs["d"], cols=cols)
        assert taken == route
        assert _relerr(S, want) <= TOL[np.float64]


def test_int64_bounds_stay_on_the_panels(design, inputs, monkeypatch):
    """A layout past ``INT32_MAX`` entries has int64 bounds, which the Gram
    kernel has no instantiation for: the panels serve it."""
    X, ref = design
    _past_both_budgets(monkeypatch)
    monkeypatch.setattr(sparse_ops, "INT32_MAX", X.nnz - 1)
    m = _matrix(X)
    S, taken = _route_taken(m, inputs["d"])
    assert taken == "panels" and m._csr_parts()[1].bounds.dtype == torch.int64
    assert _relerr(S, ref.hessian(inputs["d"])) <= TOL[np.float64]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_gram_is_exactly_symmetric_and_repeats(design, inputs, monkeypatch, dtype):
    X, _ = design
    _route(monkeypatch, "gram")
    m = _matrix(X, dtype)
    d = torch.as_tensor(inputs["d"].astype(dtype))
    first, second = m.sandwich(d), m.sandwich(d)
    assert first.dtype == as_torch(dtype)
    assert torch.equal(first, first.T) and torch.equal(first, second)
    assert _relerr(first, _ref_for(X, dtype).hessian(inputs["d"].astype(dtype)
                                                      .astype(np.float64))) <= TOL[dtype]


def as_torch(dtype):
    return {np.float64: torch.float64, np.float32: torch.float32}[dtype]


def _stored(n, k, rows, cols, vals):
    """A CSC matrix holding exactly these entries, duplicates kept."""
    rows, cols, vals = (np.asarray(a) for a in (rows, cols, vals))
    order = np.lexsort((rows, cols))
    indptr = np.r_[0, np.cumsum(np.bincount(cols, minlength=k))]
    return sps.csc_matrix((vals[order].astype(np.float64), rows[order], indptr), shape=(n, k))


EDGE_MATRICES = {
    "all_zero": sps.csc_matrix((7, 5)),
    # row 2 and column 3 hold nothing
    "empty_row_and_column": _stored(5, 5, [0, 0, 1, 3, 4, 4], [0, 4, 1, 2, 0, 4],
                                    [1.5, -2.0, 3.0, 0.5, 4.0, 1.0]),
    # (0, 1) twice, (3, 2) three times, (3, 4) twice
    "stored_duplicates": _stored(5, 6, [0, 0, 0, 1, 3, 3, 3, 3, 3, 4],
                                 [1, 1, 5, 1, 2, 2, 2, 4, 4, 0],
                                 [1.0, 2.0, 3.0, -1.0, 0.5, 0.25, 2.0, 1.0, -3.0, 2.0]),
}


@pytest.mark.parametrize("name", sorted(EDGE_MATRICES))
def test_gram_edge_matrices(monkeypatch, name):
    """Duplicates add up, empty rows and columns give zeros, and an all-zero
    matrix a zero S, on the Gram route."""
    X = EDGE_MATRICES[name]
    if name == "stored_duplicates":
        assert not X.has_canonical_format and X.nnz == 10
    _past_both_budgets(monkeypatch)
    m = tt.SparseMatrix(X, device="cpu")
    d = np.arange(1.0, X.shape[0] + 1.0)
    S, taken = _route_taken(m, d)
    assert taken == "gram"
    A = X.toarray()  # sums the duplicates
    want = (A * d[:, None]).T @ A
    np.testing.assert_allclose(S, want, rtol=1e-15, atol=0)
    assert np.array_equal(S, S.T)
    rows, cols = np.array([0, 3, 4]), np.array([4, 1, 2])
    sub = A[np.ix_(rows, cols)]
    got, taken = _route_taken(m, d, rows=rows, cols=cols)
    assert taken == "gram"
    np.testing.assert_allclose(got, (sub * d[rows, None]).T @ sub, rtol=1e-15, atol=0)


@pytest.mark.parametrize("chunk, slice_", [(4, 1 << 24), (64, 1000), (300, 7)])
def test_gram_tables_are_the_rows_lower_bounds(design, monkeypatch, chunk, slice_):
    """Each chunk edge of each CSR row, and for each CSC entry (r, i) the
    first entry of row r at or right of column i: lower bounds in the
    row's sorted columns, as the kernel reads them, whatever the slices
    their temporaries are made in."""
    monkeypatch.setattr(sparse_gram_kernel, "SLICE", slice_)
    X, _ = design
    X = X.copy()
    X.data[::50] = 0.0  # explicit zeros are entries too
    csr = X.tocsr()
    _, csr_plan = sparse_ops.compressed_layout(csr, K, "cpu")
    _, csc_plan = sparse_ops.compressed_layout(X, N, "cpu")
    once = sparse_gram_kernel.gram_tables(csr_plan, csc_plan, chunk, keep=False)
    assert not csc_plan.tables
    tab, first = sparse_gram_kernel.gram_tables(csr_plan, csc_plan, chunk)
    assert sparse_gram_kernel.gram_tables(csr_plan, csc_plan, chunk)[0] is tab  # kept
    assert all(torch.equal(a, b) for a, b in zip(once, (tab, first)))
    n_chunks = -(-K // chunk)
    assert tab.shape == (N, n_chunks + 1) and tab.dtype == first.dtype == torch.int32
    if chunk == sparse_gram_kernel.chunk_columns(K):
        assert sparse_gram_kernel.table_bytes(csr_plan, csc_plan) == 4 * (tab.numel() + X.nnz)
    edges = np.minimum(np.arange(n_chunks + 1) * chunk, K)
    want = np.array([csr.indptr[r] + np.searchsorted(csr.indices[csr.indptr[r]:csr.indptr[r + 1]],
                                                     edges) for r in range(N)])
    np.testing.assert_array_equal(tab.numpy(), want)
    col_of = np.repeat(np.arange(K), np.diff(X.indptr))
    lows = [csr.indptr[r] + np.searchsorted(csr.indices[csr.indptr[r]:csr.indptr[r + 1]], i)
            for r, i in zip(X.indices, col_of)]
    np.testing.assert_array_equal(first.numpy(), lows)
    # the entry (r, i) itself
    np.testing.assert_array_equal(csr.indices[first.numpy()], col_of)


def test_gram_plain_in_blocks_of_rows_is_the_whole(design, inputs, monkeypatch):
    """The plain version's blocks of rows (one row each, a ragged last
    block) give the same S as one block, bit for bit on the CPU."""
    X, ref = design
    data, plan = sparse_ops.compressed_layout(X.tocsr(), K, "cpu")
    d = torch.as_tensor(inputs["d"])
    whole = sparse_gram_kernel.sparse_gram_plain(data, plan.perm, plan.bounds, d, K)
    for max_pairs in (0, 1000):
        monkeypatch.setattr(sparse_gram_kernel, "PLAIN_MAX_PAIRS", max_pairs)
        got = sparse_gram_kernel.sparse_gram_plain(data, plan.perm, plan.bounds, d, K)
        assert torch.equal(got, whole)
    assert _relerr(whole, ref.hessian(inputs["d"])) <= TOL[np.float64]


def test_gram_wrapper_rejects_mismatched_inputs(design):
    X, _ = design
    csr_parts = sparse_ops.compressed_layout(X.tocsr(), K, "cpu")
    csc_parts = sparse_ops.compressed_layout(X, N, "cpu")
    d = torch.ones(N, dtype=torch.float64)
    with pytest.raises(TypeError):
        sparse_gram_kernel.sparse_gram(*csr_parts, *csc_parts, d.float())
    with pytest.raises(TypeError):
        sparse_gram_kernel.sparse_gram(csr_parts[0].int(), csr_parts[1], *csc_parts, d)
    with pytest.raises(ValueError):
        sparse_gram_kernel.sparse_gram(*csr_parts, *csc_parts, d[1:])
    with pytest.raises(ValueError):  # a CSR layout with the CSC one's shape swapped
        sparse_gram_kernel.sparse_gram(*csc_parts, *csr_parts, d)


def test_gram_route_after_pickling(design, inputs, monkeypatch):
    """A matrix pickled after a sandwich comes back with no device state and
    takes the Gram kernel again, bit for bit."""
    import pickle

    X, _ = design
    _past_both_budgets(monkeypatch)
    m = _matrix(X)
    S = m.sandwich(inputs["d"])
    back = pickle.loads(pickle.dumps(m))
    assert back._csr is None and back._gram is None
    again, taken = _route_taken(back, inputs["d"])
    assert taken == "gram"
    np.testing.assert_array_equal(again, S)
