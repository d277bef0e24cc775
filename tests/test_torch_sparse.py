"""The port's SparseMatrix, and the CategoricalMatrix pieces that give or
take one, against ``tabmat_tpu`` on the CPU.

Inputs are made from a seed with numpy and scipy and go through both
packages (the JAX package on its CPU routes: its XLA cumsum reductions and
host scipy; the OpenMP walk for numpy callers where its native library is
built).  Tolerances: ``atol=1e-12`` as in ``tests/test_matrices.py``; a
float32 matrix at 5e-4, as ``tests/test_torch_dense.py`` holds f32 (the two
packages sum f32 terms in another order).
"""

import pickle

import numpy as np
import pytest
import torch
from scipy import sparse as sps


import tabmat_tpu as tm

import tabmat_torch as tt
from tabmat_torch.convert import from_tabmat_tpu
from tabmat_torch.models import sparse as port_sparse

N, K = 2000, 12
ATOL = 1e-12
F32_TOL = 5e-4


def _scipy(n=N, k=K, density=0.1, seed=0, dtype=np.float64):
    """A CSC matrix with an empty row, an empty column, a stored zero,
    int64 indices and unsorted row indices."""
    rng = np.random.default_rng(seed)
    X = sps.random(n, k, density=density, format="csc", random_state=rng, dtype=dtype)
    X = sps.csc_matrix(X.multiply(np.where(np.arange(n) == 3, 0.0, 1.0)[:, None]))
    X = sps.csc_matrix(X.multiply(np.where(np.arange(k) == 5, 0.0, 1.0)[None, :]))
    X.data[0] = 0.0  # an explicitly stored zero
    X.indices = X.indices.astype(np.int64)
    X.indptr = X.indptr.astype(np.int64)
    j = np.argmax(np.diff(X.indptr))  # reverse one column's rows: unsorted
    lo, hi = X.indptr[j], X.indptr[j + 1]
    X.indices[lo:hi] = X.indices[lo:hi][::-1].copy()
    X.data[lo:hi] = X.data[lo:hi][::-1].copy()
    X.has_sorted_indices = False
    return X.astype(dtype)


def _pair(**kw):
    X = _scipy(**kw)
    names = [f"s{i}" for i in range(X.shape[1])]
    ref = tm.SparseMatrix(X.copy(), column_names=names)
    return ref, tt.SparseMatrix(X.copy(), column_names=names, device="cpu")


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def test_layout_and_conversion():
    ref, port = _pair()
    assert port.shape == ref.shape and port.dtype == ref.dtype
    assert port.array_csc.has_sorted_indices
    assert port.indices.dtype == ref.indices.dtype == port.indptr.dtype
    np.testing.assert_array_equal(port.toarray(), ref.toarray())
    np.testing.assert_array_equal(port.array_csr.toarray(), ref.array_csr.toarray())
    carried = from_tabmat_tpu(ref, device="cpu")
    assert isinstance(carried, tt.SparseMatrix)
    assert carried.column_names == ref.column_names
    np.testing.assert_array_equal(carried.toarray(), ref.toarray())
    # the device layouts are int32
    data, plan = port._csc_parts()
    assert plan.perm.dtype == plan.bounds.dtype == torch.int32
    assert data.dtype == torch.float64 and plan.n_rows == N


@pytest.mark.parametrize("flavor", ["numpy", "tensor"])
def test_ops(flavor):
    ref, port = _pair()
    rng = np.random.default_rng(1)
    v, r, d = rng.standard_normal(K), rng.standard_normal(N), rng.random(N)
    rows = np.sort(rng.choice(N, N // 2, replace=False))
    cols = np.array([K - 1, 0, 5, 3])

    def arg(x):
        return torch.tensor(x) if flavor == "tensor" else x

    for kw in ({}, {"cols": cols}):
        got = port.matvec(arg(v), **kw)
        assert torch.is_tensor(got) == (flavor == "tensor")
        _close(got, ref.matvec(v, **kw))
    for kw in ({}, {"rows": rows}, {"cols": cols}, {"rows": rows, "cols": cols}):
        _close(port.transpose_matvec(arg(r), **kw), ref.transpose_matvec(r, **kw))
        got = port.sandwich(arg(d), **kw)
        assert torch.is_tensor(got) == (flavor == "tensor")
        _close(got, ref.sandwich(d, **kw))
    # 2-d operands
    V, R = rng.standard_normal((K, 3)), rng.standard_normal((N, 4))
    _close(port.matvec(arg(V)), ref.matvec(V))
    _close(port.transpose_matvec(arg(R)), ref.transpose_matvec(R))
    _close(port @ arg(v), ref.toarray() @ v)


def test_out_accumulation():
    ref, port = _pair()
    rng = np.random.default_rng(2)
    v, r = rng.standard_normal(K), rng.standard_normal(N)
    cols = np.array([K - 1, 2, 8])
    want, got = np.ones(N), np.ones(N)
    ref.matvec(v, cols=cols, out=want)
    assert port.matvec(v, cols=cols, out=got) is got
    _close(got, want)
    want, got = np.ones(K), np.ones(K)
    ref.transpose_matvec(r, cols=cols, out=want)
    assert port.transpose_matvec(r, cols=cols, out=got) is got
    _close(got, want)
    # a tensor out is updated in place, with rows and cols
    rows = np.arange(0, N, 3)
    want = np.ones(K)
    ref.transpose_matvec(r, rows=rows, cols=cols, out=want)
    got_t = torch.ones(K, dtype=torch.float64)
    assert port.transpose_matvec(torch.tensor(r), rows=rows, cols=cols, out=got_t) is got_t
    _close(got_t, want)
    got_t = torch.ones(N, dtype=torch.float64)
    port.matvec(torch.tensor(v), out=got_t)
    _close(got_t, 1 + ref.toarray() @ v)


def test_float32_matrix():
    X = _scipy(dtype=np.float32)
    ref, port = tm.SparseMatrix(X.copy()), tt.SparseMatrix(X.copy(), device="cpu")
    rng = np.random.default_rng(3)
    v = rng.standard_normal(K).astype(np.float32)
    r = rng.standard_normal(N).astype(np.float32)
    d = rng.random(N).astype(np.float32)
    for got, want in ((port.matvec(v), ref.matvec(v)),
                      (port.transpose_matvec(r), ref.transpose_matvec(r)),
                      (port.sandwich(d), ref.sandwich(d))):
        assert _np(got).dtype == np.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


def test_sandwich_routes(monkeypatch):
    """The pair plan first; past its budget the densified matrix; past both
    row panels of the CSR layout, densified on the device and added in
    order (the reference takes host scipy there)."""
    ref, port = _pair()
    rng = np.random.default_rng(4)
    d = rng.random(N) - 0.3
    cols = np.array([4, 0, 11])
    want, want_cols = ref.sandwich(d), ref.sandwich(d, cols=cols)
    pair = port.sandwich(d)
    assert port._pair is not None and port._dense is None
    _close(pair, want)
    np.testing.assert_array_equal(pair, pair.T)  # the pair plan mirrors its upper triangle
    _close(port.sandwich(d, cols=cols), want_cols)

    monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
    mirror = tt.SparseMatrix(port.array_csc, device="cpu")
    _close(mirror.sandwich(d), want)
    _close(mirror.sandwich(d, rows=np.arange(0, N, 2), cols=cols),
           ref.sandwich(d, rows=np.arange(0, N, 2), cols=cols))
    assert mirror._pair == () and mirror._dense is not None

    # past both: panels of one row (a budget of 0), then of 300 rows
    for budget in (0, 300 * K):
        monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_ELEMENTS", budget)
        neither = tt.SparseMatrix(port.array_csc, device="cpu")
        _close(neither.sandwich(d), want)
        rows = np.arange(0, N, 2)
        for kw in ({"rows": rows}, {"cols": cols}, {"rows": rows, "cols": cols},
                   {"cols": np.array([3, 3, 0])}):
            _close(neither.sandwich(d, **kw), ref.sandwich(d, **kw))
        got = neither.sandwich(torch.tensor(d))
        assert torch.is_tensor(got) and got.dtype == torch.float64
        _close(got, want)
        assert neither._pair == () and neither._dense is None
        # matvec and transpose_matvec still run past the sandwich budgets
        _close(neither.transpose_matvec(d), ref.transpose_matvec(d))


@pytest.mark.parametrize("shape", [(30_000, 3, 0.01), (4_000, 100, 0.01), (500, 300, 0.05)],
                         ids=["narrow", "square", "wide"])
def test_reference_shapes_cut_down(shape):
    """``sparse_narrow``, the 400k x 100 design and ``sparse_wide``
    (``tabmat_tpu/bench/generate.py:71-73``) at fewer rows."""
    n, k, density = shape
    X = sps.random(n, k, density=density, format="csc", random_state=np.random.default_rng(k))
    ref, port = tm.SparseMatrix(X), tt.SparseMatrix(X, device="cpu")
    rng = np.random.default_rng(5)
    v, r, d = rng.standard_normal(k), rng.standard_normal(n), rng.random(n)
    rows, cols = np.arange(0, n, 2), np.arange(0, k, 2)
    _close(port.matvec(v), ref.matvec(v))
    _close(port.matvec(v, cols=cols), ref.matvec(v, cols=cols))
    _close(port.transpose_matvec(r, rows=rows, cols=cols), ref.transpose_matvec(r, rows=rows, cols=cols))
    # the sandwich against the exact product: the reference differences a
    # cumsum over all pairs (``models/sparse.py:51-64``), about 1e5 of them
    # in "wide", and its result is off by the prefix's ulp (3.5e-12 here)
    A = X.toarray()
    exact = (A * d[:, None]).T @ A
    _close(port.sandwich(d), exact)
    _close(ref.sandwich(d), exact, atol=1e-10)


def test_sandwich_dense_and_cross():
    ref, port = _pair()
    rng = np.random.default_rng(6)
    B = rng.standard_normal((N, 4))
    d = rng.random(N)
    rows, L, R = np.arange(1, N, 3), np.array([0, 7, 2]), np.array([3, 1])
    _close(port.sandwich_dense(tt.DenseMatrix(B, device="cpu"), d, rows, L, R),
           ref.sandwich_dense(tm.DenseMatrix(B), d, rows, L, R))
    _close(port._cross_sandwich(tt.DenseMatrix(B, device="cpu"), torch.tensor(d), None, None, None),
           ref._cross_sandwich(tm.DenseMatrix(B), d))
    with pytest.raises(TypeError, match="same dtype"):
        port.sandwich_dense(tt.DenseMatrix(B.astype(np.float32), device="cpu"), d, None, None, None)


def test_indexing_conversions_pickle_names():
    ref, port = _pair()
    rng = np.random.default_rng(7)
    rows, cols = np.arange(0, N, 5), np.array([1, 4, 9])
    for key in ((rows, slice(None)), (slice(None), cols), (rows, cols), (slice(10, 90), [2])):
        got, want = port[key], ref[key]
        assert isinstance(got, tt.SparseMatrix)
        np.testing.assert_array_equal(got.toarray(), want.toarray())
        assert got.column_names == want.column_names
    for i in (0, 5, -1):
        np.testing.assert_array_equal(port.getcol(i).toarray(), ref.getcol(i).toarray())
        assert port.getcol(i).column_names == ref.getcol(i).column_names
    np.testing.assert_array_equal(port.T.toarray(), ref.T.toarray())
    np.testing.assert_array_equal(port.astype(np.float32).toarray(), ref.astype(np.float32).toarray())
    w = rng.standard_normal(N)
    np.testing.assert_array_equal(port.multiply(w).toarray(), ref.multiply(w).toarray())
    d = rng.random(N)
    before = port.sandwich(d)
    back = pickle.loads(pickle.dumps(port))
    assert back.device == port.device and back._pair is None
    np.testing.assert_array_equal(back.sandwich(d), before)
    assert port.get_names(missing_prefix="_") == ref.get_names(missing_prefix="_")
    for obj in (port, ref):
        obj.set_names([f"t{i}" for i in range(K)], "term")
    assert port.term_names == ref.term_names


def test_standardize():
    ref, port = _pair()
    w = np.random.default_rng(8).random(N)
    w /= w.sum()
    std_ref, means_ref, stds_ref = ref.standardize(w, True, True)
    std_port, means_port, stds_port = port.standardize(w, True, True)
    _close(means_port, means_ref)
    _close(stds_port, stds_ref)
    d = np.random.default_rng(9).random(N)
    v = np.random.default_rng(10).standard_normal(K)
    _close(std_port.sandwich(d), std_ref.sandwich(d), atol=1e-10)
    _close(std_port.matvec(v), std_ref.matvec(v))
    _close(std_port.transpose_matvec(d), std_ref.transpose_matvec(d))


def test_degenerate_structures():
    """No nonzero at all; int64 indptr from scipy; integer data."""
    empty = tt.SparseMatrix(sps.csc_matrix((50, 4)), device="cpu")
    assert not empty.matvec(np.ones(4)).any()
    assert not empty.transpose_matvec(np.ones(50)).any()
    assert not empty.sandwich(np.ones(50)).any()
    X = sps.random(40, 6, density=0.3, format="csc", random_state=np.random.default_rng(1))
    X64 = sps.csc_matrix((X.data, X.indices.astype(np.int64), X.indptr.astype(np.int64)),
                         shape=X.shape)
    port = tt.SparseMatrix(X64, device="cpu")
    _close(port.matvec(np.arange(6.0)), X @ np.arange(6.0))
    ints = tt.SparseMatrix(sps.csc_matrix(np.eye(4, dtype=np.int64)), device="cpu")
    ref_ints = tm.SparseMatrix(sps.csc_matrix(np.eye(4, dtype=np.int64)))
    _close(ints.matvec(np.arange(4.0)), ref_ints.matvec(np.arange(4.0)))


def test_index_width_is_checked(monkeypatch):
    from tabmat_torch.ops import sparse_ops

    monkeypatch.setattr(sparse_ops, "INT32_MAX", 10)
    X = sps.random(30, 3, density=0.5, format="csc", random_state=np.random.default_rng(2))
    with pytest.raises(OverflowError, match="int32"):
        tt.SparseMatrix(X, device="cpu").matvec(np.ones(3))


def test_as_tabmat_and_hstack():
    X = _scipy()
    port = tt.as_tabmat(X, device="cpu")
    assert isinstance(port, tt.SparseMatrix) and port.device.type == "cpu"
    both = tt.hstack([X, tt.SparseMatrix(X, device="cpu")])
    assert isinstance(both, tt.SparseMatrix)
    np.testing.assert_array_equal(both.toarray(), tm.hstack([X, tm.SparseMatrix(X)]).toarray())


# -- the CategoricalMatrix pieces -----------------------------------------------


def _cat_pair(levels=7, seed=0, drop_first=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, levels, N)
    codes[rng.random(N) < 0.05] = -1
    kw = dict(categories=np.arange(levels), drop_first=drop_first, cat_missing_method="zero",
              column_name="c")
    return tm.CategoricalMatrix(codes, **kw), tt.CategoricalMatrix(codes, device="cpu", **kw)


def test_categorical_gives_sparse_matrices():
    ref, port = _cat_pair()
    for i in (0, 3, -1):
        got, want = port.getcol(i), ref.getcol(i)
        assert isinstance(got, tt.SparseMatrix)
        np.testing.assert_array_equal(got.toarray(), want.toarray())
        assert got.column_names == want.column_names
    w = np.random.default_rng(11).standard_normal(N)
    got = port.multiply(w)
    assert isinstance(got, tt.SparseMatrix)
    np.testing.assert_array_equal(got.toarray(), ref.multiply(w).toarray())
    got = port.to_sparse_matrix()
    assert isinstance(got, tt.SparseMatrix) and got.column_names == ref.column_names
    np.testing.assert_array_equal(got.toarray(), ref.to_sparse_matrix().toarray())
    for key in ((slice(None), [0, 2]), (np.arange(0, N, 4), [1, 5]), (slice(None, 50), slice(1, 4))):
        got, want = port[key], ref[key]
        assert isinstance(got, tt.SparseMatrix)
        np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.parametrize("compress", [False, True], ids=["cells", "observed_cells"])
@pytest.mark.parametrize("flavor", ["numpy", "tensor"])
def test_cross_sparse(monkeypatch, flavor, compress):
    """cat.T diag(d) sparse through the (code, column) plan, against the
    reference's host scipy product."""
    if compress:
        monkeypatch.setattr(tt.CategoricalMatrix, "_CROSS_DENSE_PLAN_MAX", 10)
    ref_c, port_c = _cat_pair(levels=11, seed=3)
    ref_s, port_s = _pair(seed=4)
    d = np.random.default_rng(12).random(N)
    darg = torch.tensor(d) if flavor == "tensor" else d
    rows, L, R = np.arange(0, N, 3), np.array([2, 0, 9]), np.array([11, 1, 4])
    for args in ((None, None, None), (rows, L, R), (None, None, R)):
        got = port_c._cross_sandwich(port_s, darg, *args)
        assert torch.is_tensor(got) == (flavor == "tensor")
        _close(got, ref_c._cross_sandwich(ref_s, d, *args))
        # and the other way round, through the sparse matrix
        _close(port_s._cross_sandwich(port_c, darg, args[0], args[2], args[1]),
               ref_s._cross_sandwich(ref_c, d, args[0], args[2], args[1]))
    a, plan, uniq = port_c._sparse_plan(port_s)
    assert (uniq is not None) == compress
    assert port_c._sparse_plan(port_s)[1] is plan  # built once per pair
