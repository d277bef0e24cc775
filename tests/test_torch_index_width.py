"""64-bit element offsets: the port's sparse layouts past ``INT32_MAX``
elements against ``tabmat_tpu`` on the CPU (ROADMAP C2).

Every CSR/CSC layout, pair plan and (code, column) plan keeps int32 indices
and takes int64 bounds exactly when it holds more than
``sparse_ops.INT32_MAX`` elements.  Each test lowers that constant, so that
these small layouts take the int64 bounds that a matrix past 2³¹ − 1
nonzeros takes, and holds the port against the JAX package on the same
scipy matrix with int64 indices.  Tolerances: ``atol=1e-12`` in f64, as in
``tests/test_matrices.py``; an f32 matrix at 5e-4, as
``tests/test_torch_sparse.py`` holds it; an IRLS step at rtol 1e-10 (f64
inner solve) and 1e-4 (f32), as ``tests/test_torch_sparse_design.py``.
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sps

import jax.numpy as jnp

import tabmat_tpu as tm
from tabmat_tpu import glm as tpu_glm
from tabmat_tpu.parallel.design import DeviceDesign as TpuDesign

import tabmat_torch as tt
from tabmat_torch import glm
from tabmat_torch.convert import from_tabmat_tpu
from tabmat_torch.models import sparse as port_sparse
from tabmat_torch.ops import segments, sparse_ops
from tabmat_torch.ops import spmv_kernel as spk
from tabmat_torch.parallel.design import DeviceDesign

N, K = 1500, 12
ATOL = 1e-12
F32_TOL = 5e-4
STEP_RTOL = {"float64": 1e-10, "float32": 1e-4}
# every layout of these tests has more elements than this
SMALL_MAX = 10


@pytest.fixture(autouse=True)
def wide_bounds(monkeypatch):
    monkeypatch.setattr(sparse_ops, "INT32_MAX", SMALL_MAX)


def _scipy(n=N, k=K, density=0.15, seed=0, dtype=np.float64, empty_column=True):
    """A CSC matrix with int64 indices and indptr, a stored zero and (by
    default) an empty column."""
    rng = np.random.default_rng(seed)
    X = sps.random(n, k, density=density, format="csc", random_state=rng, dtype=dtype)
    if empty_column:
        X = sps.csc_matrix(X.multiply(np.where(np.arange(k) == 4, 0.0, 1.0)[None, :]))
    X.data[0] = 0.0
    X = X.astype(dtype)
    X.indices = X.indices.astype(np.int64)
    X.indptr = X.indptr.astype(np.int64)
    return X


def _pair(X=None, **kw):
    X = _scipy(**kw) if X is None else X
    return tm.SparseMatrix(X.copy()), tt.SparseMatrix(X.copy(), device="cpu")


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _wide(plan):
    """The layout keeps int32 indices and int64 bounds."""
    assert plan.perm.dtype == torch.int32 and plan.bounds.dtype == torch.int64


def test_layouts_take_int64_bounds_past_the_limit(monkeypatch):
    X = _scipy()
    port = tt.SparseMatrix(X, device="cpu")
    for _, plan in (port._csr_parts(), port._csc_parts(), port._pair_parts()):
        _wide(plan)
    # exactly at the limit the bounds stay int32; one element past it, int64
    for limit, dtype in ((X.nnz, torch.int32), (X.nnz - 1, torch.int64)):
        monkeypatch.setattr(sparse_ops, "INT32_MAX", limit)
        _, plan = sparse_ops.compressed_layout(X, N, "cpu")
        assert plan.bounds.dtype == dtype and plan.perm.dtype == torch.int32
        np.testing.assert_array_equal(plan.bounds.numpy(), X.indptr)
        np.testing.assert_array_equal(plan.perm.numpy(), X.indices)


@pytest.mark.parametrize("route", ["pair_plan", "mirror", "row_panels"])
def test_ops_match_the_reference(monkeypatch, route):
    """matvec (1-D and 2-D), transpose_matvec and sandwich with and without
    ``rows=`` / ``cols=``, the sandwich through each of its three routes."""
    if route != "pair_plan":
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
    if route == "row_panels":
        monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_ELEMENTS", 100 * K)
    ref, port = _pair()
    rng = np.random.default_rng(1)
    v, r, d = rng.standard_normal(K), rng.standard_normal(N), rng.random(N) - 0.2
    V, R = rng.standard_normal((K, 3)), rng.standard_normal((N, 5))
    rows = np.sort(rng.choice(N, N // 2, replace=False))
    cols = np.array([K - 1, 0, 4, 7])
    for kw in ({}, {"cols": cols}):
        _close(port.matvec(v, **kw), ref.matvec(v, **kw))
    _close(port.matvec(V), ref.matvec(V))
    _close(port.transpose_matvec(R), ref.transpose_matvec(R))
    for kw in ({}, {"rows": rows}, {"cols": cols}, {"rows": rows, "cols": cols}):
        _close(port.transpose_matvec(r, **kw), ref.transpose_matvec(r, **kw))
        _close(port.sandwich(d, **kw), ref.sandwich(d, **kw))
    taken = {"pair_plan": port._pair not in (None, ()), "mirror": port._dense is not None}
    # past both budgets int64 bounds keep the sandwich on the row panels:
    # the Gram kernel is instantiated for int32 alone
    taken["row_panels"] = not any(taken.values()) and not port._gram_serves(port.array_csr)
    assert taken[route]
    _wide(port._csr_parts()[1])
    _wide(port._csc_parts()[1])
    if route == "pair_plan":
        _wide(port._pair_parts()[1])


def test_standardized_matches_the_reference():
    ref, port = _pair(seed=2)
    w = np.full(N, 1 / N)
    std_ref, means_ref, stds_ref = ref.standardize(w, True, True)
    std_port, means_port, stds_port = port.standardize(w, True, True)
    _close(means_port, means_ref)
    _close(stds_port, stds_ref)
    rng = np.random.default_rng(3)
    v, d = rng.standard_normal(K), rng.random(N)
    _close(std_port.matvec(v), std_ref.matvec(v))
    _close(std_port.transpose_matvec(d), std_ref.transpose_matvec(d))
    _close(std_port.sandwich(d), std_ref.sandwich(d), atol=1e-10)
    _wide(port._csc_parts()[1])


def test_float32_matches_the_reference():
    ref, port = _pair(dtype=np.float32, seed=4)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(K).astype(np.float32)
    r = rng.standard_normal(N).astype(np.float32)
    d = rng.random(N).astype(np.float32)
    for got, want in ((port.matvec(v), ref.matvec(v)),
                      (port.transpose_matvec(r), ref.transpose_matvec(r)),
                      (port.sandwich(d), ref.sandwich(d))):
        assert _np(got).dtype == np.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)
    _wide(port._csr_parts()[1])


def test_spmv_plain_is_bit_for_bit_the_int32_bounds():
    X = _scipy(seed=6).tocsr()
    rng = np.random.default_rng(7)
    a = torch.as_tensor(X.data)
    idx = torch.as_tensor(X.indices.astype(np.int32))
    bounds = torch.as_tensor(X.indptr.astype(np.int32))
    scale = torch.as_tensor(rng.random(K) + 0.5)
    for values in (torch.as_tensor(rng.standard_normal(K)),
                   torch.as_tensor(rng.standard_normal((K, 6)))):
        for s in (None, scale):
            narrow = spk.spmv_plain(values, idx, bounds, a, s)
            wide = spk.spmv_plain(values, idx, bounds.long(), a, s)
            assert torch.equal(narrow, wide)


def test_spmv_takes_only_int32_or_int64_bounds():
    X = _scipy(seed=8)
    _, plan = sparse_ops.compressed_layout(X, N, "cpu")
    plan.bounds = plan.bounds.to(torch.int16)
    with pytest.raises(TypeError, match="int32 or int64"):
        spk.spmv(torch.ones(N, dtype=torch.float64), plan, torch.ones(X.nnz, dtype=torch.float64))


def test_from_tabmat_tpu_carries_an_int64_matrix():
    X = _scipy(seed=9)
    ref = tm.SparseMatrix(X, column_names=[f"s{i}" for i in range(K)])
    assert ref.indices.dtype == np.int64
    carried = from_tabmat_tpu(ref, device="cpu")
    assert carried.column_names == ref.column_names
    np.testing.assert_array_equal(carried.toarray(), ref.toarray())
    rng = np.random.default_rng(10)
    v, d = rng.standard_normal(K), rng.random(N)
    _close(carried.matvec(v), ref.matvec(v))
    _close(carried.sandwich(d), ref.sandwich(d))
    _wide(carried._csr_parts()[1])


def _split(seed=11, n=N):
    """A tabmat_tpu SplitMatrix of 3 dense columns, the sparse matrix, and
    categoricals of 5 levels (``drop_first``, missing codes) and 9."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, n)
    codes[rng.random(n) < 0.05] = -1
    return tm.SplitMatrix([
        tm.DenseMatrix(rng.standard_normal((n, 3))),
        tm.SparseMatrix(_scipy(n=n, k=8, seed=seed, empty_column=False)),
        tm.CategoricalMatrix(codes, categories=np.arange(5), drop_first=True,
                             cat_missing_method="zero", column_name="a"),
        tm.CategoricalMatrix(rng.integers(0, 9, n), categories=np.arange(9), column_name="b"),
    ])


def _targets(X, seed):
    rng = np.random.default_rng(seed)
    eta = X @ (rng.standard_normal(X.shape[1]) * 0.2)
    return rng.poisson(np.exp(eta)).astype(np.float64)


@pytest.mark.parametrize("inner", ["float64", "float32"])
def test_design_step_matches_the_reference(inner):
    """A dense + sparse + categorical design whose CSR, CSC, pair and
    (code, column) plans all take int64 bounds: one IRLS step in both
    packages."""
    ref_X = _split()
    port = DeviceDesign.from_matrix(from_tabmat_tpu(ref_X, device="cpu"))
    sparse = port._block("sparse")
    for _, plan in (sparse.csr, sparse.csc, sparse.pair, sparse.cat):
        _wide(plan)
    assert sparse.cat[1].num_segments == (4 + 9) * 8
    assert port.supports_sandwich
    rng = np.random.default_rng(12)
    y = _targets(ref_X.toarray(), 13)
    w = rng.random(N) + 0.5
    beta0 = rng.standard_normal(ref_X.shape[1]) * 0.01
    n_cg = ref_X.shape[1] * (2 if inner == "float64" else 1)
    got = glm.irls_step(port, torch.tensor(y), torch.tensor(w), torch.tensor(beta0),
                        family="poisson", n_cg=n_cg, inner_precision=inner)
    want = tpu_glm.irls_step(TpuDesign.from_matrix(ref_X), jnp.asarray(y), jnp.asarray(w),
                             jnp.asarray(beta0), family="poisson", n_cg=n_cg,
                             inner_precision=inner)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < STEP_RTOL[inner]


@pytest.mark.parametrize("inner", ["float64", "float32"])
def test_fit_glm_matches_the_reference(inner):
    ref_X = _split(seed=14)
    port_X = from_tabmat_tpu(ref_X, device="cpu")
    y = _targets(ref_X.toarray(), 15)
    n_cg = ref_X.shape[1] * (2 if inner == "float64" else 1)
    kw = dict(family="poisson", max_iter=4, tol=0.0, n_cg=n_cg, inner_precision=inner)
    got, n_got = tt.fit_glm(port_X, y, **kw)
    want, n_want = tpu_glm.fit_glm(ref_X, y, **kw)
    assert n_got == n_want == 4
    want = np.asarray(want)
    assert np.abs(_np(got) - want).max() / np.abs(want).max() < STEP_RTOL[inner]
    _wide(port_X.matrices[1]._csr_parts()[1])


def test_segment_counts_still_raise(monkeypatch):
    """What stays int32 is a plan's number of segments: past the limit the
    (code, column) and pair plans raise, and name segments."""
    monkeypatch.setattr(sparse_ops, "SEGMENTS_MAX", SMALL_MAX)
    X = _scipy(n=40, k=4, density=0.5, seed=16)
    codes = np.random.default_rng(17).integers(0, 3, 40)
    with pytest.raises(OverflowError, match="cells exceed the kernels' int32 segment"):
        sparse_ops.code_column_plan(codes, 3, 40, X, "cpu")  # 12 cells
    with pytest.raises(OverflowError, match="pair segments exceed"):
        sparse_ops.pair_plan(X.tocsr(), "cpu")  # 16 key segments
    _, plan, _ = sparse_ops.code_column_plan(codes, 3, 40, X, "cpu", compress=True)
    _wide(plan)


def test_categorical_stack_takes_int32_plans_only():
    plan = segments.build_plan(np.array([0, 1, 1, 0]), 2, "cpu")
    assert plan.bounds.dtype == torch.int32
    assert segments.stack([plan, plan]).bounds.dtype == torch.int32
    plan.bounds = plan.bounds.long()
    with pytest.raises(AssertionError, match="int32"):
        segments.stack([plan])
