"""The port's CategoricalMatrix against ``tabmat_tpu.CategoricalMatrix`` on
the CPU.

Inputs are made from a seed with numpy and go through both packages (the
JAX package on its CPU routes: SegmentPlan and take).  Tolerance:
``atol=1e-12``, as in ``tests/test_matrices.py``.
"""

import pickle

import numpy as np
import pytest
import torch

import tabmat_tpu as tm
from tabmat_tpu.ops import segments as tpu_segments

import tabmat_torch as tt
from tabmat_torch import _native
from tabmat_torch.convert import from_tabmat_tpu

N = 2000
ATOL = 1e-12


def _codes(levels, seed, missing=0.05):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, levels, N)
    codes[rng.random(N) < missing] = -1
    return codes


CONFIGS = {
    "plain": dict(levels=7, drop_first=False, method="zero", missing=0.0),
    "drop_first": dict(levels=7, drop_first=True, method="zero", missing=0.0),
    "zero": dict(levels=11, drop_first=False, method="zero", missing=0.05),
    "zero_drop_first": dict(levels=11, drop_first=True, method="zero", missing=0.05),
    "convert": dict(levels=11, drop_first=True, method="convert", missing=0.05),
}


def _pair(name, seed=0, **extra):
    cfg = CONFIGS[name]
    codes = _codes(cfg["levels"], seed, cfg["missing"])
    kw = dict(categories=np.array([f"c{i}" for i in range(cfg["levels"])]),
              drop_first=cfg["drop_first"], cat_missing_method=cfg["method"],
              column_name="x", **extra)
    return tm.CategoricalMatrix(codes, **kw), tt.CategoricalMatrix(codes, device="cpu", **kw)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_and_dense_form(name):
    ref, port = _pair(name)
    assert port.shape == ref.shape
    assert port.device == torch.device("cpu")
    np.testing.assert_array_equal(port.indices, ref.indices)
    np.testing.assert_array_equal(port.categories, ref.categories)
    np.testing.assert_array_equal(port.toarray(), ref.toarray())
    assert (port.tocsr() != ref.tocsr()).nnz == 0
    assert port.get_names() == ref.get_names()
    assert port.get_names("term") == ref.get_names("term")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("flavor", ["numpy", "tensor"])
def test_matvec(name, flavor):
    ref, port = _pair(name)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(port.shape[1])
    cols = np.array([0, port.shape[1] - 1])
    arg = torch.tensor(v) if flavor == "tensor" else v
    got = port.matvec(arg)
    assert torch.is_tensor(got) == (flavor == "tensor")
    _close(got, ref.matvec(v))
    _close(port.matvec(arg, cols=cols), ref.matvec(v, cols=cols))
    out_ref, out_np = np.ones(N), np.ones(N)
    ref.matvec(v, out=out_ref)
    assert port.matvec(v, out=out_np) is out_np
    _close(out_np, out_ref)
    out_t = torch.ones(N, dtype=torch.float64)
    assert port.matvec(torch.tensor(v), out=out_t) is out_t
    _close(out_t, out_ref)
    vi = np.arange(port.shape[1])
    np.testing.assert_array_equal(_np(port.matvec(vi)), np.asarray(ref.matvec(vi)))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("flavor", ["numpy", "tensor"])
def test_transpose_matvec(name, flavor):
    ref, port = _pair(name)
    rng = np.random.default_rng(2)
    v = rng.standard_normal(N)
    rows = np.sort(rng.choice(N, N // 3, replace=False))
    cols = np.array([port.shape[1] - 1, 0, 2])
    arg = torch.tensor(v) if flavor == "tensor" else v
    _close(port.transpose_matvec(arg), ref.transpose_matvec(v))
    _close(port.transpose_matvec(arg, rows=rows, cols=cols),
           ref.transpose_matvec(v, rows=rows, cols=cols))
    out_ref, out_np = np.ones(port.shape[1]), np.ones(port.shape[1])
    ref.transpose_matvec(v, rows=rows, cols=cols, out=out_ref)
    port.transpose_matvec(v, rows=rows, cols=cols, out=out_np)
    _close(out_np, out_ref)
    out_t = torch.ones(port.shape[1], dtype=torch.float64)
    port.transpose_matvec(torch.tensor(v), rows=rows, cols=cols, out=out_t)
    _close(out_t, out_ref)


@pytest.mark.parametrize("name", CONFIGS)
def test_sandwich_is_diagonal(name):
    ref, port = _pair(name)
    rng = np.random.default_rng(3)
    d = rng.random(N)
    rows = np.sort(rng.choice(N, N // 2, replace=False))
    cols = np.array([1, 0, port.shape[1] - 1])
    for kw in ({}, {"rows": rows}, {"cols": cols}, {"rows": rows, "cols": cols}):
        got, want = port.sandwich(d, **kw), ref.sandwich(d, **kw)
        assert isinstance(got, tt.DiagonalResult)
        _close(got.diag, want.diag)
        _close(got.toarray(), want.toarray())
    got = port.sandwich(torch.tensor(d))
    assert torch.is_tensor(got.diag)
    _close(got.diag, ref.sandwich(d).diag)


@pytest.mark.parametrize("name", ["plain", "zero_drop_first", "convert"])
def test_cross_dense(name):
    ref, port = _pair(name)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((N, 3))
    d = rng.random(N)
    rows = np.sort(rng.choice(N, N // 2, replace=False))
    L, R = np.array([0, 2, 4]), np.array([2, 0])
    for args in ((None, None, None), (rows, L, R), (None, None, R)):
        want = ref._cross_sandwich(tm.DenseMatrix(X), d, *args)
        _close(port._cross_sandwich(tt.DenseMatrix(X, device="cpu"), d, *args), want)
        # the dense side's view is the transpose
        flip = tt.DenseMatrix(X, device="cpu")._cross_sandwich(port, d, args[0], args[2], args[1])
        _close(flip, np.asarray(want).T)


@pytest.mark.parametrize("compressed", [False, True], ids=["full_plan", "compressed_plan"])
def test_cross_categorical(compressed, monkeypatch):
    ref_a, port_a = _pair("zero_drop_first", seed=5)
    ref_b, port_b = _pair("zero", seed=6)
    if compressed:
        # a product of widths past the bound takes the observed-pairs plan
        for cls in (tm.CategoricalMatrix, tt.CategoricalMatrix):
            monkeypatch.setattr(cls, "_CROSS_DENSE_PLAN_MAX", 16)
    rng = np.random.default_rng(7)
    d = rng.standard_normal(N)
    rows = np.sort(rng.choice(N, N // 2, replace=False))
    L, R = np.array([3, 0]), np.array([0, 5, 10])
    for args in ((None, None, None), (rows, L, R)):
        want = ref_a._cross_sandwich(ref_b, d, *args)
        got = port_a._cross_sandwich(port_b, d, *args)
        _close(got, want)
        _close(port_a._cross_sandwich(port_b, torch.tensor(d), *args), want)
    plan, uniq = port_a._cross_plan(port_b)
    assert (uniq is not None) == compressed
    assert port_a._cross_plan(port_b)[0] is plan  # built once per pair


@pytest.mark.parametrize("compressed", [False, True], ids=["full_plan", "compressed_plan"])
@pytest.mark.parametrize("names", [("drop_first", "zero"), ("zero_drop_first", "zero"),
                                   ("zero", "convert"), ("plain", "zero_drop_first")],
                         ids="-".join)
def test_cross_plan_is_the_plan_of_combine_codes(names, compressed, monkeypatch):
    """The cross plan is the plan over ``_native.combine_codes``'s keys: the
    full plan's keys combined on the device, the compressed plan's over
    ``np.unique`` of them on the host; both give the dense oracle's cell."""
    _, port_a = _pair(names[0], seed=8)
    _, port_b = _pair(names[1], seed=9)
    if compressed:
        monkeypatch.setattr(tt.CategoricalMatrix, "_CROSS_DENSE_PLAN_MAX", 16)
    K1, K2 = port_a.shape[1], port_b.shape[1]
    keys = _native.combine_codes(port_a._eff_codes_np, port_b._eff_codes_np, K2)
    W = K1 * K2
    plan, uniq = port_a._cross_plan(port_b)
    if compressed:
        valid = keys >= 0
        cells, inverse = np.unique(keys[valid], return_inverse=True)
        keys = np.full(len(keys), -1)
        keys[valid] = inverse
        W = len(cells)
        np.testing.assert_array_equal(uniq.numpy(), cells)
    else:
        assert uniq is None
    ref = tpu_segments.build_plan(keys, W)  # the JAX package's host argsort
    perm, bounds = np.asarray(ref.perm), np.asarray(ref.bounds)
    np.testing.assert_array_equal(plan.perm.numpy(), perm[bounds[0] : bounds[-1]])
    np.testing.assert_array_equal(plan.bounds.numpy(), bounds - bounds[0])
    assert plan.perm.dtype == plan.bounds.dtype == torch.int32
    d = np.random.default_rng(10).random(N)
    A, B = port_a.toarray(), port_b.toarray()
    _close(port_a._cross_sandwich(port_b, d), A.T @ (d[:, None] * B))


def test_cross_sparse_names_the_roadmap():
    """The categorical × sparse cross sandwich, which ROADMAP A4 ported: the
    same values as the reference's host scipy product."""
    from scipy import sparse as sps

    ref, port = _pair("zero_drop_first")
    X = sps.random(N, 5, density=0.2, format="csc", random_state=np.random.default_rng(3))
    d = np.random.default_rng(4).random(N)
    want = ref._cross_sparse(tm.SparseMatrix(X), d, None, None, None)
    _close(port._cross_sparse(tt.SparseMatrix(X, device="cpu"), d, None, None, None), want)


@pytest.mark.parametrize("name", CONFIGS)
def test_getcol_multiply_recover(name):
    ref, port = _pair(name)
    for i in (0, 3, -1):
        got, want = port.getcol(i), ref.getcol(i)
        np.testing.assert_array_equal(got.toarray(), want.toarray())
        assert got.column_names == want.column_names
    w = np.random.default_rng(8).standard_normal(N)
    np.testing.assert_array_equal(port.multiply(w).toarray(), ref.multiply(w).toarray())
    np.testing.assert_array_equal(np.ma.getdata(port.recover_orig()),
                                  np.ma.getdata(ref.recover_orig()))


@pytest.mark.parametrize("row", [slice(None, 100), np.arange(0, N, 7), [3, 1, 4]])
def test_getitem_rows(row):
    ref, port = _pair("zero_drop_first")
    got, want = port[row, :], ref[row, :]
    assert isinstance(got, tt.CategoricalMatrix)
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    # a column subset is a SparseMatrix, as in the reference
    got, want = port[row, [0, 1]], ref[row, [0, 1]]
    assert isinstance(got, tt.SparseMatrix)
    np.testing.assert_array_equal(got.toarray(), want.toarray())


def test_names():
    ref, port = _pair("drop_first", column_name_format="{name}__{category}")
    assert port.column_names == ref.column_names
    for obj in (ref, port):
        obj.set_names(["y__c1"] + [f"y__c{i}" for i in range(2, 7)])
    assert port.column_names == ref.column_names
    assert port.get_names(missing_prefix="_col_") == ref.get_names(missing_prefix="_col_")
    with pytest.raises(ValueError):
        port.set_names(["a", "b"])


def test_pickle_round_trip():
    _, port = _pair("zero_drop_first")
    d = np.random.default_rng(9).random(N)
    before = port.sandwich(d).diag
    back = pickle.loads(pickle.dumps(port))
    assert back.device == port.device
    np.testing.assert_array_equal(back.sandwich(d).diag, before)
    np.testing.assert_array_equal(back.toarray(), port.toarray())


@pytest.mark.parametrize("method", ["fail", "zero", "convert"])
@pytest.mark.parametrize("drop_first", [False, True])
def test_constructor_contracts(method, drop_first):
    values = np.array(["b", "a", None, "c", "a"], dtype=object)
    kw = dict(drop_first=drop_first, cat_missing_method=method)
    if method == "fail":
        for pkg, extra in ((tm, {}), (tt, {"device": "cpu"})):
            with pytest.raises(ValueError, match="missing"):
                pkg.CategoricalMatrix(values, **kw, **extra)
        return
    ref = tm.CategoricalMatrix(values, **kw)
    port = tt.CategoricalMatrix(values, **kw, device="cpu")
    np.testing.assert_array_equal(port.categories, ref.categories)
    np.testing.assert_array_equal(port.toarray(), ref.toarray())


def test_constructor_errors_and_conversion():
    for pkg, extra in ((tm, {}), (tt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="exceed"):
            pkg.CategoricalMatrix(np.array([0, 3]), categories=np.arange(3), **extra)
        with pytest.raises(ValueError, match="non-negative"):
            pkg.CategoricalMatrix(np.array([0, -2]), categories=np.arange(3), **extra)
        with pytest.raises(ValueError, match="cat_missing_method"):
            pkg.CategoricalMatrix(np.array([0]), cat_missing_method="drop", **extra)
    ref = tm.CategoricalMatrix(np.array([2, 0, -1, 1]), categories=np.array(["p", "q", "r"]),
                               drop_first=True, cat_missing_method="zero", column_name="z")
    port = from_tabmat_tpu(ref, device="cpu")
    assert isinstance(port, tt.CategoricalMatrix)
    assert port.column_names == ref.column_names
    np.testing.assert_array_equal(port.toarray(), ref.toarray())
    # without pandas-typed input no pandas is needed: codes + categories, or
    # a numpy vector of labels
    np.testing.assert_array_equal(
        tt.CategoricalMatrix(np.array([1.0, 3.0, 1.0]), device="cpu").toarray(),
        tm.CategoricalMatrix(np.array([1.0, 3.0, 1.0])).toarray(),
    )


def test_no_device_asks_for_the_card(monkeypatch):
    """Without a card, a request for no device raises: nothing silently
    lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = np.array([0, 1, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.CategoricalMatrix(codes, categories=np.arange(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.DenseMatrix(np.ones((3, 2)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.fit_glm(np.ones((3, 2)), np.ones(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.GeneralizedLinearRegressor().fit(np.ones((3, 2)), np.ones(3))
    # a CPU tensor, or device="cpu", is an explicit request for the CPU
    assert tt.DenseMatrix(torch.ones(3, 2)).device.type == "cpu"
    assert tt.CategoricalMatrix(codes, categories=np.arange(2), device="cpu").device.type == "cpu"
