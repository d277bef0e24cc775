"""The port's SplitMatrix and mixed DeviceDesign against ``tabmat_tpu`` on
the CPU: a dense block and two categoricals (``drop_first`` and
``cat_missing_method="zero"``), carried across by ``from_tabmat_tpu``.

Tolerances: ``atol=1e-12`` for the matrix ops, as in
``tests/test_matrices.py``.  An IRLS step is held at rtol 1e-10 with the
f64 inner solve and 1e-4 with the f32 one, as ``tests/test_torch_glm.py``
holds the dense step; an f32 sandwich at 5e-4, as that file holds the f32
dense sandwich (the two packages sum f32 terms in another order).
"""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tabmat_tpu as tm
from tabmat_tpu import glm as tpu_glm
from tabmat_tpu.parallel.design import DeviceDesign as TpuDesign

import tabmat_torch as tt
from tabmat_torch import glm
from tabmat_torch.convert import from_tabmat_tpu
from tabmat_torch.parallel.design import DeviceDesign

N, KD = 2000, 3
ATOL = 1e-12
STEP_RTOL = {"float64": 1e-10, "float32": 1e-4}
F32_TOL = 5e-4


def _cat(levels, seed, missing=0.05, n=N):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, levels, n)
    codes[rng.random(n) < missing] = -1
    return codes


def _reference(layout="blocks", n=N, seed=0):
    """A tabmat_tpu SplitMatrix: 3 dense columns, cats of 7 and 11 levels."""
    rng = np.random.default_rng(seed)
    Xd = rng.standard_normal((n, KD))
    cats = [
        tm.CategoricalMatrix(_cat(7, seed + 1, n=n), categories=np.arange(7), drop_first=True,
                             cat_missing_method="zero", column_name="a"),
        tm.CategoricalMatrix(_cat(11, seed + 2, n=n), categories=np.arange(11),
                             cat_missing_method="zero", column_name="b"),
    ]
    blocks = [tm.DenseMatrix(Xd)] + cats
    if layout == "blocks":
        return tm.SplitMatrix(blocks)
    # the dense columns interleaved with the categoricals' columns
    k = KD + 6 + 11
    dense_at = np.array([0, 8, k - 1])
    rest = np.setdiff1d(np.arange(k), dense_at)
    return tm.SplitMatrix(blocks, [dense_at, rest[:6], rest[6:]])


LAYOUTS = ["blocks", "interleaved"]


def _pair(layout="blocks", **kw):
    ref = _reference(layout, **kw)
    return ref, from_tabmat_tpu(ref, device="cpu")


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_conversion_keeps_the_blocks():
    ref, port = _pair("interleaved")
    assert isinstance(port, tt.SplitMatrix)
    assert port.shape == ref.shape
    assert [type(m).__name__ for m in port.matrices] == [type(m).__name__ for m in ref.matrices]
    for a, b in zip(port.indices, ref.indices):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.toarray(), ref.toarray())
    assert port.get_names() == ref.get_names()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("flavor", ["numpy", "tensor"])
def test_split_ops(layout, flavor):
    ref, port = _pair(layout)
    rng = np.random.default_rng(1)
    k = port.shape[1]
    v, r, d = rng.standard_normal(k), rng.standard_normal(N), rng.random(N)
    rows = np.sort(rng.choice(N, N // 2, replace=False))
    cols = np.sort(rng.choice(k, k // 2, replace=False))

    def arg(x):
        return torch.tensor(x) if flavor == "tensor" else x

    for kw in ({}, {"cols": cols}):
        got = port.matvec(arg(v), **kw)
        assert torch.is_tensor(got) == (flavor == "tensor")
        np.testing.assert_allclose(_np(got), np.asarray(ref.matvec(v, **kw)), atol=ATOL)
    for kw in ({}, {"rows": rows}, {"cols": cols}, {"rows": rows, "cols": cols}):
        np.testing.assert_allclose(_np(port.transpose_matvec(arg(r), **kw)),
                                   np.asarray(ref.transpose_matvec(r, **kw)), atol=ATOL)
        np.testing.assert_allclose(_np(port.sandwich(arg(d), **kw)),
                                   np.asarray(ref.sandwich(d, **kw)), atol=ATOL)


# ROADMAP C1 (closed): an empty, repeated or unsorted ``cols=`` on a
# SplitMatrix, held against the dense oracle with numpy and tensor operands
C1_COLS = {"empty": [], "repeated": [0, 0], "repeats_unsorted": [3, 1, 3],
           "unsorted_subset": [9, 0, 14, 2, 8]}


def _c1_split(kind):
    """The interleaved dense + categorical split, or a dense + sparse +
    categorical one with its columns permuted across the blocks."""
    if kind == "dense_cat":
        return _pair("interleaved")[1]
    from scipy import sparse as sps

    rng = np.random.default_rng(12)
    n, ks, levels = 400, 4, 9
    blocks = [
        tt.DenseMatrix(rng.standard_normal((n, KD)), device="cpu"),
        tt.SparseMatrix(sps.random(n, ks, density=0.2, format="csc", random_state=5),
                        device="cpu"),
        tt.CategoricalMatrix(_cat(levels, 13, n=n), categories=np.arange(levels),
                             cat_missing_method="zero", device="cpu"),
    ]
    order = rng.permutation(KD + ks + levels)
    return tt.SplitMatrix(blocks, [np.sort(p) for p in np.split(order, [KD, KD + ks])])


@pytest.mark.parametrize("operand", ["numpy", "tensor"])
@pytest.mark.parametrize("cols", list(C1_COLS))
@pytest.mark.parametrize("op", ["sandwich", "matvec", "transpose_matvec"])
@pytest.mark.parametrize("kind", ["dense_cat", "dense_sparse_cat"])
def test_empty_and_repeated_cols_match_the_dense_oracle(kind, op, cols, operand):
    X = _c1_split(kind)
    A = X.toarray()
    n, k = A.shape
    c = np.asarray(C1_COLS[cols], dtype=np.int64)
    rng = np.random.default_rng(7)

    def arg(x):
        return torch.tensor(x) if operand == "tensor" else x

    def check(got, want):
        assert torch.is_tensor(got) == (operand == "tensor")
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), want, atol=ATOL)

    if op == "sandwich":
        d = rng.random(n)
        check(X.sandwich(arg(d), cols=c), (A[:, c].T * d) @ A[:, c])
    elif op == "transpose_matvec":
        r = rng.standard_normal(n)
        check(X.transpose_matvec(arg(r), cols=c), (A.T @ r)[c])
    else:
        # a matvec sums over the SET of cols, as the port's DenseMatrix does
        v = rng.standard_normal(k)
        want = tt.DenseMatrix(A, device="cpu").matvec(v, cols=c)
        s = np.unique(c)
        np.testing.assert_allclose(want, A[:, s] @ v[s], atol=ATOL)
        check(X.matvec(arg(v), cols=c), want)


@pytest.mark.parametrize("operand", ["numpy", "tensor"])
def test_standardized_split_with_repeated_cols_matches_the_reference(operand):
    """ROADMAP C1: the reference's StandardizedMatrix with jax operands
    reaches its split's device path, which handles a repeated column (its
    numpy tmv path keeps the fault); the port agrees with that path and
    with the dense oracle on both of its own paths."""
    ref, port = _pair("interleaved")
    w = np.full(N, 1 / N)
    std_ref, _, _ = ref.standardize(w, True, True)
    std_port, _, _ = port.standardize(w, True, True)
    rng = np.random.default_rng(8)
    d, r = rng.random(N), rng.standard_normal(N)
    cols = np.array([0, 0, 3, 3])

    def arg(x):
        return torch.tensor(x) if operand == "tensor" else x

    A = std_port.toarray()[:, cols]
    got = _np(std_port.sandwich(arg(d), cols=cols))
    np.testing.assert_allclose(got, np.asarray(std_ref.sandwich(jnp.asarray(d), cols=cols)),
                               atol=ATOL)
    np.testing.assert_allclose(got, (A.T * d) @ A, atol=1e-10)
    got = _np(std_port.transpose_matvec(arg(r), cols=cols))
    np.testing.assert_allclose(
        got, np.asarray(std_ref.transpose_matvec(jnp.asarray(r), cols=cols)), atol=ATOL)
    np.testing.assert_allclose(got, A.T @ r, atol=1e-10)


def test_split_out_accumulation():
    ref, port = _pair("interleaved")
    rng = np.random.default_rng(2)
    k = port.shape[1]
    v, r = rng.standard_normal(k), rng.standard_normal(N)
    cols = np.array([k - 1, 2, 8])
    want, got = np.ones(N), np.ones(N)
    ref.matvec(v, out=want)
    port.matvec(v, out=got)
    np.testing.assert_allclose(got, want, atol=ATOL)
    want, got = np.ones(k), np.ones(k)
    ref.transpose_matvec(r, cols=cols, out=want)
    port.transpose_matvec(r, cols=cols, out=got)
    np.testing.assert_allclose(got, want, atol=ATOL)
    got_t = torch.ones(k, dtype=torch.float64)
    port.transpose_matvec(torch.tensor(r), cols=cols, out=got_t)
    np.testing.assert_allclose(got_t.numpy(), want, atol=ATOL)


def test_split_indexing_names_pickle():
    ref, port = _pair("interleaved")
    rows = np.arange(0, N, 3)
    np.testing.assert_array_equal(port[rows, :].toarray(), ref[rows, :].toarray())
    for i in (0, 8, 5, -1):
        np.testing.assert_array_equal(port.getcol(i).toarray(), ref.getcol(i).toarray())
    back = pickle.loads(pickle.dumps(port))
    np.testing.assert_array_equal(back.toarray(), port.toarray())
    # one name per dense column, one per categorical
    names = np.empty(ref.shape[1], dtype=object)
    for i, (idx, mat) in enumerate(zip(ref.indices, ref.matrices)):
        names[idx] = [f"d{j}" for j in range(len(idx))] if i == 0 else f"t{i}"
    for obj in (port, ref):
        obj.set_names(names.tolist(), "term")
    assert port.get_names("term") == ref.get_names("term") == names.tolist()
    # a row-scaled categorical is a SparseMatrix, and scipy input a sparse block
    w = np.random.default_rng(16).standard_normal(N)
    np.testing.assert_array_equal(port.multiply(w).toarray(), ref.multiply(w).toarray())
    from scipy import sparse as sps

    eye = sps.eye(N, 2, format="csc")
    stacked = tt.hstack([port, eye])
    assert isinstance(stacked.matrices[-1], tt.SparseMatrix)
    np.testing.assert_array_equal(stacked.toarray(), tm.hstack([ref, eye]).toarray())


def test_hstack_and_standardize():
    rng = np.random.default_rng(3)
    Xd = rng.standard_normal((N, KD))
    codes = _cat(7, 4)
    ref = tm.hstack([Xd, tm.CategoricalMatrix(codes, drop_first=True, cat_missing_method="zero")])
    port = tt.hstack([Xd, tt.CategoricalMatrix(codes, drop_first=True, cat_missing_method="zero",
                                                device="cpu")])
    assert isinstance(port, tt.SplitMatrix)
    np.testing.assert_array_equal(port.toarray(), ref.toarray())
    w = np.full(N, 1 / N)
    std_ref, means_ref, stds_ref = ref.standardize(w, True, True)
    std_port, means_port, stds_port = port.standardize(w, True, True)
    np.testing.assert_allclose(means_port, means_ref, atol=ATOL)
    np.testing.assert_allclose(stds_port, stds_ref, atol=ATOL)
    d = rng.random(N)
    np.testing.assert_allclose(_np(std_port.sandwich(d)), np.asarray(std_ref.sandwich(d)),
                               atol=1e-10)


def _designs(layout="blocks", **kw):
    ref, port = _pair(layout, **kw)
    return TpuDesign.from_matrix(ref), DeviceDesign.from_matrix(port)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_design_ops(layout):
    ref, port = _designs(layout)
    rng = np.random.default_rng(5)
    k = port.shape[1]
    v, r, w = rng.standard_normal(k), rng.standard_normal(N), rng.random(N)
    assert port.supports_sandwich and ref.supports_sandwich
    assert [b.kind for b in port.blocks] == ["dense", "cat"]
    np.testing.assert_allclose(port.matvec(torch.tensor(v)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(v))), atol=ATOL)
    np.testing.assert_allclose(port.transpose_matvec(torch.tensor(r)).numpy(),
                               np.asarray(ref.transpose_matvec(jnp.asarray(r))), atol=ATOL)
    H = port.sandwich(torch.tensor(w))
    np.testing.assert_allclose(H.numpy(), np.asarray(ref.sandwich(jnp.asarray(w))), atol=ATOL)
    # f32: the cast design shares the codes and plans
    p32 = port.astype_float(torch.float32)
    assert p32 is port.astype_float(torch.float32)
    assert p32.X.dtype == torch.float32 and p32._block("cat") is port._block("cat")
    H32 = p32.sandwich(torch.tensor(w, dtype=torch.float32))
    assert H32.dtype == torch.float32
    H32_ref = ref.astype_float(jnp.float32).sandwich(jnp.asarray(w, dtype=jnp.float32))
    np.testing.assert_allclose(H32.numpy(), np.asarray(H32_ref), rtol=F32_TOL, atol=F32_TOL)
    assert _rel(H32, H) < 1e-6


def test_design_of_categoricals_only():
    rng = np.random.default_rng(6)
    a, b = _cat(7, 7), _cat(11, 8)
    kw_a = dict(categories=np.arange(7), cat_missing_method="zero")
    kw_b = dict(categories=np.arange(11), cat_missing_method="zero")
    ref = TpuDesign.from_matrix(tm.SplitMatrix(
        [tm.CategoricalMatrix(a, **kw_a), tm.CategoricalMatrix(b, **kw_b)]))
    port = DeviceDesign.from_matrix(tt.SplitMatrix([
        tt.CategoricalMatrix(a, **kw_a, device="cpu"),
        tt.CategoricalMatrix(b, **kw_b, device="cpu")]))
    assert port.shape == ref.shape == (N, 18)
    w, v = rng.random(N), rng.standard_normal(18)
    np.testing.assert_allclose(port.sandwich(torch.tensor(w)).numpy(),
                               np.asarray(ref.sandwich(jnp.asarray(w))), atol=ATOL)
    np.testing.assert_allclose(port.matvec(torch.tensor(v)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(v))), atol=ATOL)
    one = DeviceDesign.from_matrix(tt.CategoricalMatrix(a, **kw_a, device="cpu"))
    np.testing.assert_allclose(one.sandwich(torch.tensor(w)).numpy(),
                               np.diag(tm.CategoricalMatrix(a, **kw_a).sandwich(w).diag),
                               atol=ATOL)


FAMILIES = ["gaussian", "poisson", "logistic"]


def _targets(family, X, seed):
    rng = np.random.default_rng(seed)
    eta = X @ (rng.standard_normal(X.shape[1]) * 0.2)
    if family == "poisson":
        return rng.poisson(np.exp(eta)).astype(np.float64)
    if family == "logistic":
        return (rng.random(len(eta)) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    return eta + 0.1 * rng.standard_normal(len(eta))


@pytest.mark.parametrize("inner", ["float64", "float32"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_irls_step(layout, family, inner):
    ref_X, port_X = _pair(layout)
    ref, port = TpuDesign.from_matrix(ref_X), DeviceDesign.from_matrix(port_X)
    rng = np.random.default_rng(9)
    y = _targets(family, ref_X.toarray(), 10)
    w = rng.random(N) + 0.5
    beta0 = rng.standard_normal(ref_X.shape[1]) * 0.01
    # CG runs as many iterations as there are columns: a CG cut short
    # amplifies the two packages' different f32 rounding to ~2e-4
    n_cg = ref_X.shape[1]
    got = glm.irls_step(port, torch.tensor(y), torch.tensor(w), torch.tensor(beta0),
                        family=family, n_cg=n_cg, inner_precision=inner)
    want = tpu_glm.irls_step(ref, jnp.asarray(y), jnp.asarray(w), jnp.asarray(beta0),
                             family=family, n_cg=n_cg, inner_precision=inner)
    assert _rel(got, want) < STEP_RTOL[inner]


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_hessian_scale_is_exact_in_range(family):
    """On the mixed design too, the power-of-two scale leaves the f32 step bit
    for bit what the unscaled f32 Hessian and CG give."""
    _, port_X = _pair()
    port = DeviceDesign.from_matrix(port_X)
    rng = np.random.default_rng(11)
    yt = torch.tensor(_targets(family, port_X.toarray(), 12))
    wt = torch.tensor(8 * (rng.random(N) + 0.5))  # weights over 1: the scale is in use
    bt = torch.tensor(rng.standard_normal(port.shape[1]) * 0.01)
    got = glm.irls_step(port, yt, wt, bt, family=family, n_cg=8, inner_precision="float32")
    _, w_irls, resid = glm._family_terms(family, port @ bt, yt)
    p32 = port.astype_float(torch.float32)
    bound = p32.absmax_bound(wt * w_irls)
    # the bound covers every |x_ij w_i|: the dense columns and the one-hot ones
    X32 = port_X.toarray().astype(np.float32).astype(np.float64)
    assert float(bound) >= np.abs(X32 * _np(wt * w_irls)[:, None]).max()
    assert float(glm._f32_hessian_scale(p32, wt * w_irls)) < 1.0
    H = p32.sandwich((wt * w_irls).to(torch.float32))
    grad = (port.T @ (wt * resid)).to(torch.float32)
    unscaled = bt + glm._cg_solve(lambda v: H @ v, grad, 8).to(torch.float64)
    assert torch.equal(got, unscaled)


def test_f32_cat_cat_cell_has_f32_precision():
    """Two 300-level categoricals at 200k rows: each cat x cat cell holds a
    few rows.  The port sums each cell directly, so its f32 cell agrees with
    the f64 cell to f32 precision.  The JAX package forms the cell as a
    difference of an f32 cumsum over all rows (``design.py:830``), whose
    ulp at the prefix (about 0.016 at 2e5) swamps a cell of about 1."""
    n, levels = 200_000, 300
    rng = np.random.default_rng(13)
    mats = [(rng.integers(0, levels, n), np.arange(levels)) for _ in range(2)]
    w = rng.random(n) + 0.05
    port = DeviceDesign.from_matrix(tt.SplitMatrix(
        [tt.CategoricalMatrix(c, categories=cats, device="cpu") for c, cats in mats]))
    ref = TpuDesign.from_matrix(tm.SplitMatrix(
        [tm.CategoricalMatrix(c, categories=cats) for c, cats in mats]))
    cell = (slice(0, levels), slice(levels, 2 * levels))
    H64 = port.sandwich(torch.tensor(w)).numpy()[cell]
    H32 = port.astype_float(torch.float32).sandwich(torch.tensor(w, dtype=torch.float32))
    assert _rel(H32.numpy()[cell], H64) <= 1e-5
    ref32 = ref.astype_float(jnp.float32).sandwich(jnp.asarray(w, dtype=jnp.float32))
    np.testing.assert_allclose(np.asarray(ref.sandwich(jnp.asarray(w)))[cell], H64, atol=1e-9)
    assert _rel(np.asarray(ref32)[cell], H64) > 1e-5


@pytest.mark.parametrize("inner", ["float64", "float32"])
def test_fit_glm(inner):
    ref_X, port_X = _pair("interleaved")
    y = _targets("poisson", ref_X.toarray(), 14)
    kw = dict(family="poisson", max_iter=5, tol=0.0, n_cg=12, inner_precision=inner)
    got, n_got = tt.fit_glm(port_X, y, **kw)
    want, n_want = tpu_glm.fit_glm(ref_X, y, **kw)
    assert n_got == n_want == 5
    assert got.device.type == "cpu"
    assert _rel(got, want) < STEP_RTOL[inner]


@pytest.mark.parametrize("family", ["gaussian", "poisson"])
def test_estimator_with_intercept(family):
    ref_X, port_X = _pair()
    y = _targets(family, ref_X.toarray(), 15)
    kw = dict(family=family, n_cg=30, max_iter=8, l2=0.01)
    got = tt.GeneralizedLinearRegressor(**kw).fit(port_X, y)
    want = tm.GeneralizedLinearRegressor(**kw).fit(ref_X, y)
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.intercept_, want.intercept_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.predict(port_X), want.predict(ref_X), rtol=1e-4, atol=1e-6)
