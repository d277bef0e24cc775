"""The port's dense + sparse + categorical + categorical SplitMatrix and its
DeviceDesign against ``tabmat_tpu`` on the CPU: 3 dense columns, 8 sparse
columns at 10%, and categoricals of 7 (``drop_first``, missing as zero) and
11 levels, carried across by ``from_tabmat_tpu``.

Tolerances: ``atol=1e-12`` for the matrix ops, as in
``tests/test_matrices.py``.  An IRLS step is held at rtol 1e-10 with the f64
inner solve and 1e-4 with the f32 one.  CG runs to k iterations in f32 (a CG
cut short amplifies the two packages' different f32 rounding, ROADMAP C) and
to 2k in f64: at k iterations the f64 residual of this design is still
2e-10 of the start, and the step moves with the rounding by as much.  An f32
sandwich is held at 5e-4, as ``tests/test_torch_split.py`` holds the mixed
one.
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sps

import jax.numpy as jnp

import tabmat_tpu as tm
from tabmat_tpu import glm as tpu_glm
from tabmat_tpu.models import sparse as tpu_sparse
from tabmat_tpu.parallel import design as tpu_design
from tabmat_tpu.parallel.design import DeviceDesign as TpuDesign

import tabmat_torch as tt
from tabmat_torch import glm
from tabmat_torch.convert import from_tabmat_tpu
from tabmat_torch.models import sparse as port_sparse
from tabmat_torch.parallel import design as port_design
from tabmat_torch.parallel.design import DeviceDesign

N, KD, KS = 2000, 3, 8
ATOL = 1e-12
STEP_RTOL = {"float64": 1e-10, "float32": 1e-4}
F32_TOL = 5e-4


def _cat(levels, seed, n=N, missing=0.05):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, levels, n)
    codes[rng.random(n) < missing] = -1
    return codes


def _reference(layout="blocks", n=N, seed=0, scale=1.0):
    """A tabmat_tpu SplitMatrix: dense, sparse, and cats of 7 and 11 levels."""
    rng = np.random.default_rng(seed)
    Xd = rng.standard_normal((n, KD))
    Xs = sps.random(n, KS, density=0.1, format="csc", random_state=rng) * scale
    blocks = [
        tm.DenseMatrix(Xd),
        tm.SparseMatrix(sps.csc_matrix(Xs)),
        tm.CategoricalMatrix(_cat(7, seed + 1, n), categories=np.arange(7), drop_first=True,
                             cat_missing_method="zero", column_name="a"),
        tm.CategoricalMatrix(_cat(11, seed + 2, n), categories=np.arange(11),
                             cat_missing_method="zero", column_name="b"),
    ]
    if layout == "blocks":
        return tm.SplitMatrix(blocks)
    # the dense and sparse columns interleaved with the categoricals' columns
    k = KD + KS + 6 + 11
    order = np.random.default_rng(seed + 3).permutation(k)
    cuts = np.cumsum([KD, KS, 6])
    return tm.SplitMatrix(blocks, [np.sort(p) for p in np.split(order, cuts)])


LAYOUTS = ["blocks", "interleaved"]


def _pair(layout="blocks", **kw):
    ref = _reference(layout, **kw)
    return ref, from_tabmat_tpu(ref, device="cpu")


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_conversion_and_layout():
    ref, port = _pair("interleaved")
    assert [type(m).__name__ for m in port.matrices] == [type(m).__name__ for m in ref.matrices]
    for a, b in zip(port.indices, ref.indices):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.toarray(), ref.toarray())
    design = DeviceDesign.from_matrix(port)
    assert [b.kind for b in design.blocks] == ["dense", "sparse", "cat"]
    assert design.supports_sandwich and TpuDesign.from_matrix(ref).supports_sandwich
    sparse = design._block("sparse")
    # one (code, column) plan for both categoricals, keyed on the stacked codes
    assert sparse.cat[1].num_segments == (6 + 11) * KS
    assert sparse.absmax == np.abs(port.matrices[1].data).max()


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
        np.testing.assert_allclose(_np(port.matvec(arg(v), **kw)), np.asarray(ref.matvec(v, **kw)),
                                   atol=ATOL)
    for kw in ({}, {"rows": rows}, {"cols": cols}, {"rows": rows, "cols": cols}):
        np.testing.assert_allclose(_np(port.transpose_matvec(arg(r), **kw)),
                                   np.asarray(ref.transpose_matvec(r, **kw)), atol=ATOL)
        np.testing.assert_allclose(_np(port.sandwich(arg(d), **kw)),
                                   np.asarray(ref.sandwich(d, **kw)), atol=ATOL)


def test_split_standardize_and_getcol():
    ref, port = _pair("interleaved")
    w = np.full(N, 1 / N)
    std_ref, means_ref, stds_ref = ref.standardize(w, True, True)
    std_port, means_port, stds_port = port.standardize(w, True, True)
    np.testing.assert_allclose(means_port, means_ref, atol=ATOL)
    np.testing.assert_allclose(stds_port, stds_ref, atol=ATOL)
    d = np.random.default_rng(2).random(N)
    np.testing.assert_allclose(_np(std_port.sandwich(d)), np.asarray(std_ref.sandwich(d)),
                               atol=1e-10)
    for i in range(port.shape[1]):
        np.testing.assert_array_equal(port.getcol(i).toarray(), ref.getcol(i).toarray())


def _designs(layout="blocks", **kw):
    ref, port = _pair(layout, **kw)
    return TpuDesign.from_matrix(ref), DeviceDesign.from_matrix(port)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_design_ops(layout):
    ref, port = _designs(layout)
    rng = np.random.default_rng(5)
    k = port.shape[1]
    v, r, w = rng.standard_normal(k), rng.standard_normal(N), rng.random(N)
    np.testing.assert_allclose(port.matvec(torch.tensor(v)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(v))), atol=ATOL)
    np.testing.assert_allclose(port.transpose_matvec(torch.tensor(r)).numpy(),
                               np.asarray(ref.transpose_matvec(jnp.asarray(r))), atol=ATOL)
    H = port.sandwich(torch.tensor(w))
    np.testing.assert_allclose(H.numpy(), np.asarray(ref.sandwich(jnp.asarray(w))), atol=ATOL)
    # every cell but the dense one is mirrored, so those are exactly symmetric
    dense_cols = torch.as_tensor(port.blocks[0].positions)
    Hs = H.clone()
    Hs[dense_cols[:, None], dense_cols[None, :]] = 0
    assert torch.equal(Hs, Hs.T)
    # f32: the cast design shares the layouts and plans
    p32 = port.astype_float(torch.float32)
    s32 = p32._block("sparse")
    assert s32.csr[0].dtype == s32.pair[0].dtype == s32.cat[0].dtype == torch.float32
    assert s32.csc[1] is port._block("sparse").csc[1]
    H32 = p32.sandwich(torch.tensor(w, dtype=torch.float32))
    H32_ref = ref.astype_float(jnp.float32).sandwich(jnp.asarray(w, dtype=jnp.float32))
    np.testing.assert_allclose(H32.numpy(), np.asarray(H32_ref), rtol=F32_TOL, atol=F32_TOL)
    assert _rel(H32, H) < 1e-6


def test_design_of_a_sparse_matrix_alone():
    rng = np.random.default_rng(6)
    X = sps.random(N, KS, density=0.1, format="csc", random_state=rng)
    ref = TpuDesign.from_matrix(tm.SparseMatrix(X))
    port = DeviceDesign.from_matrix(tt.SparseMatrix(X, device="cpu"))
    assert [b.kind for b in port.blocks] == ["sparse"] and port.supports_sandwich
    w, v = rng.random(N), rng.standard_normal(KS)
    np.testing.assert_allclose(port.sandwich(torch.tensor(w)).numpy(),
                               np.asarray(ref.sandwich(jnp.asarray(w))), atol=ATOL)
    np.testing.assert_allclose(port.matvec(torch.tensor(v)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(v))), atol=ATOL)


FAMILIES = ["gaussian", "poisson", "logistic"]


def _targets(family, X, seed):
    rng = np.random.default_rng(seed)
    eta = X @ (rng.standard_normal(X.shape[1]) * 0.2)
    if family == "poisson":
        return rng.poisson(np.exp(eta)).astype(np.float64)
    if family == "logistic":
        return (rng.random(len(eta)) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    return eta + 0.1 * rng.standard_normal(len(eta))


def _step(ref, port, ref_X, family, inner, seed=9):
    rng = np.random.default_rng(seed)
    y = _targets(family, ref_X.toarray(), seed + 1)
    w = rng.random(N) + 0.5
    beta0 = rng.standard_normal(ref_X.shape[1]) * 0.01
    n_cg = ref_X.shape[1] * (2 if inner == "float64" else 1)
    got = glm.irls_step(port, torch.tensor(y), torch.tensor(w), torch.tensor(beta0),
                        family=family, n_cg=n_cg, inner_precision=inner)
    want = tpu_glm.irls_step(ref, jnp.asarray(y), jnp.asarray(w), jnp.asarray(beta0),
                             family=family, n_cg=n_cg, inner_precision=inner)
    return got, want


@pytest.mark.parametrize("inner", ["float64", "float32"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_irls_step(layout, family, inner):
    ref_X, port_X = _pair(layout)
    got, want = _step(TpuDesign.from_matrix(ref_X), DeviceDesign.from_matrix(port_X), ref_X,
                      family, inner)
    assert _rel(got, want) < STEP_RTOL[inner]


@pytest.mark.parametrize("gate", ["pair_plan", "sparse_cat_plan", "standardized"])
def test_supports_sandwich_gates(monkeypatch, gate):
    """Past a gate both packages take the Hessian-vector route, and their
    steps still agree."""
    if gate == "pair_plan":
        monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 10)
        monkeypatch.setattr(tpu_sparse, "PAIR_SANDWICH_MAX_PAIRS", 10)
    elif gate == "sparse_cat_plan":
        monkeypatch.setattr(port_design, "SPARSE_CAT_MAX_SEGMENTS", 50)
        monkeypatch.setattr(tpu_design, "SPARSE_CAT_MAX_SEGMENTS", 50)
    ref_X, port_X = _pair()
    if gate == "standardized":
        w = np.full(N, 1 / N)
        ref_X, port_X = ref_X.standardize(w, True, True)[0], port_X.standardize(w, True, True)[0]
    ref, port = TpuDesign.from_matrix(ref_X), DeviceDesign.from_matrix(port_X)
    assert not port.supports_sandwich and not ref.supports_sandwich
    for inner in ("float64", "float32"):
        got, want = _step(ref, port, ref_X, "poisson", inner)
        assert _rel(got, want) < STEP_RTOL[inner]


@pytest.mark.parametrize("inner", ["float64", "float32"])
def test_fit_glm(inner):
    ref_X, port_X = _pair("interleaved")
    y = _targets("poisson", ref_X.toarray(), 14)
    n_cg = port_X.shape[1] * (2 if inner == "float64" else 1)
    kw = dict(family="poisson", max_iter=5, tol=0.0, n_cg=n_cg, inner_precision=inner)
    got, n_got = tt.fit_glm(port_X, y, **kw)
    want, n_want = tpu_glm.fit_glm(ref_X, y, **kw)
    assert n_got == n_want == 5
    assert got.device.type == "cpu"
    assert _rel(got, want) < STEP_RTOL[inner]


@pytest.mark.parametrize("kind", ["SparseMatrix", "scipy"])
def test_fit_and_estimator_on_a_sparse_design(kind):
    rng = np.random.default_rng(15)
    X = sps.random(N, KS, density=0.2, format="csc", random_state=rng)
    y = _targets("poisson", X.toarray(), 16)
    port_X = tt.SparseMatrix(X, device="cpu") if kind == "SparseMatrix" else X
    kw = dict(family="poisson", max_iter=5, tol=0.0, n_cg=KS)
    got, _ = tt.fit_glm(port_X, y, **kw, device="cpu")
    want, _ = tpu_glm.fit_glm(tm.SparseMatrix(X), y, **kw)
    assert _rel(got, want) < STEP_RTOL["float32"]
    est = dict(family="poisson", n_cg=30, max_iter=8, l2=0.01)
    got = tt.GeneralizedLinearRegressor(**est, device="cpu").fit(port_X, y)
    want = tm.GeneralizedLinearRegressor(**est).fit(tm.SparseMatrix(X), y)
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.intercept_, want.intercept_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.predict(port_X), want.predict(tm.SparseMatrix(X)),
                               rtol=1e-4, atol=1e-6)


def test_estimator_on_the_split():
    ref_X, port_X = _pair()
    y = _targets("gaussian", ref_X.toarray(), 17)
    kw = dict(family="gaussian", n_cg=40, max_iter=6, l2=0.01)
    got = tt.GeneralizedLinearRegressor(**kw).fit(port_X, y)
    want = tm.GeneralizedLinearRegressor(**kw).fit(ref_X, y)
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.predict(port_X), want.predict(ref_X), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_hessian_scale_is_exact_in_range(family):
    """With sparse columns in the design too, the power-of-two scale leaves
    the f32 step bit for bit what the unscaled f32 Hessian and CG give, and
    the design's bound covers every |x_ij w_i|, the sparse ones included."""
    _, port_X = _pair(scale=6.0)  # sparse values past the dense ones
    port = DeviceDesign.from_matrix(port_X)
    rng = np.random.default_rng(11)
    yt = torch.tensor(_targets(family, port_X.toarray(), 12))
    wt = torch.tensor(8 * (rng.random(N) + 0.5))  # weights over 1: the scale is in use
    bt = torch.tensor(rng.standard_normal(port.shape[1]) * 0.01)
    got = glm.irls_step(port, yt, wt, bt, family=family, n_cg=8, inner_precision="float32")
    _, w_irls, resid = glm._family_terms(family, port @ bt, yt)
    p32 = port.astype_float(torch.float32)
    bound = float(p32.absmax_bound(wt * w_irls))
    X32 = port_X.toarray().astype(np.float32).astype(np.float64)
    xw = np.abs(X32 * _np(wt * w_irls)[:, None])
    assert bound >= xw.max()
    # the sparse columns set the bound here
    sparse_cols = port_X.indices[1]
    assert xw[:, sparse_cols].max() > np.delete(xw, sparse_cols, axis=1).max()
    assert float(glm._f32_hessian_scale(p32, wt * w_irls)) < 1.0
    H = p32.sandwich((wt * w_irls).to(torch.float32))
    grad = (port.T @ (wt * resid)).to(torch.float32)
    unscaled = bt + glm._cg_solve(lambda v: H @ v, grad, 8).to(torch.float64)
    assert torch.equal(got, unscaled)


def test_f32_scale_keeps_large_sparse_values_finite():
    """Sparse values near 1e3 and weights of 1e36: the unscaled f32 Hessian
    overflows (terms of 1e42); the scaled step, whose bound is the largest
    sparse value times max |w|, stays finite and agrees with the f64 step."""
    rng = np.random.default_rng(18)
    Xs = sps.random(N, KS, density=0.3, format="csc", random_state=rng) * 1e3
    port = DeviceDesign.from_matrix(tt.SparseMatrix(Xs, device="cpu"))
    y = torch.tensor(Xs @ rng.standard_normal(KS) + rng.standard_normal(N))
    w = torch.full((N,), 1e36, dtype=torch.float64)
    b0 = torch.zeros(KS, dtype=torch.float64)
    H_unscaled = port.astype_float(torch.float32).sandwich(w.to(torch.float32))
    assert not torch.isfinite(H_unscaled).all()
    assert float(port.absmax_bound(w)) == port._block("sparse").absmax * 1e36
    steps = {inner: glm.irls_step(port, y, w, b0, n_cg=KS, inner_precision=inner)
             for inner in ("float32", "float64")}
    assert torch.isfinite(steps["float32"]).all()
    assert _rel(steps["float32"], steps["float64"]) < 1e-4


def test_f32_sparse_cells_have_f32_precision():
    """200k rows, 20 sparse columns at 5% and a 300-level categorical: the
    port sums each sparse cell directly, so its f32 cells agree with its f64
    cells to f32 precision.  The JAX package forms the sparse diagonal and
    sparse x cat cells as differences of an f32 cumsum over all pairs or
    nonzeros (``design.py:775-809``)."""
    n, ks, levels = 200_000, 20, 300
    rng = np.random.default_rng(20)
    Xs = sps.random(n, ks, density=0.05, format="csc", random_state=rng)
    codes = rng.integers(0, levels, n)
    w = rng.random(n) + 0.05
    port = DeviceDesign.from_matrix(tt.SplitMatrix([
        tt.SparseMatrix(Xs, device="cpu"),
        tt.CategoricalMatrix(codes, categories=np.arange(levels), device="cpu")]))
    ref = TpuDesign.from_matrix(tm.SplitMatrix([
        tm.SparseMatrix(Xs), tm.CategoricalMatrix(codes, categories=np.arange(levels))]))
    H64 = port.sandwich(torch.tensor(w)).numpy()
    H32 = port.astype_float(torch.float32).sandwich(torch.tensor(w, dtype=torch.float32)).numpy()
    ref32 = np.asarray(ref.astype_float(jnp.float32).sandwich(jnp.asarray(w, dtype=jnp.float32)))
    np.testing.assert_allclose(np.asarray(ref.sandwich(jnp.asarray(w))), H64, atol=1e-9)
    cells = {"sparse diagonal": (slice(0, ks), slice(0, ks)),
             "sparse x cat": (slice(ks, ks + levels), slice(0, ks))}

    def rel(got, want):  # per entry, where the f64 cell is not 0
        nz = want != 0
        return float((np.abs(got[nz] - want[nz]) / np.abs(want[nz])).max())

    for cell in cells.values():
        assert rel(H32[cell], H64[cell]) <= 1e-5
    # the reference's f32 cumsum cells, as measured (ROADMAP C)
    for cell in cells.values():
        assert rel(ref32[cell], H64[cell]) > 1e-5
