"""The port's GLM layer against ``tabmat_tpu.glm`` on the CPU.

Inputs are made from a seed with numpy and carried across to the port by
``tabmat_torch.convert``.  Tolerances: an f64 Newton step is held at
rtol 1e-10 (the two packages differ only in summation order); a step with
the default float32 inner solve at rtol 1e-4, because the Hessian and CG
run in f32 and their sums are taken in another order.
"""

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

STEP_RTOL = {"float64": 1e-10, "float32": 1e-4}
FAMILIES = ["gaussian", "poisson", "logistic"]


def _problem(family, n=400, k=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, k)) * 0.5
    beta_true = rng.standard_normal(k) * 0.3
    eta = X @ beta_true
    if family == "poisson":
        y = rng.poisson(np.exp(eta)).astype(np.float64)
    elif family == "logistic":
        y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    else:
        y = eta + 0.1 * rng.standard_normal(n)
    w = rng.random(n) + 0.5
    beta0 = rng.standard_normal(k) * 0.01
    return X, y, w, beta0


def _designs(X, standardized=False):
    ref = tm.DenseMatrix(X)
    if standardized:
        ref, _, _ = ref.standardize(np.full(X.shape[0], 1.0 / X.shape[0]), True, True)
    port = from_tabmat_tpu(ref)
    return TpuDesign.from_matrix(ref), DeviceDesign.from_matrix(port)


def _rel(got, ref):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("standardized", [False, True])
def test_design_ops_match(standardized):
    X, _, w, _ = _problem("gaussian")
    ref, port = _designs(X, standardized)
    rng = np.random.default_rng(1)
    v, r = rng.standard_normal(X.shape[1]), rng.standard_normal(X.shape[0])
    assert port.supports_sandwich == ref.supports_sandwich == (not standardized)
    assert _rel(port.matvec(torch.tensor(v)), ref.matvec(jnp.asarray(v))) < 1e-12
    assert _rel(port.transpose_matvec(torch.tensor(r)), ref.transpose_matvec(jnp.asarray(r))) < 1e-12
    assert _rel(port @ torch.tensor(v), ref @ jnp.asarray(v)) < 1e-12
    assert _rel(port.T @ torch.tensor(r), ref.T @ jnp.asarray(r)) < 1e-12
    if not standardized:
        assert _rel(port.sandwich(torch.tensor(w)), ref.sandwich(jnp.asarray(w))) < 1e-13


def test_astype_float_is_built_once():
    X, _, w, _ = _problem("gaussian")
    ref, port = _designs(X)
    p32 = port.astype_float(torch.float32)
    assert p32 is port.astype_float(torch.float32)
    assert port.astype_float(torch.float64) is port
    assert p32.X.dtype == torch.float32
    H = p32.sandwich(torch.tensor(w, dtype=torch.float32))
    H_ref = ref.astype_float(jnp.float32).sandwich(jnp.asarray(w, dtype=jnp.float32))
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=5e-4, atol=5e-4)
    with pytest.raises(ValueError):
        port.astype_float(torch.float16)


@pytest.mark.parametrize("inner", ["float64", "float32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_irls_step_design(family, inner):
    X, y, w, beta0 = _problem(family, seed=FAMILIES.index(family))
    ref, port = _designs(X)
    got = glm.irls_step(
        port, torch.tensor(y), torch.tensor(w), torch.tensor(beta0),
        family=family, n_cg=8, inner_precision=inner,
    )
    want = tpu_glm.irls_step(
        ref, jnp.asarray(y), jnp.asarray(w), jnp.asarray(beta0),
        family=family, n_cg=8, inner_precision=inner,
    )
    assert got.dtype == torch.float64
    assert _rel(got, want) < STEP_RTOL[inner]


@pytest.mark.parametrize("inner", ["float64", "float32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_irls_step_standardized_design(family, inner):
    X, y, w, beta0 = _problem(family, seed=10 + FAMILIES.index(family))
    ref, port = _designs(X, standardized=True)
    got = glm.irls_step(
        port, torch.tensor(y), torch.tensor(w), torch.tensor(beta0),
        family=family, n_cg=8, inner_precision=inner,
    )
    want = tpu_glm.irls_step(
        ref, jnp.asarray(y), jnp.asarray(w), jnp.asarray(beta0),
        family=family, n_cg=8, inner_precision=inner,
    )
    assert _rel(got, want) < STEP_RTOL[inner]


@pytest.mark.parametrize("inner", ["float64", "float32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_irls_step_raw_array(family, inner):
    X, y, w, beta0 = _problem(family, seed=20 + FAMILIES.index(family))
    got = glm.irls_step(
        torch.tensor(X), torch.tensor(y), torch.tensor(w), torch.tensor(beta0),
        family=family, n_cg=8, inner_precision=inner,
    )
    want = tpu_glm.irls_step(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.asarray(beta0),
        family=family, n_cg=8, inner_precision=inner,
    )
    assert _rel(got, want) < STEP_RTOL[inner]


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_hessian_scale_is_exact_in_range(family):
    """Within float32 range the power-of-two scale leaves the step bit for bit
    what the unscaled float32 Hessian and CG give."""
    X, y, w, beta0 = _problem(family, seed=30 + FAMILIES.index(family))
    _, port = _designs(X)
    # weights over 1, so that the scale is below 1 in every family
    yt, wt, bt = torch.tensor(y), torch.tensor(8 * w), torch.tensor(beta0)
    got = glm.irls_step(port, yt, wt, bt, family=family, n_cg=8, inner_precision="float32")
    _, w_irls, resid = glm._family_terms(family, port @ bt, yt)
    s = glm._f32_hessian_scale(port.astype_float(torch.float32), wt * w_irls)
    assert float(s) < 1.0  # the scale is in use here
    H = port.astype_float(torch.float32).sandwich((wt * w_irls).to(torch.float32))
    grad = (port.T @ (wt * resid)).to(torch.float32)
    unscaled = bt + glm._cg_solve(lambda v: H @ v, grad, 8).to(torch.float64)
    assert torch.equal(got, unscaled)


def test_f32_hessian_scale_keeps_large_weights_in_range():
    """Sample weights beyond float32 overflow an unscaled float32 Hessian;
    the scaled step matches the float64 step."""
    X, y, w, beta0 = _problem("gaussian", seed=40)
    _, port = _designs(X)
    w_big = torch.tensor(w * 1e40)
    assert not torch.isfinite(w_big.to(torch.float32)).any()
    steps = {
        inner: glm.irls_step(port, torch.tensor(y), w_big, torch.tensor(beta0),
                             n_cg=8, inner_precision=inner)
        for inner in ("float32", "float64")
    }
    assert torch.isfinite(steps["float32"]).all()
    assert _rel(steps["float32"], steps["float64"]) < STEP_RTOL["float32"]


def test_irls_step_l2_penalty_scale_offset():
    X, y, w, beta0 = _problem("poisson", seed=3)
    ref, port = _designs(X)
    ps = np.r_[0.0, np.ones(X.shape[1] - 1)]
    offset = np.random.default_rng(4).standard_normal(X.shape[0]) * 0.1
    got = glm.irls_step(
        port, torch.tensor(y), torch.tensor(w), torch.tensor(beta0), family="poisson",
        n_cg=8, l2=0.5, inner_precision="float64", penalty_scale=torch.tensor(ps),
        offset=torch.tensor(offset),
    )
    want = tpu_glm.irls_step(
        ref, jnp.asarray(y), jnp.asarray(w), jnp.asarray(beta0), family="poisson",
        n_cg=8, l2=0.5, inner_precision="float64", penalty_scale=jnp.asarray(ps),
        offset=jnp.asarray(offset),
    )
    assert _rel(got, want) < 1e-10


@pytest.mark.parametrize(
    "family", ["gaussian", "poisson", "logistic", "gamma", "inverse_gaussian", "tweedie(1.3)"]
)
def test_family_terms(family):
    rng = np.random.default_rng(5)
    eta = rng.standard_normal(50) * 0.3
    y = rng.random(50) + 0.2
    for got, want in zip(
        glm._family_terms(family, torch.tensor(eta), torch.tensor(y)),
        tpu_glm._family_terms(family, jnp.asarray(eta), jnp.asarray(y)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def test_fista_epoch():
    X, y, w, beta0 = _problem("gaussian", seed=6)
    got = glm.fista_epoch(
        torch.tensor(X), torch.tensor(y), torch.tensor(w), torch.tensor(beta0), 0.01,
        n_steps=20, l1=0.05, l2=0.1,
    )
    want = tpu_glm.fista_epoch(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.asarray(beta0),
        jnp.asarray(0.01), n_steps=20, l1=0.05, l2=0.1,
    )
    assert _rel(got, want) < 1e-10


def test_cg_no_nan_past_convergence():
    A = torch.eye(3, dtype=torch.float64)
    b = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    x = glm._cg_solve(lambda v: A @ v, b, 50)
    assert torch.all(torch.isfinite(x))
    torch.testing.assert_close(x, b)


@pytest.mark.parametrize("kind", ["numpy", "tensor", "dense", "standardized"])
@pytest.mark.parametrize("inner", ["float64", "float32"])
def test_fit_glm(kind, inner):
    X, y, w, _ = _problem("poisson", seed=7)
    if kind == "numpy":
        ref_X, port_X = X, X
    elif kind == "tensor":
        ref_X, port_X = jnp.asarray(X), torch.tensor(X)
    else:
        ref_X = tm.DenseMatrix(X)
        if kind == "standardized":
            ref_X, _, _ = ref_X.standardize(np.full(len(y), 1 / len(y)), True, True)
        port_X = from_tabmat_tpu(ref_X)
    kw = dict(sample_weight=w, family="poisson", max_iter=6, tol=0.0, n_cg=10, inner_precision=inner)
    got, n_got = tt.fit_glm(port_X, y, **kw)
    want, n_want = tpu_glm.fit_glm(ref_X, y, **kw)
    assert n_got == n_want == 6
    assert _rel(got, want) < STEP_RTOL[inner]


def test_fit_glm_elastic_net_and_penalties():
    X, y, _, _ = _problem("gaussian", seed=8)
    p = np.linspace(0.5, 1.5, X.shape[1])
    kw = dict(family="gaussian", max_iter=5, tol=0.0, l1=0.01, l2=0.1, P1=p, P2=p)
    got, _ = tt.fit_glm(X, y, **kw)
    want, _ = tpu_glm.fit_glm(X, y, **kw)
    assert _rel(got, want) < 1e-9
    with pytest.raises(NotImplementedError):
        tt.fit_glm(X, y, l1=0.1, l2=0.1, P1=p, P2=2 * p)


@pytest.mark.parametrize("kind", ["numpy", "tensor", "dense"])
@pytest.mark.parametrize("family", ["gaussian", "poisson"])
def test_estimator(kind, family):
    X, y, _, _ = _problem(family, seed=9)
    port_X = {"numpy": X, "tensor": torch.tensor(X), "dense": tt.DenseMatrix(X)}[kind]
    kw = dict(family=family, n_cg=20, max_iter=8, l2=0.01)
    got = tt.GeneralizedLinearRegressor(**kw).fit(port_X, y)
    want = tm.GeneralizedLinearRegressor(**kw).fit(X, y)
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.intercept_, want.intercept_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.predict(port_X), want.predict(X), rtol=1e-4, atol=1e-6)
    carried = from_tabmat_tpu(want)
    np.testing.assert_allclose(carried.predict(X), want.predict(X), rtol=1e-12)


def test_estimator_standardized_without_intercept():
    X, y, _, _ = _problem("gaussian", seed=12)
    std_ref, _, _ = tm.DenseMatrix(X).standardize(np.full(len(y), 1 / len(y)), True, True)
    std_port = from_tabmat_tpu(std_ref)
    got = tt.GeneralizedLinearRegressor(fit_intercept=False, n_cg=20, max_iter=6).fit(std_port, y)
    want = tm.GeneralizedLinearRegressor(fit_intercept=False, n_cg=20, max_iter=6).fit(std_ref, y)
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=1e-4, atol=1e-6)
    with pytest.raises(NotImplementedError, match="A3"):
        tt.GeneralizedLinearRegressor().fit(std_port, y)


def test_beta_conversion():
    beta = jnp.asarray(np.arange(4.0))
    got = from_tabmat_tpu(beta)
    assert torch.is_tensor(got) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.arange(4.0))


def test_not_ported_inputs_raise():
    import pandas as pd

    with pytest.raises(ValueError, match="Unknown family"):
        tt.fit_glm(np.ones((4, 1)), np.ones(4), family="bogus")
    with pytest.raises(ValueError, match="Unknown family"):
        tt.GeneralizedLinearRegressor(family="bogus")
    with pytest.raises(NotImplementedError, match="A5"):
        tt.GeneralizedLinearRegressor().fit(pd.DataFrame({"x": [1.0, 2.0]}), [1.0, 2.0])
    with pytest.raises(NotImplementedError, match="A5"):
        tt.GeneralizedLinearRegressor(formula="y ~ x").fit(np.ones((2, 1)), [1.0, 2.0])
    with pytest.raises(NotImplementedError, match="A2-A4"):
        DeviceDesign.from_matrix(object())
    with pytest.raises(NotImplementedError, match="A2-A4"):
        from_tabmat_tpu(tm.CategoricalMatrix(np.array([0, 1, 0])))
