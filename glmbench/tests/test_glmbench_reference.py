"""The plain reference: its IRLS against a closed-form fit, its designs
against explicit one-hot matrices."""

import numpy as np
import pandas as pd

from glmbench.data.fremtpl2 import freq_frame
from glmbench.reference.designs import DenseCatDesign, FormulaDesign, relerr
from glmbench.reference.irls import irls
from glmbench import spec


class _Dense:
    def __init__(self, X):
        self.X, self.shape = X, X.shape

    def matvec(self, v):
        return self.X @ v

    def tmv(self, r):
        return self.X.T @ r

    def hessian(self, w):
        return (self.X * w[:, None]).T @ self.X


def test_irls_matches_the_closed_form_gaussian_ridge_fit():
    rng = np.random.default_rng(0)
    X = np.c_[np.ones(300), rng.standard_normal((300, 6))]
    y = X @ rng.standard_normal(7) + 0.1 * rng.standard_normal(300)
    w = rng.random(300) + 0.5
    ps = np.r_[0.0, np.ones(6)]
    beta, steps = irls(_Dense(X), y, w, "gaussian", l2=3.0, ps=ps)
    closed = np.linalg.solve((X * w[:, None]).T @ X + 3.0 * np.diag(ps), X.T @ (w * y))
    assert relerr(beta, closed) < 1e-13
    assert steps <= 3


def test_irls_poisson_reaches_the_optimum():
    rng = np.random.default_rng(1)
    X = np.c_[np.ones(2000), rng.standard_normal((2000, 3))]
    y = rng.poisson(np.exp(X @ np.array([0.3, 0.2, -0.1, 0.05]))).astype(float)
    beta, _ = irls(_Dense(X), y, np.ones(2000), "poisson", l2=1.0)
    grad = X.T @ (y - np.exp(X @ beta)) - 1.0 * beta
    assert np.abs(grad).max() < 1e-9


def test_dense_cat_design_is_its_explicit_one_hot_matrix():
    rng = np.random.default_rng(2)
    n, levels = 400, [7, 5]
    dense = rng.standard_normal((n, 3))
    codes = [rng.integers(0, m, n) for m in levels]
    X = np.hstack([dense] + [np.eye(m)[c] for c, m in zip(codes, levels)])
    ref = DenseCatDesign(dense, codes, levels)
    v, r, d = rng.standard_normal(X.shape[1]), rng.standard_normal(n), rng.random(n)
    assert relerr(ref.matvec(v), X @ v) < 1e-14
    assert relerr(ref.tmv(r), X.T @ r) < 1e-14
    assert relerr(ref.hessian(d), (X * d[:, None]).T @ X) < 1e-14


def test_formula_design_has_the_formulas_43_columns():
    config = spec.find("fremtpl2.refit")["config"]
    frame = freq_frame(3000, np.random.default_rng(3), config["levels"])
    X = FormulaDesign(frame, config["levels"]).X
    assert X.shape == (3000, config["columns"])
    one_hot = X[:, 5:-1]
    # each categorical's kept columns hold at most one 1 a row
    assert set(np.unique(one_hot)) <= {0.0, 1.0}
    assert np.allclose(X[:, -1], np.log(frame["Density"]))
    assert isinstance(frame["Region"].dtype, pd.CategoricalDtype)
