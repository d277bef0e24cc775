"""glum's standardized Poisson fit on tabmat's ``sparse_wide`` design.

The design is ``sparse_wide``'s (``sparse_wide.make``, from the run's
seed).  glum, fitting with an intercept, standardizes the predictors with
tabmat's ``MatrixBase.standardize(weights, center_predictors,
scale_predictors)`` and keeps the intercept outside them: the program's
matrix is ``StandardizedMatrix(hstack([1, X]), [0, shift], [1, mult])``,
the intercept's column of ones shifted by 0 and scaled by 1, and the
intercept is not penalised.

Upstream makes no response.  Here ``y ~ Poisson(exp(-0.5 + X b))`` with
``b ~ N(0, 0.1²)`` on the raw scale, drawn from the seed apart from the
design; the sample weights are 1.
"""

import numpy as np

from glmbench.data import sparse_wide, sparse_wide_std

INTERCEPT = -0.5
B_SD = 0.1

weights = sparse_wide_std.weights


def make(config: dict, seed: int, count: int) -> list:
    """``count`` datasets from ``seed``: ``sparse_wide.make``'s CSC, the
    response and the sample weights.  The response of dataset ``i`` comes
    from a stream of its own, ``SeedSequence(seed, spawn_key=(i, 0))``,
    which the design's draw does not touch."""
    out = []
    for i, data in enumerate(sparse_wide.make(config, seed, count)):
        rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(i, 0)))
        X = data["csc"]
        b = rng.normal(0.0, B_SD, X.shape[1])
        y = rng.poisson(np.exp(INTERCEPT + X @ b)).astype(np.float64)
        out.append({"csc": X, "y": y, "weights": np.ones(X.shape[0])})
    return out


def to_program(tt, data: dict, config: dict, dtype, device):
    """The program's matrix: the ``StandardizedMatrix`` of ``[1 | X]`` in
    ``dtype``, X's shift and multiplier from its own ``standardize``."""
    std = config["standardize"]
    X = tt.SparseMatrix(data["csc"].astype(dtype), device=device)
    Xs = X.standardize(weights(config), std["center_predictors"], std["scale_predictors"])[0]
    shift = np.zeros(X.shape[1] + 1, Xs.shift.dtype)
    shift[1:] = Xs.shift
    mult = np.ones_like(shift)
    if Xs.mult is not None:
        mult[1:] = Xs.mult
    ones = np.ones((X.shape[0], 1), dtype)
    return tt.StandardizedMatrix(tt.hstack([ones, X]), shift, mult)


def penalty_scale(config: dict, n_cols: int) -> np.ndarray:
    """1 on every column but the intercept (column 0), which is not penalised."""
    ps = np.ones(n_cols)
    ps[0] = 0.0
    return ps


def reference_design(data: dict, config: dict):
    from glmbench.reference.standardized_intercept import StandardizedInterceptDesign

    X, std = data["csc"], config["standardize"]
    return StandardizedInterceptDesign(X.indptr, X.indices, X.data, X.shape, weights(config),
                                       std["center_predictors"], std["scale_predictors"])
