"""tabmat's ``sparse_wide`` design standardized as glum does it.

The design is ``sparse_wide``'s (``sparse_wide.make``, from the run's
seed).  glum, fitting with an intercept, first calls tabmat's
``MatrixBase.standardize(weights, center_predictors, scale_predictors)``
and then multiplies the ``StandardizedMatrix`` it returns; the
configuration's ``standardize`` gives the three arguments, the weights as
``"1/n"`` (every row alike, summing to one).
"""

import numpy as np

from glmbench.data import sparse_wide

make = sparse_wide.make
penalty_scale = sparse_wide.penalty_scale


def weights(config: dict) -> np.ndarray:
    """The standardization's row weights: ``"1/n"`` is the only kind."""
    kind = config["standardize"]["weights"]
    if kind != "1/n":
        raise ValueError(f"no weights {kind!r}")
    return np.full(config["rows"], 1.0 / config["rows"])


def to_program(tt, data: dict, config: dict, dtype, device):
    """The program's matrix: a ``SparseMatrix`` of the CSC in ``dtype``,
    standardized by its own ``standardize``."""
    std = config["standardize"]
    X = tt.SparseMatrix(data["csc"].astype(dtype), device=device)
    return X.standardize(weights(config), std["center_predictors"], std["scale_predictors"])[0]


def reference_design(data: dict, config: dict):
    from glmbench.reference.standardized import StandardizedDesign

    X, std = data["csc"], config["standardize"]
    return StandardizedDesign(X.indptr, X.indices, X.data, X.shape, weights(config),
                              std["center_predictors"], std["scale_predictors"])
