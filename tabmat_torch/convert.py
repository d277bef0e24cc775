"""Carry ``tabmat_tpu`` objects across to their tabmat_torch twins.

The conversion duck-types the reference objects and goes through host
numpy, so this module never imports JAX: a ``DenseMatrix`` is read through
``unpack()`` and its names, a ``StandardizedMatrix`` through ``mat``,
``shift`` and ``mult``, a fitted ``GeneralizedLinearRegressor`` through its
parameters and ``coef_``/``intercept_``/``n_iter_``, and an array (a beta,
say) becomes a tensor.
"""

import numpy as np

from .glm import GeneralizedLinearRegressor
from .models.dense import DenseMatrix
from .models.standardized import StandardizedMatrix
from .utils.arrays import to_tensor

_ESTIMATOR_PARAMS = (
    "family", "l2", "l1", "fit_intercept", "max_iter", "tol", "n_cg",
    "inner_precision",
)


def from_tabmat_tpu(obj, device=None):
    """The tabmat_torch twin of a ``tabmat_tpu`` matrix, estimator or array.

    ``device=None`` means ``torch.get_default_device()``.
    """
    kind = type(obj).__name__
    if kind == "StandardizedMatrix":
        return StandardizedMatrix(
            from_tabmat_tpu(obj.mat, device),
            np.asarray(obj.shift),
            None if obj.mult is None else np.asarray(obj.mult),
        )
    if kind == "DenseMatrix":
        return DenseMatrix(
            np.asarray(obj.unpack()),
            column_names=obj.get_names("column"),
            term_names=obj.get_names("term"),
            device=device,
        )
    if kind == "GeneralizedLinearRegressor":
        est = GeneralizedLinearRegressor(
            **{name: getattr(obj, name) for name in _ESTIMATOR_PARAMS}
        )
        for name in ("coef_", "intercept_", "n_iter_"):
            if hasattr(obj, name):
                value = getattr(obj, name)
                setattr(est, name, np.asarray(value) if name == "coef_" else value)
        return est
    if hasattr(obj, "__array__"):
        return to_tensor(np.asarray(obj), device=device)
    raise NotImplementedError(
        f"converting a tabmat_tpu {kind} is not supported yet: categorical, "
        "sparse and split matrices are ROADMAP A2-A4"
    )
