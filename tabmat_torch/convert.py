"""Carry ``tabmat_tpu`` objects across to their tabmat_torch twins.

The conversion duck-types the reference objects and goes through host
numpy, so this module never imports JAX: a ``DenseMatrix`` is read through
``unpack()`` and its names, a ``SparseMatrix`` through its CSC arrays and
names, a ``CategoricalMatrix`` through its codes,
categories, ``drop_first``, missing method and names, a ``SplitMatrix``
through its blocks and their column indices, a ``StandardizedMatrix``
through ``mat``, ``shift`` and ``mult``, a fitted
``GeneralizedLinearRegressor`` through its parameters,
``coef_``/``intercept_``/``n_iter_`` and the formula spec it kept, a
``parallel.MixedDesign`` through its arrays, and an array (a beta, say)
becomes a tensor.  A matrix built from a formula keeps
its ``model_spec``: the port's ``FormulaModelSpec`` with the same terms,
factor states (numpy and Python values, and the contrast codings) and
options, and the device, so that ``get_model_matrix`` re-encodes a new frame
on the port as the JAX package does.
"""

import dataclasses

import numpy as np

from ._config import resolve_device
from .formula import contrasts, engine, parser
from .glm import GeneralizedLinearRegressor
from .models.categorical import CategoricalMatrix
from .models.dense import DenseMatrix
from .models.sparse import SparseMatrix
from .models.split import SplitMatrix
from .models.standardized import StandardizedMatrix
from .parallel.distributed import FIELDS as MIXED_FIELDS
from .parallel.distributed import MixedDesign
from .utils.arrays import to_tensor

_ESTIMATOR_PARAMS = (
    "family", "l2", "l1", "fit_intercept", "max_iter", "tol", "n_cg",
    "inner_precision", "formula",
)


def _fields(obj, cls) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def _factor_state(state):
    fields = _fields(state, engine.FactorState)
    spec = fields["contrasts"]
    if spec is not None:
        fields["contrasts"] = contrasts.ContrastSpec(**_fields(spec, contrasts.ContrastSpec))
    return engine.FactorState(**fields)


def _model_spec(spec, device):
    """The port's FormulaModelSpec of a ``tabmat_tpu`` one, building on ``device``."""
    return engine.FormulaModelSpec(
        formula=spec.formula,
        terms=[parser.Term(tuple(term.factors)) for term in spec.terms],
        intercept=spec.intercept,
        factor_states={name: _factor_state(s) for name, s in spec.factor_states.items()},
        options={**spec.options, "device": device},
        column_names=tuple(spec.column_names),
        term_names=tuple(spec.term_names),
    )


def from_tabmat_tpu(obj, device=None):
    """The tabmat_torch twin of a ``tabmat_tpu`` matrix, estimator or array.

    ``device=None`` means the CUDA card; ``device="cpu"`` asks for the CPU.
    """
    converted = _convert(obj, device)
    spec = getattr(obj, "model_spec", None)
    if spec is not None:
        converted.model_spec = _model_spec(spec, resolve_device(device))
    return converted


def _convert(obj, device):
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
    if kind == "SparseMatrix":
        from scipy import sparse as sps

        return SparseMatrix(
            sps.csc_matrix((np.asarray(obj.data), np.asarray(obj.indices),
                            np.asarray(obj.indptr)), shape=obj.shape),
            column_names=obj.get_names("column"),
            term_names=obj.get_names("term"),
            device=device,
        )
    if kind == "CategoricalMatrix":
        return CategoricalMatrix(
            np.asarray(obj.indices),
            categories=np.asarray(obj.categories),
            drop_first=obj.drop_first,
            dtype=obj.dtype,
            column_name=obj._colname,
            term_name=obj._term,
            column_name_format=obj._colname_format,
            cat_missing_method=obj._missing_method,
            cat_missing_name=obj._missing_category,
            device=device,
        )
    if kind == "SplitMatrix":
        return SplitMatrix(
            [from_tabmat_tpu(m, device) for m in obj.matrices],
            [np.asarray(idx) for idx in obj.indices],
        )
    if kind == "GeneralizedLinearRegressor":
        est = GeneralizedLinearRegressor(
            **{name: getattr(obj, name) for name in _ESTIMATOR_PARAMS}, device=device
        )
        for name in ("coef_", "intercept_", "n_iter_", "feature_names_"):
            if hasattr(obj, name):
                value = getattr(obj, name)
                setattr(est, name, np.asarray(value) if name == "coef_" else value)
        if getattr(obj, "_formula_spec", None) is not None:
            est._formula_spec = _model_spec(obj._formula_spec, resolve_device(device))
        return est
    if kind == "MixedDesign":
        return MixedDesign(**{name: to_tensor(np.asarray(getattr(obj, name)), device=device)
                              for name in MIXED_FIELDS})
    if hasattr(obj, "__array__"):
        return to_tensor(np.asarray(obj), device=device)
    raise NotImplementedError(f"converting a tabmat_tpu {kind} is not supported")
