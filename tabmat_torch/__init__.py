"""tabmat_torch: the PyTorch and CUDA port of tabmat-tpu.

The same matrix API as ``tabmat_tpu`` — ``matvec``, ``transpose_matvec``
and the sandwich product ``Xᵀ diag(d) X`` with active-set restriction,
weighted standardization, and the GLM solver on top — held in torch
tensors.  On a CUDA device the sandwich runs a hand-written Hopper kernel
(``csrc/sandwich.cu``), built with ``nvcc`` at first use.

This slice carries the dense main path: ``DenseMatrix``,
``StandardizedMatrix`` over it, ``hstack``/``as_tabmat`` for dense inputs,
and ``fit_glm``/``GeneralizedLinearRegressor``.  It never imports JAX.
"""

from .models import (  # noqa: F401
    DenseMatrix,
    MatrixBase,
    StandardizedMatrix,
    as_tabmat,
    hstack,
)
from .ops.diag import DiagonalResult  # noqa: F401
from .glm import GeneralizedLinearRegressor, fit_glm  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "DenseMatrix",
    "MatrixBase",
    "StandardizedMatrix",
    "DiagonalResult",
    "as_tabmat",
    "hstack",
    "GeneralizedLinearRegressor",
    "fit_glm",
]
