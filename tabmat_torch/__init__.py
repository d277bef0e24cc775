"""tabmat_torch: the PyTorch and CUDA port of tabmat-tpu.

The same matrix API as ``tabmat_tpu`` — ``matvec``, ``transpose_matvec``
and the sandwich product ``Xᵀ diag(d) X`` with active-set restriction,
weighted standardization, and the GLM solver on top — held in torch
tensors.  Arrays go to the CUDA card unless the caller asks for the CPU
(``device="cpu"``, or CPU tensors).  On the card the sandwich, the
categorical gather, the segment sum and the sparse segment product run
hand-written Hopper kernels (``csrc/*.cu``), built with ``nvcc`` at first
use.

The port carries ``DenseMatrix``, ``SparseMatrix``, ``CategoricalMatrix``,
``SplitMatrix`` of them, ``StandardizedMatrix``, ``hstack``/``as_tabmat``,
the dataframe and formula constructors ``from_df``/``from_pandas``/
``from_csc``/``from_formula``, and ``fit_glm``/``GeneralizedLinearRegressor``
on all of them (the estimator also on a DataFrame and with ``formula=``).
It never imports JAX.
"""

from .models import (  # noqa: F401
    CategoricalMatrix,
    DenseMatrix,
    MatrixBase,
    SparseMatrix,
    SplitMatrix,
    StandardizedMatrix,
    as_tabmat,
    hstack,
)
from .constructors import from_csc, from_df, from_pandas  # noqa: F401
from .formula import from_formula  # noqa: F401
from .ops.diag import DiagonalResult  # noqa: F401
from .glm import GeneralizedLinearRegressor, fit_glm  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "CategoricalMatrix",
    "DenseMatrix",
    "MatrixBase",
    "SparseMatrix",
    "SplitMatrix",
    "StandardizedMatrix",
    "DiagonalResult",
    "from_csc",
    "from_formula",
    "from_pandas",
    "from_df",
    "as_tabmat",
    "hstack",
    "GeneralizedLinearRegressor",
    "fit_glm",
]
