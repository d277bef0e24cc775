"""``MatrixBase``: the abstract contract shared by every matrix type.

Port of ``tabmat_tpu/models/base.py``.  The contract is three
linear-algebra ops with active-set restriction —

- ``matvec(vec, cols, out)``:            ``X[:, cols] @ vec[cols]``
- ``transpose_matvec(vec, rows, cols)``: ``X[rows, cols].T @ vec[rows]``
- ``sandwich(d, rows, cols)``:           ``X[rows, cols].T @ diag(d[rows]) @ X[rows, cols]``

— plus conversion (``toarray``/``astype``/``getcol``/``__getitem__``),
weighted standardization, and the column/term names API.  ``out=`` follows
the conventions in ``utils.arrays``: numpy and tensor buffers are both
updated in place.
"""

from abc import ABC, abstractmethod
from typing import Any, Optional, Union

import numpy as np

from ..utils.arrays import to_numpy


class MatrixBase(ABC):
    """Abstract base for all tabmat_torch matrix classes."""

    ndim = 2
    shape: tuple[int, int]
    dtype: np.dtype

    # Outrank numpy arrays so `np_array @ mat` defers to our __rmatmul__.
    __array_priority__ = 11

    @abstractmethod
    def matvec(self, other, cols: Optional[np.ndarray] = None, out=None):
        """Compute ``self[:, cols] @ other[cols]``.

        ``cols`` restricts to a column active-set without copying.  If
        ``out`` is given, the result is accumulated into it in place and
        ``out`` is returned.
        """

    @abstractmethod
    def transpose_matvec(
        self,
        vec,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ):
        """Compute ``self[rows, cols].T @ vec[rows]``.

        The output has length ``len(cols)`` (or ``shape[1]`` if ``cols`` is
        None).  With ``out`` provided the accumulation is
        ``out[cols[i]] += sum_{j in rows} self[j, cols[i]] * vec[j]``.
        """

    @abstractmethod
    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ):
        """Compute the sandwich product ``(self[rows, cols].T * d[rows]) @ self[rows, cols]``."""

    def __matmul__(self, other):
        """``self @ other`` delegates to matvec."""
        return self.matvec(other)

    def __rmatmul__(self, other):
        """``other @ self`` == ``(self.T @ other.T).T``."""
        if not hasattr(other, "T"):
            other = np.asarray(other)
        return self.transpose_matvec(other.T).T

    @abstractmethod
    def getcol(self, i: int):
        """Return column ``i`` as a single-column matrix."""

    @abstractmethod
    def toarray(self) -> np.ndarray:
        """Densify to a host numpy array."""

    @property
    def A(self) -> np.ndarray:
        """Alias for ``toarray()``."""
        return self.toarray()

    @abstractmethod
    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Return a copy cast to ``dtype``."""

    @abstractmethod
    def __getitem__(self, item):
        pass

    # ------------------------------------------------------------------
    # standardization (reference matrix_base.py:118-167)
    # ------------------------------------------------------------------

    def _get_col_means(self, weights) -> np.ndarray:
        """Weighted column means: a transpose-matvec with the weights."""
        return to_numpy(self.transpose_matvec(weights))

    @abstractmethod
    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Weighted column standard deviations."""

    def standardize(
        self, weights, center_predictors: bool, scale_predictors: bool
    ) -> tuple[Any, np.ndarray, Optional[np.ndarray]]:
        """Build a ``StandardizedMatrix`` view with zero-mean/unit-std columns.

        Returns ``(standardized, col_means, col_stds)``.  If
        ``center_predictors`` is False, the means returned are zeros; if
        ``scale_predictors`` is False, ``col_stds`` is None.  Columns with
        (near-)zero variance get a multiplier of 1 instead of 1/0.
        """
        from .standardized import StandardizedMatrix

        col_means = self._get_col_means(weights)
        if scale_predictors:
            col_stds = self._get_col_stds(weights, col_means)
            mult = one_over_var_inf_to_val(col_stds, 1.0)
            if center_predictors:
                shifter = -col_means * mult
                out_means = col_means
            else:
                shifter = np.zeros_like(col_means)
                out_means = shifter
        else:
            col_stds = None
            mult = None
            if center_predictors:
                shifter = -col_means
                out_means = col_means
            else:
                shifter = np.zeros_like(col_means)
                out_means = shifter

        return StandardizedMatrix(self, shifter, mult), out_means, col_stds

    # ------------------------------------------------------------------
    # names API (reference matrix_base.py:169-241)
    # ------------------------------------------------------------------

    @abstractmethod
    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """Return column (or term) names; unnamed columns get
        ``f"{missing_prefix}{index}"`` when a prefix is supplied."""

    @abstractmethod
    def set_names(self, names: Union[str, list[Optional[str]]], type: str = "column"):
        """Set column (or term) names."""

    @property
    def column_names(self):
        """Column names (one per matrix column)."""
        return self.get_names(type="column")

    @column_names.setter
    def column_names(self, names):
        self.set_names(names, type="column")

    @property
    def term_names(self):
        """Term names (a categorical block is a single term)."""
        return self.get_names(type="term")

    @term_names.setter
    def term_names(self, names):
        self.set_names(names, type="term")


def one_over_var_inf_to_val(arr, val: float) -> np.ndarray:
    """Elementwise ``1/arr``, with (near-)zero entries mapped to ``val``.

    Entries with ``|arr| < 1e-7`` are treated as zero-variance and get
    multiplier ``val`` (reference ``tabmat/matrix_base.py:248-258``).
    """
    arr = np.asarray(arr)
    near_zero = np.abs(arr) < 1e-7
    with np.errstate(divide="ignore"):
        out = np.where(near_zero, val, 1.0 / np.where(near_zero, 1.0, arr))
    return out
