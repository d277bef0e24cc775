"""StandardizedMatrix: a virtual shift/scale view over any MatrixBase.

Port of ``tabmat_tpu/models/standardized.py``.  The view is
``self[i, j] = mult[j] * mat[i, j] + shift[j]`` and is never densified:
every op expands into the inner matrix's op plus rank-1 corrections —

sandwich:  ``S = M ∘ (mat.sandwich)  +  outer(mult*t, shift)
            + outer(shift, mult*t)  +  outer(shift, shift) * sum(d)``
where ``t = mat.transpose_matvec(d)`` and ``M = outer(mult, mult)``.

The rank-1 algebra runs in numpy for numpy callers and in torch, on the
caller's device, for tensor callers; the inner sandwich runs the kernel
either way.
"""

from typing import Optional, Union

import numpy as np
import torch

from ..ops.diag import DiagonalResult
from ..utils import (
    as_numpy_dtype,
    as_torch_dtype,
    check_matvec_dimensions,
    check_sandwich_compatible,
    check_transpose_matvec_out_shape,
    is_identity_index,
    set_up_rows_or_cols,
    to_numpy,
)
from .base import MatrixBase


def _is_diag(x) -> bool:
    if isinstance(x, DiagonalResult):
        return True
    from scipy import sparse as sps

    return isinstance(x, sps.dia_matrix)


def _diag_data(x) -> np.ndarray:
    if isinstance(x, DiagonalResult):
        return to_numpy(x.diag)
    return np.asarray(x.data[0, :])


def _outer(a, b):
    """``np.outer`` semantics (inputs flattened) for arrays and tensors."""
    if torch.is_tensor(a):
        return torch.outer(a.reshape(-1), b.reshape(-1))
    return np.outer(a, b)


class StandardizedMatrix:
    """Shift/scale view: ``self[i, j] = mult[j] * mat[i, j] + shift[j]``."""

    __array_priority__ = 11

    def __init__(self, mat: MatrixBase, shift, mult=None):
        shift_arr = np.atleast_1d(np.squeeze(to_numpy(shift)))
        expected_shape = (mat.shape[1],)
        if not isinstance(mat, MatrixBase):
            raise TypeError("mat should be an instance of a MatrixBase subclass.")
        if shift_arr.shape != expected_shape:
            raise ValueError(
                f"Expected shift to conform to shape {expected_shape}, "
                f"but it has shape {np.asarray(shift).shape}"
            )
        if mult is not None:
            mult_arr = np.atleast_1d(np.squeeze(to_numpy(mult)))
            if mult_arr.shape != expected_shape:
                raise ValueError(
                    f"Expected mult to conform to shape {expected_shape}, "
                    f"but it has shape {np.asarray(mult).shape}"
                )
        else:
            mult_arr = None

        self.shift = shift_arr
        self.mult = mult_arr
        self.mat = mat
        self.shape = mat.shape
        self.ndim = mat.ndim
        self.dtype = mat.dtype

    def _params(self, like):
        """``(like, shift, mult)`` in one flavour.

        numpy ``like`` gets the numpy parameters.  A tensor ``like`` gets
        tensors on its device, all in the promoted dtype (numpy and JAX
        promote mixed dtypes; torch's matmul does not).
        """
        if not torch.is_tensor(like):
            return like, self.shift, self.mult
        dtype = torch.promote_types(like.dtype, as_torch_dtype(self.shift.dtype))
        shift = torch.as_tensor(self.shift, device=like.device, dtype=dtype)
        mult = None
        if self.mult is not None:
            mult = torch.as_tensor(self.mult, device=like.device, dtype=dtype)
        return like.to(dtype), shift, mult

    @property
    def device(self):
        """The device of the inner matrix."""
        return self.mat.device

    # -- core ops --------------------------------------------------------

    def matvec(self, other_mat, cols: Optional[np.ndarray] = None, out=None):
        """``self[:, cols] @ other[cols]`` (dense output)."""
        other = other_mat if torch.is_tensor(other_mat) else np.asarray(other_mat)
        check_matvec_dimensions(self, other, transpose=False)

        k = self.shape[1]
        full_cols = cols is None or len(cols) == k
        cols = None if full_cols else set_up_rows_or_cols(cols, k, np.int64)
        other, shift, mult = self._params(other)

        mult_other = other
        if mult is not None:
            for _ in range(other.ndim - 1):
                mult = mult[:, None]
            mult_other = mult * other

        mat_part = self.mat.matvec(mult_other, cols, out=out)
        if full_cols:
            shift_part = shift @ other
        else:
            idx = cols if not torch.is_tensor(other) else torch.as_tensor(cols, device=other.device)
            shift_part = shift[idx] @ other[idx]
        if torch.is_tensor(mat_part):
            # in place: a tensor ``out`` was already updated by the inner op
            return mat_part.add_(shift_part.to(mat_part.dtype))
        if isinstance(mat_part, np.ndarray) and mat_part.flags.writeable:
            mat_part += np.asarray(shift_part)
            return mat_part
        return mat_part + shift_part

    def transpose_matvec(
        self,
        other,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ):
        """``self[rows, cols].T @ other[rows]``.

        The shift contributes ``outer(shift[cols], other[rows].sum(0))``.
        """
        check_transpose_matvec_out_shape(self, out)
        other = other if torch.is_tensor(other) else np.asarray(other)
        check_matvec_dimensions(self, other, transpose=True)
        is_t = torch.is_tensor(other)

        res = self.mat.transpose_matvec(other, rows, cols)

        # no row index array without a row restriction: np.arange(n) would be
        # the call's only host allocation of n elements
        cols_idx = set_up_rows_or_cols(cols, self.shape[1], np.int64)
        full_cols = is_identity_index(cols, self.shape[1])
        if rows is None or len(rows) == self.shape[0]:
            other_sum = other.sum(0)
        else:
            rows_idx = set_up_rows_or_cols(rows, self.shape[0], np.int64)
            ridx = torch.as_tensor(rows_idx, device=other.device) if is_t else rows_idx
            other_sum = other[ridx].sum(0)

        other, shift, mult = self._params(other)
        other_sum = other_sum.to(shift.dtype) if is_t else other_sum
        cidx = torch.as_tensor(cols_idx, device=other.device) if is_t else cols_idx
        shift_lim = shift if full_cols else shift[cidx]
        output_shape = (
            (self.shape[1] if cols is None else len(cols_idx)),
        ) + tuple(res.shape[1:])
        shift_part = _outer(shift_lim, other_sum).reshape(output_shape)

        if mult is not None:
            mult_lim = mult if full_cols else mult[cidx]
            for _ in range(res.ndim - 1):
                mult_lim = mult_lim[:, None]
            res = res * mult_lim
        res = res + shift_part

        if out is None:
            return res
        if isinstance(out, np.ndarray):
            out[cols_idx] += to_numpy(res).astype(out.dtype, copy=False)
            return out
        oidx = torch.as_tensor(cols_idx, device=out.device)
        out[oidx] += res.to(device=out.device, dtype=out.dtype)
        return out

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ):
        """Four-term expansion of the standardized sandwich.

        A numpy ``d`` gets a host numpy result; a tensor ``d`` gets a tensor
        on its own device, with no download.
        """
        if not hasattr(d, "dtype"):
            d = np.asarray(d)
        check_sandwich_compatible(self, d)

        if rows is not None:
            rows = set_up_rows_or_cols(rows, self.shape[0], np.int64)
        if cols is not None:
            cols = set_up_rows_or_cols(cols, self.shape[1], np.int64)

        term1 = self.mat.sandwich(d, rows, cols)
        d_mat = self.mat.transpose_matvec(d, rows, cols)
        d, shift, mult = self._params(d)
        if torch.is_tensor(d):
            idx = None if cols is None else torch.as_tensor(cols, device=d.device)
            d_rows = d if rows is None else d[torch.as_tensor(rows, device=d.device)]
        else:
            idx = cols
            d_rows = d if rows is None else d[rows]
            d_mat = to_numpy(d_mat)
        limited_shift = shift if idx is None else shift[idx]
        limited_mult = None
        if mult is not None:
            limited_mult = mult if idx is None else mult[idx]
            d_mat = d_mat * limited_mult

        res = (
            _outer(d_mat, limited_shift)
            + _outer(limited_shift, d_mat)
            + _outer(limited_shift, limited_shift) * d_rows.sum()
        )
        if _is_diag(term1):
            if torch.is_tensor(d):
                diag = term1.diag.to(d.dtype)
            else:
                diag = _diag_data(term1)
            if limited_mult is not None:
                diag = diag * limited_mult**2
            return res + (torch.diag(diag) if torch.is_tensor(d) else np.diag(diag))
        if torch.is_tensor(d):
            term1 = term1.to(d.dtype)
        if limited_mult is not None:
            term1 = term1 * _outer(limited_mult, limited_mult)
        return res + term1

    # -- conversions / plumbing -------------------------------------------

    def unstandardize(self) -> MatrixBase:
        """Return the inner (unstandardized) matrix."""
        return self.mat

    def getcol(self, i: int):
        """Column ``i`` as a StandardizedMatrix over the inner column."""
        mult = None
        if self.mult is not None:
            mult = [self.mult[i]]
        col = self.mat.getcol(i)
        return StandardizedMatrix(col, [self.shift[i]], mult)

    def toarray(self) -> np.ndarray:
        """Densify: ``mult * mat + shift``."""
        mat_part = self.mat.toarray()
        if self.mult is not None:
            mat_part = self.mult[None, :] * mat_part
        return mat_part + self.shift[None, :]

    @property
    def A(self) -> np.ndarray:
        """Alias for toarray()."""
        return self.toarray()

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Cast the inner matrix, shift and mult."""
        np_dtype = as_numpy_dtype(dtype)
        return type(self)(
            self.mat.astype(dtype, casting=casting, copy=copy),
            self.shift.astype(np_dtype, order=order, casting=casting, copy=copy),
            self.mult if self.mult is None else self.mult.astype(np_dtype),
        )

    def multiply(self, other):
        """Row-wise scaling (densifies)."""
        from .dense import DenseMatrix

        return DenseMatrix(self.toarray(), device=self.mat.device).multiply(other)

    def __matmul__(self, other):
        return self.matvec(other)

    def __rmatmul__(self, other):
        if not hasattr(other, "T"):
            other = np.asarray(other)
        return self.transpose_matvec(other.T).T

    def __getitem__(self, item):
        if isinstance(item, tuple):
            row, col = item
        else:
            row = item
            col = slice(None, None, None)

        mat_part = self.mat.__getitem__(item)
        shift_part = self.shift[col]
        mult_part = self.mult
        if mult_part is not None:
            mult_part = np.atleast_1d(mult_part[col])

        if isinstance(row, int):
            out = mat_part.toarray()
            if mult_part is not None:
                out = out * mult_part
            return out + shift_part

        return StandardizedMatrix(mat_part, np.atleast_1d(shift_part), mult_part)

    def __repr__(self):
        return (
            f"StandardizedMat. Mat: {type(self.mat)} of shape {self.mat.shape}.\n"
            f"Shift: {self.shift}\nMult: {self.mult}"
        )

    # -- names -------------------------------------------------------------

    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """Delegate to the inner matrix."""
        return self.mat.get_names(type, missing_prefix, indices)

    def set_names(self, names: Union[str, list[Optional[str]]], type: str = "column"):
        """Delegate to the inner matrix."""
        self.mat.set_names(names, type)

    @property
    def column_names(self):
        """Column names of the inner matrix."""
        return self.get_names(type="column")

    @column_names.setter
    def column_names(self, names):
        self.set_names(names, type="column")

    @property
    def term_names(self):
        """Term names of the inner matrix."""
        return self.get_names(type="term")

    @term_names.setter
    def term_names(self, names):
        self.set_names(names, type="term")
