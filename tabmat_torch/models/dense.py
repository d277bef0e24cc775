"""DenseMatrix: a dense matrix held in one torch tensor, with the MatrixBase API.

Port of ``tabmat_tpu/models/dense.py``.  The matrix lives in one
contiguous row-major tensor on its device; ``sandwich`` goes to the
hand-written CUDA kernel on a CUDA device (``ops.sandwich_kernel``) and to
its plain version on the CPU.  The reference's Ozaki and plane caches are
TPU-only machinery and have no counterpart here.
"""

import textwrap
from typing import Optional

import numpy as np
import torch

from ..ops import dense_ops
from ..utils import (
    _check_indexer,
    add_into_out,
    as_numpy_dtype,
    as_torch_dtype,
    check_matvec_dimensions,
    check_matvec_out_shape,
    check_sandwich_compatible,
    check_transpose_matvec_out_shape,
    cols_to_mask,
    is_identity_index,
    result_like,
    rows_to_mask,
    set_up_rows_or_cols,
    to_numpy,
    to_tensor,
)
from .base import MatrixBase


def _axis_index(key, length: int) -> np.ndarray:
    """An integer index array for a slice, an index array or a boolean mask."""
    return np.ascontiguousarray(np.arange(length)[key])


class DenseMatrix(MatrixBase):
    """A dense matrix stored in one contiguous torch tensor.

    ``device=None`` keeps a tensor input on its own device and puts other
    inputs on ``torch.get_default_device()``.

    Examples
    --------
    >>> import numpy as np, tabmat_torch as tt
    >>> X = tt.DenseMatrix(np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]))
    >>> X.shape
    (3, 2)
    >>> X.matvec(np.array([1.0, 10.0]))
    array([21., 43., 65.])
    >>> X.sandwich(np.array([1.0, 1.0, 1.0]))
    array([[35., 44.],
           [44., 56.]])
    """

    def __init__(self, input_array, column_names=None, term_names=None, device=None):
        arr = to_tensor(input_array, device=device)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        elif arr.ndim > 2:
            raise ValueError("Input array must be 1- or 2-dimensional")

        self._array = arr.contiguous()
        width = arr.shape[1]

        if column_names is not None:
            if len(column_names) != width:
                raise ValueError(
                    f"Expected {width} column names, got {len(column_names)}"
                )
            self._colnames = list(column_names)
        else:
            self._colnames = [None] * width

        if term_names is not None:
            if len(term_names) != width:
                raise ValueError(f"Expected {width} term names, got {len(term_names)}")
            self._terms = list(term_names)
        else:
            self._terms = self._colnames

    # -- array protocol ------------------------------------------------

    __array_ufunc__ = None

    @property
    def shape(self):
        """(n_rows, n_cols)."""
        return tuple(self._array.shape)

    @property
    def ndim(self):
        """Always 2 after construction."""
        return self._array.ndim

    @property
    def dtype(self):
        """Element dtype (numpy dtype object)."""
        return as_numpy_dtype(self._array.dtype)

    @property
    def device(self) -> torch.device:
        """The device holding the matrix."""
        return self._array.device

    def transpose(self):
        """Transposed copy as a DenseMatrix."""
        return type(self)(self._array.T)

    T = property(transpose)

    def _operand(self, x) -> torch.Tensor:
        """``x`` as a tensor on this matrix's device (dtype kept)."""
        return to_tensor(x, device=self._array.device)

    def _matmul_pair(self, v: torch.Tensor):
        """X and v promoted to a common dtype, as numpy and JAX promote."""
        dtype = torch.promote_types(self._array.dtype, v.dtype)
        return self._array.to(dtype), v.to(dtype)

    def __matmul__(self, other):
        X, v = self._matmul_pair(self._operand(other))
        return result_like(other, X @ v)

    def __rmatmul__(self, other):
        X, v = self._matmul_pair(self._operand(other))
        return result_like(other, v @ X)

    def __str__(self):
        return "{}x{} DenseMatrix:\n\n".format(*self.shape) + np.array_str(
            self.toarray()
        )

    def __repr__(self):
        class_name = type(self).__name__
        array_str = f"{class_name}({np.array2string(self.toarray(), separator=', ')})"
        return textwrap.indent(
            array_str,
            " " * (len(class_name) + 1),
            predicate=lambda line: not line.startswith(class_name),
        )

    def __getitem__(self, key):
        row, col = _check_indexer(key)
        colnames = np.array(self.column_names, dtype=object)[col].ravel().tolist()
        terms = np.array(self.term_names, dtype=object)[col].ravel().tolist()

        dev = self._array.device
        if isinstance(row, np.ndarray) and row.ndim == 2:
            # np.ix_ open mesh: advanced indexing broadcasts it to a block
            sub = self._array[
                torch.as_tensor(row, device=dev), torch.as_tensor(col, device=dev)
            ]
        else:
            n, k = self.shape
            r = torch.as_tensor(_axis_index(row, n), device=dev)
            c = torch.as_tensor(_axis_index(col, k), device=dev)
            sub = self._array.index_select(0, r).index_select(1, c)
        return type(self)(sub, column_names=colnames, term_names=terms)

    def getcol(self, i):
        """Column ``i`` as a (n, 1) DenseMatrix."""
        return type(self)(
            self._array[:, [i]],
            column_names=[self.column_names[i]],
            term_names=[self.term_names[i]],
        )

    def toarray(self) -> np.ndarray:
        """Host numpy copy."""
        return np.array(to_numpy(self._array))

    def unpack(self) -> torch.Tensor:
        """The underlying tensor."""
        return self._array

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Cast to ``dtype`` (numpy or torch; order/casting accepted for API parity)."""
        return type(self)(
            self._array.to(as_torch_dtype(dtype)),
            column_names=self.column_names,
            term_names=self.term_names,
        )

    def multiply(self, other):
        """Row-wise (1-d ``other``) or elementwise (2-d) scaling."""
        other_t = self._operand(other)
        if other_t.ndim == 1:
            other_t = other_t[:, None]
        return type(self)(
            self._array * other_t,
            column_names=self.column_names,
            term_names=self.term_names,
        )

    # -- core ops --------------------------------------------------------

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ):
        """``X[rows, cols].T @ diag(d[rows]) @ X[rows, cols]``."""
        d_t = self._operand(d)
        check_sandwich_compatible(self, d_t)
        mask = rows_to_mask(
            None if rows is None else set_up_rows_or_cols(rows, self.shape[0]),
            self.shape[0],
            d_t.dtype,
            self.device,
        )
        cols_np = None
        if not is_identity_index(cols, self.shape[1]):
            cols_np = set_up_rows_or_cols(cols, self.shape[1])
        S = dense_ops.sandwich_restricted(self._array, d_t, mask, cols_np)
        return result_like(d, S)

    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Weighted column standard deviations (shifted, robust form)."""
        dtype = self._array.dtype
        sqrt_arg = to_numpy(
            dense_ops.transpose_square_dot_weights(
                self._array,
                self._operand(weights).to(dtype),
                self._operand(col_means).to(dtype),
            )
        ).copy()
        # tiny negative values can appear from floating point error
        sqrt_arg[sqrt_arg < 0] = 0
        return np.sqrt(sqrt_arg)

    def _matvec_helper(self, vec, rows, cols, out, transpose: bool):
        X, v = self._matmul_pair(self._operand(vec))
        check_matvec_dimensions(self, v, transpose=transpose)

        n, k = self.shape
        unrestricted_rows = rows is None or len(rows) == n
        # matvec sums over the cols SET (order-free); transpose_matvec's
        # output is ORDERED by cols, so it needs the identity check
        unrestricted_cols = (
            is_identity_index(cols, k) if transpose
            else cols is None or len(cols) == k
        )

        if transpose:
            if not unrestricted_rows:
                m = rows_to_mask(set_up_rows_or_cols(rows, n), n, v.dtype, v.device)
                v = v * (m if v.ndim == 1 else m[:, None])
            res_full = dense_ops.transpose_matvec(X, v)
            if unrestricted_cols:
                if out is None:
                    return result_like(vec, res_full)
                return add_into_out(out, res_full)
            cols_np = set_up_rows_or_cols(cols, k, np.int64)
            res = res_full.index_select(0, torch.as_tensor(cols_np, device=X.device))
            if out is None:
                return result_like(vec, res)
            if isinstance(out, np.ndarray):
                out[cols_np] += to_numpy(res).astype(out.dtype, copy=False)
                return out
            idx = torch.as_tensor(cols_np, device=out.device)
            out[idx] += res.to(device=out.device, dtype=out.dtype)
            return out
        # matvec: only column restriction is supported by the contract; it
        # is equivalent to zeroing the unselected entries of vec
        if not unrestricted_cols:
            cm = cols_to_mask(set_up_rows_or_cols(cols, k), k, v.dtype, v.device)
            v = v * (cm if v.ndim == 1 else cm[:, None])
        res = dense_ops.matvec(X, v)
        if out is None:
            return result_like(vec, res)
        return add_into_out(out, res)

    def matvec(self, vec, cols: Optional[np.ndarray] = None, out=None):
        """``X[:, cols] @ vec[cols]``."""
        check_matvec_out_shape(self, out)
        return self._matvec_helper(vec, None, cols, out, False)

    def transpose_matvec(
        self,
        vec,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ):
        """``X[rows, cols].T @ vec[rows]``."""
        check_transpose_matvec_out_shape(self, out)
        return self._matvec_helper(vec, rows, cols, out, True)

    # -- names -----------------------------------------------------------

    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """Column/term names with optional default-name generation."""
        if type == "column":
            names = np.array(self._colnames, dtype=object)
        elif type == "term":
            names = np.array(self._terms, dtype=object)
        else:
            raise ValueError(f"Type must be 'column' or 'term', got {type}")

        if indices is None:
            indices = list(range(len(self._colnames)))
        if missing_prefix is not None:
            defaults = np.array(
                [f"{missing_prefix}{i}" for i in indices], dtype=object
            )
            missing = np.array([nm is None for nm in names.tolist()])
            names[missing] = defaults[missing]
        return names.tolist()

    def set_names(self, names, type: str = "column"):
        """Set column/term names (must match the column count)."""
        if isinstance(names, str):
            names = [names]
        if len(names) != self.shape[1]:
            raise ValueError(f"Length of names must be {self.shape[1]}")
        if type == "column":
            self._colnames = list(names)
        elif type == "term":
            self._terms = list(names)
        else:
            raise ValueError(f"Type must be 'column' or 'term', got {type}")
