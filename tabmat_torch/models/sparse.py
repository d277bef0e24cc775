"""SparseMatrix: a host CSC matrix with its CSR and CSC layouts on the device.

Port of ``tabmat_tpu/models/sparse.py``.  Construction, slicing and export
stay on the host as a ``scipy.sparse.csc_matrix`` with sorted indices and a
CSR twin; the first op uploads each layout once (int32 indices and indptr,
the data in the matrix's dtype) and every op is one launch of the sparse
segment product (``ops/spmv_kernel.py``) on the matrix's device:

- ``matvec``           → the CSR layout (segments = rows);
- ``transpose_matvec`` → the CSC layout (segments = columns);
- ``sandwich``         → the pair plan (within-row nonzero pairs keyed by
  column pair) while it fits its budgets, else the densified matrix on the
  device through the dense sandwich kernel; past both budgets (or where the
  device-cache ledger, ``_config.cache_charge``, refuses both) row panels of
  the CSR layout, each densified on the device and added in order into one
  (k, k) result by the dense sandwich's width dispatch (the FP64 tensor
  cores at the reference's ``sparse_wide``, 40k × 10k);
- cross vs dense       → the CSC layout with ``d`` as a per-row scale.

The reference's six tmv and five matvec routes (mirrors, plane caches,
windowed takes, the fused tmv, host OpenMP walks) are TPU or host machinery
and collapse into these.
"""

from typing import Optional

import numpy as np
import torch
from scipy import sparse as sps

from .._config import cache_charge, resolve_device
from ..ops import dense_ops, sparse_ops
from ..utils import (
    _check_indexer,
    add_into_out,
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
    tensor_bytes,
    to_numpy,
    to_tensor,
)
from .base import MatrixBase

# The densified matrix serves the sandwich up to this width and n·k
# elements; past them (and the pair plan's budgets) row panels of at most
# DENSE_SANDWICH_MAX_ELEMENTS elements do.
DENSE_SANDWICH_MAX_COLS = 4096
DENSE_SANDWICH_MAX_ELEMENTS = 1 << 28
# The pair plan serves the sandwich up to Σ_r nnz_r² pairs and k² segments.
PAIR_SANDWICH_MAX_PAIRS = 50_000_000
PAIR_SANDWICH_MAX_SEGMENTS = 1 << 26

_DEVICE_STATE = ("_csr", "_csc", "_pair", "_dense")


class SparseMatrix(MatrixBase):
    """CSC sparse matrix conforming to the MatrixBase interface.

    ``device=None`` puts the device layouts on the CUDA card (and raises
    without one); ``device="cpu"`` asks for the CPU.

    Examples
    --------
    >>> import numpy as np, tabmat_torch as tt
    >>> X = tt.SparseMatrix(np.array([[1.0, 0.0], [0.0, 2.0], [3.0, 0.0]]), device="cpu")
    >>> X.matvec(np.array([1.0, 10.0]))
    array([ 1., 20.,  3.])
    >>> X.sandwich(np.ones(3))
    array([[10.,  0.],
           [ 0.,  4.]])
    """

    def __init__(
        self,
        input_array,
        shape=None,
        dtype=None,
        copy=False,
        column_names=None,
        term_names=None,
        device=None,
    ):
        self._device = resolve_device(device)
        if torch.is_tensor(input_array):
            input_array = input_array.cpu().numpy()
        if isinstance(input_array, np.ndarray):
            if input_array.ndim == 1:
                input_array = input_array.reshape(-1, 1)
            elif input_array.ndim > 2:
                raise ValueError("Input array must be 1- or 2-dimensional")

        self._array = sps.csc_matrix(input_array, shape, dtype, copy)
        self.idx_dtype = max(self._array.indices.dtype, self._array.indptr.dtype)
        if self._array.indices.dtype != self.idx_dtype:
            self._array.indices = self._array.indices.astype(self.idx_dtype)
        if self._array.indptr.dtype != self.idx_dtype:
            self._array.indptr = self._array.indptr.astype(self.idx_dtype)
        if not self._array.has_sorted_indices:
            self._array.sort_indices()
        self._array_csr = None

        if column_names is not None:
            if len(column_names) != self.shape[1]:
                raise ValueError(
                    f"Expected {self.shape[1]} column names, got {len(column_names)}"
                )
            self._colnames = list(column_names)
        else:
            self._colnames = [None] * self.shape[1]
        if term_names is not None:
            if len(term_names) != self.shape[1]:
                raise ValueError(f"Expected {self.shape[1]} term names, got {len(term_names)}")
            self._terms = list(term_names)
        else:
            self._terms = self._colnames
        self._reset_device_state()

    def _reset_device_state(self):
        for key in _DEVICE_STATE:
            setattr(self, key, None)

    def __getstate__(self):
        """Pickle host state only; the device layouts are rebuilt on use."""
        state = self.__dict__.copy()
        for key in _DEVICE_STATE:
            state.pop(key)
        state["_array_csr"] = None
        state["_device"] = str(self._device)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device = torch.device(state["_device"])
        self._reset_device_state()

    # -- device layouts ------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The device holding the layouts."""
        return self._device

    def _csr_parts(self):
        """``(data, plan)`` of the CSR layout on the device, built once."""
        if self._csr is None:
            self._csr = sparse_ops.compressed_layout(self.array_csr, self.shape[1], self._device)
        return self._csr

    def _csc_parts(self):
        """``(data, plan)`` of the CSC layout on the device, built once."""
        if self._csc is None:
            self._csc = sparse_ops.compressed_layout(self._array, self.shape[0], self._device)
        return self._csc

    def _pair_parts(self):
        """``(prod, plan)`` of the pair sandwich, built once; None past the
        budgets (``Σ_r nnz_r²`` pairs or k² segments) or when the device-cache
        ledger refuses its bytes (``_config.cache_charge``)."""
        if self._pair is None:
            k = self.shape[1]
            if (
                sparse_ops.pair_count(self.array_csr) > PAIR_SANDWICH_MAX_PAIRS
                or k * k > PAIR_SANDWICH_MAX_SEGMENTS
            ):
                self._pair = ()
            else:
                prod, plan = sparse_ops.pair_plan(self.array_csr, self._device)
                # a fresh plan keeps no kernel table yet; those built at its
                # first launch are the kernel's inputs and are not charged
                nbytes = tensor_bytes((prod, plan.perm, plan.bounds))
                self._pair = (prod, plan) if cache_charge(nbytes, self) else ()
        return self._pair or None

    def _dense_mirror(self) -> Optional[torch.Tensor]:
        """The densified matrix on the device for the sandwich, or None past
        its budgets or when the device-cache ledger refuses its bytes (the JAX
        package's charge, ``tabmat_tpu/models/sparse.py:215-224``)."""
        n, k = self.shape
        if k > DENSE_SANDWICH_MAX_COLS or n * k > DENSE_SANDWICH_MAX_ELEMENTS:
            return None
        if self._dense is None:
            if not cache_charge(self.dtype.itemsize * n * k, self):
                return None
            self._dense = torch.as_tensor(self._array.toarray(), device=self._device)
        return self._dense

    # -- scipy-compatible surface --------------------------------------------

    @property
    def shape(self):
        """(n_rows, n_cols)."""
        return self._array.shape

    @property
    def ndim(self):
        """Always 2."""
        return self._array.ndim

    @property
    def dtype(self):
        """Element dtype."""
        return self._array.dtype

    @property
    def indices(self):
        """CSC row indices."""
        return self._array.indices

    @property
    def indptr(self):
        """CSC column pointers."""
        return self._array.indptr

    @property
    def data(self):
        """CSC nonzero values."""
        return self._array.data

    @property
    def array_csc(self):
        """The underlying CSC matrix."""
        return self._array

    @property
    def array_csr(self):
        """Cached CSR twin."""
        if self._array_csr is None:
            self._array_csr = self._array.tocsr(copy=False)
            if self._array_csr.indices.dtype != self.idx_dtype:
                self._array_csr.indices = self._array_csr.indices.astype(self.idx_dtype)
            if self._array_csr.indptr.dtype != self.idx_dtype:
                self._array_csr.indptr = self._array_csr.indptr.astype(self.idx_dtype)
        return self._array_csr

    def _like(self, array, column_names=None, term_names=None):
        """A SparseMatrix of ``array`` on this matrix's device."""
        return type(self)(array, column_names=column_names, term_names=term_names,
                          device=self._device)

    def tocsc(self, copy=False):
        """CSC copy/view."""
        return self._array.tocsc(copy=copy)

    def transpose(self):
        """Transposed SparseMatrix."""
        return self._like(self._array.T)

    T = property(transpose)

    def getcol(self, i):
        """Column ``i`` as a single-column SparseMatrix."""
        return self._like(
            self._array[:, [i]],
            column_names=[self.column_names[i]],
            term_names=[self.term_names[i]],
        )

    def unpack(self):
        """The underlying scipy CSC matrix."""
        return self._array

    def toarray(self):
        """Densify to host numpy."""
        return self._array.toarray()

    def dot(self, other):
        """``self @ other``: the matvec on the device."""
        return self.matvec(other)

    __array_ufunc__ = None

    def __getitem__(self, key):
        row, col = _check_indexer(key)
        colnames = np.array(self.column_names, dtype=object)[col].ravel().tolist()
        terms = np.array(self.term_names, dtype=object)[col].ravel().tolist()
        return self._like(self._array.__getitem__((row, col)), colnames, terms)

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Cast to dtype (names kept)."""
        return self._like(self._array.astype(dtype, casting, copy), self.column_names,
                          self.term_names)

    def multiply(self, other):
        """Row-wise (1-d) or elementwise scaling."""
        other = to_numpy(other)
        if other.ndim == 1:
            other = other[:, np.newaxis]
        return self._like(sps.csc_matrix(self._array.multiply(other)), self.column_names,
                          self.term_names)

    # -- core ops ----------------------------------------------------------------

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ):
        """``X[rows, cols].T @ diag(d[rows]) @ X[rows, cols]``.

        The pair plan first, then the densified matrix; past both budgets
        (a ``sparse_wide``-like shape), or where the device-cache ledger
        refuses both, densified row panels.
        """
        d_t = to_tensor(d, device=self._device)
        check_sandwich_compatible(self, d_t)
        mask = rows_to_mask(
            None if rows is None else set_up_rows_or_cols(rows, self.shape[0]),
            self.shape[0], d_t.dtype, self._device,
        )
        dm = d_t if mask is None else d_t * mask
        cols_np = None
        if not is_identity_index(cols, self.shape[1]):
            cols_np = set_up_rows_or_cols(cols, self.shape[1], np.int64)
        pair = self._pair_parts()
        if pair is not None:
            S = sparse_ops.pair_sandwich(*pair, self.shape[1], dm)
            if cols_np is not None:
                c = torch.as_tensor(cols_np, device=S.device)
                S = S[c][:, c]
            return result_like(d, S)
        dense = self._dense_mirror()
        if dense is not None:
            return result_like(d, dense_ops.sandwich_restricted(dense, dm, None, cols_np))
        return result_like(d, self._panel_sandwich(dm, cols_np))

    def _panel_sandwich(self, dm: torch.Tensor, cols_np: Optional[np.ndarray]) -> torch.Tensor:
        """``X[:, cols].T diag(dm) X[:, cols]`` by row panels of the CSR layout.

        ``cols`` restricts the columns on the host before densifying; each
        panel (at most ``DENSE_SANDWICH_MAX_ELEMENTS`` elements, at least one
        row) is densified on the device and its sandwich added in order into
        one (k, k) result.
        """
        if cols_np is None:
            csr = self.array_csr
            data, plan = self._csr_parts()
        else:
            csr = self.array_csr[:, cols_np]
            data, plan = sparse_ops.compressed_layout(csr, len(cols_np), self._device)
        width = csr.shape[1]
        S = torch.zeros((width, width), dtype=data.dtype, device=self._device)
        for start, stop, panel in sparse_ops.csr_row_panels(
            data, plan, csr.indptr, width, DENSE_SANDWICH_MAX_ELEMENTS
        ):
            dense_ops.sandwich(panel, dm[start:stop].contiguous(), out=S)
        return S

    def _cross_sandwich(
        self,
        other,
        d,
        rows: Optional[np.ndarray] = None,
        L_cols: Optional[np.ndarray] = None,
        R_cols: Optional[np.ndarray] = None,
    ):
        """``X[:, L_cols].T @ diag(d) @ other[:, R_cols]``."""
        from .categorical import CategoricalMatrix
        from .dense import DenseMatrix

        if isinstance(other, DenseMatrix):
            return self.sandwich_dense(other, d, rows, L_cols, R_cols)
        if isinstance(other, CategoricalMatrix):
            return other._cross_sandwich(self, d, rows, R_cols, L_cols).T
        raise TypeError(f"no cross sandwich of a SparseMatrix with {type(other).__name__}")

    def sandwich_dense(self, B, d, rows, L_cols, R_cols):
        """``self[:, L_cols].T @ diag(d) @ B[:, R_cols]``: one launch over the
        CSC layout with ``d`` as the per-row scale."""
        B_t = B.unpack() if hasattr(B, "unpack") else to_tensor(B, device=self._device)
        d_t = to_tensor(d, device=self._device)
        if not (as_torch_dtype(self.dtype) == d_t.dtype == B_t.dtype):
            raise TypeError(
                "self, B and d all need to be of same dtype, either "
                f"np.float64 or np.float32. This matrix is of type {self.dtype}, "
                f"B is of type {B_t.dtype}, while d is of type {d_t.dtype}."
            )
        mask = rows_to_mask(
            None if rows is None else set_up_rows_or_cols(rows, self.shape[0]),
            self.shape[0], d_t.dtype, self._device,
        )
        dm = d_t if mask is None else d_t * mask
        if R_cols is not None and len(R_cols) < B_t.shape[1]:
            B_t = B_t.index_select(
                1, torch.as_tensor(np.asarray(R_cols, dtype=np.int64), device=B_t.device))
        data, plan = self._csc_parts()
        res = sparse_ops.csc_cross_dense(data, plan, dm.contiguous(), B_t.contiguous())
        if L_cols is not None and len(L_cols) < self.shape[1]:
            res = res.index_select(
                0, torch.as_tensor(np.asarray(L_cols, dtype=np.int64), device=res.device))
        return result_like(d, res)

    def _matvec_helper(self, vec, rows, cols, out, transpose: bool):
        v = to_tensor(vec, device=self._device)
        check_matvec_dimensions(self, v, transpose=transpose)
        n, k = self.shape
        # the kernel computes in float; integer operands take float64
        dtype = torch.promote_types(as_torch_dtype(self.dtype), v.dtype)
        work = dtype if dtype.is_floating_point else torch.float64
        v = v.to(work)

        if transpose:
            if rows is not None and len(rows) != n:
                m = rows_to_mask(set_up_rows_or_cols(rows, n), n, work, v.device)
                v = v * (m if v.ndim == 1 else m[:, None])
            data, plan = self._csc_parts()
            res = sparse_ops.csc_rmatvec(data.to(work), plan, v.contiguous()).to(dtype)
            if is_identity_index(cols, k):
                return result_like(vec, res) if out is None else add_into_out(out, res)
            cols_np = set_up_rows_or_cols(cols, k, np.int64)
            res = res.index_select(0, torch.as_tensor(cols_np, device=res.device))
            if out is None:
                return result_like(vec, res)
            if isinstance(out, np.ndarray):
                out[cols_np] += to_numpy(res).astype(out.dtype, copy=False)
                return out
            out[torch.as_tensor(cols_np, device=out.device)] += res.to(out.device, out.dtype)
            return out
        # matvec: a column restriction zeroes the unselected entries of vec
        if cols is not None and len(cols) != k:
            cm = cols_to_mask(set_up_rows_or_cols(cols, k), k, work, v.device)
            v = v * (cm if v.ndim == 1 else cm[:, None])
        data, plan = self._csr_parts()
        res = sparse_ops.csr_matvec(data.to(work), plan, v.contiguous()).to(dtype)
        return result_like(vec, res) if out is None else add_into_out(out, res)

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

    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Weighted column stds via E[X²] − E[X]² over the CSC layout."""
        data, plan = self._csc_parts()
        w = to_tensor(weights, device=self._device, dtype=data.dtype)
        ex2 = to_numpy(sparse_ops.csc_square_dot_weights(data, plan, w.contiguous()))
        sqrt_arg = ex2 - np.asarray(col_means) ** 2
        sqrt_arg[sqrt_arg < 0] = 0
        return np.sqrt(sqrt_arg)

    # -- names -----------------------------------------------------------------

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
            defaults = np.array([f"{missing_prefix}{i}" for i in indices], dtype=object)
            missing = np.array([nm is None for nm in names.tolist()])
            names[missing] = defaults[missing]
        return names.tolist()

    def set_names(self, names, type: str = "column"):
        """Set column/term names."""
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
