"""CategoricalMatrix: a one-hot matrix stored as one int32 code vector.

Port of ``tabmat_tpu/models/categorical.py``.  The math:

- ``matvec(v)[i] = v[codes[i]]``                  — the gather kernel
- ``transpose_matvec(v)[c] = Σ_{codes[i]=c} v[i]`` — the segment-sum kernel
- ``sandwich(d)`` is diagonal: ``diag(Σ_{codes[i]=c} d[i])``

``drop_first`` and missing values ('fail' | 'zero' | 'convert') reduce to a
code shift: ``eff = codes - drop_first``, and a negative code contributes
nothing.  The codes live on the matrix's device; the segment plan (a stable
sort of the codes) is built once there and kept.
"""

import copy as _copy
import warnings
import weakref
from typing import Optional

import numpy as np
import torch

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

from .. import _native
from .._config import resolve_device
from .._frames import nw
from ..ops import categorical_ops
from ..ops.diag import DiagonalResult
from ..ops.segments import SegmentPlan, build_plan
from ..utils import (
    _check_indexer,
    add_into_out,
    check_matvec_dimensions,
    check_matvec_out_shape,
    check_sandwich_compatible,
    check_transpose_matvec_out_shape,
    is_identity_index,
    result_like,
    rows_to_mask,
    set_up_rows_or_cols,
    to_numpy,
    to_tensor,
)
from .base import MatrixBase


def _factorize_numpy(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted factorization of a numpy vector; missing values get code -1."""
    na_mask = (x == None) | (x != x)  # noqa: E711  (second term catches NaN)
    categories, inverse = np.unique(x[~na_mask], return_inverse=True)
    codes = np.full(x.shape, -1, dtype=np.int64)
    codes[~na_mask] = inverse
    return codes, categories


def _extract_codes_and_categories(cat_vec) -> tuple[np.ndarray, np.ndarray]:
    """(codes, categories) of a vector; missing values map to code -1.

    The reference's extraction (``tabmat_tpu/models/categorical.py:65-99``):
    a pandas categorical, bare or wrapped in a narwhals series, keeps its
    declared category order; another pandas series is factorized in sorted
    order; another narwhals series is cast to strings first; everything else
    is factorized in sorted order, by pandas where it is installed.
    """
    native = nw.to_native(cat_vec, pass_through=True)
    if pd is not None and isinstance(native, (pd.Series, pd.Categorical)):
        if isinstance(native, pd.Categorical):
            return np.asarray(native.codes), np.asarray(native.categories)
        if isinstance(native.dtype, pd.CategoricalDtype):
            return native.cat.codes.to_numpy(), np.asarray(native.cat.categories)
        codes, categories = pd.factorize(native, sort=True)
        return codes, np.asarray(categories)

    maybe_series = nw.from_native(cat_vec, series_only=True, pass_through=True)
    if isinstance(maybe_series, nw.Series):
        arr = maybe_series.cast(nw.String).to_numpy()
    else:
        arr = np.asarray(native)
    if pd is not None:
        codes, categories = pd.factorize(arr, sort=True)
        return codes, np.asarray(categories)
    return _factorize_numpy(arr)


class CategoricalMatrix(MatrixBase):
    """One-hot encoded categorical column stored as an int32 code vector.

    Parameters mirror the reference: ``cat_vec`` (data, or codes when
    ``categories`` is given), ``drop_first``, ``cat_missing_method``
    ('fail' | 'zero' | 'convert'), ``cat_missing_name``, dtype and naming.
    ``device=None`` puts the codes on the CUDA card (and raises without
    one); pass ``device="cpu"`` to compute on the CPU.

    Examples
    --------
    >>> import numpy as np, tabmat_torch as tt
    >>> C = tt.CategoricalMatrix(np.array([0, 1, 2, 1]), categories=np.arange(3),
    ...                          device="cpu")
    >>> C.shape
    (4, 3)
    >>> C.transpose_matvec(np.array([1.0, 2.0, 3.0, 4.0]))
    array([1., 6., 3.])
    """

    def __init__(
        self,
        cat_vec,
        categories: Optional[np.ndarray] = None,
        drop_first: bool = False,
        dtype=np.float64,
        column_name: Optional[str] = None,
        term_name: Optional[str] = None,
        column_name_format: str = "{name}[{category}]",
        cat_missing_method: str = "fail",
        cat_missing_name: str = "(MISSING)",
        device=None,
    ):
        if cat_missing_method not in {"fail", "zero", "convert"}:
            raise ValueError(
                "cat_missing_method must be one of 'fail' 'zero' or 'convert'; "
                f" got {cat_missing_method}."
            )
        self._device = resolve_device(device)
        if not hasattr(cat_vec, "dtype"):
            cat_vec = np.asarray(cat_vec)
        if torch.is_tensor(cat_vec):
            cat_vec = cat_vec.cpu().numpy()

        self._missing_method = cat_missing_method
        self._missing_category = cat_missing_name

        if categories is not None:
            self.categories = np.asarray(categories)
            codes = np.nan_to_num(np.asarray(cat_vec), nan=-1)
            if codes.size:
                if np.max(codes) >= len(self.categories):
                    raise ValueError("Indices exceed length of categories.")
                if np.min(codes) < -1:
                    raise ValueError("Indices must be non-negative (or -1 for missing).")
        else:
            codes, self.categories = _extract_codes_and_categories(cat_vec)

        codes = np.asarray(codes)
        self._has_missings = False
        if np.any(codes == -1):
            if self._missing_method == "fail":
                raise ValueError(
                    "Categorical data can't have missing values "
                    "if cat_missing_method='fail'."
                )
            if self._missing_method == "convert":
                if self._missing_category in self.categories:
                    raise ValueError(
                        f"Missing category {self._missing_category} already exists."
                    )
                self.categories = np.hstack(
                    [self.categories, self._missing_category], dtype="object"
                )
                codes = np.where(codes < 0, len(self.categories) - 1, codes)
            else:
                self._has_missings = True

        self.drop_first = drop_first
        try:
            self.indices = codes.astype(np.int32, copy=False)
        except (ValueError, TypeError):
            raise ValueError(
                "When creating a CategoricalMatrix with indices and categories, "
                "indices must be castable to a numpy int32 dtype."
            )
        self.shape = (len(self.indices), max(len(self.categories) - int(drop_first), 0))
        self.dtype = np.dtype(dtype)

        self._colname = column_name
        self._colname_format = column_name_format
        self._term = column_name if term_name is None else term_name
        self._reset_device_state()

    __array_ufunc__ = None

    def _reset_device_state(self):
        self._eff_codes_dev = None
        self._plan = None
        # weak keys: a cross plan dies with the matrix it was built against
        self._cross_plans = weakref.WeakKeyDictionary()
        self._sparse_plans = weakref.WeakKeyDictionary()

    def __getstate__(self):
        """Pickle host state only; the device state is rebuilt on use."""
        state = self.__dict__.copy()
        for key in ("_eff_codes_dev", "_plan", "_cross_plans", "_sparse_plans"):
            state.pop(key)
        state["_device"] = str(self._device)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device = torch.device(state["_device"])
        self._reset_device_state()

    # -- device state ----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The device holding the codes and the plans."""
        return self._device

    @property
    def _eff_codes_np(self) -> np.ndarray:
        """Effective codes: indices shifted by drop_first; < 0 means no entry."""
        if self.drop_first:
            return self.indices.astype(np.int64) - 1
        return self.indices.astype(np.int64)

    @property
    def eff_codes(self) -> torch.Tensor:
        """int32 effective codes on the device."""
        if self._eff_codes_dev is None:
            self._eff_codes_dev = torch.as_tensor(
                self._eff_codes_np.astype(np.int32), device=self._device
            )
        return self._eff_codes_dev

    @property
    def plan(self) -> SegmentPlan:
        """The SegmentPlan over the effective codes, built once."""
        if self._plan is None:
            self._plan = build_plan(self.eff_codes, self.shape[1], self._device)
        return self._plan

    def _operand(self, x) -> torch.Tensor:
        return to_tensor(x, device=self._device)

    def _row_masked(self, v: torch.Tensor, rows) -> torch.Tensor:
        mask = rows_to_mask(
            None if rows is None else set_up_rows_or_cols(rows, self.shape[0]),
            self.shape[0], v.dtype, v.device,
        )
        return v if mask is None else categorical_ops.masked_values(v, mask)

    # -- core ops --------------------------------------------------------------

    def matvec(self, other, cols: Optional[np.ndarray] = None, out=None):
        """``out[i] (+)= other[codes[i]]``: one gather."""
        check_matvec_out_shape(self, out)
        v = self._operand(other)
        if v.ndim > 1:
            raise NotImplementedError(
                "CategoricalMatrix.matvec is only implemented for 1d arrays."
            )
        check_matvec_dimensions(self, v, transpose=False)
        is_int = not v.is_floating_point() and v.dtype != torch.bool
        if is_int:
            v = v.to(torch.float64 if self.dtype == np.float64 else torch.float32)
        if cols is not None and len(cols) < self.shape[1]:
            cmask = torch.zeros(self.shape[1], dtype=v.dtype, device=v.device)
            cmask[torch.as_tensor(np.asarray(cols, dtype=np.int64), device=v.device)] = 1
            v = v * cmask
        res = categorical_ops.routed_matvec(self.eff_codes, v)
        if is_int:
            res = res.to(torch.int64 if self.dtype == np.float64 else torch.int32)
        if out is None:
            return result_like(other, res)
        return add_into_out(out, res)

    def _segment_sum(self, v: torch.Tensor) -> torch.Tensor:
        """``plan.sum`` in v's float dtype; integer vectors sum in float64."""
        if v.is_floating_point():
            return self.plan.sum(v)
        return self.plan.sum(v.to(torch.float64)).to(v.dtype)

    def transpose_matvec(
        self,
        vec,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ):
        """``out[c] (+)= Σ_{i in rows, codes[i]=c} vec[i]``: one segment sum."""
        v = self._operand(vec)
        check_matvec_dimensions(self, v, transpose=True)
        if v.ndim > 1:
            raise NotImplementedError(
                "CategoricalMatrix.transpose_matvec is only implemented for 1d arrays."
            )
        if out is not None:
            check_transpose_matvec_out_shape(self, out)
        res_full = self._segment_sum(self._row_masked(v, rows))

        cols_idx = None
        if cols is not None:
            cols_idx = set_up_rows_or_cols(cols, self.shape[1], np.int64)
        if out is None:
            if cols_idx is not None:
                res_full = res_full.index_select(0, torch.as_tensor(cols_idx, device=v.device))
            return result_like(vec, res_full)
        if cols_idx is None or len(cols_idx) == self.shape[1]:
            return add_into_out(out, res_full)
        res = res_full.index_select(0, torch.as_tensor(cols_idx, device=v.device))
        if isinstance(out, np.ndarray):
            out[cols_idx] += res.cpu().numpy().astype(out.dtype, copy=False)
            return out
        out[torch.as_tensor(cols_idx, device=out.device)] += res.to(out.device, out.dtype)
        return out

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ) -> DiagonalResult:
        """Diagonal sandwich ``diag(Σ_{i in rows, codes[i]=c} d[i])``.

        Returns a :class:`DiagonalResult`: a tensor diagonal on the device
        for a tensor ``d``, a numpy one otherwise.
        """
        d_t = self._operand(d)
        check_sandwich_compatible(self, d_t)
        diag = self._segment_sum(self._row_masked(d_t, rows))
        if not is_identity_index(cols, self.shape[1]):
            idx = set_up_rows_or_cols(cols, self.shape[1], np.int64)
            diag = diag.index_select(0, torch.as_tensor(idx, device=diag.device))
        return DiagonalResult(result_like(d, diag))

    # -- cross sandwiches (used by SplitMatrix) --------------------------------

    def _cross_sandwich(self, other, d, rows=None, L_cols=None, R_cols=None):
        """``X[:, L_cols].T @ diag(d) @ other[:, R_cols]``."""
        from .dense import DenseMatrix
        from .sparse import SparseMatrix

        if isinstance(other, DenseMatrix):
            return self._cross_dense(other, d, rows, L_cols, R_cols)
        if isinstance(other, SparseMatrix):
            return self._cross_sparse(other, d, rows, L_cols, R_cols)
        if isinstance(other, CategoricalMatrix):
            return self._cross_categorical(other, d, rows, L_cols, R_cols)
        raise TypeError(f"no cross sandwich of a CategoricalMatrix with {type(other).__name__}")

    def _sparse_plan(self, other):
        """``(a, plan, uniq)`` of the (code, column) plan with the SparseMatrix
        ``other``, built once per pair of matrices: one segment per cell of
        the (K, k) result, or per observed cell past ``_CROSS_DENSE_PLAN_MAX``
        cells (``uniq`` the flat cell of each)."""
        from ..ops import sparse_ops

        cached = self._sparse_plans.get(other)
        if cached is None:
            K = self.shape[1]
            cached = sparse_ops.code_column_plan(
                self._eff_codes_np, K, self.shape[0], other.array_csc, self._device,
                compress=K * other.shape[1] > self._CROSS_DENSE_PLAN_MAX,
            )
            self._sparse_plans[other] = cached
        return cached

    def _cross_sparse(self, other, d, rows, L_cols, R_cols):
        """cat.T @ diag(d) @ sparse: one launch of the sparse segment product
        over the (code, column) plan.  The JAX package multiplies on the host
        with scipy (``models/categorical.py:510-526``)."""
        from ..ops import sparse_ops

        K, k = self.shape[1], other.shape[1]
        if K * k > 2**31:
            raise MemoryError(
                f"cat × sparse cross-sandwich output would have {K}×{k} entries; "
                "this is infeasible to densify."
            )
        a, plan, uniq = self._sparse_plan(other)
        dm = self._row_masked(self._operand(d), rows)
        res = sparse_ops.code_column_cross(a.to(dm.dtype), plan, uniq, K, k, dm.contiguous())
        if L_cols is not None and len(L_cols) < K:
            res = res.index_select(
                0, torch.as_tensor(np.asarray(L_cols, dtype=np.int64), device=res.device)
            )
        if R_cols is not None and len(R_cols) < k:
            res = res.index_select(
                1, torch.as_tensor(np.asarray(R_cols, dtype=np.int64), device=res.device)
            )
        return result_like(d, res)

    def _cross_dense(self, other, d, rows, L_cols, R_cols):
        """cat.T @ diag(d) @ dense: segment sum of the d-scaled dense rows."""
        B = other.unpack()
        dm = self._row_masked(self._operand(d), rows)
        if R_cols is not None and len(R_cols) < B.shape[1]:
            B = B.index_select(
                1, torch.as_tensor(np.asarray(R_cols, dtype=np.int64), device=B.device)
            )
        res = self.plan.sum((B * dm[:, None]).contiguous())  # (K, |R_cols|)
        if L_cols is not None and len(L_cols) < self.shape[1]:
            res = res.index_select(
                0, torch.as_tensor(np.asarray(L_cols, dtype=np.int64), device=res.device)
            )
        return result_like(d, res)

    # Above this, the cross plan compresses to the observed pairs instead of
    # K1*K2 segments.
    _CROSS_DENSE_PLAN_MAX = 1 << 24

    def _cross_plan(self, other):
        """``(plan, uniq)`` over the combined codes with ``other``, built once
        per pair of matrices.

        Small products get a K1·K2-segment plan (``uniq`` None), its keys
        combined on the device as ``_native.combine_codes`` does on the host
        (below 2²⁴ cells no key overflows int32); larger ones a compressed
        plan over the observed code pairs (at most n of them), with ``uniq``
        the flat cell of each segment.
        """
        K1, K2 = self.shape[1], other.shape[1]
        cached = self._cross_plans.get(other)
        if cached is None:
            if K1 * K2 <= self._CROSS_DENSE_PLAN_MAX:
                a, b = self.eff_codes, other.eff_codes.to(self._device)
                combined = torch.where((a >= 0) & (b >= 0), a * K2 + b, -1)
                cached = (build_plan(combined, K1 * K2, self._device), None)
            else:
                combined = _native.combine_codes(self._eff_codes_np, other._eff_codes_np, K2)
                valid = combined >= 0
                uniq, inverse = np.unique(combined[valid], return_inverse=True)
                keys = np.full(len(combined), -1, dtype=np.int64)
                keys[valid] = inverse
                cached = (
                    build_plan(keys, len(uniq), self._device),
                    torch.as_tensor(uniq.astype(np.int64), device=self._device),
                )
            self._cross_plans[other] = cached
        return cached

    def _cross_categorical(self, other, d, rows, L_cols, R_cols):
        """cat.T @ diag(d) @ cat: segment sum of d over the combined codes,
        scattered into the (K1, K2) result for a compressed plan."""
        K1, K2 = self.shape[1], other.shape[1]
        if K1 * K2 > 2**31:
            raise MemoryError(
                f"cat × cat cross-sandwich output would have {K1}×{K2} "
                "entries; this is infeasible to densify."
            )
        plan, uniq = self._cross_plan(other)
        sums = plan.sum(self._row_masked(self._operand(d), rows))
        if uniq is None:
            res = sums.reshape(K1, K2)
        else:
            res = torch.zeros(K1 * K2, dtype=sums.dtype, device=sums.device)
            res[uniq] = sums
            res = res.reshape(K1, K2)
        if L_cols is not None and len(L_cols) < K1:
            res = res.index_select(
                0, torch.as_tensor(np.asarray(L_cols, dtype=np.int64), device=res.device)
            )
        if R_cols is not None and len(R_cols) < K2:
            res = res.index_select(
                1, torch.as_tensor(np.asarray(R_cols, dtype=np.int64), device=res.device)
            )
        return result_like(d, res)

    # -- conversions ------------------------------------------------------------

    def getcol(self, i: int):
        """Column ``i`` (wrap-around index) as a single-column SparseMatrix."""
        from scipy import sparse as sps

        from .sparse import SparseMatrix

        i = int(i) % self.shape[1]
        hits = np.flatnonzero(self._eff_codes_np == i)
        col_i = sps.csc_matrix(
            (np.ones(hits.size, dtype=int), (hits, np.zeros(hits.size, dtype=np.int32))),
            shape=(self.shape[0], 1),
        )
        return SparseMatrix(
            col_i,
            column_names=[self.column_names[i]],
            term_names=[self.term_names[i]],
            device=self._device,
        )

    def tocsr(self):
        """scipy CSR representation (host)."""
        from scipy import sparse as sps

        eff = self._eff_codes_np
        valid = eff >= 0
        indptr = np.zeros(self.shape[0] + 1, dtype=int)
        np.cumsum(valid, out=indptr[1:])
        return sps.csr_matrix(
            (np.ones(int(valid.sum()), dtype=int), eff[valid].astype(np.int32), indptr),
            shape=self.shape,
        )

    def to_sparse_matrix(self):
        """The one-hot matrix as a SparseMatrix on the same device."""
        from .sparse import SparseMatrix

        return SparseMatrix(
            self.tocsr(),
            column_names=self.column_names,
            term_names=self.term_names,
            device=self._device,
        )

    def toarray(self) -> np.ndarray:
        """Densify to host numpy (in the matrix's float dtype)."""
        return self.tocsr().toarray().astype(self.dtype)

    def recover_orig(self) -> np.ndarray:
        """The original category-valued vector (masked where missing)."""
        if self._has_missings:
            missing_code = -1
        elif self._missing_method == "convert" and self._missing_category in self.categories:
            missing_code = len(self.categories) - 1
        else:
            missing_code = None
        values = self.categories[self.indices]
        if missing_code is None:
            return values
        return np.ma.array(values, mask=self.indices == missing_code)

    @property
    def cat(self):
        """pandas.Categorical view (deprecated; needs pandas)."""
        warnings.warn(
            "This property will be removed in the next major release.",
            category=DeprecationWarning,
        )
        try:
            import pandas as pd
        except ImportError:
            raise ModuleNotFoundError("The `cat` property requires pandas to be installed.")
        return pd.Categorical.from_codes(self.indices, categories=self.categories)

    def unpack(self):
        """The pandas.Categorical underlying this matrix."""
        return self.cat

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """A copy with another nominal float dtype (the codes are shared)."""
        new = _copy.copy(self)
        new.dtype = np.dtype(dtype)
        return new

    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Column stds via E[X²] = E[X] (entries are 0/1)."""
        mean = np.asarray(self.transpose_matvec(np.asarray(weights)))
        variances = mean - np.asarray(col_means) ** 2
        return np.sqrt(np.maximum(variances, 0))

    def multiply(self, other):
        """Row-wise scaling → SparseMatrix on the same device (names kept)."""
        from scipy import sparse as sps

        from .sparse import SparseMatrix

        other = np.squeeze(to_numpy(other))
        if self.shape[0] != other.shape[0]:
            raise ValueError(
                f"Shapes do not match. Expected length of {self.shape[0]}. "
                f"Got {len(other)}."
            )
        eff = self._eff_codes_np
        valid = eff >= 0
        indptr = np.zeros(self.shape[0] + 1, dtype=int)
        np.cumsum(valid, out=indptr[1:])
        return SparseMatrix(
            sps.csr_matrix((other[valid], eff[valid].astype(np.int32), indptr), shape=self.shape),
            column_names=self.column_names,
            term_names=self.term_names,
            device=self._device,
        )

    def __getitem__(self, item):
        row, col = _check_indexer(item)
        if isinstance(col, np.ndarray):
            if (col > self.shape[1] - 1).any():
                raise IndexError("Index out-of-range.")
            full = np.array_equal(col.ravel(), np.arange(self.shape[1]))
        else:
            full = len(range(*col.indices(self.shape[1]))) == self.shape[1]
        if not full:
            # column subsetting loses the one-nonzero-per-row structure
            return self.to_sparse_matrix()[row, col]
        if isinstance(row, np.ndarray):
            row = row.ravel()
        return CategoricalMatrix(
            self.indices[row],
            categories=self.categories,
            drop_first=self.drop_first,
            dtype=self.dtype,
            column_name=self._colname,
            term_name=self._term,
            column_name_format=self._colname_format,
            cat_missing_method=self._missing_method,
            cat_missing_name=self._missing_category,
            device=self._device,
        )

    def __repr__(self):
        return f"{self.__class__.__name__}\nCategories: {self.categories}"

    # -- names ------------------------------------------------------------------

    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """One formatted name per category (or the single term name)."""
        if type == "column":
            name = self._colname
        elif type == "term":
            name = self._term
        else:
            raise ValueError(f"Type must be 'column' or 'term', got {type}")

        if indices is None:
            indices = list(range(len(self.categories) - self.drop_first))
        if name is None and missing_prefix is None:
            return [None] * (len(self.categories) - self.drop_first)
        elif name is None:
            name = f"{missing_prefix}{indices[0]}-{indices[-1]}"

        if type == "column":
            return [
                self._colname_format.format(name=name, category=cat)
                for cat in self.categories[self.drop_first :]
            ]
        return [name] * (len(self.categories) - self.drop_first)

    def _strip_category_decoration(self, formatted, category):
        """Invert ``_colname_format`` for one column: recover the name field."""
        if formatted is None:
            return None
        template = self._colname_format.format(name="\x00", category=category)
        prefix, sep, suffix = template.partition("\x00")
        if not sep:
            return formatted
        if (
            len(formatted) >= len(prefix) + len(suffix)
            and formatted.startswith(prefix)
            and formatted.endswith(suffix)
        ):
            return formatted[len(prefix) : len(formatted) - len(suffix)]
        return formatted

    def set_names(self, names, type: str = "column"):
        """Set the single base name (parses formatted names back if needed)."""
        attr = {"column": "_colname", "term": "_term"}.get(type)
        if attr is None:
            raise ValueError(f"Type must be 'column' or 'term', got {type}")
        if isinstance(names, str):
            names = [names]
        names = list(names)
        if len(names) > 1:
            if type == "column":
                names = [
                    self._strip_category_decoration(nm, cat)
                    for nm, cat in zip(names, self.categories[self.drop_first :])
                ]
            if len(names) == self.shape[1] and len(set(names)) == 1:
                names = names[:1]
        if len(names) != 1:
            raise ValueError("A categorical matrix has only one name")
        setattr(self, attr, names[0])
