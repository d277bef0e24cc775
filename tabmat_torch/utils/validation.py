"""Host-side argument validation and rows/cols restriction canonicalization.

Port of ``tabmat_tpu/utils/validation.py``: shape checks raise
``ValueError``, dtype mismatches ``TypeError``, before any device work.
Row and column active sets stay on the host as numpy index arrays; dtypes
may be numpy or torch dtypes.
"""

from typing import Optional

import numpy as np
import torch


def as_numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def set_up_rows_or_cols(arr, length: int, dtype=np.int32) -> np.ndarray:
    """Normalize an optional index array to a concrete int index array."""
    if arr is None:
        return np.arange(length, dtype=dtype)
    if torch.is_tensor(arr):
        arr = arr.cpu().numpy()
    return np.asarray(arr).astype(dtype)


def setup_restrictions(
    shape: tuple[int, int],
    rows,
    cols,
    dtype=np.int32,
) -> tuple[np.ndarray, np.ndarray]:
    """Materialize both active-set restrictions as index arrays."""
    return (
        set_up_rows_or_cols(rows, shape[0], dtype),
        set_up_rows_or_cols(cols, shape[1], dtype),
    )


def _check_out_shape(out, expected_first_dim: int) -> None:
    if out is not None and out.shape[0] != expected_first_dim:
        raise ValueError(
            f"The first dimension of 'out' must be {expected_first_dim}, "
            f"but it is {out.shape[0]}."
        )


def check_transpose_matvec_out_shape(mat, out) -> None:
    """Check that ``out`` of a transpose_matvec conforms to the column count."""
    _check_out_shape(out, mat.shape[1])


def check_matvec_out_shape(mat, out) -> None:
    """Check that ``out`` of a matvec conforms to the row count."""
    _check_out_shape(out, mat.shape[0])


def check_matvec_dimensions(mat, vec, transpose: bool) -> None:
    """Check vector/matrix alignment for (transpose_)matvec."""
    match_dim = 0 if transpose else 1
    if mat.shape[match_dim] != vec.shape[0]:
        raise ValueError(
            f"shapes {tuple(mat.shape)} and {tuple(vec.shape)} not aligned: "
            f"{mat.shape[match_dim]} (dim {match_dim}) != {vec.shape[0]} (dim 0)"
        )


def check_sandwich_compatible(mat, d) -> None:
    """Check shape and dtype compatibility for the sandwich product."""
    if mat.shape[0] != d.shape[0]:
        raise ValueError(
            f"shapes {tuple(mat.shape)} and {tuple(d.shape)} not aligned: "
            f"{mat.shape[0]} (dim 0) != {d.shape[0]} (dim 0)"
        )
    if as_numpy_dtype(mat.dtype) != as_numpy_dtype(d.dtype):
        raise TypeError(
            "self and d need to be of same dtype, either np.float64 or "
            f"np.float32. self is of type {mat.dtype}, while d is of type "
            f"{d.dtype}."
        )


def _flatten_axis_key(key):
    """Canonicalize a single-axis key: slices pass, array-likes flatten to 1-d."""
    if isinstance(key, slice):
        return key
    if torch.is_tensor(key):
        key = key.cpu().numpy()
    arr = np.asarray(key)
    if arr.ndim > 1:
        raise ValueError(
            "Indexing would result in a matrix with more than 2 dimensions."
        )
    return arr.reshape(-1)


def _check_indexer(indexer):
    """Validate a ``__getitem__`` key and return a canonical (row, col) pair.

    Slices pass through; a 1-d array-like paired with a slice is flattened;
    two array-likes become an ``np.ix_``-style open mesh (pre-meshed
    ``np.ix_`` output is recognized and kept); anything else raises.
    """
    if not isinstance(indexer, tuple):
        indexer = (indexer, slice(None))
    if len(indexer) > 2:
        raise ValueError("More than two indexers are not supported.")
    row_key, col_key = indexer

    n_slices = isinstance(row_key, slice) + isinstance(col_key, slice)
    if n_slices > 0:
        return _flatten_axis_key(row_key), _flatten_axis_key(col_key)

    row_arr = np.asarray(row_key)
    col_arr = np.asarray(col_key)
    if max(row_arr.ndim, col_arr.ndim) <= 1:
        return np.ix_(row_arr.reshape(-1), col_arr.reshape(-1))
    if (row_arr.ndim, col_arr.ndim) == (2, 2) and (
        row_arr.shape[1],
        col_arr.shape[0],
    ) == (1, 1):
        return row_arr, col_arr
    raise ValueError("This type of indexing is not supported.")


def is_identity_index(indexer: Optional[np.ndarray], length: int) -> bool:
    """True when a COLUMN restriction is exactly the identity 0..length-1.

    Column restrictions order the output, so a permuted full-length array is
    NOT a no-op; order-sensitive call sites must use this stronger check.
    """
    if indexer is None:
        return True
    arr = set_up_rows_or_cols(indexer, length, np.int64)
    return len(arr) == length and bool(np.array_equal(arr, np.arange(length)))
