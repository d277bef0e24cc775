"""Sparse (CSR/CSC) ops, each one launch of the sparse segment product.

Port of ``tabmat_tpu/ops/sparse_ops.py`` and of the plans the JAX package
builds around it (``models/sparse.py:51-69, 178-213``,
``parallel/design.py:136-174``).  A CSR matrix is a sorted segment layout
with one segment per row (the column indices are the source rows of ``v``),
a CSC matrix one with a segment per column, so every sparse reduction is
:func:`~.spmv_kernel.spmv` over a layout built once:

- ``csr_matvec``: ``X @ v`` (1-D or 2-D ``v``; the reference's
  ``csr_matmat`` is the same call);
- ``csc_rmatvec``: ``X.T @ r`` (1-D or 2-D; the reference's ``csc_rmatmat``);
- ``csc_square_dot_weights``: ``Σ_i x_ij² w_i`` per column;
- ``csc_cross_dense``: ``X.T diag(d) B`` for a dense ``B``;
- ``pair_sandwich``: ``X.T diag(w) X`` over the plan of within-row pairs;
- ``code_column_cross``: ``C.T diag(w) X`` for a one-hot ``C``, over the
  plan of (code, column) keys;
- ``csr_row_panels``: row panels of a CSR layout densified on the device,
  for the sandwich past the pair plan's and the densified matrix's budgets.

The reference's ``_pg`` (lane-shuffle gather), ``_window`` (windowed take)
and plain variants formed each reduction as a cumsum over all nonzeros,
differenced at the bounds; here each segment is summed directly.

Every layout and plan keeps int32 indices (they index at most n rows or k
columns) and takes int64 bounds exactly when it holds more than
``INT32_MAX`` elements (:func:`bounds_dtype`), as the reference keeps
scipy's int64 indptr past 2³¹ − 1 nonzeros (``tabmat_tpu/models/
sparse.py:154-175``).  What stays int32 is the number of segments (rows,
columns, cells), which the budgets keep far below 2³¹.
"""

import numpy as np
import torch

from .. import _native
from .segments import SegmentPlan, build_plan
from .spmv_kernel import spmv

INT32_MAX = 2**31 - 1
# the kernels number a plan's segments (rows, columns, cells) in int32
SEGMENTS_MAX = 2**31 - 1
# elements cast and copied at a time by _to_device
_CAST_CHUNK = 1 << 27
_TORCH_INT = {np.int32: torch.int32, np.int64: torch.int64}


def bounds_dtype(count: int):
    """The bounds' dtype of a layout of ``count`` elements: int64 past
    ``INT32_MAX``, else int32."""
    return np.int64 if count > INT32_MAX else np.int32


def _segments(name: str, count: int) -> None:
    if count > SEGMENTS_MAX:
        raise OverflowError(
            f"{count} {name} exceed the kernels' int32 segment indices (at most "
            f"{SEGMENTS_MAX}); the budgets keep a plan's segments far below that"
        )


def _to_device(array: np.ndarray, dtype, device) -> torch.Tensor:
    """``array`` as ``dtype`` on ``device``, cast a chunk at a time, so that
    the host never holds a cast copy of a large layout."""
    out = torch.empty(len(array), dtype=_TORCH_INT[dtype], device=device)
    for lo in range(0, len(array), _CAST_CHUNK):
        out[lo : lo + _CAST_CHUNK] = torch.as_tensor(
            np.asarray(array[lo : lo + _CAST_CHUNK], dtype=dtype))
    return out


def compressed_layout(mat, n_src: int, device):
    """``(data, plan)`` of a scipy CSR or CSC matrix on ``device``.

    ``plan`` is the matrix's own layout: ``perm`` its indices as int32,
    ``bounds`` its indptr as int32, or as int64 past ``INT32_MAX`` nonzeros,
    ``n_rows`` the length ``n_src`` of the operand they index.
    """
    plan = SegmentPlan(
        _to_device(mat.indices, np.int32, device),
        _to_device(mat.indptr, bounds_dtype(mat.nnz), device),
        n_src,
    )
    return torch.as_tensor(np.asarray(mat.data), device=device), plan


def csr_matvec(data: torch.Tensor, plan: SegmentPlan, v: torch.Tensor) -> torch.Tensor:
    """``out[r] = Σ_{nnz in row r} data · v[col]`` (v (k,) or (k, m))."""
    return spmv(v, plan, data)


def csc_rmatvec(data: torch.Tensor, plan: SegmentPlan, r: torch.Tensor) -> torch.Tensor:
    """``out[c] = Σ_{nnz in col c} data · r[row]`` (r (n,) or (n, m))."""
    return spmv(r, plan, data)


def csc_square_dot_weights(data: torch.Tensor, plan: SegmentPlan,
                           weights: torch.Tensor) -> torch.Tensor:
    """``out[c] = Σ_{nnz in col c} data² · weights[row]`` (column E[X²])."""
    return spmv(weights, plan, data * data)


def csc_cross_dense(data: torch.Tensor, plan: SegmentPlan, d: torch.Tensor,
                    B: torch.Tensor) -> torch.Tensor:
    """``X.T diag(d) B`` → (k, kd): ``out[c, j] = Σ_{nnz (r, c)} data · d[r] · B[r, j]``."""
    return spmv(B, plan, data, scale=d)


def pair_count(csr) -> int:
    """``Σ_r nnz_r²``: the ordered within-row pairs of a CSR structure."""
    counts = np.diff(np.asarray(csr.indptr, dtype=np.int64))
    return int((counts * counts).sum())


def pair_plan(csr, device):
    """``(prod, plan)`` for the pair sandwich of a CSR matrix.

    ``S[i, j] = Σ_r w_r Σ_{(a, b) ∈ nnz(r)², col a = i, col b = j} data_a data_b``
    is one segment sum over the within-row pairs keyed by ``i·k + j``.  Only
    the pairs with ``i ≤ j`` are kept (:func:`pair_sandwich` mirrors them), so
    the assembled matrix is exactly symmetric.  The products ``prod`` and
    their rows (``plan.perm``) are sorted by key once, here, on ``device``
    (:func:`_sorted_by_key`).  A
    ``SparseMatrix`` builds it only under ``PAIR_SANDWICH_MAX_PAIRS``, so
    its bounds are int32 there; they follow :func:`bounds_dtype` all the
    same.
    """
    k = csr.shape[1]
    _segments("pair segments", k * k)
    ia, ib, row = _native.expand_pairs_csr(csr.indptr)
    cols = np.asarray(csr.indices, dtype=np.int64)
    ca, cb = cols[ia], cols[ib]
    upper = ca <= cb
    ia, ib, row = ia[upper], ib[upper], row[upper]
    data = np.asarray(csr.data)
    return _sorted_by_key(ca[upper] * k + cb[upper], k * k, data[ia] * data[ib], row,
                          csr.shape[0], device)


def _sorted_by_key(keys: np.ndarray, n_segments: int, values: np.ndarray, rows: np.ndarray,
                   n_rows: int, device):
    """``(values, plan)`` sorted by ``keys`` on ``device``: the order and
    bounds of :func:`~.segments.build_plan` (keys outside ``[0,
    n_segments)`` dropped), ``values`` and ``rows`` gathered there by that
    order; ``plan.perm`` the rows as int32, its bounds in
    :func:`bounds_dtype` of the elements kept."""
    order = build_plan(keys, n_segments, device)
    values = torch.as_tensor(values, device=order.device).index_select(0, order.perm)
    rows = torch.as_tensor(rows.astype(np.int32), device=order.device).index_select(0, order.perm)
    bounds = order.bounds.to(_TORCH_INT[bounds_dtype(rows.shape[0])])
    return values, SegmentPlan(rows, bounds, n_rows)


def pair_sandwich(prod: torch.Tensor, plan: SegmentPlan, k: int, w: torch.Tensor) -> torch.Tensor:
    """``X.T diag(w) X`` → (k, k) from :func:`pair_plan`: the upper triangle
    in one launch, mirrored."""
    upper = spmv(w, plan, prod).reshape(k, k)
    return upper + torch.triu(upper, 1).T


def row_panels(n: int, width: int, max_elements: int) -> list:
    """``(start, stop)`` of each panel of rows of an (n, width) matrix: at
    most ``max_elements`` elements and at least one row a panel."""
    step = max(1, max_elements // max(width, 1))
    return [(start, min(start + step, n)) for start in range(0, n, step)]


def csr_row_panel(data: torch.Tensor, plan: SegmentPlan, indptr, start: int, stop: int,
                  width: int) -> torch.Tensor:
    """Rows ``[start, stop)`` of a CSR layout as a dense (stop - start, width)
    tensor on the layout's device.

    ``plan`` is the layout of :func:`compressed_layout` (``perm`` the column
    indices, ``bounds`` the indptr) and ``indptr`` its host copy.  Stored
    duplicates add up.
    """
    lo, hi = int(indptr[start]), int(indptr[stop])
    counts = (plan.bounds[start + 1 : stop + 1] - plan.bounds[start:stop]).long()
    rows = torch.repeat_interleave(
        torch.arange(stop - start, device=data.device), counts, output_size=hi - lo)
    panel = torch.zeros((stop - start, width), dtype=data.dtype, device=data.device)
    panel.index_put_((rows, plan.perm[lo:hi].long()), data[lo:hi], accumulate=True)
    return panel


def csr_row_panels(data: torch.Tensor, plan: SegmentPlan, indptr, width: int,
                   max_elements: int):
    """Yield ``(start, stop, panel)`` for each of :func:`row_panels`, the
    panel densified by :func:`csr_row_panel`."""
    for start, stop in row_panels(len(indptr) - 1, width, max_elements):
        yield start, stop, csr_row_panel(data, plan, indptr, start, stop, width)


def code_column_plan(codes: np.ndarray, n_codes: int, n_rows: int, csc, device,
                     compress: bool = False):
    """``(a, plan, uniq)`` for ``C.T diag(w) X`` of one-hot codes and a CSC ``X``.

    ``codes`` holds one or more code vectors of ``n_rows`` each, one after
    the other (the design's stacked categoricals); a code outside
    ``[0, n_codes)`` is in no column.  Every nonzero ``(r, j)`` of ``X``
    meets each code vector once, at key ``codes[c·n + r]·k + j``: one segment
    per cell of the (n_codes, k) result, the data ``a`` and rows
    (``plan.perm``) sorted by key once, here, on ``device``
    (:func:`_sorted_by_key`).  With ``compress`` the
    segments are only the observed keys, ``uniq`` their flat cells (else
    None).  The bounds follow :func:`bounds_dtype` of the plan's elements
    (``C`` times the nonzeros).
    """
    k = csc.shape[1]
    n_cells = n_codes * k
    nnz = csc.nnz
    C = len(codes) // n_rows if n_rows else 0
    rows = np.tile(np.asarray(csc.indices, dtype=np.int64), C)
    cols = np.tile(np.repeat(np.arange(k, dtype=np.int64), np.diff(csc.indptr)), C)
    code = np.asarray(codes, dtype=np.int64)[np.repeat(np.arange(C) * n_rows, nnz) + rows]
    keys = np.where((code >= 0) & (code < n_codes), code * k + cols, -1)
    uniq = None
    if compress:
        valid = keys >= 0
        uniq, inverse = np.unique(keys[valid], return_inverse=True)
        keys[valid] = inverse
        n_segments = len(uniq)
        uniq = torch.as_tensor(uniq, device=device)
    else:
        _segments("cells", n_cells)
        n_segments = n_cells
    a, plan = _sorted_by_key(keys, n_segments, np.tile(np.asarray(csc.data), C), rows, n_rows,
                             device)
    return a, plan, uniq


def code_column_cross(a: torch.Tensor, plan: SegmentPlan, uniq, n_codes: int, k: int,
                      w: torch.Tensor) -> torch.Tensor:
    """``C.T diag(w) X`` → (n_codes, k) from :func:`code_column_plan`."""
    sums = spmv(w, plan, a)
    if uniq is None:
        return sums.reshape(n_codes, k)
    out = torch.zeros(n_codes * k, dtype=sums.dtype, device=sums.device)
    out[uniq] = sums
    return out.reshape(n_codes, k)
