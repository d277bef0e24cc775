"""SplitMatrix: a column-partitioned container of dense, sparse and
categorical blocks.

Port of ``tabmat_tpu/models/split.py`` (with ``as_tabmat`` and ``hstack``).
Each block covers a sorted set of global column indices; ops fan out to the
blocks and the results are assembled.  All dense blocks fuse into one, and
so do all sparse blocks.

Tensor callers go through the cached :class:`DeviceDesign`, as the
reference's jax callers do (``split.py:39-66, 422-434, 474-487, 522-539``):
one gather, one segment sum, one sparse segment product per sparse layout
and the sandwich grid over all blocks, with the result left on the device.
numpy callers take the blockwise path: each block's op, the pairwise cross
sandwiches, and an indexed assembly.
"""

import warnings
from collections.abc import Sequence
from typing import Optional

import numpy as np
import torch
from scipy import sparse as sps

from .. import _trace
from ..ops.diag import DiagonalResult
from ..utils import (
    as_numpy_dtype,
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
from .dense import DenseMatrix
from .sparse import SparseMatrix
from .standardized import StandardizedMatrix


def as_tabmat(a, device=None):
    """Coerce to a MatrixBase: a scipy sparse matrix becomes a SparseMatrix,
    an ndarray or tensor a DenseMatrix."""
    if isinstance(a, (MatrixBase, StandardizedMatrix)):
        return a
    if isinstance(a, np.ndarray) or torch.is_tensor(a):
        return DenseMatrix(a, device=device)
    if sps.issparse(a):
        return SparseMatrix(a.tocsc(copy=False), device=device)
    raise ValueError(f"Cannot convert type {type(a)} to Matrix.")


def _device_of(tup, device):
    if device is not None:
        return torch.device(device)
    for a in tup:
        if isinstance(a, (MatrixBase, StandardizedMatrix)) or torch.is_tensor(a):
            return a.device
    return None


def hstack(tup: Sequence, device=None) -> MatrixBase:
    """Stack matrices horizontally; all-dense inputs give one DenseMatrix,
    all-sparse inputs one SparseMatrix.

    The result lives on ``device``, else on the device of the first input
    that is a tensor or a matrix, else on the CUDA card.
    """
    if len(tup) == 0:
        raise ValueError("Need at least one array to concatenate.")
    dev = _device_of(tup, device)
    matrices = [as_tabmat(a, device=dev) for a in tup]
    dev = matrices[0].device
    if all(isinstance(m, SparseMatrix) for m in matrices):
        return SparseMatrix(sps.hstack([m.unpack() for m in matrices]), device=dev)
    if all(isinstance(m, DenseMatrix) for m in matrices):
        return DenseMatrix(torch.cat([m.unpack().to(dev) for m in matrices], dim=1))
    return SplitMatrix(matrices)


def _merge_group(blocks, col_lists):
    """Fuse several blocks of one kind (dense or sparse) into one, re-sorted
    into global order."""
    stacked_cols = np.concatenate([np.asarray(c) for c in col_lists])
    order = np.argsort(stacked_cols)
    if isinstance(blocks[0], DenseMatrix):
        wide = torch.cat([b.unpack() for b in blocks], dim=1)
        fused = DenseMatrix(wide[:, torch.as_tensor(order, device=wide.device)])
    else:
        wide = sps.hstack([b.unpack() for b in blocks], format="csc")
        fused = SparseMatrix(wide[:, order], device=blocks[0].device)
    names = np.concatenate([np.asarray(b._colnames, dtype=object) for b in blocks])
    terms = np.concatenate([np.asarray(b._terms, dtype=object) for b in blocks])
    fused._colnames = names[order].tolist()
    fused._terms = terms[order].tolist()
    return fused, stacked_cols[order]


def _coalesce_blocks(blocks, col_lists):
    """Drop zero-width blocks; fuse all dense blocks into one, and all sparse
    blocks into one.

    Categorical blocks are never fused: each stands for one model term.  A
    fused block takes the list position of its group's first member.
    """
    kept = [(b, c) for b, c in zip(blocks, col_lists, strict=True) if b.shape[1] > 0]
    for kind in (DenseMatrix, SparseMatrix):
        group = [p for p, (b, _) in enumerate(kept) if isinstance(b, kind)]
        if len(group) > 1:
            fused = _merge_group([kept[p][0] for p in group], [kept[p][1] for p in group])
            kept = [
                fused if p == group[0] else bc
                for p, bc in enumerate(kept)
                if p == group[0] or p not in group
            ]
    return [b for b, _ in kept], [c for _, c in kept]


def _unique_cols(cols, n_cols: int):
    """``(uniq, inverse)`` of a column active set: ``uniq`` its sorted
    distinct columns, ``cols == uniq[inverse]``; ``inverse`` is None when
    ``cols`` is already sorted without repeats (or None)."""
    if cols is None:
        return None, None
    cols = set_up_rows_or_cols(cols, n_cols, np.int64)
    uniq, inverse = np.unique(cols, return_inverse=True)
    return uniq, (None if len(uniq) == len(cols) and np.array_equal(uniq, cols) else inverse)


def _matvec_cols(cols, n_cols: int):
    """The set of columns a matvec sums over, sorted, or None for all.

    As ``DenseMatrix.matvec``: a repeated column counts once, and a ``cols``
    of length ``n_cols`` restricts nothing.
    """
    if cols is None or len(cols) == n_cols:
        return None
    return np.unique(set_up_rows_or_cols(cols, n_cols, np.int64))


def _take(x, index, both: bool = False):
    """``x[index]`` (rows and columns with ``both``) for an array or tensor."""
    if torch.is_tensor(x):
        index = torch.as_tensor(index, device=x.device)
        x = x[index]
        return x[:, index] if both else x
    return x[np.ix_(index, index)] if both else x[index]


def _place_segments(segments, positions, total_len):
    """Place 1-d tensor ``segments`` at global ``positions`` (zeros elsewhere)."""
    index_map = np.full(total_len, -1, dtype=np.int64)
    off = 0
    for pos in positions:
        index_map[np.asarray(pos)] = off + np.arange(len(pos))
        off += len(pos)
    index_map[index_map < 0] = off  # point at the zero slot
    flat = torch.cat(list(segments) + [segments[0].new_zeros(1)])
    return flat[torch.as_tensor(index_map, device=flat.device)]


class SplitMatrix(MatrixBase):
    """Matrix with dense, sparse and categorical column blocks."""

    __array_priority__ = 13

    def __init__(
        self,
        matrices: Sequence[MatrixBase],
        indices: Optional[list[np.ndarray]] = None,
    ):
        blocks, default_cols = self._flatten_inputs(matrices)
        self._validate_blocks(blocks)
        self.dtype = blocks[0].dtype

        if indices is None:
            block_cols = default_cols
            n_col = int(sum(len(c) for c in block_cols))
        else:
            block_cols = [np.asarray(ix, dtype=np.int64) for ix in indices]
            n_col = self._validate_cols(blocks, block_cols)

        self.matrices, kept_cols = _coalesce_blocks(blocks, block_cols)
        self.indices = [np.asarray(c, dtype=np.int64) for c in kept_cols]
        self.shape = (blocks[0].shape[0], n_col)
        if self.shape[1] == 0:
            raise ValueError("A SplitMatrix needs at least one column.")

    @staticmethod
    def _flatten_inputs(matrices):
        """Flatten nested SplitMatrix inputs into leaf blocks, with each
        top-level entry claiming the next span of global columns."""
        blocks, default_cols, cursor = [], [], 0
        for entry in matrices:
            if not isinstance(entry, MatrixBase):
                raise ValueError(
                    "Expected all elements of matrices to be subclasses of MatrixBase."
                )
            if isinstance(entry, SplitMatrix):
                for leaf, leaf_cols in zip(entry.matrices, entry.indices):
                    blocks.append(leaf)
                    default_cols.append(cursor + np.asarray(leaf_cols, np.int64))
                cursor += entry.shape[1]
            else:
                blocks.append(entry)
                default_cols.append(np.arange(cursor, cursor + entry.shape[1], dtype=np.int64))
                cursor += entry.shape[1]
        return blocks, default_cols

    @staticmethod
    def _validate_blocks(blocks):
        """Shared row count, device and dtype checks."""
        n_row, ref_dtype, device = blocks[0].shape[0], blocks[0].dtype, blocks[0].device
        for i, blk in enumerate(blocks):
            if blk.dtype != ref_dtype:
                warnings.warn(
                    "Matrices do not all have the same dtype. Dtypes are "
                    f"{[elt.dtype for elt in blocks]}."
                )
            if blk.shape[0] != n_row:
                raise ValueError(
                    "All matrices should have the same first dimension, "
                    f"but the first matrix has first dimension {n_row} and "
                    f"matrix {i} has first dimension {blk.shape[0]}."
                )
            if blk.device != device:
                raise ValueError(
                    f"All matrices should be on one device, but matrix 0 is on "
                    f"{device} and matrix {i} on {blk.device}."
                )

    @staticmethod
    def _validate_cols(blocks, block_cols):
        """Check an explicit column assignment; returns the column count."""
        flat = np.concatenate(block_cols)
        n_col = len(flat)
        if not np.array_equal(np.sort(flat), np.arange(n_col, dtype=flat.dtype)):
            raise ValueError(
                "Indices should contain all integers from 0 to one less than "
                "the number of columns."
            )
        for i, cols in enumerate(block_cols):
            if np.any(np.diff(cols) < 0):
                raise ValueError(
                    f"Each index block should be sorted, but indices[{i}] was not sorted"
                )
        for i, (blk, cols) in enumerate(zip(blocks, block_cols)):
            if blk.shape[1] != len(cols):
                raise ValueError(
                    f"Length mismatch: block {i} has {blk.shape[1]} columns but "
                    f"its index array has shape {cols.shape}"
                )
        return n_col

    @property
    def device(self) -> torch.device:
        """The device holding the blocks."""
        return self.matrices[0].device

    # -- restriction plumbing ----------------------------------------------------

    def _split_col_subsets(self, cols):
        """Map a sorted column active set without repeats onto each block.

        Returns ``(subset_cols_indices, subset_cols, n_cols)`` with
        ``self.indices[i][subset_cols[i]] == cols[subset_cols_indices[i]]``.
        Callers reduce any other ``cols`` to such a set first
        (:func:`_unique_cols`).
        """
        if cols is None:
            return self.indices, [None] * len(self.indices), self.shape[1]
        subset_cols_indices, subset_cols = [], []
        for idx in self.indices:
            pos = np.searchsorted(cols, idx)
            found = pos < len(cols)
            found[found] = cols[pos[found]] == idx[found]
            subset_cols.append(np.flatnonzero(found))
            subset_cols_indices.append(pos[found])
        return subset_cols_indices, subset_cols, len(cols)

    # -- core ops ------------------------------------------------------------------

    def _get_device_design(self):
        """The DeviceDesign twin of this matrix, built once."""
        dd = getattr(self, "_device_design", None)
        if dd is None:
            from ..parallel.design import DeviceDesign

            dd = DeviceDesign.from_matrix(self)
            self._device_design = dd
        return dd

    def _device_sandwich_ok(self) -> bool:
        from ..parallel.design import DeviceDesign

        return (
            self.shape[1] <= DeviceDesign.SANDWICH_MAX_COLS
            and self._get_device_design().supports_sandwich
        )

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_device_design", None)
        return state

    def _design_operand(self, v_in) -> bool:
        """True for a 1-d tensor of the matrix's dtype: the DeviceDesign route."""
        return (
            torch.is_tensor(v_in)
            and v_in.ndim == 1
            and as_numpy_dtype(v_in.dtype) == np.dtype(self.dtype)
        )

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ):
        """Blocked sandwich: per-block diagonal cells plus pairwise cross cells.

        A tensor ``d`` takes the DeviceDesign's explicit sandwich and gets a
        (k, k) tensor on the device; a numpy ``d`` takes the blockwise path
        and gets numpy.
        """
        d_in = d if hasattr(d, "dtype") else np.asarray(d)
        check_sandwich_compatible(self, d_in)
        if self._design_operand(d_in) and self._device_sandwich_ok():
            with _trace.span("api.sandwich"):
                design = self._get_device_design()
                mask = rows_to_mask(
                    None if rows is None else set_up_rows_or_cols(rows, self.shape[0]),
                    self.shape[0], d_in.dtype, design.device,
                )
                w = d_in.to(design.device)
                H = design.sandwich(w if mask is None else w * mask)
                if not is_identity_index(cols, self.shape[1]):
                    c = torch.as_tensor(set_up_rows_or_cols(cols, self.shape[1], np.int64),
                                        device=H.device)
                    H = H[c][:, c]
                return H.to(d_in.device)

        uniq, inverse = _unique_cols(cols, self.shape[1])
        if inverse is not None:
            # a categorical block's diagonal would lose the off-diagonal
            # copies of a repeated column: assemble over the distinct ones
            return _take(self.sandwich(d_in, rows, uniq), inverse, both=True)
        # upload the weights once; the blocks' ops reuse the device copy
        d_dev = to_tensor(d_in, device=self.device)
        subset_cols_indices, subset_cols, n_cols = self._split_col_subsets(uniq)
        out = torch.zeros((n_cols, n_cols), dtype=d_dev.dtype, device=d_dev.device)
        idx = [torch.as_tensor(i, device=d_dev.device) for i in subset_cols_indices]
        active = [i for i, c in enumerate(subset_cols) if c is None or len(c)]
        for i in active:
            mat_i = self.matrices[i]
            res = mat_i.sandwich(d_dev, rows, subset_cols[i])
            if isinstance(res, DiagonalResult):
                out[idx[i], idx[i]] += res.diag
            else:
                out[idx[i][:, None], idx[i][None, :]] = res
            for j in active[active.index(i) + 1 :]:
                res = mat_i._cross_sandwich(
                    self.matrices[j], d_dev, rows, subset_cols[i], subset_cols[j]
                )
                out[idx[i][:, None], idx[j][None, :]] = res
                out[idx[j][:, None], idx[i][None, :]] = res.T
        return result_like(d, out)

    def matvec(self, v, cols: Optional[np.ndarray] = None, out=None):
        """``X[:, cols] @ v[cols]``: per-block matvecs accumulated."""
        v_in = v
        v = v if torch.is_tensor(v) else np.asarray(v)
        check_matvec_dimensions(self, v, transpose=False)
        check_matvec_out_shape(self, out)

        cols = _matvec_cols(cols, self.shape[1])
        if self._design_operand(v_in) and out is None:
            with _trace.span("api.matvec"):
                # column restriction ≡ masking v (matvec sums over columns)
                ve = v.to(self.device)
                if cols is not None:
                    ve = ve * rows_to_mask(cols, self.shape[1], ve.dtype, ve.device)
                return self._get_device_design().matvec(ve).to(v_in.device)

        _, subset_cols, _ = self._split_col_subsets(cols)
        out_dtype = np.result_type(self.dtype, as_numpy_dtype(v.dtype))
        if out is None:
            out_shape = (self.shape[0],) + tuple(v.shape[1:])
            if torch.is_tensor(v_in):
                out = torch.zeros(out_shape, dtype=v.dtype, device=v.device)
            else:
                out = np.zeros(out_shape, out_dtype)
        elif isinstance(out, np.ndarray) and out.dtype != out_dtype:
            raise ValueError(
                f"out array is required to have dtype {out_dtype} but has dtype {out.dtype}"
            )
        for sub_cols, idx, mat in zip(subset_cols, self.indices, self.matrices):
            if sub_cols is not None and not len(sub_cols):
                continue
            if torch.is_tensor(v):
                in_vec = v[torch.as_tensor(idx, device=v.device)]
            else:
                in_vec = v[idx, ...]
            out = mat.matvec(in_vec, sub_cols, out=out)
        return out

    def transpose_matvec(
        self,
        v,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ):
        """``X[rows, cols].T @ v[rows]``: per-block results placed by index."""
        v_in = v
        v = v if torch.is_tensor(v) else np.asarray(v)
        check_matvec_dimensions(self, v, transpose=True)
        check_transpose_matvec_out_shape(self, out)

        if self._design_operand(v_in) and out is None:
            with _trace.span("api.tmv"):
                ve = v.to(self.device)
                if rows is not None and len(rows) != self.shape[0]:
                    ve = ve * rows_to_mask(set_up_rows_or_cols(rows, self.shape[0]),
                                           self.shape[0], ve.dtype, ve.device)
                res = self._get_device_design().transpose_matvec(ve)
                if cols is not None and not is_identity_index(cols, self.shape[1]):
                    res = res[torch.as_tensor(
                        set_up_rows_or_cols(cols, self.shape[1], np.int64), device=res.device)]
                return res.to(v_in.device)

        uniq, inverse = _unique_cols(cols, self.shape[1])
        if inverse is not None:
            res = self.transpose_matvec(v_in, rows, uniq, out=out)
            return res if out is not None else _take(res, inverse)
        subset_cols_indices, subset_cols, n_cols = self._split_col_subsets(uniq)
        active = [i for i, c in enumerate(subset_cols) if c is None or len(c)]
        subset_cols_indices = [subset_cols_indices[i] for i in active]
        out_dtype = np.result_type(self.dtype, as_numpy_dtype(v.dtype))
        # one upload shared by every block op
        v_dev = to_tensor(v, device=self.device)
        segments = [
            self.matrices[i].transpose_matvec(v_dev, rows=rows, cols=subset_cols[i])
            for i in active
        ]
        if not torch.is_tensor(v_in):
            out_is_none = out is None
            if out_is_none:
                out = np.zeros([n_cols] + list(v.shape[1:]), out_dtype)
            elif out.dtype != out_dtype:
                raise ValueError(
                    f"out array is required to have dtype {out_dtype} but has "
                    f"dtype {out.dtype}"
                )
            for idx, seg in zip(subset_cols_indices, segments):
                pos = idx if out_is_none or uniq is None else uniq[idx]
                out[pos, ...] += to_numpy(seg).astype(out.dtype, copy=False)
            return out
        if not segments:  # an empty active set
            return v_in.new_zeros((0,) + tuple(v.shape[1:])) if out is None else out
        if out is None:
            return _place_segments(segments, subset_cols_indices, n_cols).to(v_in.device)
        if uniq is None:
            positions, total = subset_cols_indices, self.shape[1]
        else:
            positions, total = [uniq[idx] for idx in subset_cols_indices], out.shape[0]
        placed = _place_segments(segments, positions, total)
        return out.add_(placed.to(device=out.device, dtype=out.dtype))

    # -- statistics ----------------------------------------------------------------

    def _get_col_means(self, weights) -> np.ndarray:
        """Weighted column means, per block."""
        col_means = np.empty(self.shape[1], dtype=self.dtype)
        for idx, mat in zip(self.indices, self.matrices):
            col_means[idx] = to_numpy(mat._get_col_means(weights))
        return col_means

    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Weighted column stds, per block."""
        col_stds = np.empty(self.shape[1], dtype=self.dtype)
        for idx, mat in zip(self.indices, self.matrices):
            col_stds[idx] = to_numpy(mat._get_col_stds(weights, col_means[idx]))
        return col_stds

    # -- conversions ---------------------------------------------------------------

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Cast all blocks."""
        return SplitMatrix([mat.astype(dtype) for mat in self.matrices], self.indices)

    def toarray(self) -> np.ndarray:
        """Densify to host numpy."""
        out = np.empty(self.shape)
        for mat, idx in zip(self.matrices, self.indices):
            out[:, idx] = mat.toarray()
        return out

    def getcol(self, i: int):
        """Column ``i`` (wrap-around) from whichever block owns it."""
        i %= self.shape[1]
        for mat, idx in zip(self.matrices, self.indices):
            if i in idx:
                return mat.getcol(int(np.where(idx == i)[0][0]))
        raise RuntimeError(f"Column {i} was not found.")

    def __getitem__(self, key):
        row, col = key if isinstance(key, tuple) else (key, slice(None, None, None))
        if not (isinstance(col, slice) and col == slice(None, None, None)):
            raise NotImplementedError(
                f"Only row indexing is supported. Index passed was {key}."
            )
        if isinstance(row, int):
            row = [row]
        return SplitMatrix([mat[row, :] for mat in self.matrices], self.indices)

    def multiply(self, other):
        """Row-wise scaling of every block (a scaled categorical is a
        SparseMatrix)."""
        return SplitMatrix([mat.multiply(other) for mat in self.matrices], self.indices)

    def __repr__(self):
        out = "SplitMatrix:"
        for i, mat in enumerate(self.matrices):
            out += f"\n\nComponent {i} with type {mat.__class__.__name__}\n" + repr(mat)
        return out

    # -- names -----------------------------------------------------------------------

    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """Gather names from all blocks in global column order."""
        names = np.empty(self.shape[1], dtype=object)
        for idx, mat in zip(self.indices, self.matrices):
            names[idx] = mat.get_names(type, missing_prefix, idx)
        return names.tolist()

    def set_names(self, names, type: str = "column"):
        """Distribute names to the owning blocks."""
        names_array = np.array(names, dtype=object)
        if len(names) != self.shape[1]:
            raise ValueError(f"Length of names must be {self.shape[1]}")
        for idx, mat in zip(self.indices, self.matrices):
            mat.set_names(names_array[idx].tolist(), type)
