"""DeviceDesign: a design matrix as the operator the GLM layer drives.

Port of ``tabmat_tpu/parallel/design.py``.  ``DeviceDesign.from_matrix``
turns a DenseMatrix, a SparseMatrix, a CategoricalMatrix, a SplitMatrix of
them, or a StandardizedMatrix over one of those into blocks of device
tensors, with ``@``, ``.T @`` and an explicit ``sandwich`` so that
``glm.irls_step`` drives it.  The reference traces the whole step into one
XLA program; the port runs eagerly, a few kernels per op.

Blocks (at most one of each; a SplitMatrix fuses its dense blocks into one,
and its sparse blocks into one):

- dense: X (n, kd).  matvec and tmv are ``torch.matmul``; the sandwich
  diagonal cell is the CUDA sandwich, ``column_absmax`` the range prepass.
- sparse: the CSR and CSC layouts of a SparseMatrix, its pair plan, and one
  (code, column) plan keyed on the cat block's stacked codes.  matvec, tmv,
  the sparse diagonal cell, the sparse×dense cell and all sparse×cat cells
  are one launch each of the sparse segment product ``spmv<T>``.
- cat: every categorical of the design stacked into one block, as the
  reference's ``catstack`` (``design.py:36-48``) does, so that an op costs
  the same launches for any number of categoricals: one gather over the
  stacked codes (matvec), one segment sum over the stacked plan (tmv, the
  sandwich diagonals, the cat×dense cells), and one segment sum per pair of
  categoricals over their combined codes (the cat×cat cells).  One
  categorical is the stack of one.

Every segment is summed directly; the reference differenced cumsums over
all nonzeros or rows (``design.py:493-505, 538-551, 661-664, 775-809``).
"""

import numpy as np
import torch

from .._config import cache_charge
from ..models.categorical import CategoricalMatrix
from ..models.sparse import SparseMatrix
from ..ops import dense_ops, gather_kernel, sandwich_kernel, segments, sparse_ops
from ..utils import tensor_bytes

# The explicit sandwich needs a full K1·K2-segment plan for every pair of
# categoricals: the product of their widths must be at most this (the
# reference's bound, ``design.py:90-94``, and the matrices' own).
CROSS_MAX_SEGMENTS = CategoricalMatrix._CROSS_DENSE_PLAN_MAX
# ... and a (code, column) plan for the sparse block against every
# categorical: each width times the sparse width at most this
# (``design.py:136-138``).
SPARSE_CAT_MAX_SEGMENTS = 1 << 24


class _DenseBlock:
    """Dense columns ``X`` (n, kd) at global column ``positions``."""

    kind = "dense"

    def __init__(self, X: torch.Tensor, positions: np.ndarray):
        self.X = X
        self.width = X.shape[1]
        self.positions = positions
        self.device = X.device

    def astype_float(self, dtype) -> "_DenseBlock":
        return _DenseBlock(self.X.to(dtype), self.positions)

    def float_tensors(self) -> list:
        return [self.X]

    def matvec(self, v):
        return dense_ops.matvec(self.X, v)

    def tmv(self, r):
        return dense_ops.transpose_matvec(self.X, r)


class _CatBlock:
    """Categoricals stacked into one block (the reference's catstack).

    - ``codes`` (C·n,) int32: each categorical's effective codes, offset by
      the widths before it; an invalid code becomes the pad code ``width``,
      which the gather reads as 0;
    - ``plan``: the categoricals' plans stacked, one segment per column;
    - ``cross``: ``(a, b) → SegmentPlan`` over the combined codes of
      categoricals a < b, one segment per cell of their (w_a, w_b) block.
    """

    kind = "cat"

    def __init__(self, cats, positions: np.ndarray):
        self.widths = tuple(m.shape[1] for m in cats)
        self.width = sum(self.widths)
        self.positions = positions
        self.n = cats[0].shape[0]
        self.device = device = cats[0].device
        codes, off = [], 0
        for m in cats:
            eff = m._eff_codes_np
            codes.append(np.where(eff >= 0, eff + off, self.width).astype(np.int32))
            off += m.shape[1]
        self.codes = torch.as_tensor(np.concatenate(codes), device=device)
        self.plan = segments.stack([m.plan for m in cats])
        self.cross = {}
        if all(
            wa * wb <= CROSS_MAX_SEGMENTS
            for a, wa in enumerate(self.widths)
            for wb in self.widths[a + 1 :]
        ):
            # the matrices' own cross plans, so a plan is built once per pair
            for a in range(len(cats)):
                for b in range(a + 1, len(cats)):
                    self.cross[(a, b)], _ = cats[a]._cross_plan(cats[b])

    @property
    def has_cross_plans(self) -> bool:
        k = len(self.widths)
        return len(self.cross) == k * (k - 1) // 2

    def matvec(self, v):
        return gather_kernel.gather(v, self.codes, self.n)

    def tmv(self, r):
        return self.plan.sum(r)

    def sandwich(self, w, wX):
        """The cat rows of the Hessian: ``(cat×dense cells (width, kd) or
        None, cat×cat block (width, width))``."""
        H = torch.zeros((self.width, self.width), dtype=w.dtype, device=w.device)
        H.diagonal().copy_(self.plan.sum(w))
        offsets = np.concatenate([[0], np.cumsum(self.widths)])
        for (a, b), plan in self.cross.items():
            cell = plan.sum(w).reshape(self.widths[a], self.widths[b])
            ra = slice(offsets[a], offsets[a + 1])
            rb = slice(offsets[b], offsets[b + 1])
            H[ra, rb] = cell
            H[rb, ra] = cell.T
        cross_dense = None if wX is None else self.plan.sum2d(wX)
        return cross_dense, H


class _SparseBlock:
    """A SparseMatrix's device layouts at global column ``positions``.

    - ``csr`` and ``csc``: ``(data, plan)`` of each layout, shared with the
      matrix;
    - ``pair``: ``(prod, plan)`` of the pair sandwich, or None past its
      budgets;
    - ``cat``: ``(a, plan)`` of the (code, column) plan against the design's
      stacked categoricals, or None (no categoricals, or past the budget);
    - ``absmax``: the largest |x| of the block, taken once: with max |w| it
      bounds every |x_ij · w_i| for the f32 Hessian scale.
    """

    kind = "sparse"

    def __init__(self, mat: SparseMatrix, positions: np.ndarray):
        self.width = mat.shape[1]
        self.positions = positions
        self.device = mat.device
        self.csr = mat._csr_parts()
        self.csc = mat._csc_parts()
        self.pair = mat._pair_parts()
        self.cat = None
        self._csc_host = mat.array_csc
        self.absmax = float(np.abs(mat.data).max()) if mat.data.size else 0.0

    def attach_cat_plan(self, cat: "_CatBlock") -> None:
        """Build the (code, column) plan over the stacked codes of ``cat``:
        one launch then gives every sparse×cat cell."""
        if all(w * self.width <= SPARSE_CAT_MAX_SEGMENTS for w in cat.widths):
            a, plan, _ = sparse_ops.code_column_plan(
                cat.codes.cpu().numpy(), cat.width, cat.n, self._csc_host, self.device)
            self.cat = (a, plan)

    def astype_float(self, dtype) -> "_SparseBlock":
        new = object.__new__(_SparseBlock)
        new.__dict__.update(self.__dict__)

        def cast(pair):
            return None if pair is None else (pair[0].to(dtype), pair[1])

        new.csr, new.csc, new.pair, new.cat = (cast(p) for p in (self.csr, self.csc, self.pair,
                                                                  self.cat))
        return new

    def float_tensors(self) -> list:
        return [p[0] for p in (self.csr, self.csc, self.pair, self.cat) if p is not None]

    def matvec(self, v):
        return sparse_ops.csr_matvec(*self.csr, v.contiguous())

    def tmv(self, r):
        return sparse_ops.csc_rmatvec(*self.csc, r.contiguous())

    def diag(self, w):
        return sparse_ops.pair_sandwich(*self.pair, self.width, w)

    def cross_dense(self, X, w):
        """(ks, kd): ``X_sᵀ diag(w) X_d``, w as the per-row scale."""
        return sparse_ops.csc_cross_dense(*self.csc, w, X)

    def cross_cat(self, w, cat_width: int):
        """(cat width, ks): every sparse×cat cell in one launch."""
        return sparse_ops.code_column_cross(*self.cat, None, cat_width, self.width, w)


class DeviceDesign:
    """A dense, sparse and/or categorical design on one device."""

    # widest design for which the explicit (k, k) Hessian is built
    SANDWICH_MAX_COLS = 4096

    def __init__(self, blocks, n_rows: int, n_cols: int, dtype: torch.dtype,
                 shift=None, mult=None):
        self.blocks = blocks
        self.shape = (n_rows, n_cols)
        self.dtype = dtype
        self.shift = shift  # standardization: x -> mult*x + shift (per col)
        self.mult = mult
        self._f32 = None  # the float32 design, built once by astype_float
        order = np.concatenate([b.positions for b in blocks])
        self._identity_order = bool(np.array_equal(order, np.arange(n_cols)))
        device = self.device
        # v in block order = v[_gather_v]; block outputs in global order =
        # concat[_index_map]
        self._gather_v = torch.as_tensor(order.astype(np.int64), device=device)
        self._index_map = torch.as_tensor(
            np.argsort(order, kind="stable").astype(np.int64), device=device
        )

    @classmethod
    def from_matrix(cls, mat) -> "DeviceDesign":
        """Convert a DenseMatrix, a SparseMatrix, a CategoricalMatrix, a
        SplitMatrix of them, or a StandardizedMatrix over one of those."""
        from ..models.dense import DenseMatrix
        from ..models.split import SplitMatrix
        from ..models.standardized import StandardizedMatrix
        from ..utils import as_torch_dtype

        if isinstance(mat, StandardizedMatrix):
            inner = cls.from_matrix(mat.mat)

            def param(x):
                return torch.as_tensor(x, device=inner.device, dtype=inner.dtype)

            mult = None if mat.mult is None else param(mat.mult)
            return cls(inner.blocks, *inner.shape, inner.dtype, param(mat.shift), mult)
        if not isinstance(mat, (DenseMatrix, SparseMatrix, CategoricalMatrix, SplitMatrix)):
            raise TypeError(f"Cannot convert {type(mat).__name__} to a DeviceDesign")
        n, k = mat.shape
        dtype = as_torch_dtype(mat.dtype)
        if isinstance(mat, DenseMatrix):
            return cls([_DenseBlock(mat.unpack(), np.arange(k))], n, k, dtype)
        if isinstance(mat, SparseMatrix):
            return cls([_SparseBlock(mat, np.arange(k))], n, k, dtype)
        if isinstance(mat, CategoricalMatrix):
            return cls([_CatBlock([mat], np.arange(k))], n, k, dtype)
        # a SplitMatrix: at most one dense and one sparse block (fused), and
        # any number of categoricals, stacked into one block
        blocks, cats, cat_positions = [], [], []
        for m, idx in zip(mat.matrices, mat.indices):
            if isinstance(m, DenseMatrix):
                blocks.append(_DenseBlock(m.unpack(), idx))
            elif isinstance(m, SparseMatrix):
                blocks.append(_SparseBlock(m, idx))
            else:
                cats.append(m)
                cat_positions.append(idx)
        if cats:
            cat = _CatBlock(cats, np.concatenate(cat_positions))
            blocks.append(cat)
            for b in blocks:
                if b.kind == "sparse":
                    b.attach_cat_plan(cat)
        return cls(blocks, n, k, dtype)

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def X(self):
        """The dense block's tensor, or None."""
        dense = self._block("dense")
        return None if dense is None else dense.X

    def _block(self, kind):
        return next((b for b in self.blocks if b.kind == kind), None)

    def astype_float(self, dtype) -> "DeviceDesign":
        """The design with its float tensors cast to ``dtype``.

        The float32 design is built on the first call and kept, so an IRLS
        loop with a float32 inner solve casts the dense block once per
        design instead of once per step.  The codes and plans are shared.
        Its float32 blocks are charged to the device-cache ledger
        (``_config.cache_charge``) with the design as owner; when refused,
        the cast design is returned and not kept, so each call casts anew.
        """
        if dtype == self.dtype:
            return self
        if dtype != torch.float32:
            raise ValueError(f"astype_float supports float32, got {dtype}")
        if self._f32 is not None:
            return self._f32

        def cast(x):
            return None if x is None else x.to(dtype)

        blocks = [b if b.kind == "cat" else b.astype_float(dtype) for b in self.blocks]
        d = object.__new__(DeviceDesign)
        d.__dict__.update(self.__dict__)
        d.blocks, d.dtype, d.shift, d.mult = blocks, dtype, cast(self.shift), cast(self.mult)
        if cache_charge(tensor_bytes(t for b in blocks if b.kind != "cat"
                                     for t in b.float_tensors()), self):
            self._f32 = d
        return d

    # -- ops -------------------------------------------------------------------

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``X @ v``."""
        v_eff = v * self.mult if self.mult is not None else v
        v_blocks = v_eff if self._identity_order else v_eff[self._gather_v]
        out, off = None, 0
        for b in self.blocks:
            part = b.matvec(v_blocks[off : off + b.width])
            out = part if out is None else out + part
            off += b.width
        if self.shift is not None:
            out = out + torch.dot(self.shift, v)
        return out

    def transpose_matvec(self, r: torch.Tensor) -> torch.Tensor:
        """``X.T @ r``."""
        segs = [b.tmv(r) for b in self.blocks]
        flat = segs[0] if len(segs) == 1 else torch.cat(segs)
        out = flat if self._identity_order else flat[self._index_map]
        if self.mult is not None:
            out = out * self.mult
        if self.shift is not None:
            out = out + self.shift * torch.sum(r)
        return out

    @property
    def supports_sandwich(self) -> bool:
        """True when the explicit sandwich is available.

        Standardized designs take the Hessian-vector path, as in the
        reference, and so do designs whose cat×cat cross plans, sparse pair
        plan or sparse×cat plan were too large to build
        (``design.py:610-641``).
        """
        cat, sparse = self._block("cat"), self._block("sparse")
        return (
            self.shape[1] <= self.SANDWICH_MAX_COLS
            and self.shift is None
            and self.mult is None
            and (cat is None or cat.has_cross_plans)
            and (sparse is None or (sparse.pair is not None
                                    and (cat is None or sparse.cat is not None)))
        )

    def sandwich(self, w: torch.Tensor) -> torch.Tensor:
        """Explicit ``Xᵀ diag(w) X`` → (k, k): the dense cell through the
        sandwich kernel, the categorical cells through the segment sum, the
        sparse cells through the sparse segment product.  Each off-diagonal
        cell is computed once and mirrored, so the result is exactly
        symmetric where each diagonal cell is."""
        dense, sparse, cat = (self._block(kind) for kind in ("dense", "sparse", "cat"))
        cells = {}
        if dense is not None:
            cells["dense", "dense"] = dense_ops.sandwich(dense.X, w)
        if sparse is not None:
            cells["sparse", "sparse"] = sparse.diag(w)
            if dense is not None:
                cells["sparse", "dense"] = sparse.cross_dense(dense.X, w)
        if cat is not None:
            wX = None if dense is None else (dense.X * w[:, None]).contiguous()
            cells["cat", "dense"], cells["cat", "cat"] = cat.sandwich(w, wX)
            if sparse is not None:
                cells["cat", "sparse"] = sparse.cross_cat(w, cat.width)

        def cell(a, b):
            return cells[a, b] if (a, b) in cells else cells[b, a].T

        kinds = [b.kind for b in self.blocks]
        if len(kinds) == 1:
            H = cells[kinds[0], kinds[0]]
        else:
            H = torch.cat([torch.cat([cell(a, b) for b in kinds], dim=1) for a in kinds])
        if self._identity_order:
            return H
        return H[self._index_map][:, self._index_map]

    def absmax_bound(self, w: torch.Tensor) -> torch.Tensor:
        """A float64 bound of ``max_ij |x_ij| · |w_i|``, on the device.

        Dense columns take the range prepass (the CUDA ``column_absmax`` on
        the float32 copy); a one-hot column's maximum is at most ``max |w|``,
        a sparse column's at most its largest |x| times ``max |w|``.  NaN
        propagates.
        """
        parts = []
        dense, sparse = self._block("dense"), self._block("sparse")
        if dense is not None:
            parts.append(sandwich_kernel.column_absmax(dense.X, w).amax())
        if sparse is not None:
            parts.append(sparse.absmax * w.abs().amax())
        if self._block("cat") is not None:
            parts.append(w.abs().amax())
        bound = parts[0]
        for part in parts[1:]:
            bound = torch.maximum(bound, part)
        return bound

    # operator sugar so glm.irls_step treats designs and tensors alike
    def __matmul__(self, v):
        return self.matvec(v)

    @property
    def T(self):
        return _TransposedDesign(self)


class _TransposedDesign:
    def __init__(self, design: DeviceDesign):
        self._design = design

    def __matmul__(self, r):
        return self._design.transpose_matvec(r)
