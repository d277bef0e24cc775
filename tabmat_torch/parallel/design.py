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

from .. import _trace
from .._config import cache_charge
from ..models.categorical import CategoricalMatrix
from ..models.sparse import SparseMatrix
from ..ops import dense_ops, gather_kernel, sandwich_kernel, segments, sparse_ops
from ..utils import tensor_bytes
from .mesh import (all_reduce, axes_of, gather_columns, mesh_device, row_range, shard_index,
                   split_range)

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

    def full(self) -> torch.Tensor:
        """All the block's columns of the rows held here."""
        return self.X

    def matvec(self, v):
        return dense_ops.matvec(self.X, v)

    def tmv(self, r):
        return dense_ops.transpose_matvec(self.X, r)


class _ColumnShardedDenseBlock(_DenseBlock):
    """The columns ``cols[0]:cols[1]`` of a dense block's rows, the other
    columns on the other ranks of the mesh axis ``axis``.

    ``width`` is the block's full width.  matvec and tmv give the whole
    block's result for these rows (one all-reduce over ``axis`` each);
    :meth:`full` gathers the columns for the sandwich's dense cells.
    """

    def __init__(self, X: torch.Tensor, positions: np.ndarray, cols: tuple, mesh, axis):
        super().__init__(X, positions)
        self.width = len(positions)
        self.cols, self.mesh, self.axis = cols, mesh, axis

    def astype_float(self, dtype) -> "_ColumnShardedDenseBlock":
        return _ColumnShardedDenseBlock(self.X.to(dtype), self.positions, self.cols, self.mesh,
                                        self.axis)

    def full(self) -> torch.Tensor:
        return gather_columns(self.X, self.cols, self.width, self.mesh, self.axis)

    def matvec(self, v):
        return all_reduce(dense_ops.matvec(self.X, v[self.cols[0]:self.cols[1]]), self.mesh,
                          self.axis)

    def tmv(self, r):
        out = r.new_zeros(self.width)
        out[self.cols[0]:self.cols[1]] = dense_ops.transpose_matvec(self.X, r)
        return all_reduce(out, self.mesh, self.axis)


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
        self.cats = list(cats)
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

    def rows(self, lo: int, hi: int, device) -> "_CatBlock":
        """The block of rows ``lo:hi`` on ``device``, with plans of its own."""
        return _CatBlock([
            CategoricalMatrix(np.maximum(m._eff_codes_np[lo:hi], -1),
                              categories=np.arange(m.shape[1]), cat_missing_method="zero",
                              device=device)
            for m in self.cats
        ], self.positions)

    @property
    def has_cross_plans(self) -> bool:
        k = len(self.widths)
        return len(self.cross) == k * (k - 1) // 2

    def matvec(self, v):
        return gather_kernel.gather(v, self.codes, self.n)

    def tmv(self, r):
        return self.plan.sum(r)

    def sandwich(self, w):
        """The cat×cat block of the Hessian (width, width): the diagonals
        and the cross cells."""
        H = torch.zeros((self.width, self.width), dtype=w.dtype, device=w.device)
        H.diagonal().copy_(self.plan.sum(w))
        offsets = np.concatenate([[0], np.cumsum(self.widths)])
        for (a, b), plan in self.cross.items():
            cell = plan.sum(w).reshape(self.widths[a], self.widths[b])
            ra = slice(offsets[a], offsets[a + 1])
            rb = slice(offsets[b], offsets[b + 1])
            H[ra, rb] = cell
            H[rb, ra] = cell.T
        return H


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
        # max and -min: no |data| copy of a large layout on the host
        self.absmax = float(np.maximum(mat.data.max(), -mat.data.min())) if mat.data.size else 0.0

    def rows(self, lo: int, hi: int, device) -> "_SparseBlock":
        """The block of rows ``lo:hi`` on ``device``, with layouts and plans of
        its own (the pair plan charged to the ledger)."""
        return _SparseBlock(SparseMatrix(self._csc_host[lo:hi], device=device), self.positions)

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
        self.n_local = n_rows  # the rows held here: all of them, or a rank's slab
        self.dtype = dtype
        self.shift = shift  # standardization: x -> mult*x + shift (per col)
        self.mult = mult
        self._f32 = None  # the float32 design, built once by astype_float
        # the CUDA graphs of the Hessian-vector CG solve on this design's
        # tensors (``glm._cg_solve_hvp``), freed with it
        self._hvp_graphs = {}
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
        # at most one dense and one sparse block (a SplitMatrix's fused), and
        # any number of categoricals, stacked into one block
        parts = (zip(mat.matrices, mat.indices) if isinstance(mat, SplitMatrix)
                 else [(mat, np.arange(k))])
        with _trace.span("from_matrix"):
            blocks, cats, cat_positions = [], [], []
            for m, idx in parts:
                if isinstance(m, DenseMatrix):
                    with _trace.span("from_matrix.dense"):
                        blocks.append(_DenseBlock(m.unpack(), idx))
                elif isinstance(m, SparseMatrix):
                    with _trace.span("from_matrix.sparse"):
                        blocks.append(_SparseBlock(m, idx))
                else:
                    cats.append(m)
                    cat_positions.append(idx)
            if cats:
                with _trace.span("from_matrix.cat"):
                    cat = _CatBlock(cats, np.concatenate(cat_positions))
                blocks.append(cat)
                for b in blocks:
                    if b.kind == "sparse":
                        with _trace.span("from_matrix.sparse"):
                            b.attach_cat_plan(cat)
            return cls(blocks, n, k, dtype)

    def shard(self, mesh, rows="dp", dense_cols=None) -> "ShardedDesign":
        """This rank's row slab of the design on the mesh's device — the user
        multichip path.  Every rank of the mesh calls it.

        Rows shard over the mesh axis ``rows`` (or an axis tuple, e.g.
        ``("dcn", "dp")`` for a two-level mesh); with ``dense_cols`` (a mesh
        axis) the rank keeps only its share of the dense columns too.  The
        slab's blocks are rebuilt on the rank's device from its rows: the
        dense rows, the sparse rows with their CSR, CSC and pair plan, the
        codes with their own segment, cross and sparse × cat plans.  So the
        design may live on the CPU, and no rank holds all of it on a card.

        The result feeds ``glm.irls_step`` and ``fit_glm`` unchanged, with y
        and the weights this rank's rows (``shard_rows``) and beta whole.
        """
        return ShardedDesign(self, mesh, rows, dense_cols)

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
        Its float32 blocks, ``shift`` and ``mult`` are charged to the
        device-cache ledger (``_config.cache_charge``) with the design as
        owner; when refused, the cast design is returned and not kept, so
        each call casts anew.
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
        d = object.__new__(type(self))
        d.__dict__.update(self.__dict__)
        d.blocks, d.dtype, d.shift, d.mult = blocks, dtype, cast(self.shift), cast(self.mult)
        d._hvp_graphs = {}
        kept = [t for b in blocks if b.kind != "cat" for t in b.float_tensors()]
        kept += [t for t in (d.shift, d.mult) if t is not None]
        if cache_charge(tensor_bytes(kept), self):
            self._f32 = d
        return d

    # -- ops -------------------------------------------------------------------

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``X @ v``."""
        with _trace.span("design.matvec"):
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
        with _trace.span("design.tmv"):
            segs = [b.tmv(r) for b in self.blocks]
            flat = segs[0] if len(segs) == 1 else torch.cat(segs)
            out = flat if self._identity_order else flat[self._index_map]
            if self.mult is not None:
                out = out * self.mult
            if self.shift is not None:
                out = out + self.shift * torch.sum(r)
            return out

    @property
    def sandwich_refusals(self) -> tuple:
        """Why the explicit sandwich is not available, empty when it is:
        ``"standardized"`` (a ``shift`` or ``mult``), ``"wide"`` (more than
        ``SANDWICH_MAX_COLS`` columns) and ``"plan"`` (a cat×cat cross plan,
        the sparse pair plan or the sparse×cat plan was too large to build,
        ``design.py:610-641``), each that holds."""
        cat, sparse = self._block("cat"), self._block("sparse")
        plans = ((cat is None or cat.has_cross_plans)
                 and (sparse is None or (sparse.pair is not None
                                         and (cat is None or sparse.cat is not None))))
        return tuple(reason for reason, refused in (
            ("standardized", self.shift is not None or self.mult is not None),
            ("wide", self.shape[1] > self.SANDWICH_MAX_COLS),
            ("plan", not plans),
        ) if refused)

    @property
    def supports_sandwich(self) -> bool:
        """True when the explicit sandwich is available: no
        :attr:`sandwich_refusals`.  Standardized designs take the
        Hessian-vector path, as in the reference, and so do designs past a
        width or a plan's budget."""
        return not self.sandwich_refusals

    def sandwich(self, w: torch.Tensor) -> torch.Tensor:
        """Explicit ``Xᵀ diag(w) X`` → (k, k): the dense cell through the
        sandwich kernel, the categorical cells through the segment sum, the
        sparse cells through the sparse segment product.  Each off-diagonal
        cell is computed once and mirrored, so the result is exactly
        symmetric where each diagonal cell is."""
        with _trace.span("design.sandwich"):
            dense, sparse, cat = (self._block(kind) for kind in ("dense", "sparse", "cat"))
            X = None if dense is None else dense.full()
            cells = {}
            # the cells with the longest kernels are queued first: the host
            # is the slower side, and they run while it queues the rest
            if dense is not None:
                with _trace.span("sandwich.dense"):
                    cells["dense", "dense"] = dense_ops.sandwich(X, w)
            if sparse is not None:
                with _trace.span("sandwich.sparse"):
                    cells["sparse", "sparse"] = sparse.diag(w)
                    if dense is not None:
                        cells["sparse", "dense"] = sparse.cross_dense(X, w)
                    if cat is not None:
                        cells["cat", "sparse"] = sparse.cross_cat(w, cat.width)
            if cat is not None:
                if dense is not None:
                    with _trace.span("sandwich.cat_dense"):
                        cells["cat", "dense"] = cat.plan.sum((X * w[:, None]).contiguous())
                with _trace.span("sandwich.cat"):
                    cells["cat", "cat"] = cat.sandwich(w)

            def cell(a, b):
                return cells[a, b] if (a, b) in cells else cells[b, a].T

            with _trace.span("sandwich.assemble"):
                kinds = [b.kind for b in self.blocks]
                if len(kinds) == 1:
                    H = cells[kinds[0], kinds[0]]
                else:
                    H = torch.cat([torch.cat([cell(a, b) for b in kinds], dim=1)
                                   for a in kinds])
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


class ShardedDesign(DeviceDesign):
    """A rank's row slab of a design on a mesh (:meth:`DeviceDesign.shard`).

    ``shape`` is the whole design's (n, k) and ``n_local`` the rank's rows.
    ``matvec`` gives the rank's rows of ``X @ v`` (the dense part all-reduced
    over the ``dense_cols`` axis first, when the columns are sharded too);
    ``transpose_matvec`` and ``sandwich`` take the rank's partial, the
    standardization's ``shift · Σ r`` term included once, then one
    all-reduce over the row axes, so every rank holds the whole result.
    With ``dense_cols``, the slab's dense columns are gathered within the
    ``dense_cols`` group before the sandwich's dense cells, and each rank of
    the group computes the slab's whole sandwich: the group's ranks hold the
    same rows, and the all-reduce runs over the row axes alone.

    The ranks agree where they could differ: ``absmax_bound`` (the float32
    Hessian's scale) is a MAX over the mesh, and ``supports_sandwich`` a MIN,
    taken once here, since a cache budget may refuse a plan on one rank only.
    """

    def __init__(self, source: DeviceDesign, mesh, rows="dp", dense_cols=None):
        if isinstance(source, ShardedDesign):
            raise ValueError("the design is sharded already")
        n, k = source.shape
        lo, hi = row_range(n, mesh, rows)
        device = mesh_device(mesh)
        blocks = []
        for b in source.blocks:
            if b.kind == "dense":
                X = b.X[lo:hi]
                if dense_cols is None:
                    blocks.append(_DenseBlock(X.to(device).contiguous(), b.positions))
                else:
                    cols = split_range(b.width, *shard_index(mesh, dense_cols))
                    blocks.append(_ColumnShardedDenseBlock(
                        X[:, cols[0]:cols[1]].to(device).contiguous(), b.positions, cols,
                        mesh, dense_cols))
            else:
                blocks.append(b.rows(lo, hi, device))
        cat = next((b for b in blocks if b.kind == "cat"), None)
        if cat is not None:
            for b in blocks:
                if b.kind == "sparse":
                    b.attach_cat_plan(cat)

        def replicated(x):
            return None if x is None else x.to(device)

        super().__init__(blocks, hi - lo, k, source.dtype, replicated(source.shift),
                         replicated(source.mult))
        self.shape = (n, k)
        self.mesh, self.row_axes, self.dense_cols = mesh, axes_of(rows), dense_cols
        local = torch.tensor([float(DeviceDesign.supports_sandwich.fget(self))], device=device)
        self._supports_sandwich = bool(
            all_reduce(local, mesh, mesh.mesh_dim_names, "min").item())

    @property
    def supports_sandwich(self) -> bool:
        """True when every rank's slab takes the explicit sandwich."""
        return self._supports_sandwich

    def transpose_matvec(self, r: torch.Tensor) -> torch.Tensor:
        """``X.T @ r`` with ``r`` this rank's rows."""
        return all_reduce(super().transpose_matvec(r), self.mesh, self.row_axes)

    def sandwich(self, w: torch.Tensor) -> torch.Tensor:
        """Explicit ``Xᵀ diag(w) X`` with ``w`` this rank's rows."""
        return all_reduce(super().sandwich(w), self.mesh, self.row_axes)

    def absmax_bound(self, w: torch.Tensor) -> torch.Tensor:
        """The bound over every rank's rows and columns.  A NaN becomes inf
        before the MAX, whatever the backend's MAX makes of NaN: either
        leaves the float32 scale at 1."""
        bound = super().absmax_bound(w).reshape(1)
        bound = torch.where(torch.isnan(bound), torch.full_like(bound, float("inf")), bound)
        return all_reduce(bound, self.mesh, self.mesh.mesh_dim_names, "max")[0]
