"""A mixed-design GLM training step that shards over rows.

Port of ``tabmat_tpu/parallel/distributed.py``: one function covering the
whole tabmat workload, a design of dense, sparse (CSR and CSC) and
categorical columns, written straight against the device kernels.

- ``design_matvec`` is the dense ``matmul``, the sparse product ``spmv<T>``
  over the CSR layout and the gather ``gather<T>`` of the codes;
- ``design_transpose_matvec`` is the dense ``matmul``, ``spmv<T>`` over the
  CSC layout and the segment sum ``segsum<T>`` over ``(cat_perm,
  cat_bounds)``.

Each of those sums is the reference's cumsum difference at the bounds
(``distributed.py:42-45``), summed segment by segment.  On a mesh, each rank
holds its rows (:func:`shard_mixed_design` rebuilds a rank's CSR, CSC and
``perm``/``bounds`` from them, where the reference lets GSPMD re-shard
``cat_perm``), and :func:`mixed_irls_step` all-reduces each transpose-matvec
over ``dp``.
"""

import dataclasses

import numpy as np
import torch

from .._config import resolve_device
from ..ops import gather_kernel, sparse_ops
from ..ops.segments import SegmentPlan, build_plan
from .mesh import all_reduce, mesh_device, row_range


@dataclasses.dataclass(eq=False)
class MixedDesign:
    """Device tensors of a dense + sparse + categorical design.

    Column layout: [dense | sparse | categorical].  The segment layouts the
    kernels walk (and the tables they build at a first launch) are made
    once, at the first op (:meth:`plans`).
    """

    dense: torch.Tensor  # (n, kd)
    sp_csr_data: torch.Tensor  # (nnz,)
    sp_csr_cols: torch.Tensor  # (nnz,) int32
    sp_csr_bounds: torch.Tensor  # (n+1,) int32
    sp_csc_data: torch.Tensor  # (nnz,)
    sp_csc_rows: torch.Tensor  # (nnz,) int32
    sp_csc_bounds: torch.Tensor  # (ks+1,) int32
    cat_codes: torch.Tensor  # (n,) int32
    cat_perm: torch.Tensor  # (n,) int32, argsort of codes
    cat_bounds: torch.Tensor  # (kc+1,) int32
    _plans: tuple = dataclasses.field(default=None, init=False, repr=False)

    def plans(self) -> tuple:
        """``(csr, csc, cat)`` SegmentPlans over the design's own arrays."""
        if self._plans is None:
            n, ks = self.dense.shape[0], self.sp_csc_bounds.shape[0] - 1
            self._plans = (SegmentPlan(self.sp_csr_cols, self.sp_csr_bounds, ks),
                           SegmentPlan(self.sp_csc_rows, self.sp_csc_bounds, n),
                           SegmentPlan(self.cat_perm, self.cat_bounds, n))
        return self._plans


FIELDS = tuple(f.name for f in dataclasses.fields(MixedDesign) if f.init)


def design_matvec(dz: MixedDesign, v: torch.Tensor) -> torch.Tensor:
    """``X @ v`` for the mixed design (v in global column layout)."""
    kd = dz.dense.shape[1]
    ks = dz.sp_csc_bounds.shape[0] - 1
    vd, vs, vc = v[:kd], v[kd : kd + ks], v[kd + ks :]
    csr, _, _ = dz.plans()
    out = dz.dense @ vd
    out = out + sparse_ops.csr_matvec(dz.sp_csr_data, csr, vs.contiguous())
    return out + gather_kernel.gather(vc, dz.cat_codes)


def design_transpose_matvec(dz: MixedDesign, r: torch.Tensor) -> torch.Tensor:
    """``Xᵀ @ r`` for the mixed design → global column layout."""
    _, csc, cat = dz.plans()
    r = r.contiguous()
    gd = dz.dense.T @ r
    gs = sparse_ops.csc_rmatvec(dz.sp_csc_data, csc, r)
    return torch.cat([gd, gs, cat.sum(r)])


def mixed_irls_step(
    dz: MixedDesign,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    beta: torch.Tensor,
    family: str = "poisson",
    n_cg: int = 8,
    mesh=None,
) -> torch.Tensor:
    """One full GLM training step over the mixed design.

    With ``mesh``, ``dz``, ``y`` and ``sample_weight`` are this rank's rows
    over ``dp`` (:func:`shard_mixed_design`, ``shard_rows``) and beta is
    whole: each transpose-matvec is all-reduced over ``dp``, so every rank
    takes the same step.
    """
    from ..glm import _cg_solve, _family_terms

    def tmv(r):
        out = design_transpose_matvec(dz, r)
        return out if mesh is None else all_reduce(out, mesh, "dp")

    eta = design_matvec(dz, beta)
    mu, w_irls, resid = _family_terms(family, eta, y)
    w = sample_weight * w_irls
    grad = tmv(sample_weight * resid)

    def hvp(v):
        return tmv(w * design_matvec(dz, v)) + 1e-8 * v

    delta = _cg_solve(hvp, grad, n_cg)
    return beta + delta


def _mixed_design(dense, sp, codes: np.ndarray, kc: int, device) -> MixedDesign:
    """The MixedDesign of a dense block, a scipy CSR block and codes in
    ``[0, kc)``, on ``device``: the CSC, and the codes' plan by
    :func:`~..ops.segments.build_plan` (the reference's stable argsort and
    bounds, bit for bit)."""
    csc = sp.tocsc()
    plan = build_plan(codes, kc, device)
    arrays = dict(
        dense=dense,
        sp_csr_data=sp.data,
        sp_csr_cols=sp.indices.astype(np.int32),
        sp_csr_bounds=sp.indptr.astype(np.int32),
        sp_csc_data=csc.data,
        sp_csc_rows=csc.indices.astype(np.int32),
        sp_csc_bounds=csc.indptr.astype(np.int32),
        cat_codes=codes,
        cat_perm=plan.perm,
        cat_bounds=plan.bounds,
    )
    return MixedDesign(**{name: torch.as_tensor(a, device=device) for name, a in arrays.items()})


def build_mixed_design(n: int, kd: int, ks: int, kc: int, seed: int = 0, density: float = 0.1,
                       device=None) -> MixedDesign:
    """A random MixedDesign, the reference's numpy draws, on ``device``
    (None: the card; ``"cpu"``: the CPU)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, kd))

    from scipy import sparse as sps

    sp = sps.random(n, ks, density=density, random_state=seed, format="csr")
    codes = rng.integers(0, kc, n).astype(np.int32)
    return _mixed_design(dense, sp, codes, kc, device)


def shard_mixed_design(dz: MixedDesign, mesh) -> MixedDesign:
    """This rank's rows (sharded over ``dp``) of ``dz`` on its device.

    The CSR slab is a slice; its CSC and the categorical ``perm``/``bounds``
    are rebuilt from the slab's rows, as the design's own were built.
    """
    from scipy import sparse as sps

    n = dz.dense.shape[0]
    ks, kc = dz.sp_csc_bounds.shape[0] - 1, dz.cat_bounds.shape[0] - 1
    lo, hi = row_range(n, mesh, "dp")
    indptr = dz.sp_csr_bounds[lo : hi + 1].cpu().numpy()
    a, b = int(indptr[0]), int(indptr[-1])
    sp = sps.csr_matrix((dz.sp_csr_data[a:b].cpu().numpy(), dz.sp_csr_cols[a:b].cpu().numpy(),
                         indptr - a), shape=(hi - lo, ks))
    return _mixed_design(dz.dense[lo:hi].cpu(), sp, dz.cat_codes[lo:hi].cpu().numpy(), kc,
                         mesh_device(mesh))
