"""Dense ops: sandwich, matvec, transpose-matvec, weighted column stats.

Port of ``tabmat_tpu/ops/dense_ops.py``:

- ``sandwich`` goes through :mod:`.sandwich_kernel`: for a CUDA tensor the
  hand-written CUDA kernel its width dispatch names (narrow k ≤ 32, the
  FFMA tile, the FP64 tensor cores for f64 k > 128), for a CPU tensor the
  plain version.  This one route replaces the reference's v3/v4/v5 plane
  kernels, slice-pair kernels and the f32 Pallas kernel, which exist only
  because the TPU lacks native f64.
- Row restriction multiplies a 0/1 mask into ``d``/``vec`` (exact: every op
  is a linear reduction over rows); column restriction is an
  ``index_select`` on the small column axis.  The result is the exact
  (k, k) matrix: the reference's power-of-two column buckets only bounded
  XLA recompiles.
- ``matvec``/``transpose_matvec`` are ``torch.matmul``.  The reference
  computes them outside any Pallas kernel too (XLA einsums).
"""

from typing import Optional

import numpy as np
import torch

from . import sandwich_kernel


def sandwich(X: torch.Tensor, d: torch.Tensor, out=None) -> torch.Tensor:
    """Unrestricted sandwich ``X.T @ diag(d) @ X`` → (k, k); with ``out`` a
    (k, k) tensor the product is added into it."""
    return sandwich_kernel.sandwich(X, d, out)


def sandwich_restricted(
    X: torch.Tensor,
    d: torch.Tensor,
    row_mask: Optional[torch.Tensor],
    cols: Optional[np.ndarray],
) -> torch.Tensor:
    """Sandwich with active-set restriction → (len(cols), len(cols))."""
    dm = d if row_mask is None else d * row_mask
    if cols is None:
        return sandwich(X, dm)
    idx = torch.as_tensor(np.asarray(cols, dtype=np.int64), device=X.device)
    return sandwich(X.index_select(1, idx), dm)


def matvec(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``X @ v`` (v may be 1-d or 2-d)."""
    return X @ v


def transpose_matvec(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``X.T @ v`` (v may be 1-d or 2-d)."""
    return X.T @ v


def transpose_square_dot_weights(
    X: torch.Tensor, weights: torch.Tensor, shift: torch.Tensor
) -> torch.Tensor:
    """``sum_i weights[i] * (X[i, j] - shift[j])**2`` per column j.

    The shifted form is the numerically robust variance used by the
    reference for dense column stds (``tabmat/ext/dense.pyx:103-122``).
    """
    centered = X - shift[None, :]
    return torch.sum(weights[:, None] * centered * centered, dim=0)
