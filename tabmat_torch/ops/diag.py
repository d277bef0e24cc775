"""Diagonal sandwich results.

Port of ``tabmat_tpu/ops/diag.py``.  A categorical sandwich is diagonal;
this wrapper keeps the diagonal (a tensor or numpy array) where it was
computed, with ``to_scipy()`` for interop.
"""

from typing import Union

import numpy as np
import torch

from ..utils.arrays import to_numpy


class DiagonalResult:
    """A (k, k) diagonal matrix represented by its diagonal vector."""

    def __init__(self, diag: Union[torch.Tensor, np.ndarray]):
        self.diag = diag
        self.shape = (diag.shape[0], diag.shape[0])

    @property
    def dtype(self):
        return self.diag.dtype

    def toarray(self) -> np.ndarray:
        """Densify to a host numpy array."""
        return np.diag(to_numpy(self.diag))

    @property
    def data(self) -> np.ndarray:
        """Diagonal data in scipy ``dia_matrix.data`` layout: shape (1, k)."""
        return to_numpy(self.diag)[None, :]

    def to_scipy(self):
        """Convert to ``scipy.sparse.dia_matrix``."""
        from scipy import sparse as sps

        return sps.diags(to_numpy(self.diag))

    def __repr__(self):
        return f"DiagonalResult(k={self.shape[0]}, dtype={self.dtype})"
