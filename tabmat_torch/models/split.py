"""``as_tabmat`` and ``hstack`` for dense inputs.

Port of the dense part of ``tabmat_tpu/models/split.py`` (``as_tabmat``,
``hstack``).  ``SplitMatrix`` itself, and the sparse and categorical inputs
that need it, are ROADMAP A3 and A4; they raise ``NotImplementedError``.
"""

from collections.abc import Sequence

import numpy as np
import torch

from .base import MatrixBase
from .dense import DenseMatrix
from .standardized import StandardizedMatrix


def as_tabmat(a, device=None):
    """Coerce to a MatrixBase: an ndarray or tensor becomes a DenseMatrix."""
    if isinstance(a, (MatrixBase, StandardizedMatrix)):
        return a
    if isinstance(a, np.ndarray) or torch.is_tensor(a):
        return DenseMatrix(a, device=device)
    from scipy import sparse as sps

    if sps.issparse(a):
        raise NotImplementedError(
            "SparseMatrix is not ported to tabmat_torch yet (ROADMAP A4)"
        )
    raise ValueError(f"Cannot convert type {type(a)} to Matrix.")


def _device_of(tup, device):
    if device is not None:
        return torch.device(device)
    for a in tup:
        if isinstance(a, DenseMatrix):
            return a.device
        if torch.is_tensor(a):
            return a.device
    return None


def hstack(tup: Sequence, device=None) -> MatrixBase:
    """Stack dense matrices horizontally into one DenseMatrix.

    The result lives on ``device``, else on the device of the first input
    that is a tensor or a DenseMatrix, else on the default device.
    """
    if len(tup) == 0:
        raise ValueError("Need at least one array to concatenate.")
    dev = _device_of(tup, device)
    matrices = [as_tabmat(a, device=dev) for a in tup]
    if not all(isinstance(m, DenseMatrix) for m in matrices):
        kinds = sorted({type(m).__name__ for m in matrices})
        raise NotImplementedError(
            f"hstack of {kinds} needs SplitMatrix, which is not ported to "
            "tabmat_torch yet (ROADMAP A3)"
        )
    dev = matrices[0].device
    return DenseMatrix(torch.cat([m.unpack().to(dev) for m in matrices], dim=1))
