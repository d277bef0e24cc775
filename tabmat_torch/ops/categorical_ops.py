"""Categorical (one-hot) ops as a gather and a segment sum.

Port of ``tabmat_tpu/ops/categorical_ops.py``.  A categorical matrix is an
int32 code vector; with ``eff = codes - drop_first`` the missing and
dropped levels land below zero:

- ``matvec``:            ``out[i] = v[eff[i]]`` (gather; invalid → 0)
- ``transpose_matvec``:  ``out[c] = Σ_{i: eff[i]=c} v[i]`` (SegmentPlan)
- ``sandwich``:          diagonal ``Σ_{i: eff[i]=c} d[i]`` (SegmentPlan)
"""

import torch

from . import gather_kernel


def take_matvec(eff_codes: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[i] = v[eff_codes[i]]`` with negative codes giving zero (plain torch)."""
    if v.shape[0] == 0:
        # zero-column matrix (drop_first with a single level)
        return torch.zeros(eff_codes.shape, dtype=v.dtype, device=v.device)
    valid = eff_codes >= 0
    gathered = v[torch.clamp(eff_codes, 0, v.shape[0] - 1)]
    return torch.where(valid, gathered, torch.zeros((), dtype=v.dtype, device=v.device))


def routed_matvec(eff_codes: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The categorical matvec through the gather kernel for float tables
    (its plain version on the CPU); other dtypes take :func:`take_matvec`."""
    if v.dtype in (torch.float32, torch.float64):
        return gather_kernel.gather(v, eff_codes)
    return take_matvec(eff_codes, v)


def masked_values(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Apply a 0/1 row mask to the reduced operand."""
    return v * mask
