"""Host/device array plumbing.

tabmat_torch keeps the reference's two calling conventions
(``tabmat_tpu/utils/arrays.py:1-13``), with torch tensors in place of jax
arrays:

- numpy in → numpy out, and a numpy ``out=`` buffer is updated in place;
- tensor in → tensor out, on the input tensor's own device.  A tensor
  ``out=`` is ALSO updated in place (``out.add_``) and returned.  This
  differs from the JAX package, whose ``out=`` branch for device arrays is
  functional (``out + result``): torch tensors are mutable, and an in-place
  update saves a copy of ``out``.
"""

from typing import Optional

import numpy as np
import torch

from .._config import resolve_device
from .validation import as_numpy_dtype


def as_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def to_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``.

    A tensor keeps its own device when ``device`` is None; anything else goes
    to the CUDA card (:func:`~tabmat_torch._config.resolve_device`).  Host
    data is always copied, so the result never aliases a caller's numpy
    buffer.
    """
    dtype = None if dtype is None else as_torch_dtype(dtype)
    if torch.is_tensor(x):
        return x.to(device=x.device if device is None else device, dtype=dtype)
    return torch.tensor(np.asarray(x), device=resolve_device(device), dtype=dtype)


def to_numpy(x) -> np.ndarray:
    """Bring an array or tensor to the host as numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def result_like(template, result: torch.Tensor):
    """Match the caller's array flavor.

    A tensor ``template`` gets ``result`` on the template's device; anything
    else (numpy, lists) gets a fresh writable numpy array.
    """
    if torch.is_tensor(template):
        return result.to(template.device)
    return np.array(to_numpy(result))


def add_into_out(out, result: torch.Tensor):
    """Apply tabmat's ``out=`` accumulation contract.

    - ``out is None``  → return ``result``;
    - numpy ``out``    → ``out += result`` in place, return ``out``;
    - tensor ``out``   → ``out.add_(result)`` in place, return ``out``.
    """
    if out is None:
        return result
    if isinstance(out, np.ndarray):
        out += to_numpy(result).astype(out.dtype, copy=False)
        return out
    return out.add_(result.to(device=out.device, dtype=out.dtype))


def rows_to_mask(rows, n_rows: int, dtype, device) -> Optional[torch.Tensor]:
    """Turn a row active-set into a 0/1 multiplicative mask on ``device``.

    Row restriction of any of the three core ops is exactly equivalent to
    zeroing the complementary rows of the reduced operand (``d`` or ``vec``),
    because each op is a linear reduction over rows.  Returns None when the
    restriction covers all rows.
    """
    if rows is None or len(rows) == n_rows:
        return None
    idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)
    mask = torch.zeros(n_rows, dtype=as_torch_dtype(dtype), device=device)
    return mask.index_fill_(0, idx, 1)


def cols_to_mask(cols, n_cols: int, dtype, device) -> Optional[torch.Tensor]:
    """Turn a column active-set into a 0/1 mask over columns on ``device``."""
    return rows_to_mask(cols, n_cols, dtype, device)



def tensor_bytes(tensors) -> int:
    """Bytes of the tensors in ``tensors`` (what a cache charges against
    ``_config.cache_charge``)."""
    return sum(t.numel() * t.element_size() for t in tensors)
