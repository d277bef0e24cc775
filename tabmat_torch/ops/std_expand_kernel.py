"""The hand-written CUDA expansion of the standardized sandwich, and its
plain version.

Kernel: ``tabmat_torch/csrc/std_expand.cu``, instantiated for ``double``
and ``float``, in place on the inner sandwich ``T`` (k, k)::

    R[i, j] = T[i, j]·(m_i·m_j) + a_i·s_j + s_i·a_j + (s_i·s_j)·σ,   a = m ∘ t

with ``t`` the inner transpose-matvec of the weights, ``s`` the shift,
``m`` the multiplier (``None``: a view that only centres, ``a = t`` and
``T`` added as it is) and ``σ`` the weights' sum, a one-element tensor on
the device (no host sync).  It serves ``StandardizedMatrix.sandwich``
(``models/standardized.py``) on the card wherever the inner sandwich is not
diagonal: one read and one write of ``T`` in place of the eager
expansion's nine (k, k) passes.  Each entry is rounded as the eager
expansion rounds it, in its order, so the result is bit for bit that of
:func:`std_expand_plain`.

The wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

import ctypes
from typing import Optional

import torch

# Launch counts by instantiation: each rises by one where that kernel is
# launched, nowhere else.
launches = {"std_expand<double>": 0, "std_expand<float>": 0}

_NAMES = {torch.float64: "std_expand<double>", torch.float32: "std_expand<float>"}
_SYMBOLS = {"std_expand<double>": "tabmat_std_expand_f64",
            "std_expand<float>": "tabmat_std_expand_f32"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]

_lib = None


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def std_expand_plain(T: torch.Tensor, t: torch.Tensor, shift: torch.Tensor,
                     mult: Optional[torch.Tensor], sigma: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in place on ``T``: the eager expansion's
    operations in their order (the outer products of ``a = mult * t`` and
    ``shift``, their sum, the scaled ``outer(shift, shift)``, ``T ∘
    outer(mult, mult)`` and the last sum).  Returns ``T``."""
    a = t if mult is None else t * mult
    res = torch.outer(a, shift) + torch.outer(shift, a) + torch.outer(shift, shift) * sigma
    if mult is not None:
        T.mul_(torch.outer(mult, mult))
    return T.add_(res)


def std_expand(T: torch.Tensor, t: torch.Tensor, shift: torch.Tensor,
               mult: Optional[torch.Tensor], sigma: torch.Tensor) -> torch.Tensor:
    """``T ∘ outer(mult, mult) + outer(a, shift) + outer(shift, a) +
    outer(shift, shift)·σ`` in place on ``T`` (k, k), ``a = mult * t``;
    returns ``T``.

    ``t``, ``shift`` and ``mult`` (or ``None``) are (k,), ``sigma`` holds one
    value; all float64 or all float32, contiguous, on one device.  CPU
    tensors take :func:`std_expand_plain`; CUDA tensors launch the kernel.
    """
    vectors = [t, shift] + ([] if mult is None else [mult])
    operands = [T] + vectors + [sigma]
    if not all(torch.is_tensor(x) for x in operands):
        raise TypeError("T, t, shift, mult and sigma must be torch tensors")
    if T.dtype not in _NAMES:
        raise TypeError(f"T must be float64 or float32, got {T.dtype}")
    if any(x.dtype != T.dtype for x in operands):
        raise TypeError(f"t, shift, mult and sigma must have T's dtype, {T.dtype}")
    if T.ndim != 2 or T.shape[0] != T.shape[1]:
        raise ValueError(f"T must be square (k, k), got shape {tuple(T.shape)}")
    k = T.shape[0]
    if any(x.shape != (k,) for x in vectors):
        raise ValueError(f"t, shift and mult must have shape ({k},)")
    if sigma.numel() != 1:
        raise ValueError(f"sigma must hold one value, got {sigma.numel()}")
    device = T.device
    if any(x.device != device for x in operands):
        raise ValueError("T, t, shift, mult and sigma must lie on one device")
    if not all(x.is_contiguous() for x in operands):
        raise ValueError("std_expand needs contiguous T, t, shift, mult and sigma")
    if device.type == "cpu":
        return std_expand_plain(T, t, shift, mult, sigma.reshape(()))
    if device.type != "cuda":
        raise ValueError(f"the kernels run on cpu or cuda tensors, got {device}")
    if k == 0:
        return T
    name = _NAMES[T.dtype]
    from .. import _build

    with torch.cuda.device(device):
        lib = _library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, _SYMBOLS[name])(
            T.data_ptr(), t.data_ptr(), shift.data_ptr(),
            None if mult is None else mult.data_ptr(), sigma.data_ptr(), k, stream,
        )
        _build.raise_on(lib, err, "std_expand.cu kernel")
        launches[name] += 1
    return T


def _library():
    """The built ``std_expand.cu`` with its C functions typed (built at first use)."""
    global _lib
    if _lib is None:
        from .. import _build

        _lib = _build.bind("std_expand", {symbol: _ARGTYPES for symbol in _SYMBOLS.values()})
    return _lib
