"""Global configuration for tabmat_torch.

The reference library is float64 by default (``tabmat_tpu/_config.py:101``
turns on JAX's x64 mode for that).  PyTorch keeps a numpy array's float64
as it is, so the port needs no global switch: constructors keep the input's
dtype, and :data:`DEFAULT_DTYPE` is used where the reference fell back to
``jnp.float64``.

Device choice: the JAX package puts arrays on JAX's default device, the
accelerator.  The port does the same: ``device=None`` means the CUDA card,
and raises where there is none.  The CPU is used only when the caller asks
for it, with ``device="cpu"`` or with tensors that already lie on the CPU.

The device-cache budget is the ledger of ``tabmat_tpu/_config.py:24-91``
with the same semantics under the port's name
(``TABMAT_TORCH_CACHE_BUDGET_MB``).  The JAX module's x64 switch and
compile-cache settings have no counterpart here.
"""

import os
import threading
import weakref

import torch

DEFAULT_DTYPE = torch.float64

# ---------------------------------------------------------------------------
# Global device-cache budget.
#
# A matrix keeps structures on the device that are pure speed, each with a
# route that does without it: a SparseMatrix's pair plan and densified
# mirror (``models/sparse.py``), a DeviceDesign's float32 copy
# (``parallel/design.py``).  ``TABMAT_TORCH_CACHE_BUDGET_MB`` (or
# :func:`set_cache_budget_mb`) caps the TOTAL bytes charged across all live
# owners; once the ledger is full, further builds are refused and the owners
# take their cache-free routes.  A charge is refunded when its owner is
# garbage-collected.  Default: unlimited, and then nothing is recorded.
#
# The kernels' own inputs are not charged: the CSR and CSC layouts, the
# categorical codes and the SegmentPlan tables of the gather, segment-sum
# and merge-path kernels have no route that keeps the kernel without them.
# ---------------------------------------------------------------------------

_budget_lock = threading.Lock()
_cache_budget = "unset"  # lazy env read; None = unlimited; else bytes
_cache_spent = 0


def set_cache_budget_mb(mb) -> None:
    """Set (or clear, with ``None``) the global device-cache budget."""
    global _cache_budget
    with _budget_lock:
        _cache_budget = None if mb is None else int(float(mb) * (1 << 20))


def cache_budget_bytes():
    """Current budget in bytes, or None when unlimited."""
    global _cache_budget
    if _cache_budget == "unset":
        env = os.environ.get("TABMAT_TORCH_CACHE_BUDGET_MB")
        with _budget_lock:
            if _cache_budget == "unset":
                _cache_budget = int(float(env) * (1 << 20)) if env else None
    return _cache_budget


def cache_spent_bytes() -> int:
    """Bytes currently charged against the budget."""
    return _cache_spent


def _cache_refund(nbytes: int) -> None:
    global _cache_spent
    with _budget_lock:
        _cache_spent = max(0, _cache_spent - nbytes)


def cache_charge(nbytes: int, owner=None) -> bool:
    """Charge a device cache against the global budget.

    Returns True when the build may proceed (always, when no budget is
    set).  False tells the caller to take its cache-free route.  The
    charge is refunded when ``owner`` is garbage-collected.
    """
    budget = cache_budget_bytes()
    if budget is None:
        return True
    nbytes = int(nbytes)
    global _cache_spent
    with _budget_lock:
        if _cache_spent + nbytes > budget:
            return False
        _cache_spent += nbytes
    if owner is not None:
        weakref.finalize(owner, _cache_refund, nbytes)
    return True


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None.

    Raises ``RuntimeError`` when ``device`` is None and no card is present:
    nothing falls back to the CPU unless asked.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tabmat_torch computes on the CUDA card by default and found none; "
            "pass device='cpu' (or CPU tensors) to compute on the CPU"
        )
    # with its index, so that it compares equal to a tensor's device
    return torch.device("cuda", torch.cuda.current_device())
