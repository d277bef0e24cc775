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
"""

import torch

DEFAULT_DTYPE = torch.float64


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
