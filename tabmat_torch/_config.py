"""Global configuration for tabmat_torch.

The reference library is float64 by default (``tabmat_tpu/_config.py:101``
turns on JAX's x64 mode for that).  PyTorch keeps a numpy array's float64
as it is, so the port needs no global switch: constructors keep the input's
dtype, and :data:`DEFAULT_DTYPE` is used where the reference fell back to
``jnp.float64``.

Device choice is explicit: ``device=None`` means
``torch.get_default_device()``, never "cuda if available".
"""

import torch

DEFAULT_DTYPE = torch.float64


def resolve_device(device=None) -> torch.device:
    """``device``, or ``torch.get_default_device()`` when it is None."""
    if device is None:
        return torch.get_default_device()
    return torch.device(device)
