"""The hand-written CUDA table gather with sentinels, and its plain version.

Kernel: ``tabmat_torch/csrc/gather.cu``, instantiated for ``double`` and
``float``::

    out[i] = Σ_{c < C} table[codes[c·n + i]]

where a code outside ``[0, len(table))`` contributes exactly 0.  It
replaces ``tabmat_tpu/ops/pallas_gather.py:_gather_kernel_1plane`` /
``_gather_kernel_2plane`` (the categorical and catstack matvecs) and, for a
sorted code vector, ``tabmat_tpu/ops/pallas_window_take.py:
_window_kernel_1plane`` / ``_window_kernel_2plane`` (the window take).  The
TPU built a gather from lane shuffles and carried f64 as two f32 planes;
Hopper gathers natively in either type.

Bound: the bytes (C int32 codes in, one value per row out; the table is
read once, then from L1 and L2).  A thread takes a run of rows that fills
one 16-byte store (4 in f32, 2 in f64): its codes in one load a plane,
every table load of the run in flight at once, on one wave of resident
blocks; a plane that is not aligned to its run (n odd or not a multiple of
4, a view at an offset) takes scalar loads, and the last rows of a warp's
tile go a row a thread (the kernel decides, from the pointers).  The kernel
sums the C terms in order from the first, as the plain version does, so the
two agree bit for bit.

The wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch

from .. import _build

# Launch counts by instantiation: each rises by one where that kernel is
# launched, nowhere else.
launches = {"gather<double>": 0, "gather<float>": 0}

_NAMES = {torch.float64: "gather<double>", torch.float32: "gather<float>"}
_SYMBOLS = {"gather<double>": "tabmat_gather_f64", "gather<float>": "tabmat_gather_f32"}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p,
]

_lib = None


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def gather_plain(table: torch.Tensor, codes: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version: a padded take, then the C terms summed in order."""
    width = table.shape[0]
    padded = torch.cat([table, table.new_zeros(1)])
    idx = torch.where((codes >= 0) & (codes < width), codes, width)
    g = padded[idx].reshape(-1, n)
    out = g[0]
    for c in range(1, g.shape[0]):
        out = out + g[c]
    return out


def gather(table: torch.Tensor, codes: torch.Tensor, n: int = None) -> torch.Tensor:
    """``Σ_c table[codes[c·n + i]]`` → (n,), sentinel codes giving 0.

    ``codes`` is int32, of length ``C·n`` (``n`` defaults to its length, C = 1).
    CPU tensors take :func:`gather_plain`.  CUDA tensors launch the kernel;
    ``codes`` must be contiguous, ``table`` is made contiguous here.
    """
    if not (torch.is_tensor(table) and torch.is_tensor(codes)):
        raise TypeError("table and codes must be torch tensors")
    if table.ndim != 1 or codes.ndim != 1:
        raise ValueError(f"need a table and codes of rank 1, got {table.ndim} and {codes.ndim}")
    if table.dtype not in _NAMES:
        raise TypeError(f"table must be float64 or float32, got {table.dtype}")
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {codes.dtype}")
    if table.device != codes.device:
        raise ValueError(f"table is on {table.device} but codes on {codes.device}")
    n = codes.shape[0] if n is None else n
    if n == 0:
        return torch.zeros(0, dtype=table.dtype, device=table.device)
    if codes.shape[0] == 0 or codes.shape[0] % n:
        raise ValueError(f"{codes.shape[0]} codes are not a whole number of {n} rows")
    if table.device.type == "cpu":
        return gather_plain(table, codes, n)
    if table.device.type != "cuda":
        raise ValueError(f"the kernels run on cpu or cuda tensors, got {table.device}")
    if not codes.is_contiguous():
        raise ValueError("the CUDA gather needs contiguous codes")
    name = _NAMES[table.dtype]
    table = table.contiguous()
    device = table.device
    if device.index == torch.cuda.current_device():
        out = _launch(name, table, codes, n, device)
    else:
        with torch.cuda.device(device):
            out = _launch(name, table, codes, n, device)
    launches[name] += 1
    return out


def _launch(name: str, table: torch.Tensor, codes: torch.Tensor, n: int, device):
    """Launch ``name`` on ``device`` (the current device) and its current
    stream; raise if the launch failed."""
    lib = _library()
    out = torch.empty(n, dtype=table.dtype, device=device)
    err = getattr(lib, _SYMBOLS[name])(
        table.data_ptr(), table.shape[0], codes.data_ptr(), n, codes.shape[0] // n,
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.raise_on(lib, err, "gather.cu kernel")
    return out


def _library():
    """The built ``gather.cu`` with its C functions typed (built at first use)."""
    global _lib
    if _lib is None:
        _lib = _build.bind("gather", {symbol: _ARGTYPES for symbol in _SYMBOLS.values()})
    return _lib
