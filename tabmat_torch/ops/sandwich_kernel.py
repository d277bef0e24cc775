"""The hand-written CUDA sandwich ``S = Xᵀ diag(d) X``, its range prepass,
and their plain versions.

Kernels: ``tabmat_torch/csrc/sandwich.cu``.

- ``sandwich``: one template instantiated for ``double`` and ``float``.  It
  replaces ``tabmat_tpu/ops/pallas_sandwich_v4.py:_v4_kernel`` (exact f64
  through int8 anti-diagonal plane dots) and
  ``tabmat_tpu/ops/pallas_kernels.py:_sandwich_kernel`` (full f32 at
  ``Precision.HIGHEST``).  Hopper has native FP64, so ``sandwich<double>``
  computes the function directly, without planes; ``sandwich<float>`` uses
  plain FFMA, never TF32.
- ``column_absmax``: ``max_i |X[i, j]| · |d[i]|`` per column, replacing the
  v4 prepass ``pallas_sandwich_v4.py:_max_kernel``.  The TPU used these
  maxima to pick the plane exponents that keep the scaled values in range.
  The port's narrow format is the float32 Hessian of the default IRLS step,
  and ``glm.irls_step`` uses the maxima to pick the power-of-two weight scale
  that keeps that Hessian in range.

Bound at 1M × 50 f64: about 2.5 GFLOP (upper triangle) against 400 MB of
X, roughly 6 FLOP/byte, just under the H100's FP64 ridge of about
10 FLOP/byte (34 TFLOP/s without tensor cores over 3.35 TB/s, NVIDIA's data
sheet).  So the sandwich reads X once per 64-column tile (once in all for
k ≤ 64) with d folded into the staged rows, splits the rows so that the grid
fills one wave of the blocks an SM holds at once (the occupancy the CUDA
runtime reports), and sums the per-block partials in a second pass in a
fixed order: no atomics, so results repeat exactly and S is exactly
symmetric.  The prepass reads the f32 X once.

The wrappers take the plain version only for a tensor on the CPU; for a
CUDA tensor they launch the kernel or raise.
"""

import ctypes

import torch

# Launch counts by kernel: each rises by one where that kernel is launched,
# nowhere else.  ``sandwich_launches`` is the sum of the two sandwiches.
launches = {"sandwich<double>": 0, "sandwich<float>": 0, "column_absmax": 0}

_SANDWICH_NAMES = {torch.float64: "sandwich<double>", torch.float32: "sandwich<float>"}

# Must match csrc/sandwich.cu.
TILE = 64
ROWS = 32
AM_COLS = 32
AM_ROWS = 8
MAX_SPLITS = 65535  # gridDim.y limit

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p,
]
_SYMBOLS = {
    "sandwich<double>": "tabmat_sandwich_f64",
    "sandwich<float>": "tabmat_sandwich_f32",
    "column_absmax": "tabmat_column_absmax",
}
_lib = None
_blocks_per_sm: dict = {}  # dtype -> resident sandwich blocks per SM


def __getattr__(name):
    if name == "sandwich_launches":
        return launches["sandwich<double>"] + launches["sandwich<float>"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def sandwich_plain(X: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``(X * d[:, None]).T @ X`` in X's dtype."""
    return (X * d[:, None]).T @ X


def column_absmax_plain(X: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain ``max_i |X[i, j]| · |d[i]|`` per column, in float64."""
    if X.shape[0] == 0:
        return torch.zeros(X.shape[1], dtype=torch.float64, device=X.device)
    return (X.abs().to(torch.float64) * d.abs()[:, None]).amax(dim=0)


def _split_rows(n: int, splits: int, multiple: int):
    """``(splits, rows_per_split)`` with every split holding rows and each
    split a whole number of ``multiple`` rows."""
    splits = max(1, min(splits, MAX_SPLITS))
    rows_per_split = -(-max(n, 1) // splits)
    rows_per_split = -(-rows_per_split // multiple) * multiple
    return -(-max(n, 1) // rows_per_split), rows_per_split


def launch_plan(n: int, k: int, n_sm: int, blocks_per_sm: int):
    """Row split of the sandwich's first pass: ``(splits, rows_per_split)``.

    The grid fills one wave of ``n_sm * blocks_per_sm`` resident blocks,
    never one block more: every block does the same work, so one extra
    block on one SM costs a whole block's time, and at the main path's
    k = 50 more waves were slower (PERF.md).  Each split is a whole number
    of ``ROWS``-row stages.
    """
    nt = -(-k // TILE)
    pairs = nt * (nt + 1) // 2
    return _split_rows(n, n_sm * blocks_per_sm // pairs, ROWS)


def absmax_plan(n: int, k: int, n_sm: int):
    """Row split of the prepass: ``(splits, rows_per_split)``.

    An SM holds 2048 threads, so 8 of the 256-thread blocks; the grid asks
    for one such wave over the column blocks.
    """
    col_blocks = -(-k // AM_COLS)
    return _split_rows(n, n_sm * (2048 // (AM_COLS * AM_ROWS)) // col_blocks, 1)


def _check(X, d, x_dtypes, d_dtype=None) -> None:
    if not (torch.is_tensor(X) and torch.is_tensor(d)):
        raise TypeError("X and d must be torch tensors")
    if X.ndim != 2 or d.ndim != 1:
        raise ValueError(f"need X of rank 2 and d of rank 1, got {X.ndim} and {d.ndim}")
    if X.shape[0] != d.shape[0]:
        raise ValueError(f"X has {X.shape[0]} rows but d has {d.shape[0]}")
    if X.dtype not in x_dtypes:
        raise TypeError(f"X must be one of {x_dtypes}, got {X.dtype}")
    if d.dtype != (X.dtype if d_dtype is None else d_dtype):
        raise TypeError(f"X is {X.dtype} but d is {d.dtype}")
    if X.device != d.device:
        raise ValueError(f"X is on {X.device} but d is on {d.device}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda tensors, got {X.device}")
    if X.device.type == "cuda" and not X.is_contiguous():
        # a silent copy of X would double the traffic
        raise ValueError("the CUDA kernels need a contiguous (row-major) X")


def sandwich(X: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``Xᵀ diag(d) X`` → (k, k) in X's dtype (float64 or float32), on X's device.

    CPU tensors take :func:`sandwich_plain`.  CUDA tensors launch the
    kernel; X must be contiguous, d is made contiguous here.
    """
    _check(X, d, tuple(_SANDWICH_NAMES))
    if X.device.type == "cpu":
        return sandwich_plain(X, d)
    n, k = X.shape
    if n == 0 or k == 0:
        return torch.zeros((k, k), dtype=X.dtype, device=X.device)
    name = _SANDWICH_NAMES[X.dtype]
    with torch.cuda.device(X.device):
        lib = _library()
        if X.dtype not in _blocks_per_sm:
            blocks = ctypes.c_int(0)
            _raise_on(lib, lib.tabmat_sandwich_blocks_per_sm(
                int(X.dtype == torch.float64), ctypes.byref(blocks)))
            _blocks_per_sm[X.dtype] = max(1, blocks.value)
        n_sm = torch.cuda.get_device_properties(X.device).multi_processor_count
        splits, rows_per_split = launch_plan(n, k, n_sm, _blocks_per_sm[X.dtype])
        out = torch.empty((k, k), dtype=X.dtype, device=X.device)
        partial = torch.empty((splits, k, k), dtype=X.dtype, device=X.device)
        _launch(lib, name, X, d.contiguous(), out, partial, n, k, splits, rows_per_split)
    return out


def column_absmax(X: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``max_i |X[i, j]| · |d[i]|`` → (k,) float64, for a float32 X and float64 d.

    CPU tensors take :func:`column_absmax_plain`; CUDA tensors launch the
    kernel.  NaN propagates.
    """
    _check(X, d, (torch.float32,), torch.float64)
    if X.device.type == "cpu":
        return column_absmax_plain(X, d)
    n, k = X.shape
    if n == 0 or k == 0:
        return torch.zeros(k, dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        lib = _library()
        n_sm = torch.cuda.get_device_properties(X.device).multi_processor_count
        splits, rows_per_split = absmax_plan(n, k, n_sm)
        out = torch.empty(k, dtype=torch.float64, device=X.device)
        partial = torch.empty((splits, k), dtype=torch.float64, device=X.device)
        _launch(lib, "column_absmax", X, d.contiguous(), out, partial, n, k, splits,
                rows_per_split)
    return out


def _library():
    """The built ``sandwich.cu`` with its C functions typed (built at first use)."""
    global _lib
    if _lib is None:
        from .. import _build

        signatures = {symbol: _ARGTYPES for symbol in _SYMBOLS.values()}
        signatures["tabmat_sandwich_blocks_per_sm"] = [ctypes.c_int, ctypes.c_void_p]
        _lib = _build.bind("sandwich", signatures)
    return _lib


def _raise_on(lib, err: int) -> None:
    from .. import _build

    _build.raise_on(lib, err, "sandwich.cu kernel")


def _launch(lib, name, X, d, out, partial, n, k, splits, rows_per_split) -> None:
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = getattr(lib, _SYMBOLS[name])(
        X.data_ptr(), d.data_ptr(), out.data_ptr(), partial.data_ptr(),
        n, k, splits, rows_per_split, stream,
    )
    _raise_on(lib, err)
    launches[name] += 1
