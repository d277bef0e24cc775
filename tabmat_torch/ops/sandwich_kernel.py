"""The hand-written CUDA sandwiches ``S = Xᵀ diag(d) X``, their width
dispatch, the range prepass, and their plain versions.

Kernels, one wrapper each, chosen by :func:`route` on the width k and the
dtype:

- float64: k ≤ 32 ``sandwich_narrow<double>``, 33-128
  ``sandwich_mma_tri<double>``, k > 128 ``sandwich_mma<double>``;
- float32: k ≤ 32 ``sandwich_narrow<float>``, 33-176 ``sandwich_tri<float>``,
  k > 176 ``sandwich_wide<float>``.

- ``sandwich_narrow<T>`` (``csrc/sandwich_narrow.cu``, k ≤ 32, f64 and
  f32): replaces ``tabmat_tpu/ops/pallas_sandwich_v3.py:_v3p_kernel`` (k
  narrow, G = ⌊100/k⌋ row groups packed into the lanes) and the packed mode
  of ``pallas_sandwich_v4.py:_v4_kernel`` and
  ``pallas_sandwich_v5.py:_v5_kernel`` (G = ⌊128/k⌋), in f32
  ``pallas_kernels.py:_sandwich_kernel`` at these widths.  Bound by the
  bytes of X (1 FLOP/byte at k = 10): a block owns every upper-triangle
  entry in 4 × 4 register micro-tiles and reads X once, coalesced; the row
  splits fill one wave.
- ``sandwich_tri<float>`` (``csrc/sandwich_tri.cu``, f32 33 ≤ k ≤ 176):
  replaces ``pallas_kernels.py:_sandwich_kernel`` (``Precision.HIGHEST``)
  at these widths.  The narrow kernel's design with 8 × 8 micro-tiles: a
  block owns the whole upper triangle (at most 253 micro-tiles, one a
  thread), rows staged at a padded pitch with three cp.async stages, four
  16-byte shared loads for 64 FFMAs.  Bound by bytes at 1M × 50 and by
  operations at 400k × 160.
- ``sandwich_mma_tri<double>`` (``csrc/sandwich_mma_tri.cu``, f64
  33 ≤ k ≤ 128): replaces ``pallas_sandwich_v4.py:_v4_kernel`` (exact f64
  through int8 anti-diagonal plane dots), the unpacked
  ``pallas_sandwich_v5.py:_v5_kernel`` and ``pallas_sandwich_v3.py:_v3_kernel``
  at these widths.  A block owns the upper triangle in ``m16n8k8``
  accumulator tiles on the FP64 tensor cores (16 tiles at k = 50, 72 at
  128), each warp two bands of row blocks; the A fragments are the B
  fragments times the weights, so X is staged once, by three cp.async
  stages at a conflict-free pitch.  Bound by bytes at 1M × 50 (0.122 ms)
  and nearly level at 1M × 128 (0.308 ms of bytes, 0.275 of padded MMAs).
- ``sandwich_wide<float>`` (``csrc/sandwich_wide.cu``, f32 k > 176):
  replaces ``pallas_kernels.py:_sandwich_kernel`` past 176 (and the XLA
  einsum the JAX package takes past its k ≤ 1023).  A block owns one pair
  of 128-column tiles (the last tile the remainder) in 8 × 8 FFMA
  micro-tiles, warps of 64 × 32 outputs that skip the products where they
  lie past the tile or below a diagonal pair's diagonal; both strips staged
  by three cp.async stages of 32 rows, d·x applied once a stage to the
  staged a-strip, four 16-byte shared loads for 64 FFMAs.  Bound by
  operations.
- ``sandwich<T>`` (``csrc/sandwich.cu``): off the route in both dtypes,
  reached only through :func:`sandwich_tiled`, the yardstick of the triangle
  and wide kernels.  A 64 × 64 FFMA tile per upper tile pair, X read once
  per column tile (once in all for k ≤ 64).
- ``sandwich_mma<double>`` (``csrc/sandwich_mma.cu``, f64 k > 128):
  replaces ``tabmat_tpu/ops/pallas_pairs.py:_pairs_kernel`` and
  ``:_sliced_pairs_kernel`` (the slice-pair contractions whose f64
  combination is ``AᵀB`` with A = d·X, the TPU default for 128 < k ≤ 160),
  and v3 / v5 beyond one lane tile.  Balanced at 400k × 160 (0.153 ms of
  bytes, 0.154 ms of operations at 67 TFLOP/s), bound by operations at
  k = 10⁴: FP64 tensor cores through ``mma.sync.m16n8k8``, 64 × 64 tiles
  of four 32 × 32 warp tiles.

Hopper has native FP64, so every f64 kernel computes the function
directly, without the TPU's planes; f32 uses FFMA, never TF32.  Each
kernel sums its per-block partials in a second pass in a fixed order: no
atomics, so results repeat bit for bit and S is exactly symmetric.  With
``out=`` the second pass adds S into ``out``, so row panels of one product
sum in order in one (k, k) buffer.  128 is where the JAX package leaves v4
for the pair kernels (``pallas_sandwich_v4.py:71``); 176 is the widest k
whose upper 8 × 8 micro-tiles fit one 256-thread block.

- ``column_absmax``: ``max_i |X[i, j]| · |d[i]|`` per column, replacing the
  v4 prepass ``pallas_sandwich_v4.py:_max_kernel``.  The TPU used these
  maxima to pick the plane exponents that keep the scaled values in range.
  The port's narrow format is the float32 Hessian of the default IRLS step,
  and ``glm.irls_step`` uses the maxima to pick the power-of-two weight scale
  that keeps that Hessian in range.  It reads the f32 X once.

The plain version of every sandwich is :func:`sandwich_plain`.  The
wrappers take it only for a tensor on the CPU; for a CUDA tensor they launch
the kernel or raise.
"""

import ctypes
import functools

import torch

# Launch counts by kernel: each rises by one where that kernel is launched,
# nowhere else.  ``sandwich_launches`` is the sum over the sandwiches.
launches = {
    "sandwich<double>": 0, "sandwich<float>": 0,
    "sandwich_narrow<double>": 0, "sandwich_narrow<float>": 0,
    "sandwich_tri<float>": 0, "sandwich_wide<float>": 0, "sandwich_mma<double>": 0,
    "sandwich_mma_tri<double>": 0, "column_absmax": 0,
}

# Must match csrc/sandwich.cu, csrc/sandwich_narrow.cu, csrc/sandwich_tri.cu,
# csrc/sandwich_wide.cu, csrc/sandwich_mma.cu and csrc/sandwich_mma_tri.cu.
TILE = 64  # the output tile of sandwich<T> and sandwich_mma<double>
ROWS = 32
NARROW_MAX_K = 32
TRI_MT = 8  # the micro-tile edge of sandwich_tri<float>
TRI_MIN_K = 33  # the kernel is built for 5 to 22 micro-tiles a side
TRI_MAX_K = 176  # 22 micro-tiles a side: 253 upper ones, one a thread of 256
WIDE_TILE = 128  # the column tile of sandwich_wide<float>, for k > TRI_MAX_K
WIDE_ROWS = 32  # rows of X a stage of sandwich_wide<float>
WIDE_MIN_K = 129  # f64 widths for the tensor cores (pallas_sandwich_v4.py:71)
MMA_TRI_MIN_K = 33  # sandwich_mma_tri<double>: 5 to 16 column blocks of 8
MMA_TRI_MAX_K = WIDE_MIN_K - 1
MMA_FRAG = 128  # doubles of one m16n8k8 accumulator tile: 32 lanes x 4
AM_COLS = 32
AM_ROWS = 8
MAX_SPLITS = 65535  # gridDim.y limit

_SANDWICH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_void_p,
]
# sandwich_wide.cu takes a device table of rows a split, one a tile pair
_WIDE_ARGTYPES = _SANDWICH_ARGTYPES[:7] + [ctypes.c_void_p] + _SANDWICH_ARGTYPES[8:]
_ABSMAX_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p,
]
# kernel -> (source in csrc/, C function)
_KERNELS = {
    "sandwich<double>": ("sandwich", "tabmat_sandwich_f64"),
    "sandwich<float>": ("sandwich", "tabmat_sandwich_f32"),
    "sandwich_narrow<double>": ("sandwich_narrow", "tabmat_sandwich_narrow_f64"),
    "sandwich_narrow<float>": ("sandwich_narrow", "tabmat_sandwich_narrow_f32"),
    "sandwich_tri<float>": ("sandwich_tri", "tabmat_sandwich_tri_f32"),
    "sandwich_wide<float>": ("sandwich_wide", "tabmat_sandwich_wide_f32"),
    "sandwich_mma<double>": ("sandwich_mma", "tabmat_sandwich_mma_f64"),
    "sandwich_mma_tri<double>": ("sandwich_mma_tri", "tabmat_sandwich_mma_tri_f64"),
    "column_absmax": ("sandwich", "tabmat_column_absmax"),
}
_libs: dict = {}
_blocks_per_sm: dict = {}  # (source, dtype) -> resident first-pass blocks per SM


def __getattr__(name):
    if name == "sandwich_launches":
        return sum(c for key, c in launches.items() if key.startswith("sandwich"))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def _instance(kernel: str, dtype: torch.dtype) -> str:
    return f"{kernel}<{'double' if dtype == torch.float64 else 'float'}>"


def route(k: int, dtype: torch.dtype) -> str:
    """The sandwich kernel for width ``k`` and dtype (float64 or float32).

    k ≤ 32 → ``sandwich_narrow<T>``; float32: k ≤ 176 →
    ``sandwich_tri<float>``, wider ``sandwich_wide<float>``; float64: k ≤ 128 →
    ``sandwich_mma_tri<double>``, wider ``sandwich_mma<double>``.
    """
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"the sandwich takes float64 or float32, got {dtype}")
    if k <= NARROW_MAX_K:
        return _instance("sandwich_narrow", dtype)
    if dtype == torch.float32:
        return "sandwich_tri<float>" if k <= TRI_MAX_K else "sandwich_wide<float>"
    return "sandwich_mma<double>" if k >= WIDE_MIN_K else "sandwich_mma_tri<double>"


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
    """Row split of the first pass of ``sandwich<T>`` and
    ``sandwich_mma<double>``: ``(splits, rows_per_split)``.

    The grid of 64 × 64 upper tile pairs × splits fills one wave of
    ``n_sm * blocks_per_sm`` resident blocks, never one block more: every
    block does the same work, so one extra block on one SM costs a whole
    block's time, and at the main path's k = 50 more waves were slower
    (PERF.md).  Once the tile pairs alone fill the wave there is one split,
    so the (splits, k, k) scratch stays near k².  Each split is a whole
    number of ``ROWS``-row stages.
    """
    nt = -(-k // TILE)
    pairs = nt * (nt + 1) // 2
    return _split_rows(n, n_sm * blocks_per_sm // pairs, ROWS)


def narrow_plan(n: int, n_sm: int, blocks_per_sm: int):
    """Row split of ``sandwich_narrow<T>``: one block owns every entry, so
    the splits alone fill one wave of resident blocks."""
    return _split_rows(n, n_sm * blocks_per_sm, ROWS)


def tri_plan(n: int, n_sm: int, blocks_per_sm: int):
    """Row split of the triangle kernels ``sandwich_tri<float>`` and
    ``sandwich_mma_tri<double>``: one block owns every upper tile, so the
    splits alone fill one wave of resident blocks."""
    return _split_rows(n, n_sm * blocks_per_sm, ROWS)


def wide_plan(n: int, k: int, n_sm: int, blocks_per_sm: int):
    """Row split of ``sandwich_wide<float>``: ``(splits, pair_rows)``.

    ``pair_rows`` holds the rows of one split of each tile pair (ti ≤ tj,
    row by row), whole stages; the kernel reads it and decides nothing of
    the split itself.  ``splits``, the grid's second dimension, is the most
    splits of any pair, so every pair's splits cover its rows; a pair's
    splits past its rows write zeros.  A pair with A active warps
    (:func:`wide_active_warps`) keeps its busiest scheduler issuing for
    ⌈A/4⌉ warps, so a split of it holds ``sched_rows`` / ⌈A/4⌉ rows rounded
    up to a stage (:func:`_wide_rows`) and every split keeps its busiest
    scheduler about as long; ``sched_rows`` (:func:`_least_sched_rows`) is
    the least that keeps the splits holding rows, summed over the pairs,
    within one wave of ``n_sm * blocks_per_sm`` resident blocks (one split
    each once the pairs alone fill it, as in :func:`launch_plan`).
    """
    return _wide_plan(max(n, 1), k, n_sm * blocks_per_sm)


@functools.lru_cache(maxsize=256)
def _wide_plan(n: int, k: int, wave: int):
    costs = [-(-a // 4) for a in wide_active_warps(k)]
    sched_rows = _least_sched_rows(n, costs, wave)
    pair_rows = tuple(_wide_rows(sched_rows, c) for c in costs)
    splits = max(-(-n // r) for r in pair_rows)
    if splits > MAX_SPLITS:
        raise ValueError(f"sandwich_wide would need {splits} row splits (at most {MAX_SPLITS})")
    return splits, pair_rows


def _least_sched_rows(n: int, costs: list, wave: int) -> int:
    """The least ``sched_rows`` whose splits that hold rows, over pairs whose
    busiest schedulers issue for ``costs`` warps, fit ``wave``."""

    def blocks(sched_rows):
        return sum(-(-n // _wide_rows(sched_rows, c)) for c in costs)

    lo, hi = 1, max(costs) * -(-n // WIDE_ROWS) * WIDE_ROWS  # hi: one split a pair
    while lo < hi:
        mid = (lo + hi) // 2
        if blocks(mid) <= wave:
            hi = mid
        else:
            lo = mid + 1
    return lo


@functools.cache
def _on_device(values: tuple, device: torch.device) -> torch.Tensor:
    """``values`` as an int64 tensor on ``device``, copied once a plan and
    kept for the process's life, so that no launch on any stream reads a
    table freed under it (a few hundred bytes a plan)."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _wide_rows(sched_rows: int, per_sched: int) -> int:
    """Rows of one split of a tile pair whose busiest scheduler issues for
    ``per_sched`` warps."""
    return -(-sched_rows // (per_sched * WIDE_ROWS)) * WIDE_ROWS


def wide_pairs(k: int) -> int:
    """The upper pairs (ti ≤ tj) of ``WIDE_TILE``-column tiles of a k × k S:
    the first-pass blocks of one split of ``sandwich_wide<float>``."""
    nt = -(-k // WIDE_TILE)
    return nt * (nt + 1) // 2


def wide_active_warps(k: int) -> list:
    """Warps of each tile pair (ti ≤ tj, row by row) of ``sandwich_wide<float>``
    that do products: the warp tiles q = 0..7 at rows 64·(q // 4) and
    columns 32·(q % 4) of the 128 × 128 pair that start inside the tile and
    do not lie wholly below a diagonal pair's diagonal (as the kernel counts
    them; it hands them to warps 0, 1, ... in order).  Only the balance of
    :func:`wide_plan` rests on this count, not which rows are covered."""
    nt = -(-k // WIDE_TILE)
    counts = []
    for ti in range(nt):
        for tj in range(ti, nt):
            wa, wb = min(WIDE_TILE, k - ti * WIDE_TILE), min(WIDE_TILE, k - tj * WIDE_TILE)
            counts.append(sum(
                r < wa and c < wb and (ti != tj or r < c + 32)
                for r, c in ((64 * (w // 4), 32 * (w % 4)) for w in range(8))))
    return counts


def tri_partial_size(k: int) -> int:
    """Floats of one split's partial in ``sandwich_tri<float>``: 64 per
    upper 8 × 8 micro-tile, padding included."""
    nt = -(-k // TRI_MT)
    return nt * (nt + 1) // 2 * TRI_MT * TRI_MT


def mma_tri_tiles(k: int) -> int:
    """The upper ``m16n8k8`` tiles (16 rows by 8 columns) of a k × k S:
    tile (r, c) is kept where c ≥ 2r, with C = ⌈k/8⌉ column blocks and
    R = ⌈C/2⌉ row blocks."""
    c_blocks = -(-k // 8)
    r_blocks = -(-c_blocks // 2)
    return r_blocks * c_blocks - r_blocks * (r_blocks - 1)


def mma_tri_partial_size(k: int) -> int:
    """Doubles of one split's partial in ``sandwich_mma_tri<double>``: 128
    per upper ``m16n8k8`` tile, padding and lower halves included."""
    return mma_tri_tiles(k) * MMA_FRAG


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


def _check_out(out, X) -> None:
    k = X.shape[1]
    if not torch.is_tensor(out):
        raise TypeError("out must be a torch tensor")
    if out.shape != (k, k) or out.dtype != X.dtype or out.device != X.device:
        raise ValueError(
            f"out must be ({k}, {k}) {X.dtype} on {X.device}, got {tuple(out.shape)} "
            f"{out.dtype} on {out.device}"
        )
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


def _plain_into(X, d, out):
    S = sandwich_plain(X, d)
    return S if out is None else out.add_(S)


def _run_sandwich(name: str, X, d, out):
    """Check the operands, then the plain version on the CPU or ``name``'s
    kernel on the card; with ``out`` the product is added into it."""
    _check(X, d, (torch.float64,) if name.endswith("<double>") else (torch.float32,))
    if out is not None:
        _check_out(out, X)
    if X.device.type == "cpu":
        return _plain_into(X, d, out)
    n, k = X.shape
    if n == 0 or k == 0:
        return torch.zeros((k, k), dtype=X.dtype, device=X.device) if out is None else out
    source = _KERNELS[name][0]
    with torch.cuda.device(X.device):
        lib = _library(source)
        key = (source, X.dtype)
        if key not in _blocks_per_sm:
            blocks = ctypes.c_int(0)
            _raise_on(lib, getattr(lib, f"tabmat_{source}_blocks_per_sm")(
                int(X.dtype == torch.float64), ctypes.byref(blocks)), source)
            _blocks_per_sm[key] = max(1, blocks.value)
        n_sm = torch.cuda.get_device_properties(X.device).multi_processor_count
        splits, per_split, rows_per_split = first_pass_args(
            source, n, k, n_sm, _blocks_per_sm[key], X.device)
        accumulate = out is not None
        if out is None:
            out = torch.empty((k, k), dtype=X.dtype, device=X.device)
        partial = torch.empty((splits, per_split), dtype=X.dtype, device=X.device)
        _launch(lib, name, X, d.contiguous(), out, partial, n, k, splits, rows_per_split,
                int(accumulate))
    return out


def first_pass_args(source: str, n: int, k: int, n_sm: int, blocks_per_sm: int, device):
    """``(splits, elements of one split's partial, the row argument)`` of
    ``csrc/<source>.cu``'s first pass: the row argument is the rows a split,
    or for ``sandwich_wide`` the address of its table on ``device``."""
    if source == "sandwich_wide":
        splits, pair_rows = wide_plan(n, k, n_sm, blocks_per_sm)
        return splits, k * k, _on_device(pair_rows, device).data_ptr()
    if source in ("sandwich_tri", "sandwich_mma_tri"):
        splits, rows_per_split = tri_plan(n, n_sm, blocks_per_sm)
        size = (tri_partial_size if source == "sandwich_tri" else mma_tri_partial_size)(k)
        return splits, size, rows_per_split
    if source == "sandwich_narrow":
        splits, rows_per_split = narrow_plan(n, n_sm, blocks_per_sm)
    else:
        splits, rows_per_split = launch_plan(n, k, n_sm, blocks_per_sm)
    return splits, k * k, rows_per_split


def sandwich(X: torch.Tensor, d: torch.Tensor, out=None) -> torch.Tensor:
    """``Xᵀ diag(d) X`` → (k, k) in X's dtype (float64 or float32), on X's device.

    The kernel is the one :func:`route` names for X's width and dtype.  CPU
    tensors take :func:`sandwich_plain`.  CUDA tensors launch the kernel; X
    must be contiguous, d is made contiguous here.  With ``out`` (a
    contiguous (k, k) tensor of X's dtype and device) the product is added
    into ``out``, which is returned.
    """
    _check(X, d, (torch.float64, torch.float32))
    return _run_sandwich(route(X.shape[1], X.dtype), X, d, out)


def sandwich_tiled(X: torch.Tensor, d: torch.Tensor, out=None) -> torch.Tensor:
    """:func:`sandwich` through ``sandwich<T>`` (64 × 64 FFMA tiles), any k;
    off the route, kept as the yardstick of the triangle and wide kernels."""
    _check(X, d, (torch.float64, torch.float32))
    return _run_sandwich(_instance("sandwich", X.dtype), X, d, out)


def sandwich_narrow(X: torch.Tensor, d: torch.Tensor, out=None) -> torch.Tensor:
    """:func:`sandwich` through ``sandwich_narrow<T>``; k ≤ 32."""
    _check(X, d, (torch.float64, torch.float32))
    if X.shape[1] > NARROW_MAX_K:
        raise ValueError(f"sandwich_narrow takes k <= {NARROW_MAX_K}, got {X.shape[1]}")
    return _run_sandwich(_instance("sandwich_narrow", X.dtype), X, d, out)


def sandwich_tri(X: torch.Tensor, d: torch.Tensor, out=None) -> torch.Tensor:
    """:func:`sandwich` through ``sandwich_tri<float>`` (8 × 8 FFMA
    micro-tiles of the upper triangle); 33 ≤ k ≤ 176, float32 only."""
    _check(X, d, (torch.float32,))
    if not TRI_MIN_K <= X.shape[1] <= TRI_MAX_K:
        raise ValueError(f"sandwich_tri takes {TRI_MIN_K} <= k <= {TRI_MAX_K}, got {X.shape[1]}")
    return _run_sandwich("sandwich_tri<float>", X, d, out)


def sandwich_wide(X: torch.Tensor, d: torch.Tensor, out=None) -> torch.Tensor:
    """:func:`sandwich` through ``sandwich_wide<float>`` (pairs of 128-column
    tiles in 8 × 8 FFMA micro-tiles); k > 176, float32 only."""
    _check(X, d, (torch.float32,))
    if X.shape[1] <= TRI_MAX_K:
        raise ValueError(f"sandwich_wide takes k > {TRI_MAX_K}, got {X.shape[1]}")
    return _run_sandwich("sandwich_wide<float>", X, d, out)


def sandwich_mma(X: torch.Tensor, d: torch.Tensor, out=None) -> torch.Tensor:
    """:func:`sandwich` through ``sandwich_mma<double>`` (FP64 tensor
    cores), any k; float64 only."""
    return _run_sandwich("sandwich_mma<double>", X, d, out)


def sandwich_mma_tri(X: torch.Tensor, d: torch.Tensor, out=None) -> torch.Tensor:
    """:func:`sandwich` through ``sandwich_mma_tri<double>`` (the upper
    triangle in ``m16n8k8`` FP64 tensor-core tiles); 33 ≤ k ≤ 128, float64
    only."""
    _check(X, d, (torch.float64,))
    if not MMA_TRI_MIN_K <= X.shape[1] <= MMA_TRI_MAX_K:
        raise ValueError(f"sandwich_mma_tri takes {MMA_TRI_MIN_K} <= k <= {MMA_TRI_MAX_K}, "
                         f"got {X.shape[1]}")
    return _run_sandwich("sandwich_mma_tri<double>", X, d, out)


# the wrapper of each sandwich kernel, for callers that name the kernel
KERNEL_WRAPPERS = {
    "sandwich<double>": sandwich_tiled, "sandwich<float>": sandwich_tiled,
    "sandwich_narrow<double>": sandwich_narrow, "sandwich_narrow<float>": sandwich_narrow,
    "sandwich_tri<float>": sandwich_tri, "sandwich_wide<float>": sandwich_wide,
    "sandwich_mma<double>": sandwich_mma, "sandwich_mma_tri<double>": sandwich_mma_tri,
}


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
        lib = _library("sandwich")
        n_sm = torch.cuda.get_device_properties(X.device).multi_processor_count
        splits, rows_per_split = absmax_plan(n, k, n_sm)
        out = torch.empty(k, dtype=torch.float64, device=X.device)
        partial = torch.empty((splits, k), dtype=torch.float64, device=X.device)
        _launch(lib, "column_absmax", X, d.contiguous(), out, partial, n, k, splits,
                rows_per_split)
    return out


def _library(source: str):
    """The built ``csrc/<source>.cu`` with its C functions typed (built at first use)."""
    if source not in _libs:
        from .. import _build

        signatures = {
            symbol: (_ABSMAX_ARGTYPES if name == "column_absmax" else
                     _WIDE_ARGTYPES if src == "sandwich_wide" else _SANDWICH_ARGTYPES)
            for name, (src, symbol) in _KERNELS.items() if src == source
        }
        signatures[f"tabmat_{source}_blocks_per_sm"] = [ctypes.c_int, ctypes.c_void_p]
        _libs[source] = _build.bind(source, signatures)
    return _libs[source]


def _raise_on(lib, err: int, source: str) -> None:
    from .. import _build

    _build.raise_on(lib, err, f"{source}.cu kernel")


def _launch(lib, name, X, d, out, partial, n, k, splits, rows_per_split, *flags) -> None:
    source, symbol = _KERNELS[name]
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = getattr(lib, symbol)(
        X.data_ptr(), d.data_ptr(), out.data_ptr(), partial.data_ptr(),
        n, k, splits, rows_per_split, *flags, stream,
    )
    _raise_on(lib, err, source)
    launches[name] += 1
