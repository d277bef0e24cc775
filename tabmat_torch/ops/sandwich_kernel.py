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
  bytes of X (1 FLOP/byte at k = 10): one block an SM (the row splits fill
  one wave) streams its rows through eight stages of TMA bulk copies of X's
  and d's row runs (:func:`narrow_stage_rows`); a thread sums whole rows
  into all k(k+1)/2 entries at k ≤ 10; past it the f64 kernel takes the
  upper triangle in ``m16n8k8`` FP64 tensor-core tiles, the f32 one in
  4 × 4 FFMA micro-tiles.  One launch: the block that takes the last ticket
  of a counter sums the splits in order (:func:`narrow_plan`, ``_tickets``).
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
- ``sandwich_mma<double>`` (``csrc/sandwich_mma.cu``, f64 k > 128):
  replaces ``tabmat_tpu/ops/pallas_pairs.py:_pairs_kernel`` and
  ``:_sliced_pairs_kernel`` (the slice-pair contractions whose f64
  combination is ``AᵀB`` with A = d·X, the TPU default for 128 < k ≤ 160),
  and v3 / v5 beyond one lane tile.  Balanced at 400k × 160 (0.153 ms of
  bytes, 0.154 ms of operations at 67 TFLOP/s), bound by operations past
  it: FP64 tensor cores through ``mma.sync.m16n8k8``.  A block owns one
  pair of 128-column tiles (the last tile the remainder) and computes only
  the ``m16n8k8`` accumulator tiles that start inside both tiles and, on a
  diagonal pair, on or above the diagonal, in warp tiles of 64 × 32 and
  18 fixed tile patterns; where the last tile is 32 columns or fewer, its
  pairs also take the diagonal pairs (:func:`mma_units`; at k = 160 two
  units of 104 and 6 tiles).  Both strips staged by three cp.async stages
  of 32 rows, one on a diagonal pair; d·x applied to the B fragments.
  :func:`mma_plan` sizes each unit's splits by a cost a stage fitted to the
  blocks' times; :func:`mma_blocks` is the launch table.

Hopper has native FP64, so every f64 kernel computes the function
directly, without the TPU's planes; f32 uses FFMA, never TF32.  Each
kernel sums its per-block partials in a second pass (the narrow kernel's
last block) in a fixed order: no atomics in the sums, so results repeat bit
for bit and S is exactly symmetric.  With ``out=`` the second pass adds S
into ``out``, so row panels of one product sum in order in one (k, k)
buffer.  128 is where the JAX package leaves v4
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
    "sandwich_narrow<double>": 0, "sandwich_narrow<float>": 0,
    "sandwich_tri<float>": 0, "sandwich_wide<float>": 0, "sandwich_mma<double>": 0,
    "sandwich_mma_tri<double>": 0, "column_absmax": 0,
}

# Must match csrc/sandwich.cu, csrc/sandwich_narrow.cu, csrc/sandwich_tri.cu,
# csrc/sandwich_wide.cu, csrc/sandwich_mma.cu and csrc/sandwich_mma_tri.cu.
ROWS = 32  # a split of the triangle kernels: whole stages of 32 rows
NARROW_MAX_K = 32
NARROW_STAGE_BYTES = 24576  # X and d of one stage of sandwich_narrow<T>, at most
NARROW_ROW_ALIGN = 4  # its stage rows and splits: copies with 16-byte ends
TRI_MT = 8  # the micro-tile edge of sandwich_tri<float>
TRI_MIN_K = 33  # the kernel is built for 5 to 22 micro-tiles a side
TRI_MAX_K = 176  # 22 micro-tiles a side: 253 upper ones, one a thread of 256
WIDE_TILE = 128  # the column tile of sandwich_wide<float> and sandwich_mma<double>
WIDE_ROWS = 32  # rows of X a stage of sandwich_wide<float> and sandwich_mma<double>
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
# sandwich_wide.cu takes a device table of rows a split, one a tile pair;
# sandwich_mma.cu its launch table (mma_blocks)
_WIDE_ARGTYPES = _SANDWICH_ARGTYPES[:7] + [ctypes.c_void_p] + _SANDWICH_ARGTYPES[8:]
# sandwich_narrow.cu takes its ticket counter after the partials
_NARROW_ARGTYPES = _SANDWICH_ARGTYPES[:4] + [ctypes.c_void_p] + _SANDWICH_ARGTYPES[4:]
_TABLE_SOURCES = ("sandwich_wide", "sandwich_mma")
_ABSMAX_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p,
]
# kernel -> (source in csrc/, C function)
_KERNELS = {
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
# (device index, stream) -> sandwich_narrow<T>'s ticket counter: 0 between
# launches (every launch leaves it at 0), one a stream, so no two launches
# that can overlap share one
_tickets: dict = {}


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


def narrow_stage_rows(k: int, size: int) -> int:
    """Rows a stage of ``sandwich_narrow<T>`` (``stage_rows`` in the
    source): the most whose X and d fit ``NARROW_STAGE_BYTES``, a multiple
    of ``NARROW_ROW_ALIGN``, so both copies of a stage start and end on 16
    bytes wherever X and d do.  ``size`` is the element's bytes."""
    return NARROW_STAGE_BYTES // ((k + 1) * size) // NARROW_ROW_ALIGN * NARROW_ROW_ALIGN


def narrow_plan(n: int, n_sm: int, blocks_per_sm: int):
    """Row split of ``sandwich_narrow<T>``: one block owns every entry, so
    the splits alone fill one wave of resident blocks; each split is a
    multiple of ``NARROW_ROW_ALIGN`` rows, so every stage but the matrix's
    last is bulk-copied (its stages are :func:`narrow_stage_rows` each, its
    last one shorter)."""
    return _split_rows(n, n_sm * blocks_per_sm, NARROW_ROW_ALIGN)


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
    each once the pairs alone fill it).
    """
    costs = tuple(-(-a // 4) for a in wide_active_warps(k))
    return _cost_plan(max(n, 1), costs, n_sm * blocks_per_sm, "sandwich_wide")


def mma_plan(n: int, k: int, n_sm: int, blocks_per_sm: int):
    """Row split of ``sandwich_mma<double>``: ``(splits, pair_splits)``.

    Each unit (:func:`mma_units`) gets the splits that
    :func:`wide_plan`'s sizing gives it, with a pair's cost the MMAs a
    stage (:func:`mma_pair_costs`): ``pair_splits[p]`` = ⌈n / its rows a
    split⌉, so the splits fill one wave and end together.  The kernel hands
    split s of S the ``WIDE_ROWS``-row stages s, s + S, ..., so every block
    walks down X at the same pace; ``splits``, the scratch's splits, is the
    most of any pair (:func:`mma_blocks` lists the blocks)."""
    n = max(n, 1)
    _, pair_rows = _cost_plan(n, tuple(mma_pair_costs(k)), n_sm * blocks_per_sm, "sandwich_mma")
    pair_splits = tuple(-(-n // r) for r in pair_rows)
    return max(pair_splits), pair_splits


@functools.lru_cache(maxsize=256)
def _cost_plan(n: int, costs: tuple, wave: int, name: str):
    """``(splits, pair_rows)`` for pairs of ``costs`` (time a row, any unit)
    over ``wave`` resident blocks: see :func:`wide_plan`."""
    sched_rows = _least_sched_rows(n, costs, wave)
    pair_rows = tuple(_wide_rows(sched_rows, c) for c in costs)
    splits = max(-(-n // r) for r in pair_rows)
    if splits > MAX_SPLITS:
        raise ValueError(f"{name} would need {splits} row splits (at most {MAX_SPLITS})")
    return splits, pair_rows


def _least_sched_rows(n: int, costs: list, wave: int) -> int:
    """The least ``sched_rows`` whose splits that hold rows, over pairs of
    ``costs`` (a row's time, in any unit), fit ``wave``."""

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
    """Rows of one split, whole stages, of a tile pair of cost ``per_sched``
    a row (its busiest scheduler's warps in :func:`wide_plan`)."""
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


# A pair's cost a stage in sandwich_mma<double>, in a third of the time of
# one MMA on one scheduler: 3 a busiest scheduler's MMA a k-step, MMA_STAGE
# for the stage's barrier, fragment loads and copy latency, and one a 16
# staged columns (a least-squares fit of the blocks' times on the card,
# PERF.md)
MMA_STAGE_COST = 18
MMA_BAND = 8  # tiles a band: the launch order of sandwich_mma<double>'s pairs


def _mma_tiles(offset, rows=4, cols=4) -> frozenset:
    """Accumulator tiles (u, v) of a 64 × 32 warp tile: the ``rows`` ×
    ``cols`` corner, and with ``offset`` (its first column less its first
    row, on a diagonal pair) those on or above the diagonal."""
    return frozenset((u, v) for u in range(rows) for v in range(cols)
                     if offset is None or offset + 8 * v >= 16 * u)


# the fixed patterns of sandwich_mma.cu besides its U × V corners: all 16
# tiles, and the diagonal ones where a warp tile starts on a diagonal pair's
# diagonal or 32 columns past it
_MMA_PATTERNS = (_mma_tiles(None), _mma_tiles(0), _mma_tiles(32))


def mma_units(k: int) -> list:
    """The blocks' units of work of ``sandwich_mma<double>``: ``(ti, tj,
    with_diag)`` in row order, one a tile pair ti ≤ tj of 128-column tiles
    (the last tile the remainder), but that where the last tile is 32
    columns or fewer, the pair (ti, last) with ti < last also takes the
    diagonal pair (ti, ti) (``with_diag``), which then has no unit of its
    own: the first pair's two busy warp tiles and the diagonal pair's six
    fill the block's eight warps, and strip ti is staged once for both."""
    nt = -(-k // WIDE_TILE)
    merge = nt >= 2 and k - (nt - 1) * WIDE_TILE <= 32
    return [(ti, tj, merge and ti < tj == nt - 1) for ti in range(nt) for tj in range(ti, nt)
            if not (merge and ti == tj < nt - 1)]


def _mma_warp_counts(k: int, ti: int, tj: int, diag_too: bool) -> list:
    """The MMAs a k-step of each warp tile with live tiles of pair (ti, tj)
    and, with ``diag_too``, of the diagonal pair (ti, ti)."""
    def counts(ti, tj):
        wa, wb = min(WIDE_TILE, k - ti * WIDE_TILE), min(WIDE_TILE, k - tj * WIDE_TILE)
        for q in range(8):
            r0, c0 = 64 * (q // 4), 32 * (q % 4)
            live = frozenset(
                (u, v) for u in range(4) for v in range(4)
                if r0 + 16 * u < wa and c0 + 16 * (v // 2) + v % 2 < wb
                and (ti != tj or c0 + 16 * (v // 2) >= r0 + 16 * u))
            if live and live not in _MMA_PATTERNS:
                live = _mma_tiles(None, 1 + max(u for u, _ in live), 1 + max(v for _, v in live))
            yield len(live)

    return list(counts(ti, tj)) + (list(counts(ti, ti)) if diag_too else [])


def mma_warp_tiles(k: int) -> list:
    """For each unit (:func:`mma_units`) of ``sandwich_mma<double>``, the
    ``m16n8k8`` MMAs a k-step of each busy warp, in warp order.

    A pair's warp tiles q = 0..7 sit at rows 64·(q // 4) and columns
    32·(q % 4) of the 128 × 128 pair and hold 4 × 4 accumulator tiles of 16
    rows by 8 columns, column block v the even (v even) or odd columns of
    the 16 from 16·(v // 2); a tile is live where it starts inside both
    tiles and, on a diagonal pair, its 16-column group starts at or past
    its first row.  A warp computes a fixed pattern that holds its live
    tiles: all 16, the 6 or 14 of a warp tile that starts on the diagonal
    or 32 columns past it, or else the smallest corner of rows by columns
    that holds them.  The kernel ranks the busy warp tiles of a unit by
    their pattern's tiles, most first, and hands ranks 0-3 to warps 3-0 and
    the rest to warps 4, 5, ...: the list is in that warp order.  Only the
    balance of :func:`mma_plan` rests on it, not which rows are covered."""
    units = []
    for ti, tj, diag_too in mma_units(k):
        ranked = sorted((c for c in _mma_warp_counts(k, ti, tj, diag_too) if c), reverse=True)
        if len(ranked) > 8:
            raise AssertionError(f"unit {(ti, tj, diag_too)} of k = {k} has {len(ranked)} warps")
        head = min(len(ranked), 4)
        units.append(ranked[:head][::-1] + ranked[head:])
    return units


def mma_pair_costs(k: int) -> list:
    """The cost of a stage of each unit of ``sandwich_mma<double>``
    (:func:`mma_units`): 3 × the MMAs a k-step of its busiest scheduler
    (warp w issues on scheduler w % 4), plus ``MMA_STAGE_COST``, plus one a
    16 columns it stages (one strip on a diagonal pair, two else)."""
    width = [min(WIDE_TILE, k - t * WIDE_TILE) for t in range(-(-k // WIDE_TILE))]
    staged = [width[tj] + (width[ti] if ti != tj else 0) for ti, tj, _ in mma_units(k)]
    return [3 * max(sum(warps[s::4]) for s in range(4)) + MMA_STAGE_COST + -(-cols // 16)
            for warps, cols in zip(mma_warp_tiles(k), staged)]


def mma_blocks(n: int, k: int, n_sm: int, blocks_per_sm: int):
    """The launch table of ``sandwich_mma<double>``: ``(splits, table)``.

    ``table`` holds the count of blocks, then one entry a block in launch
    order, ``ti << 48 | tj << 32 | with_diag << 47 | s << 16 | S``: split s
    of the S of unit (ti, tj, with_diag) (:func:`mma_units`,
    :func:`mma_plan`).  The units come in row order within pairs of bands
    of ``MMA_BAND`` tiles, the bands' pairs in row order, so that the
    blocks resident at once read few strips; a unit's splits come
    together."""
    return _mma_blocks(max(n, 1), k, n_sm * blocks_per_sm)


@functools.lru_cache(maxsize=256)
def _mma_blocks(n: int, k: int, wave: int):
    splits, unit_splits = mma_plan(n, k, wave, 1)
    nt = -(-k // WIDE_TILE)
    if nt >= 1 << 15:
        raise ValueError(f"sandwich_mma takes k < {WIDE_TILE << 15}, got {k}")
    units = mma_units(k)
    band = {(ti // MMA_BAND, tj // MMA_BAND, ti, tj): u for u, (ti, tj, _) in enumerate(units)}
    entries = []
    for key in sorted(band):
        ti, tj, diag_too = units[band[key]]
        S = unit_splits[band[key]]
        entries += [ti << 48 | tj << 32 | diag_too << 47 | s << 16 | S for s in range(S)]
    return splits, (len(entries), *entries)


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
        scratch = (partial,) if source != "sandwich_narrow" else (partial, _ticket(X.device))
        _launch(lib, name, X, d.contiguous(), out, scratch, n, k, splits, rows_per_split,
                int(accumulate))
    return out


def _ticket(device) -> torch.Tensor:
    """The ticket counter of ``sandwich_narrow<T>`` for the current stream of
    ``device``: made 0 on that stream at its first use, and left 0 by every
    launch."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[key]


def first_pass_args(source: str, n: int, k: int, n_sm: int, blocks_per_sm: int, device):
    """``(splits, elements of one split's partial, the row argument)`` of
    ``csrc/<source>.cu``'s first pass: the row argument is the rows a split,
    or for ``sandwich_wide`` and ``sandwich_mma`` the address of its table
    on ``device`` (rows a split of each tile pair; the launch table of
    :func:`mma_blocks`)."""
    if source in _TABLE_SOURCES:
        plan = wide_plan if source == "sandwich_wide" else mma_blocks
        splits, table = plan(n, k, n_sm, blocks_per_sm)
        return splits, k * k, _on_device(table, device).data_ptr()
    if source in ("sandwich_tri", "sandwich_mma_tri"):
        splits, rows_per_split = tri_plan(n, n_sm, blocks_per_sm)
        size = (tri_partial_size if source == "sandwich_tri" else mma_tri_partial_size)(k)
        return splits, size, rows_per_split
    # sandwich_narrow: its partials are the k(k+1)/2 upper entries
    splits, rows_per_split = narrow_plan(n, n_sm, blocks_per_sm)
    return splits, k * (k + 1) // 2, rows_per_split


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
        _launch(lib, "column_absmax", X, d.contiguous(), out, (partial,), n, k, splits,
                rows_per_split)
    return out


def _library(source: str):
    """The built ``csrc/<source>.cu`` with its C functions typed (built at first use)."""
    if source not in _libs:
        from .. import _build

        signatures = {
            symbol: (_ABSMAX_ARGTYPES if name == "column_absmax" else
                     _WIDE_ARGTYPES if src in _TABLE_SOURCES else
                     _NARROW_ARGTYPES if src == "sandwich_narrow" else _SANDWICH_ARGTYPES)
            for name, (src, symbol) in _KERNELS.items() if src == source
        }
        if any(_KERNELS[name][0] == source for name in KERNEL_WRAPPERS):
            # a sandwich's source: its occupancy query sizes the row splits
            signatures[f"tabmat_{source}_blocks_per_sm"] = [ctypes.c_int, ctypes.c_void_p]
        _libs[source] = _build.bind(source, signatures)
    return _libs[source]


def _raise_on(lib, err: int, source: str) -> None:
    from .. import _build

    _build.raise_on(lib, err, f"{source}.cu kernel")


def _launch(lib, name, X, d, out, scratch, n, k, splits, rows_per_split, *flags) -> None:
    """Launch ``name`` on X's current stream; ``scratch`` are the tensors
    its C function takes after ``out`` (the partials, a ticket counter)."""
    source, symbol = _KERNELS[name]
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = getattr(lib, symbol)(
        X.data_ptr(), d.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in scratch),
        n, k, splits, rows_per_split, *flags, stream,
    )
    _raise_on(lib, err, source)
    launches[name] += 1
