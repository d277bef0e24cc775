"""The hand-written CUDA segment sum over a plan, and its plain version.

Kernel: ``tabmat_torch/csrc/segsum.cu``, instantiated for ``double`` and
``float``::

    out[s, j] = Σ_{bounds[s] ≤ t < bounds[s+1]} values[perm[t], j]

It replaces ``tabmat_tpu/ops/pallas_segsum.py:_segsum_kernel`` (W ≤ 2^14)
and ``tabmat_tpu/ops/pallas_segsum_bucketed.py:_segsum_bucketed_kernel``
(512 < W ≤ 2^17), which formed the sums as one-hot matrix products of exact
bf16 slices, tile of rows by tile of rows, because the TPU gathers slowly
and has no f64.  Here it covers any number of segments W and takes the
:class:`~.segments.SegmentPlan` built once per matrix: the categorical tmv
and sandwich diagonal (m = 1), the cat×dense cross cells (m = dense width)
and the cat×cat cells (W = the product of the two widths, 10^6 at
1000 × 1000).

Bound: the bytes.  The kernel walks rows in tiles of ``R`` rows, as the TPU
kernels did: a block stages a tile's values and elements in shared memory
by TMA bulk copies (the next tile's in flight) and sums the tile's elements
from there, so ``values`` is read once and never gathered; runs that cross
threads are joined by a segmented scan in a fixed order.  The row-tile layout (the plan's elements sorted stably
by ``perm // R``, a local row and a key each, tiles padded to ``ITEMS``
elements) depends on the plan alone: :func:`tile_layout` and
:func:`slot_layout` build it on the card at a plan's first call and keep it
in ``plan.tables``.  Two routes, chosen per call by :func:`choose_route`:

- ``segsum<T>`` (tiles): each block keeps a dense (W, G) accumulator in
  shared memory over its range of tiles, and a second launch sums the
  blocks' partials in block order.  Taken where the accumulator fits beside
  the two stages for some group of G ≤ 8 columns and the blocks' partials
  number no more than the plan's elements (blocks × W ≤ E).
- ``segsum_slots<T>`` (slots): each (tile, segment) run's total goes to a
  slot the plan fixes, a segment's slots together in tile order, and a
  second launch sums each segment's slots.  Taken otherwise: the cat×cat
  cell (W = 10^6) and any W whose accumulator does not fit.

Columns go in groups of up to 8 (grid y).  No atomics: a result repeats bit
for bit on one card, and an assembled Hessian is exactly symmetric.

The wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch

from .. import _trace

# Launch counts by instantiation: each rises by one where that kernel is
# launched, nowhere else.
launches = {"segsum<double>": 0, "segsum<float>": 0,
            "segsum_slots<double>": 0, "segsum_slots<float>": 0}

_NAMES = {torch.float64: "double", torch.float32: "float"}
_SYMBOLS = {"segsum<double>": "tabmat_segsum_f64", "segsum<float>": "tabmat_segsum_f32",
            "segsum_slots<double>": "tabmat_segsum_slots_f64",
            "segsum_slots<float>": "tabmat_segsum_slots_f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (values, tile_off, words, n, R, tiles, m, G, W, blocks, tpb, max_tile, partial, out,
    #  stream)
    "tabmat_segsum_f64": [_P, _P, _P] + [_I] * 9 + [_P, _P, _P],
    "tabmat_segsum_f32": [_P, _P, _P] + [_I] * 9 + [_P, _P, _P],
    # (values, tile_off, rows, slots, slot_bounds, n, R, tiles, m, G, W, blocks, tpb,
    #  max_tile, slot_val, out, stream)
    "tabmat_segsum_slots_f64": [_P] * 5 + [_I] * 9 + [_P, _P, _P],
    "tabmat_segsum_slots_f32": [_P] * 5 + [_I] * 9 + [_P, _P, _P],
    # (f64, slots, R, G, W, tpb, max_tile, *per_sm): pass-1 blocks resident on one SM
    "tabmat_segsum_resident": [_I] * 7 + [ctypes.POINTER(ctypes.c_int)],
}

# Must match csrc/segsum.cu: elements a thread (each tile's elements are
# padded to a multiple), the widest column group, the stages (a tile's
# values and elements) in shared memory, and the shared memory a block may
# take (the card's 227 KB, less the kernel's static arrays).
ITEMS = 8
MAX_GROUP = 8
STAGES = 2
SMEM_MAX = 227 * 1024 - 1024
# Rows a tile: the first of TILE_ROWS, TILE_ROWS / 2, ... (down to
# MIN_TILE_ROWS) whose stages fit.  Local rows, and the zero row R that
# padding reads, are int16 in the slots route's layout.
TILE_ROWS = 1024
MIN_TILE_ROWS = 256
MAX_TILE_ROWS = 16384
# At most this many tiles-route blocks an SM: the blocks' partials grow
# with their number, and two fill the card at 1M rows.
BLOCKS_PER_SM = 2

_lib = None
_sms = {}  # device index -> SM count
_resident = {}  # (device, name, R, G, W, tpb, max_tile) -> pass-1 blocks resident on an SM


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def segsum_plain(values: torch.Tensor, perm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch segment sum: gather through ``perm``, ``index_add_`` by
    segment id.  ``values`` (n,) or (n, m) → (W,) or (W, m)."""
    num_segments = bounds.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(num_segments, dtype=torch.int32, device=values.device),
        bounds[1:] - bounds[:-1],
        output_size=perm.shape[0],
    )
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values.index_select(0, perm))


def _stage_elems(R: int, G: int, itemsize: int) -> int:
    per = 16 // itemsize
    return -(-(R + 1) * G // per) * per


def smem_bytes(R: int, G: int, W: int, itemsize: int, slots: bool, tpb: int = 1,
               max_tile: int = 0) -> int:
    """Shared bytes of a pass-1 block (``csrc/segsum.cu:smem_bytes``):
    ``STAGES`` stages of R rows and the zero row and of ``max_tile``
    elements, for the tiles route the (W, G) accumulator, and the block's
    tile offsets (at most tpb tiles)."""
    stage = _stage_elems(R, G, itemsize) * itemsize + max_tile * (6 if slots else 4)
    return STAGES * stage + (0 if slots else W * G * itemsize) + 4 * (tpb + 1)


def tiles_per_block(n: int, R: int, sms: int) -> int:
    """At least the tiles of any block: blocks number min(tiles, sms) or more."""
    tiles = -(-n // R)
    return max(1, -(-tiles // sms))


def max_tile(per_row: int, R: int) -> int:
    """At least the elements of any tile (padding included) of a plan whose
    rows hold at most ``per_row`` elements each."""
    return -(-per_row * R // ITEMS) * ITEMS


def _fit(W: int, G: int, itemsize: int, slots: bool, n: int, per_row: int, sms: int):
    """The first of TILE_ROWS, TILE_ROWS / 2, ... (down to MIN_TILE_ROWS)
    whose block fits, or None."""
    r = TILE_ROWS
    while r >= MIN_TILE_ROWS:
        if smem_bytes(r, G, W, itemsize, slots, tiles_per_block(n, r, sms),
                      max_tile(per_row, r)) <= SMEM_MAX:
            return r
        r //= 2
    return None


def choose_route(W: int, m: int, E: int, n: int, per_row: int, itemsize: int, sms: int,
                 tiles_blocks):
    """``(route, R, G)``.  The tiles route takes the widest column group
    (≤ 8, ≤ m) and then the most rows a tile (``_fit``) whose block fits,
    where the blocks' partials (``tiles_blocks(R, G)`` blocks, W each)
    number no more than the plan's E elements; else the slots route, with
    groups of ``min(m, 8)`` columns.  ``per_row``: the most elements of one
    row in the plan (2 in the stacked plan of two categoricals)."""
    for G in range(min(m, MAX_GROUP), 0, -1):
        r = _fit(W, G, itemsize, False, n, per_row, sms)
        if r is not None:
            if tiles_blocks(r, G) * W <= E:
                return "tiles", r, G
            break
    G = min(m, MAX_GROUP)
    r = _fit(W, G, itemsize, True, n, per_row, sms)
    if r is None:
        raise ValueError(f"no row tile of {G} columns fits in shared memory")
    return "slots", r, G


def _sorted_by_tile(plan, R: int):
    """The plan's elements sorted stably by row tile: (tile, segment, local
    row) of each, the tiles' padded offsets, and the padded layout's
    positions: ``src[p]`` is the element at position p or, for padding, the
    tile's last element, and ``pad[p]`` marks the padding."""
    perm, bounds = plan.perm, plan.bounds
    device = perm.device
    E, W, n = perm.shape[0], plan.num_segments, plan.n_rows
    tiles = -(-n // R)
    seg = torch.repeat_interleave(torch.arange(W, device=device), (bounds[1:] - bounds[:-1]).long(),
                                  output_size=E)
    tile = perm.long() // R
    order = torch.argsort(tile, stable=True)
    tile, seg = tile[order], seg[order]
    lrow = perm.long()[order] - tile * R
    counts = torch.bincount(tile, minlength=tiles)
    padded = (counts + ITEMS - 1) // ITEMS * ITEMS
    zero = torch.zeros(1, dtype=torch.long, device=device)
    tile_off = torch.cat([zero, torch.cumsum(padded, 0)])
    first = torch.cat([zero, torch.cumsum(counts, 0)])[:-1]
    pos = tile_off[tile] + torch.arange(E, device=device) - first[tile]
    E_pad = int(tile_off[-1])  # one host read a plan
    src = torch.full((E_pad,), -1, dtype=torch.long, device=device)
    src[pos] = torch.arange(E, device=device)
    src = torch.cummax(src, 0).values  # padding follows its tile's last element
    pad = torch.ones(E_pad, dtype=torch.bool, device=device)
    pad[pos] = False
    return tile, seg, lrow, tile_off, src, pad


def tile_layout(plan, R: int = TILE_ROWS) -> dict:
    """The tiles route's layout of ``plan`` for R rows a tile: ``tile_off``
    (tiles + 1, int32) and ``words`` (int32, local row << 16 | segment;
    padding reads row R).  Needs W ≤ 2^16."""
    if not 1 <= R <= MAX_TILE_ROWS:
        raise ValueError(f"R must lie in [1, {MAX_TILE_ROWS}], got {R}")
    if plan.num_segments > 1 << 16:
        raise ValueError(f"the tiles route takes at most 2^16 segments, got {plan.num_segments}")
    tile, seg, lrow, tile_off, src, pad = _sorted_by_tile(plan, R)
    row = torch.where(pad, R, lrow[src])
    words = (row << 16) | seg[src]
    return {"R": R, "tile_off": tile_off.to(torch.int32), "words": words.to(torch.int32)}


def slot_layout(plan, R: int = TILE_ROWS) -> dict:
    """The slots route's layout of ``plan`` for R rows a tile: ``tile_off``,
    ``rows`` (int16 local rows; padding reads row R), ``slots`` (int32: the
    slot of the element's (tile, segment) run, slots ordered by segment
    then tile), ``slot_bounds`` (W + 1, int32: segment s's slots start at
    ``slot_bounds[s]``) and ``n_slots``."""
    if not 1 <= R <= MAX_TILE_ROWS:
        raise ValueError(f"R must lie in [1, {MAX_TILE_ROWS}], got {R}")
    tile, seg, lrow, tile_off, src, pad = _sorted_by_tile(plan, R)
    E = tile.shape[0]
    device = tile.device
    # runs in tile order; a run's slot is its rank by (segment, tile)
    starts = torch.ones(E, dtype=torch.bool, device=device)
    starts[1:] = (tile[1:] != tile[:-1]) | (seg[1:] != seg[:-1])
    run = torch.cumsum(starts.long(), 0) - 1
    run_seg = seg[starts]
    n_slots = run_seg.shape[0]
    slot_of_run = torch.empty(n_slots, dtype=torch.long, device=device)
    slot_of_run[torch.argsort(run_seg, stable=True)] = torch.arange(n_slots, device=device)
    per_seg = torch.bincount(run_seg, minlength=plan.num_segments)
    slot_bounds = torch.cat([torch.zeros(1, dtype=torch.long, device=device),
                             torch.cumsum(per_seg, 0)])
    return {
        "R": R,
        "tile_off": tile_off.to(torch.int32),
        "rows": torch.where(pad, R, lrow[src]).to(torch.int16),
        "slots": slot_of_run[run[src]].to(torch.int32),
        "slot_bounds": slot_bounds.to(torch.int32),
        "n_slots": n_slots,
    }


def _per_row(plan) -> int:
    """The most elements of one row in ``plan`` (one host read a plan)."""
    per_row = plan.tables.get("segsum_per_row")
    if per_row is None:
        per_row = int(torch.bincount(plan.perm.long(), minlength=1).max())
        plan.tables["segsum_per_row"] = per_row
    return per_row


def _layout(plan, route: str, R: int) -> dict:
    key = ("segsum", route, R)
    layout = plan.tables.get(key)
    if layout is None:
        layout = tile_layout(plan, R) if route == "tiles" else slot_layout(plan, R)
        plan.tables[key] = layout
    return layout


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _blocks(lib, name: str, device, n: int, R: int, G: int, W: int, mt: int) -> int:
    """Pass-1 blocks of a call: one wave (the tiles route at most
    ``BLOCKS_PER_SM`` an SM), no more than the tiles."""
    sms = _sm_count(device)
    slots = name.startswith("segsum_slots")
    tpb = tiles_per_block(n, R, sms)
    key = (device.index, name, R, G, 0 if slots else W, tpb, mt)
    per_sm = _resident.get(key)
    if per_sm is None:
        from .. import _build

        out = ctypes.c_int(0)
        err = lib.tabmat_segsum_resident(int(name.endswith("<double>")), int(slots), R, G, W,
                                         tpb, mt, ctypes.byref(out))
        _build.raise_on(lib, err, "segsum.cu occupancy")
        if out.value < 1:
            raise RuntimeError(f"{name}: no block of R={R}, G={G}, W={W} fits on an SM")
        _resident[key] = per_sm = out.value
    if not slots:
        per_sm = min(per_sm, BLOCKS_PER_SM)
    return max(1, min(-(-n // R), sms * per_sm))


def segsum(values: torch.Tensor, plan) -> torch.Tensor:
    """Segment sum of ``values`` (n,) or (n, m) by ``plan`` → (W,) or (W, m).

    CPU tensors take :func:`segsum_plain`.  CUDA tensors launch the kernel,
    on the route and with the rows a tile of :func:`choose_route`;
    ``values`` must be contiguous and on the plan's device.
    """
    if not torch.is_tensor(values):
        raise TypeError("values must be a torch tensor")
    if values.ndim not in (1, 2):
        raise ValueError(f"values must have rank 1 or 2, got {values.ndim}")
    if values.dtype not in _NAMES:
        raise TypeError(f"values must be float64 or float32, got {values.dtype}")
    if values.shape[0] != plan.n_rows:
        raise ValueError(f"values has {values.shape[0]} rows, the plan {plan.n_rows}")
    if values.device != plan.perm.device:
        raise ValueError(f"values is on {values.device}, the plan on {plan.perm.device}")
    if values.device.type == "cpu":
        return segsum_plain(values, plan.perm, plan.bounds)
    if values.device.type != "cuda":
        raise ValueError(f"the kernels run on cpu or cuda tensors, got {values.device}")
    if not values.is_contiguous():
        raise ValueError("the CUDA segment sum needs contiguous values")
    m = 1 if values.ndim == 1 else values.shape[1]
    W, E, n = plan.num_segments, plan.perm.shape[0], plan.n_rows
    if E == 0 or m == 0:
        return torch.zeros((W,) + tuple(values.shape[1:]), dtype=values.dtype,
                           device=values.device)
    from .. import _build

    with torch.cuda.device(values.device):
        lib = _library()
        name, fn, args, scratch = _call(lib, plan, values.device, _NAMES[values.dtype],
                                        values.element_size(), m)
        out = torch.empty((W,) + tuple(values.shape[1:]), dtype=values.dtype,
                          device=values.device)
        sums = torch.empty(scratch, dtype=values.dtype, device=values.device)
        err = fn(values.data_ptr(), *args, sums.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(values.device).cuda_stream)
        _build.raise_on(lib, err, "segsum.cu kernel")
        launches[name] += 1
    return out


def _call(lib, plan, device, T: str, size: int, m: int):
    """``(name, C function, its arguments between values and the scratch,
    scratch length)`` of a call on ``plan`` with m columns of type T:
    decided once per plan, type and m and kept in ``plan.tables``, so a
    repeated call costs a lookup (the step is host bound)."""
    key = ("segsum_call", T, m, TILE_ROWS)
    call = plan.tables.get(key)
    if call is None:
        with _trace.span("tables.build"):
            _trace.count("tables_built")
            W, E, n = plan.num_segments, plan.perm.shape[0], plan.n_rows
            sms = _sm_count(device)
            per_row = _per_row(plan)
            route, rows, G = choose_route(
                W, m, E, n, per_row, size, sms,
                lambda r, g: _blocks(lib, f"segsum<{T}>", device, n, r, g, W,
                                     max_tile(per_row, r)))
            name = f"segsum<{T}>" if route == "tiles" else f"segsum_slots<{T}>"
            mt = max_tile(per_row, rows)
            blocks = _blocks(lib, name, device, n, rows, G, W, mt)
            layout = _layout(plan, route, rows)
            shape = (n, rows, -(-n // rows), m, G, W, blocks, tiles_per_block(n, rows, sms),
                     mt)
            if route == "tiles":
                tables = (layout["tile_off"], layout["words"])
                scratch = -(-m // G) * blocks * W * G  # the blocks' partials
            else:
                tables = (layout["tile_off"], layout["rows"], layout["slots"],
                          layout["slot_bounds"])
                scratch = layout["n_slots"] * m  # the slots
            call = (name, getattr(lib, _SYMBOLS[name]),
                    tuple(t.data_ptr() for t in tables) + shape, scratch)
            plan.tables[key] = call
    return call


def _library():
    """The built ``segsum.cu`` with its C functions typed (built at first use)."""
    global _lib
    if _lib is None:
        from .. import _build

        _lib = _build.bind("segsum", _SIGNATURES)
    return _lib
