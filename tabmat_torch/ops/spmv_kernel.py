"""The hand-written CUDA sparse segment product, and its plain version.

Kernel: ``tabmat_torch/csrc/spmv.cu``, instantiated for ``double`` and
``float``, each for int32 and int64 bounds::

    out[s, j] = Σ_{bounds[s] ≤ t < bounds[s+1]} a[t] · scale[idx[t]] · values[idx[t], j]

with the layout ``(idx, bounds)`` held in a :class:`~.segments.SegmentPlan`
(``perm`` is ``idx``, ``n_rows`` the number of source rows of ``values``),
``a`` one value per element and ``scale`` optional, one per source row.  A
CSR or CSC matrix is such a layout as it stands (the indices sorted by row
or column, the indptr as bounds), and so are the pair plan of the sparse
sandwich and the (code, column) plan of a sparse×categorical cell.  The
indices are int32; the bounds int32, or int64 for a layout past 2³¹ − 1
elements (``sparse_ops.INT32_MAX``), which launches ``spmv<T,int64>``.

It replaces ``tabmat_tpu/ops/pallas_tmv_fused.py:_kernel`` (the one-pass
CSR ``Xᵀv``) and, at the sparse callers, the gather, window-take and
one-hot segment-sum kernels the TPU chained around a cumsum over all
nonzeros (``ops/sparse_ops.py``, ``models/sparse.py:423-450``,
``parallel/design.py:492-551``).  Here each sparse reduction is one launch
that sums every segment directly, so no error grows with a prefix.

Bound: the bytes (``a``, ``idx``, ``bounds``, one gathered row of ``values``
per element, the output).  Segment lengths range from 0 to E, so the kernel
walks a merge path over the W segment ends and the E elements together: a
tile is a fixed span of that merged list; a block stages a tile's products
and its segment sums in shared memory, and joins a segment that spans
threads or tiles in a fixed order.  No atomics: a result repeats bit for
bit.  Where each tile starts depends on the layout alone, so the wrapper
builds that table on the card at a plan's first call and keeps it in
``plan.tables``.

The wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch

from .. import _trace

# Launch counts by instantiation: each rises by one where that kernel is
# launched, nowhere else.
launches = {"spmv<double>": 0, "spmv<float>": 0, "spmv<double,int64>": 0,
            "spmv<float,int64>": 0}

# (values dtype, bounds dtype) -> instantiation
_NAMES = {
    (torch.float64, torch.int32): "spmv<double>",
    (torch.float32, torch.int32): "spmv<float>",
    (torch.float64, torch.int64): "spmv<double,int64>",
    (torch.float32, torch.int64): "spmv<float,int64>",
}
_SYMBOLS = {"spmv<double>": "tabmat_spmv_f64", "spmv<float>": "tabmat_spmv_f32",
            "spmv<double,int64>": "tabmat_spmv_f64_i64",
            "spmv<float,int64>": "tabmat_spmv_f32_i64"}
_STARTS = {torch.int32: "tabmat_spmv_starts", torch.int64: "tabmat_spmv_starts_i64"}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
_TABLE_SIGNATURES = {
    # (W, E, m): the merge tiles of a call
    "tabmat_spmv_tiles": [ctypes.c_int, ctypes.c_longlong, ctypes.c_int],
    # (bounds, W, E, m, starts, stream): where each tile begins
    **{symbol: [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p] for symbol in _STARTS.values()},
}

_lib = None


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def spmv_plain(values: torch.Tensor, idx: torch.Tensor, bounds: torch.Tensor, a: torch.Tensor,
               scale=None) -> torch.Tensor:
    """Plain PyTorch version: ``index_select``, a multiply, and ``index_add_``
    by segment id.  ``values`` (n_src,) or (n_src, m) → (W,) or (W, m)."""
    num_segments = bounds.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(num_segments, dtype=torch.int32, device=values.device),
        bounds[1:] - bounds[:-1],
        output_size=idx.shape[0],
    )
    f = a if scale is None else a * scale.index_select(0, idx)
    terms = values.index_select(0, idx) * (f if values.ndim == 1 else f[:, None])
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, terms)


def spmv(values: torch.Tensor, plan, a: torch.Tensor, scale=None) -> torch.Tensor:
    """``Σ_t a[t] · scale[idx[t]] · values[idx[t]]`` per segment of ``plan``
    → (W,) or (W, m).

    CPU tensors take :func:`spmv_plain`.  CUDA tensors launch the kernel
    for the values' dtype and the plan's bounds (int32 or int64); ``values``,
    ``a`` and ``scale`` must be contiguous and on the plan's device.
    """
    operands = (values, a) if scale is None else (values, a, scale)
    if not all(torch.is_tensor(x) for x in operands):
        raise TypeError("values, a and scale must be torch tensors")
    if values.ndim not in (1, 2):
        raise ValueError(f"values must have rank 1 or 2, got {values.ndim}")
    if values.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"values must be float64 or float32, got {values.dtype}")
    if plan.bounds.dtype not in _STARTS:
        raise TypeError(f"the plan's bounds must be int32 or int64, got {plan.bounds.dtype}")
    if any(x.dtype != values.dtype for x in operands):
        raise TypeError(f"a and scale must have the dtype of values, {values.dtype}")
    if values.shape[0] != plan.n_rows:
        raise ValueError(f"values has {values.shape[0]} rows, the plan {plan.n_rows}")
    if a.shape != plan.perm.shape:
        raise ValueError(f"a has shape {tuple(a.shape)}, the plan {plan.perm.shape[0]} elements")
    if scale is not None and scale.shape != (plan.n_rows,):
        raise ValueError(f"scale has shape {tuple(scale.shape)}, not ({plan.n_rows},)")
    if any(x.device != plan.perm.device for x in operands):
        raise ValueError(f"values, a and scale must lie on the plan's device, {plan.perm.device}")
    if values.device.type == "cpu":
        return spmv_plain(values, plan.perm, plan.bounds, a, scale)
    if values.device.type != "cuda":
        raise ValueError(f"the kernels run on cpu or cuda tensors, got {values.device}")
    if not all(x.is_contiguous() for x in operands):
        raise ValueError("the CUDA spmv needs contiguous values, a and scale")
    if plan.perm.dtype != torch.int32:
        raise TypeError(f"the CUDA spmv needs int32 indices, got {plan.perm.dtype}")
    m = 1 if values.ndim == 1 else values.shape[1]
    W, E = plan.num_segments, plan.perm.shape[0]
    if E == 0 or m == 0:
        return torch.zeros((W,) + tuple(values.shape[1:]), dtype=values.dtype,
                           device=values.device)
    name = _NAMES[values.dtype, plan.bounds.dtype]
    from .. import _build

    with torch.cuda.device(values.device):
        lib = _library()
        stream = torch.cuda.current_stream(values.device).cuda_stream
        starts = _tile_starts(lib, plan, W, E, m, stream)
        out = torch.empty((W,) + tuple(values.shape[1:]), dtype=values.dtype,
                          device=values.device)
        carry_val = torch.empty((starts.shape[0] - 1, m), dtype=values.dtype,
                                device=values.device)
        err = getattr(lib, _SYMBOLS[name])(
            a.data_ptr(), plan.perm.data_ptr(), plan.bounds.data_ptr(), starts.data_ptr(),
            None if scale is None else scale.data_ptr(), values.data_ptr(),
            W, E, m, out.data_ptr(), carry_val.data_ptr(), stream,
        )
        _build.raise_on(lib, err, "spmv.cu kernel")
        launches[name] += 1
    return out


def _tile_starts(lib, plan, W: int, E: int, m: int, stream) -> torch.Tensor:
    """Where each merge tile of ``plan`` begins (int32, one per tile and one
    past the last), for the tile size that ``m`` selects (one column or a
    column group): built on the card at the first call and kept in
    ``plan.tables``."""
    key = ("spmv_starts", m == 1)
    starts = plan.tables.get(key)
    if starts is None:
        from .. import _build

        with _trace.span("tables.build"):
            _trace.count("tables_built")
            tiles = lib.tabmat_spmv_tiles(W, E, m)
            starts = torch.empty(tiles + 1, dtype=torch.int32, device=plan.perm.device)
            err = getattr(lib, _STARTS[plan.bounds.dtype])(plan.bounds.data_ptr(), W, E, m,
                                                          starts.data_ptr(), stream)
            _build.raise_on(lib, err, "spmv.cu tile starts")
            plan.tables[key] = starts
    return starts


def _library():
    """The built ``spmv.cu`` with its C functions typed (built at first use)."""
    global _lib
    if _lib is None:
        from .. import _build

        signatures = {symbol: _ARGTYPES for symbol in _SYMBOLS.values()}
        _lib = _build.bind("spmv", {**signatures, **_TABLE_SIGNATURES})
    return _lib
