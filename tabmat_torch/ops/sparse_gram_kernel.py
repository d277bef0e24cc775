"""The hand-written CUDA sparse Gram matrix, and its plain version.

Kernel: ``tabmat_torch/csrc/sparse_gram.cu``, instantiated for ``double``
and ``float``::

    S = X.T diag(d) X    (k, k),   S[i, c] = Σ_r x_ri · d_r · x_rc

straight from the CSR and CSC layouts a ``SparseMatrix`` keeps on the card
(``sparse_ops.compressed_layout``: int32 indices, int32 bounds), with no
densified panel.  It serves the sandwich of a matrix past the pair plan's
and the densified matrix's budgets (tabmat's ``sparse_wide``, 40,000 ×
10,000 at 1%), which took row panels of the CSR layout, densified, through
the FP64 tensor cores (``sandwich_mma<double>``; the JAX package's
``_sliced_pairs_kernel``, ``tabmat_tpu/ops/pallas_pairs.py:103``).  Its work
is the within-row pairs, ``Σ_r nnz_r²``, not the panels' ``n·k²``.

Gustavson by output row: a warp sums one row of the upper triangle over a
chunk of columns in shared memory, gathering the CSR runs of the rows of
CSC column i; a block writes its rows and their mirror, so S is exactly
symmetric and each entry is written once.  No atomics: a result repeats bit
for bit.  Its least time is S written once (0.25 ms at ``sparse_wide`` on an
H100); it takes 1.81 ms there, more in each (step, chunk)'s set-up and
search than in its 2.4 GB of gathered CSR entries (the source's note).

Two tables the kernel reads (:func:`gram_tables`), built on the card at
the layouts' first call and kept in the CSC plan's ``tables`` unless the
caller asks for them a call at a time (a ``SparseMatrix`` whose
device-cache ledger refuses their bytes, :func:`table_bytes`): for each CSR
row where each chunk of columns begins, and for each CSC entry (r, i) the
first CSR entry of row r at or right of column i.

Layouts with int64 bounds (past 2³¹ − 1 nonzeros) have no instantiation:
the sandwich keeps them on the row panels, and the wrapper raises for them
on the card.  The wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch

from .. import _trace

# Launch counts by instantiation: each rises by one where that kernel is
# launched, nowhere else.
launches = {"sparse_gram<double>": 0, "sparse_gram<float>": 0}

_NAMES = {torch.float64: "sparse_gram<double>", torch.float32: "sparse_gram<float>"}
_SYMBOLS = {"sparse_gram<double>": "tabmat_sparse_gram_f64",
            "sparse_gram<float>": "tabmat_sparse_gram_f32"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
# columns of one warp's accumulator (a multiple of the block's 4 rows): 8 KB
# of shared memory a warp in f64, and a byte a column to find shared columns
CHUNK = 1024
# rows a block (csrc/sparse_gram.cu's ROWS)
ROWS = 4
# pairs of one block of rows in the plain version
PLAIN_MAX_PAIRS = 1 << 24
# entries (or table cells) a step of gram_tables' temporaries
SLICE = 1 << 24

_lib = None


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def sparse_gram_plain(data: torch.Tensor, cols: torch.Tensor, bounds: torch.Tensor,
                      d: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version from the CSR layout alone: in blocks of rows of
    at most ``PLAIN_MAX_PAIRS`` within-row pairs (at least one row), each pair of
    entries (a, b) of a row with ``col a ≤ col b`` adds ``(x_a d_r) x_b`` to
    ``S[col a, col b]`` by ``index_add_``; the upper triangle is mirrored."""
    n = bounds.shape[0] - 1
    dev = data.device
    S = torch.zeros(k * k, dtype=data.dtype, device=dev)
    counts = (bounds[1:] - bounds[:-1]).long()
    through = torch.cumsum(counts * counts, 0)  # pairs of rows 0 .. r
    start = 0
    while start < n:
        before = int(through[start - 1]) if start else 0
        stop = int(torch.searchsorted(through, before + PLAIN_MAX_PAIRS, right=True))
        stop = min(n, max(start + 1, stop))
        lo, hi = int(bounds[start]), int(bounds[stop])
        row = torch.repeat_interleave(torch.arange(start, stop, device=dev),
                                      counts[start:stop], output_size=hi - lo)
        partners = counts[row]
        a = torch.repeat_interleave(torch.arange(lo, hi, device=dev), partners)
        ra = torch.repeat_interleave(row, partners)
        firsts = torch.cumsum(partners, 0) - partners
        b = (bounds[ra].long() + torch.arange(a.numel(), device=dev)
             - torch.repeat_interleave(firsts, partners))
        ca, cb = cols[a].long(), cols[b].long()
        upper = ca <= cb
        a, b, ra = a[upper], b[upper], ra[upper]
        S.index_add_(0, ca[upper] * k + cb[upper], data[a] * d[ra] * data[b])
        start = stop
    S = S.view(k, k)
    return S + torch.triu(S, 1).T


def chunk_columns(k: int) -> int:
    """The columns of one warp's accumulator for a k-column matrix."""
    return min(CHUNK, -(-k // ROWS) * ROWS)


def table_bytes(csr_plan, csc_plan) -> int:
    """Bytes of :func:`gram_tables`' two tables for these layouts."""
    k, n = csr_plan.n_rows, csc_plan.n_rows
    return 4 * (n * (-(-k // chunk_columns(k)) + 1) + csc_plan.perm.shape[0])


def gram_tables(csr_plan, csc_plan, chunk: int, keep: bool = True):
    """``(tab, first)`` of the kernel for ``chunk`` columns a chunk, built on
    the layouts' device; with ``keep`` they are kept in ``csc_plan.tables``
    and built at the first call alone.

    ``tab`` (n, n_chunks + 1) int32: ``tab[r, j]`` is the first CSR entry of
    row r whose column is ≥ ``j·chunk`` (clamped to k: ``tab[r, n_chunks]``
    is the row's end); ``first`` (E,) int32: for each CSC entry (r, i), the
    first CSR entry of row r whose column is ≥ i.  Both are
    ``searchsorted`` over the CSR entries' keys ``r·k + col``, which the
    layout's sorted columns keep in order; the keys are the one temporary
    as long as the layout, the rest is made ``SLICE`` at a time.
    """
    key = ("sparse_gram", chunk)
    tables = csc_plan.tables.get(key)
    if tables is None:
        with _trace.span("tables.build"):
            _trace.count("tables_built")
            k, n = csr_plan.n_rows, csc_plan.n_rows
            E = csr_plan.perm.shape[0]
            dev = csr_plan.perm.device
            keys = torch.empty(E, dtype=torch.int64, device=dev)
            for lo, pos in _slices(E, csr_plan.bounds):
                row = torch.searchsorted(csr_plan.bounds, pos, right=True) - 1
                keys[lo : lo + len(pos)] = row.long() * k + csr_plan.perm[lo : lo + len(pos)]
            edges = (torch.arange(-(-k // chunk) + 1, device=dev) * chunk).clamp_(max=k)
            tab = torch.empty((n, len(edges)), dtype=torch.int32, device=dev)
            step = max(1, SLICE // len(edges))
            for lo in range(0, n, step):
                rows = torch.arange(lo, min(n, lo + step), device=dev)
                tab[lo : lo + step] = torch.searchsorted(keys, rows[:, None] * k + edges,
                                                         out_int32=True)
            first = torch.empty(E, dtype=torch.int32, device=dev)
            for lo, pos in _slices(E, csc_plan.bounds):
                col = torch.searchsorted(csc_plan.bounds, pos, right=True) - 1
                first[lo : lo + len(pos)] = torch.searchsorted(
                    keys, csc_plan.perm[lo : lo + len(pos)].long() * k + col, out_int32=True)
            tables = (tab, first)
            if keep:
                csc_plan.tables[key] = tables
    return tables


def _slices(E: int, bounds: torch.Tensor):
    """``(lo, positions lo .. lo + SLICE)`` over E entries, the positions in
    the bounds' dtype (``searchsorted`` takes one dtype)."""
    for lo in range(0, E, SLICE):
        yield lo, torch.arange(lo, min(E, lo + SLICE), dtype=bounds.dtype, device=bounds.device)


def sparse_gram(csr_data: torch.Tensor, csr_plan, csc_data: torch.Tensor, csc_plan,
                d: torch.Tensor, keep_tables: bool = True) -> torch.Tensor:
    """``X.T diag(d) X`` → (k, k) from the CSR layout ``(csr_data,
    csr_plan)`` and the CSC layout ``(csc_data, csc_plan)`` of one (n, k)
    matrix (``sparse_ops.compressed_layout``; the CSR's columns sorted
    within each row) and ``d`` (n,).

    CPU tensors take :func:`sparse_gram_plain`.  CUDA tensors launch the
    kernel for the data's dtype; they need int32 bounds and contiguous
    operands on one device.  ``keep_tables=False`` builds the kernel's
    tables for this call alone.
    """
    operands = (csr_data, csc_data, d)
    if not all(torch.is_tensor(x) for x in operands):
        raise TypeError("the layouts' data and d must be torch tensors")
    if csr_data.dtype not in _NAMES:
        raise TypeError(f"the data must be float64 or float32, got {csr_data.dtype}")
    if any(x.dtype != csr_data.dtype for x in operands):
        raise TypeError(f"the CSC data and d must have the CSR data's dtype, {csr_data.dtype}")
    k, n = csr_plan.n_rows, csc_plan.n_rows
    E = csr_plan.perm.shape[0]
    if (csr_plan.num_segments, csc_plan.num_segments) != (n, k) or csc_plan.perm.shape[0] != E:
        raise ValueError("the CSR and CSC layouts are not of one (n, k) matrix")
    if d.shape != (n,):
        raise ValueError(f"d has shape {tuple(d.shape)}, not ({n},)")
    if csr_data.shape != (E,) or csc_data.shape != (E,):
        raise ValueError(f"the layouts' data must hold their {E} entries")
    device = csr_data.device
    if any(x.device != device for x in (csc_data, d, csr_plan.perm, csc_plan.perm)):
        raise ValueError("the layouts and d must lie on one device")
    if device.type == "cpu":
        return sparse_gram_plain(csr_data, csr_plan.perm, csr_plan.bounds, d, k)
    if device.type != "cuda":
        raise ValueError(f"the kernels run on cpu or cuda tensors, got {device}")
    if csr_plan.bounds.dtype != torch.int32 or csc_plan.bounds.dtype != torch.int32:
        raise TypeError("sparse_gram needs int32 bounds: a layout past 2**31 - 1 entries "
                        "stays on the sandwich's row panels")
    if not all(x.is_contiguous() for x in operands):
        raise ValueError("the CUDA sparse_gram needs contiguous data and d")
    name = _NAMES[csr_data.dtype]
    chunk = chunk_columns(k)
    from .. import _build

    with torch.cuda.device(device):
        lib = _library()
        stream = torch.cuda.current_stream(device).cuda_stream
        S = torch.empty((k, k), dtype=csr_data.dtype, device=device)
        if k == 0:
            return S
        tab, first = gram_tables(csr_plan, csc_plan, chunk, keep_tables)
        err = getattr(lib, _SYMBOLS[name])(
            csc_plan.bounds.data_ptr(), csc_plan.perm.data_ptr(), csc_data.data_ptr(),
            first.data_ptr(), csr_plan.perm.data_ptr(), csr_data.data_ptr(), tab.data_ptr(),
            tab.shape[1], d.data_ptr(), k, chunk, S.data_ptr(), stream,
        )
        _build.raise_on(lib, err, "sparse_gram.cu kernel")
        launches[name] += 1
    return S


def _library():
    """The built ``sparse_gram.cu`` with its C functions typed (built at first use)."""
    global _lib
    if _lib is None:
        from .. import _build

        _lib = _build.bind("sparse_gram", {symbol: _ARGTYPES for symbol in _SYMBOLS.values()})
    return _lib
