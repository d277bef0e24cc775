"""Host helpers for the categorical and sparse plans' keys, in numpy.

The port's own copy of ``expand_pairs_csr`` and ``combine_codes``
(``tabmat_tpu/_native/__init__.py:131-168, 222-250``).  The JAX package runs
them in a native library with numpy fallbacks; the port keeps the numpy
versions only.  They run once per matrix or design, outside any step.  The
plans themselves are sorted on their device by ``ops/segments.build_plan``;
the JAX package's host argsort is not carried, nor its OpenMP CSR/CSC
walks (``csr_matvec``, ``csc_tmv``): in the port a numpy caller's sparse op
runs on the card, as every other op does.
"""

import numpy as np


def expand_pairs_csr(indptr: np.ndarray):
    """All ordered within-row nonzero pairs of a CSR structure.

    Returns ``(ia, ib, row)`` int64 arrays of length ``Σ_r nnz_r²``: the
    positions of the two members in the data array and the owning row, in
    row order, then ``ia``, then ``ib``.
    """
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    counts = np.diff(indptr)
    pair_counts = counts * counts
    row = np.repeat(np.arange(len(counts), dtype=np.int64), pair_counts)
    pair_starts = np.concatenate([[0], np.cumsum(pair_counts)])
    q = np.arange(int(pair_counts.sum()), dtype=np.int64) - pair_starts[row]
    c_r = np.maximum(counts[row], 1)
    start = indptr[row]
    return start + q // c_r, start + q % c_r, row


def combine_codes(a: np.ndarray, b: np.ndarray, k2: int) -> np.ndarray:
    """Combined categorical cross keys: ``a*k2 + b`` where both valid, else -1.

    Returns int32.  Raises ``OverflowError`` when ``max(a)*k2 + max(b)``
    does not fit in int32, so a key never wraps around.
    """
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    if len(a) and int(a.max()) * k2 + max(int(b.max()), 0) >= 2**31:
        raise OverflowError(
            f"combined categorical key space {int(a.max()) + 1}*{k2} exceeds "
            "int32; reduce the category product below 2**31"
        )
    out = np.where((a >= 0) & (b >= 0), a.astype(np.int64) * k2 + b, -1)
    return out.astype(np.int32)
