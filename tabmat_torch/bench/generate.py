"""Benchmark matrix generators — the reference's designs, regenerated.

Port of ``tabmat_tpu/bench/generate.py``: the same eight designs, names,
shapes and numpy seeds, so one seed and scale give the same ``toarray()``
bit for bit in both packages.  Shapes follow the upstream tabmat benchmark
(``benchmark/generate_matrices.py:90-101``): dense 4M×10, sparse 400k×100
(1% density), sparse_narrow 3M×3, sparse_wide 40k×10k, one_cat 1M×100k,
two_cat 1M×(1k+1k), dense_cat 3M×(5+1k+1k), dense_smallcat 3M×(5+10+1k).

Every generator takes ``device=``: None means the CUDA card (and raises
without one), as for every other entry point of the port.
"""

import numpy as np
from scipy import sparse as sps

from .. import CategoricalMatrix, DenseMatrix, SparseMatrix, SplitMatrix


def make_cat_matrix(n_rows: int, n_cats: int, seed: int = 0, device=None) -> CategoricalMatrix:
    rng = np.random.default_rng(seed)
    return CategoricalMatrix(
        rng.integers(0, n_cats, n_rows, dtype=np.int32), categories=np.arange(n_cats),
        device=device,
    )


def make_cat_matrices(n_rows: int, n_cat_cols_1: int, n_cat_cols_2: int, device=None):
    m1 = make_cat_matrix(n_rows, n_cat_cols_1, seed=1, device=device)
    m2 = make_cat_matrix(n_rows, n_cat_cols_2, seed=2, device=device)
    return SplitMatrix(
        [m1, m2],
        [np.arange(n_cat_cols_1), n_cat_cols_1 + np.arange(n_cat_cols_2)],
    )


def make_dense_cat_matrices(
    n_rows: int, n_dense_cols: int, n_cat_cols_1: int, n_cat_cols_2: int, device=None
):
    rng = np.random.default_rng(3)
    dense = DenseMatrix(rng.standard_normal((n_rows, n_dense_cols)), device=device)
    c1 = make_cat_matrix(n_rows, n_cat_cols_1, seed=4, device=device)
    c2 = make_cat_matrix(n_rows, n_cat_cols_2, seed=5, device=device)
    off = n_dense_cols
    return SplitMatrix(
        [dense, c1, c2],
        [
            np.arange(n_dense_cols),
            off + np.arange(n_cat_cols_1),
            off + n_cat_cols_1 + np.arange(n_cat_cols_2),
        ],
    )


def make_dense_matrix(n_rows: int, n_cols: int, device=None) -> DenseMatrix:
    rng = np.random.default_rng(6)
    return DenseMatrix(rng.standard_normal((n_rows, n_cols)), device=device)


def make_sparse_matrix(n_rows: int, n_cols: int, density: float = 0.01, device=None):
    return SparseMatrix(
        sps.random(n_rows, n_cols, density=density, random_state=7, format="csc"),
        device=device,
    )


def get_all_benchmark_matrices(scale: float = 1.0, device=None):
    """Name → thunk for every benchmark design.

    ``scale`` shrinks the row counts (e.g. 0.01 for smoke tests), floored at
    16 rows.  ``device`` goes to every matrix: None means the CUDA card.
    """

    def s(n):
        return max(int(n * scale), 16)

    return {
        "dense": lambda: make_dense_matrix(s(4_000_000), 10, device),
        "sparse": lambda: make_sparse_matrix(s(400_000), 100, device=device),
        "sparse_narrow": lambda: make_sparse_matrix(s(3_000_000), 3, device=device),
        "sparse_wide": lambda: make_sparse_matrix(s(40_000), 10_000, device=device),
        "one_cat": lambda: make_cat_matrix(s(1_000_000), 100_000, device=device),
        "two_cat": lambda: make_cat_matrices(s(1_000_000), 1_000, 1_000, device),
        "dense_cat": lambda: make_dense_cat_matrices(s(3_000_000), 5, 1_000, 1_000, device),
        "dense_smallcat": lambda: make_dense_cat_matrices(s(3_000_000), 5, 10, 1_000, device),
    }
