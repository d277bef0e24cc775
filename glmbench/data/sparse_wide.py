"""tabmat's ``sparse_wide`` design, made with SciPy from a seed.

The upstream benchmark's ``benchmark/generate_matrices.py`` (Quantco/tabmat)
draws ``scipy.sparse.random(40_000, 10_000, density=0.01)`` in CSC with
``random_state=7``: 4,000,000 nonzeros at uniform positions, values
U[0, 1) in float64.  The same call here, from a ``np.random.Generator`` of
the run's seed.  The ``ops`` loop reads no response, so none is made.
"""

import numpy as np
from scipy import sparse as sps


def make(config: dict, seed: int, count: int) -> list:
    """``count`` designs from ``seed``, each a float64 CSC matrix with sorted
    row indices."""
    n, k, density = config["rows"], config["cols"], config["density"]
    out = []
    for child in np.random.SeedSequence(seed).spawn(count):
        # the generator is passed by position: SciPy names that argument
        # random_state in older versions and rng in newer ones
        X = sps.random(n, k, density, "csc", np.float64, np.random.default_rng(child))
        X.sort_indices()
        out.append({"csc": X})
    return out


def to_program(tt, data: dict, config: dict, dtype, device):
    """The program's matrix: a ``SparseMatrix`` of the CSC in ``dtype``."""
    return tt.SparseMatrix(data["csc"].astype(dtype), device=device)


def penalty_scale(config: dict, n_cols: int) -> np.ndarray:
    """Every column penalised alike."""
    return np.ones(n_cols)


def reference_design(data: dict, config: dict):
    from glmbench.reference.sparse import SparseDesign

    X = data["csc"]
    return SparseDesign(X.indptr, X.indices, X.data, X.shape)
