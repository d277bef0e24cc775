"""tabmat's ``dense_cat`` design, made with NumPy from a seed.

The upstream benchmark's ``benchmark/generate_matrices.py`` (Quantco/tabmat)
draws 3,000,000 rows of 5 standard-normal dense columns and two
categoricals of 1,000 uniform levels each (2,005 columns).  The same
shapes and distributions here, drawn from the run's seed, with a Poisson
response from a seeded coefficient vector so that the design can be fitted.
"""

import numpy as np


def make(config: dict, seed: int, count: int) -> list:
    """``count`` datasets from ``seed``: dense values, codes, response."""
    n, kd, levels = config["rows"], config["dense_cols"], config["cat_levels"]
    resp = config["response"]
    out = []
    for child in np.random.SeedSequence(seed).spawn(count):
        rng = np.random.default_rng(child)
        dense = rng.standard_normal((n, kd))
        codes = [rng.integers(0, m, n, dtype=np.int32) for m in levels]
        eta = resp["intercept"] + dense @ (rng.standard_normal(kd) * resp["dense_scale"])
        for c, m in zip(codes, levels):
            eta = eta + (rng.standard_normal(m) * resp["level_scale"])[c]
        y = rng.poisson(np.exp(eta)).astype(np.float64)
        out.append({"dense": dense, "codes": codes, "y": y, "weights": np.ones(n)})
    return out


def to_program(tt, data: dict, config: dict, dtype, device):
    """The program's matrix: a ``SplitMatrix`` of a ``DenseMatrix`` and one
    ``CategoricalMatrix`` per categorical, as the upstream generator builds it."""
    kd, levels = config["dense_cols"], config["cat_levels"]
    mats = [tt.DenseMatrix(data["dense"].astype(dtype), device=device)]
    mats += [tt.CategoricalMatrix(c, categories=np.arange(m), dtype=dtype, device=device)
             for c, m in zip(data["codes"], levels)]
    offsets = np.cumsum([kd] + list(levels))
    indices = [np.arange(kd)] + [np.arange(lo, hi) for lo, hi in zip(offsets[:-1], offsets[1:])]
    return tt.SplitMatrix(mats, indices)


def penalty_scale(config: dict, n_cols: int) -> np.ndarray:
    """Every column penalised: the one-hot blocks each sum to one, so the
    coefficients are unique only under the ridge."""
    return np.ones(n_cols)


def reference_design(data: dict, config: dict):
    from glmbench.reference.designs import DenseCatDesign

    return DenseCatDesign(data["dense"], data["codes"], config["cat_levels"])
