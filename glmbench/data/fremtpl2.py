"""Frames in the shape of freMTPL2freq, made with NumPy from a seed.

freMTPL2freq is the French motor third-party liability table of R's
CASdatasets (678,013 policies), the data of glum's tutorial.  The table is
not in the repository, so each frame is made in its shape: the exposure,
the numeric columns in their ranges, the four categoricals with their
levels in a declared order that is not sorted, and Poisson claim counts.
"""

import numpy as np


def freq_frame(n: int, rng, levels: dict):
    """One frame of ``n`` policies (``levels``: each categorical's levels)."""
    import pandas as pd

    exposure = np.where(rng.random(n) < 0.3, 1.0, rng.uniform(0.0027, 1.0, n))
    frame = pd.DataFrame({
        "Exposure": exposure,
        "VehPower": rng.integers(4, 16, n),
        "VehAge": np.minimum(rng.geometric(0.12, n) - 1, 100),
        "DrivAge": np.clip(np.rint(rng.normal(45.0, 14.0, n)), 18, 100).astype(np.int64),
        "BonusMalus": np.minimum(49 + rng.geometric(0.08, n), 230),
        "Density": np.clip(np.rint(np.exp(rng.normal(6.0, 2.0, n))), 1, 27_000).astype(np.int64),
    })
    eta = (-3.0 + 0.02 * (frame["VehPower"] - 6) - 0.01 * frame["VehAge"]
           - 0.004 * (frame["DrivAge"] - 45) + 0.015 * (frame["BonusMalus"] - 50)
           + 0.05 * np.log(frame["Density"])).to_numpy()
    for name, names in levels.items():
        p = rng.random(len(names)) + 0.2
        codes = rng.choice(len(names), n, p=p / p.sum())
        frame[name] = pd.Categorical.from_codes(codes, categories=names)
        eta = eta + (rng.standard_normal(len(names)) * 0.2)[codes]
    frame["ClaimNb"] = rng.poisson(exposure * np.exp(eta))
    return frame


def make(config: dict, seed: int, count: int) -> list:
    """``count`` datasets from ``seed``, each a dict with the frame, the
    response (claims per unit of exposure) and the weights (the exposure),
    as glum's tutorial fits them."""
    out = []
    for child in np.random.SeedSequence(seed).spawn(count):
        frame = freq_frame(config["rows"], np.random.default_rng(child), config["levels"])
        exposure = frame["Exposure"].to_numpy(np.float64, copy=True)
        out.append({"frame": frame, "y": frame["ClaimNb"].to_numpy(np.float64) / exposure,
                    "weights": exposure})
    return out


def to_program(tt, data: dict, config: dict, dtype, device):
    """The program's matrix of one dataset: ``from_formula`` on its frame."""
    return tt.from_formula(config["formula"], data["frame"], include_intercept=True,
                           ensure_full_rank=True, dtype=dtype, device=device)


def penalty_scale(config: dict, n_cols: int) -> np.ndarray:
    """1 on every column but the intercept (column 0), which is not penalised."""
    ps = np.ones(n_cols)
    ps[0] = 0.0
    return ps


def reference_design(data: dict, config: dict):
    """The reference's operator for the dataset (encoded again by NumPy)."""
    from glmbench.reference.designs import FormulaDesign

    return FormulaDesign(data["frame"], config["levels"])
