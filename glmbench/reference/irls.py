"""The reference GLM fit: IRLS with every Newton step solved exactly.

Plain NumPy in float64 over a reference design (``designs.py``): the
canonical-link Poisson or Gaussian family, sample weights, an l2 penalty
``l2/2 · Σ ps_j β_j²`` with per-column scales ``ps`` (0 leaves a column,
such as the intercept, unpenalised), from β = 0.  The objective and the
start are the program's (``fit_glm``), so both converge to one optimum.
"""

import numpy as np


def family_terms(family: str, eta):
    """(mu, IRLS weight without the sample weight)."""
    if family == "poisson":
        mu = np.exp(eta)
        return mu, mu
    if family == "gaussian":
        return eta, np.ones_like(eta)
    raise ValueError(f"the reference has no family {family!r}")


def irls(design, y, sample_weight, family: str = "poisson", l2: float = 0.0, ps=None,
         max_iter: int = 60, rtol: float = 1e-13):
    """β of the penalised fit, and the Newton steps taken.

    Stops when a step moves no coefficient by more than ``rtol · max(1,
    max|β|)``, or once the steps stop shrinking (two steps in a row at least
    half the size of the one before, after the first few): rounding then sets
    their size, and the optimum is reached to it.
    """
    k = design.shape[1]
    ps = np.ones(k) if ps is None else np.asarray(ps, dtype=np.float64)
    beta = np.zeros(k)
    sizes = []
    for it in range(max_iter):
        mu, w_irls = family_terms(family, design.matvec(beta))
        grad = design.tmv(sample_weight * (y - mu)) - l2 * ps * beta
        H = design.hessian(sample_weight * w_irls)
        H[np.diag_indices(k)] += l2 * ps
        delta = np.linalg.solve(H, grad)
        beta = beta + delta
        size = float(np.abs(delta).max())
        sizes.append(size)
        if size <= rtol * max(1.0, float(np.abs(beta).max())):
            return beta, it + 1
        if it >= 5 and sizes[-1] >= 0.5 * sizes[-2] and sizes[-2] >= 0.5 * sizes[-3]:
            return beta, it + 1
    return beta, max_iter
