"""A GLM solver on the tabmat_torch kernels.

Port of ``tabmat_tpu/glm.py``: iteratively reweighted least squares with a
conjugate-gradient inner solve, and FISTA for the elastic net.  The
reference jit-compiles each step; the port runs eagerly, so its fixed-count
loops (``lax.fori_loop``) are Python loops over device tensors with no
host synchronisation inside a step.

Functional core:
  - ``irls_step(X, y, weights, beta, family=...)`` — one Newton step
  - ``fista_epoch(...)`` — ``n_steps`` proximal-gradient steps
  - ``fit_glm(...)`` — host loop with convergence check

On a :class:`~tabmat_torch.parallel.design.DeviceDesign` the Newton step
builds one explicit Hessian through the sandwich kernel, in float32 by
default (``inner_precision='float32'``) or float64.
"""

from typing import Callable

import numpy as np
import torch

from ._config import DEFAULT_DTYPE
from .utils.arrays import to_tensor

FAMILIES = (
    "gaussian",
    "poisson",
    "logistic",
    "gamma",
    "inverse_gaussian",
    "tweedie",
)

# glum-compatible spellings (glum: Normal/Binomial/InverseGaussian etc.)
_FAMILY_ALIASES = {
    "normal": "gaussian",
    "binomial": "logistic",
    "bernoulli": "logistic",
    "inverse.gaussian": "inverse_gaussian",
}


def _parse_family(family: str):
    """'tweedie(p)' → ('tweedie', p); other names pass through."""
    family = _FAMILY_ALIASES.get(family, family)
    if family.startswith("tweedie"):
        if "(" in family:
            power = float(family[family.index("(") + 1 : family.rindex(")")])
        else:
            power = 1.5
        if not 1.0 < power < 2.0:
            raise ValueError(
                f"tweedie power must be in (1, 2), got {power}"
            )
        return "tweedie", power
    return family, None


def _family_terms(family: str, eta: torch.Tensor, y: torch.Tensor):
    """Return (mu, irls_weight, working_residual) for the canonical link.

    For canonical links the IRLS weight is Var(mu) = dmu/deta and the
    Newton step solves  (Xᵀ W X) δ = Xᵀ (y - mu).
    """
    family = _FAMILY_ALIASES.get(family, family)
    if family == "gaussian":
        mu = eta
        w = torch.ones_like(eta)
    elif family == "poisson":
        mu = torch.exp(eta)
        w = mu
    elif family == "logistic":
        mu = torch.sigmoid(eta)
        w = mu * (1 - mu)
    elif family == "gamma":
        # log link: w = mu²/V(mu) = 1 and the score is Xᵀ((y - mu)/mu)
        mu = torch.exp(eta)
        w = torch.ones_like(eta)
        return mu, w, (y - mu) / mu
    elif family == "inverse_gaussian":
        # V(mu) = mu³ under the log link: Fisher weight mu^{-1},
        # score Xᵀ((y - mu)/mu²)
        mu = torch.exp(eta)
        w = 1.0 / mu
        return mu, w, (y - mu) / (mu * mu)
    elif family.startswith("tweedie"):
        # V(mu) = mu^p under the log link: Fisher weight mu^{2-p},
        # score Xᵀ((y - mu)·mu^{1-p})
        _, power = _parse_family(family)
        mu = torch.exp(eta)
        w = mu ** (2.0 - power)
        return mu, w, (y - mu) * mu ** (1.0 - power)
    else:
        raise ValueError(f"Unknown family {family!r}; options: {FAMILIES}")
    return mu, w, y - mu


def _make_mv_tmv(X):
    """Matvec/transpose-matvec closures for a tensor or DeviceDesign."""
    return (lambda v: X @ v), (lambda r: X.T @ r)


def _cg_solve(matvec: Callable, b: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Fixed-iteration conjugate gradient.

    Convergence-safe: once the residual has collapsed (or ``pᵀAp`` flushes
    to zero on FTZ hardware), the step sizes are forced to 0 instead of
    dividing by a flushed denominator — running past convergence would
    otherwise overflow into inf−inf = NaN.
    """
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.dot(b, b)
    for _ in range(n_iter):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        live = denom > tiny
        alpha = torch.where(live, rs / torch.where(live, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        beta = torch.where(rs > tiny, rs_new / torch.where(rs > tiny, rs, 1.0), 0.0)
        p = r + beta * p
        rs = rs_new
    return x


def _f32_hessian_scale(X32, w: torch.Tensor) -> torch.Tensor:
    """Power of two ``s ≤ 1`` with ``max |x_ij| · |w_i| · s ≤ 1``, on the device.

    The float32 Newton system ``(s H) δ = s g`` has the solution of
    ``H δ = g``.  Scaling by a power of two is exact, so while the unscaled
    terms fit in float32 the step is bit for bit the unscaled one; where the
    weights would overflow float32 (large Poisson or Gamma weights, or
    sample weights) the scaled Hessian still fits.  This is the port's use of
    the reference's exponent prepass (``pallas_sandwich_v4._max_prepass``),
    which keeps the TPU's narrow planes in range in the same way.  A zero,
    inf or NaN maximum leaves ``s = 1``.  No host sync.
    """
    m = X32.column_absmax(w).amax()
    e = torch.clamp(torch.ceil(torch.log2(m)), min=0.0)
    return torch.where(torch.isfinite(e), torch.exp2(-e), torch.ones_like(e))


def irls_step(
    X,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    beta: torch.Tensor,
    family: str = "gaussian",
    n_cg: int = 16,
    l2: float = 0.0,
    inner_precision: str = "float32",
    penalty_scale=None,
    offset=None,
) -> torch.Tensor:
    """One IRLS Newton step with a conjugate-gradient inner solve.

    ``X`` is a tensor or a :class:`DeviceDesign`.  The linear predictor and
    gradient are evaluated in the operand dtype; by default the inner solve
    runs in float32 — an inexact-Newton direction, which IRLS absorbs
    (same fixed point).  Pass ``inner_precision='float64'`` for a fully f64
    step.

    A design with an explicit sandwich builds the Hessian once
    (``Xᵀ diag(w) X``, the CUDA kernel on a GPU) and runs CG on the (k, k)
    matrix; otherwise the Hessian-vector product is two matvecs.
    """
    mv, tmv = _make_mv_tmv(X)

    eta = mv(beta)
    if offset is not None:
        eta = eta + offset
    mu, w_irls, resid = _family_terms(family, eta, y)
    w = sample_weight * w_irls
    # penalty_scale (e.g. 0 on the intercept) keeps chosen coords unpenalized
    ps = torch.ones_like(beta) if penalty_scale is None else penalty_scale
    grad = tmv(sample_weight * resid) - l2 * ps * beta
    f32_inner = inner_precision == "float32" and X.dtype == torch.float64

    if getattr(X, "supports_sandwich", False):
        # explicit-Hessian path: ONE sandwich per step, then CG on (k, k)
        if f32_inner:
            X32 = X.astype_float(torch.float32)
            s = _f32_hessian_scale(X32, w)
            H = X32.sandwich((w * s).to(torch.float32))
            if l2:
                H = H + torch.diag((l2 * s * ps).to(torch.float32))
            delta = _cg_solve(lambda v: H @ v, (grad * s).to(torch.float32), n_cg)
            return beta + delta.to(beta.dtype)
        H = X.sandwich(w)
        if l2:
            H = H + l2 * torch.diag(ps)
        delta = _cg_solve(lambda v: H @ v, grad, n_cg)
        return beta + delta

    if f32_inner:
        if torch.is_tensor(X):
            X32 = X.to(torch.float32)
        else:
            X32 = X.astype_float(torch.float32)
        w32 = w.to(torch.float32)
        ps32 = ps.to(torch.float32)

        def hvp(v):
            return X32.T @ (w32 * (X32 @ v)) + l2 * ps32 * v

        delta = _cg_solve(hvp, grad.to(torch.float32), n_cg)
        return beta + delta.to(beta.dtype)

    def hvp(v):
        return tmv(w * mv(v)) + l2 * ps * v

    delta = _cg_solve(hvp, grad, n_cg)
    return beta + delta


def fista_epoch(
    X,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    beta: torch.Tensor,
    step,
    family: str = "gaussian",
    n_steps: int = 50,
    l1: float = 0.0,
    l2: float = 0.0,
    penalty_scale=None,
    offset=None,
) -> torch.Tensor:
    """``n_steps`` of FISTA for the elastic-net GLM objective.

    Proximal gradient with Nesterov momentum: the smooth part is the
    negative log-likelihood (+ l2/2·|β|²), the prox is soft-thresholding at
    ``step·l1``.  ``step`` ≈ 1/L with L the gradient Lipschitz constant
    (estimated by power iteration in :func:`fit_glm`).
    """
    mv, tmv = _make_mv_tmv(X)

    ps = torch.ones_like(beta) if penalty_scale is None else penalty_scale

    def grad(b):
        eta = mv(b)
        if offset is not None:
            eta = eta + offset
        _, _, resid = _family_terms(family, eta, y)
        return -tmv(sample_weight * resid) + l2 * ps * b

    def soft(b, thresh):
        return torch.sign(b) * torch.clamp(torch.abs(b) - thresh, min=0.0)

    b, z = beta, beta
    t = torch.tensor(1.0, dtype=beta.dtype, device=beta.device)
    for _ in range(n_steps):
        b_new = soft(z - step * grad(z), step * l1 * ps)
        t_new = 0.5 * (1 + torch.sqrt(1 + 4 * t * t))
        z = b_new + ((t - 1) / t_new) * (b_new - b)
        b, t = b_new, t_new
    return b


def _power_iteration_lipschitz(mv, tmv, w, k, dtype, device, n_iter=12):
    """Estimate L = λmax(Xᵀ diag(w) X) by power iteration (matvec-based)."""
    v = torch.ones(k, dtype=dtype, device=device) / np.sqrt(k)
    lam = torch.tensor(1.0, dtype=dtype, device=device)
    for _ in range(n_iter):
        hv = tmv(w * mv(v))
        lam = torch.linalg.vector_norm(hv)
        v = hv / torch.clamp(lam, min=1e-30)
    return float(lam)


def _as_float(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` on ``like``'s device; integer data takes ``like``'s dtype."""
    t = to_tensor(x, device=like.device)
    return t if t.is_floating_point() else t.to(like.dtype)


def fit_glm(
    X,
    y,
    sample_weight=None,
    family: str = "gaussian",
    max_iter: int = 25,
    tol: float = 1e-10,
    n_cg: int = 16,
    l2: float = 0.0,
    l1: float = 0.0,
    inner_precision: str = "float32",
    penalty_scale=None,
    offset=None,
    P1=None,
    P2=None,
):
    """Fit a GLM by IRLS; accepts numpy arrays, tensors, a DenseMatrix or a
    StandardizedMatrix over one.

    Matrices become a :class:`DeviceDesign` on their own device; a numpy
    array goes to ``torch.get_default_device()``.  ``offset`` adds a fixed
    term to the linear predictor.  ``P1``/``P2`` are per-feature penalty
    multipliers in glum's convention: the effective penalties are
    ``l1·P1[j]`` and ``l2·P2[j]``.

    Returns (beta, n_iter), beta a tensor on the design's device.
    Convergence: max |Δβ| < tol.
    """
    from .models.base import MatrixBase
    from .models.standardized import StandardizedMatrix
    from .parallel.design import DeviceDesign

    if isinstance(X, (MatrixBase, StandardizedMatrix)):
        X = DeviceDesign.from_matrix(X)
    if not isinstance(X, DeviceDesign):
        X = to_tensor(X)
        if not X.is_floating_point():
            X = X.to(DEFAULT_DTYPE)
    beta = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    y = _as_float(y, beta)
    if sample_weight is None:
        sample_weight = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    else:
        sample_weight = _as_float(sample_weight, beta)

    if penalty_scale is not None:
        penalty_scale = to_tensor(penalty_scale, device=beta.device, dtype=beta.dtype)
    if P1 is not None or P2 is not None:
        # glum-style per-feature multipliers fold into penalty_scale; when
        # P1 and P2 differ the l1/l2 terms need separate scales — supported
        # for the common case P1 == P2 (or only one penalty active)
        base = penalty_scale if penalty_scale is not None else torch.ones_like(beta)
        if P1 is not None and P2 is not None and not np.array_equal(
            np.asarray(P1), np.asarray(P2)
        ) and l1 > 0 and l2 > 0:
            raise NotImplementedError(
                "distinct P1 and P2 with both l1 and l2 active are not yet supported"
            )
        pf = P1 if P1 is not None else P2
        penalty_scale = base * to_tensor(pf, device=beta.device, dtype=beta.dtype)
    if offset is not None:
        offset = to_tensor(offset, device=beta.device, dtype=beta.dtype)

    if l1 > 0:
        # elastic net → FISTA epochs (IRLS can't handle the nonsmooth term)
        mv, tmv = _make_mv_tmv(X)
        # Lipschitz bound of the smooth part: the IRLS weight is bounded for
        # gaussian/logistic/gamma; poisson (w=mu), inverse_gaussian (w=1/mu)
        # and tweedie (w=mu^{2-p}) are unbounded in mu, so estimate at w=1
        # and add step slack below
        family_base, _ = _parse_family(family)
        caps = {"gaussian": 1.0, "logistic": 0.25, "gamma": 1.0}
        w_cap = caps.get(family_base)
        w_est = sample_weight * (w_cap if w_cap is not None else 1.0)
        L = _power_iteration_lipschitz(
            mv, tmv, w_est, X.shape[1], beta.dtype, beta.device
        ) + l2
        if w_cap is None:
            L *= 4.0  # slack for the mu-dependent weight near the optimum
        step = 0.95 / max(L, 1e-30)
        for it in range(max_iter):
            new_beta = fista_epoch(
                X, y, sample_weight, beta, step,
                family=family, n_steps=50, l1=l1, l2=l2,
                penalty_scale=penalty_scale, offset=offset,
            )
            delta = float(torch.max(torch.abs(new_beta - beta)))
            beta = new_beta
            if delta < tol:
                return beta, it + 1
        return beta, max_iter

    for it in range(max_iter):
        new_beta = irls_step(
            X, y, sample_weight, beta, family=family, n_cg=n_cg, l2=l2,
            inner_precision=inner_precision, penalty_scale=penalty_scale,
            offset=offset,
        )
        delta = float(torch.max(torch.abs(new_beta - beta)))
        beta = new_beta
        if delta < tol:
            return beta, it + 1
    return beta, max_iter


def _not_ported_input(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tabmat_torch yet: the constructors and the "
        "formula engine are ROADMAP A5"
    )


class GeneralizedLinearRegressor:
    """Minimal sklearn-style GLM estimator over tabmat_torch matrices.

    Accepts numpy arrays, tensors, a DenseMatrix, or a StandardizedMatrix
    (with ``fit_intercept=False``; prepending the intercept column to it
    needs SplitMatrix, ROADMAP A3).  DataFrames and formulas are ROADMAP A5.

    Parameters
    ----------
    family: 'gaussian' | 'poisson' | 'logistic' | 'gamma' | ...
    l2: ridge penalty strength
    fit_intercept: prepend a constant column
    max_iter / tol / n_cg: IRLS and inner-CG controls
    """

    def __init__(
        self,
        family: str = "gaussian",
        l2: float = 0.0,
        l1: float = 0.0,
        fit_intercept: bool = True,
        max_iter: int = 50,
        tol: float = 1e-10,
        n_cg: int = 20,
        inner_precision: str = "float32",
        formula: str = None,
    ):
        family = _FAMILY_ALIASES.get(family, family)
        if family not in FAMILIES and not family.startswith("tweedie"):
            raise ValueError(f"Unknown family {family!r}; options: {FAMILIES}")
        if family.startswith("tweedie"):
            _parse_family(family)  # validates the power
        self.family = family
        self.l2 = l2
        self.l1 = l1
        self.fit_intercept = fit_intercept
        self.max_iter = max_iter
        self.tol = tol
        self.n_cg = n_cg
        self.inner_precision = inner_precision
        self.formula = formula

    @staticmethod
    def _supported(X) -> bool:
        from .models.base import MatrixBase
        from .models.standardized import StandardizedMatrix

        return isinstance(X, (MatrixBase, StandardizedMatrix, np.ndarray, torch.Tensor))

    def _design(self, X):
        from .models.split import hstack
        from .utils.validation import as_numpy_dtype

        if not self._supported(X):
            raise _not_ported_input(f"fitting on a {type(X).__name__}")
        if self.fit_intercept:
            ones = np.ones((X.shape[0], 1), dtype=as_numpy_dtype(X.dtype))
            X = hstack([ones, X])
        return X

    def _penalty_scale(self, k_total, has_intercept):
        """Exclude the intercept column from l1/l2 penalties (glum/sklearn
        convention)."""
        if not (has_intercept and (self.l1 > 0 or self.l2 > 0)):
            return None
        ps = np.ones(k_total)
        ps[0] = 0.0
        return ps

    def fit(self, X, y=None, sample_weight=None):
        """Fit by IRLS; stores ``coef_``, ``intercept_``, ``n_iter_``."""
        if self.formula is not None:
            raise _not_ported_input("formula=")
        design = self._design(X)
        beta, n_iter = fit_glm(
            design,
            y,
            sample_weight=sample_weight,
            family=self.family,
            max_iter=self.max_iter,
            tol=self.tol,
            n_cg=self.n_cg,
            l2=self.l2,
            l1=self.l1,
            inner_precision=self.inner_precision,
            penalty_scale=self._penalty_scale(design.shape[1], self.fit_intercept),
        )
        beta = beta.cpu().numpy()
        if self.fit_intercept:
            self.intercept_ = float(beta[0])
            self.coef_ = beta[1:]
        else:
            self.intercept_ = 0.0
            self.coef_ = beta
        self.n_iter_ = n_iter
        return self

    def linear_predictor(self, X):
        """``X @ coef_ + intercept_`` as host numpy (same X types as fit)."""
        if not self._supported(X):
            raise _not_ported_input(f"predicting on a {type(X).__name__}")
        if isinstance(X, np.ndarray):
            eta = X @ self.coef_
        elif torch.is_tensor(X):
            coef = torch.as_tensor(self.coef_, device=X.device, dtype=X.dtype)
            eta = (X @ coef).cpu().numpy()
        else:
            eta = np.asarray(X.matvec(self.coef_))
        return eta + self.intercept_

    def predict(self, X):
        """Mean prediction on the response scale."""
        eta = self.linear_predictor(X)
        if self.family in ("poisson", "gamma") or self.family.startswith("tweedie"):
            return np.exp(eta)
        if self.family == "logistic":
            return 1 / (1 + np.exp(-eta))
        return eta
