"""The reference of glum's design with an intercept beside a standardized
sparse design, and its IRLS, in plain PyTorch and NumPy.

The design is ``[1 | Z]``: ``Z = X diag(mult) + 1 shiftᵀ`` is
``reference/standardized.py``'s ``StandardizedDesign``, which computes its
means and stds itself from the generator's CSC arrays and the row weights;
the intercept's column of ones stays outside the standardization, as glum
keeps it.  In float64, with TF32 off, on the CUDA card when one is present,
else on the CPU:

- ``matvec(β) = β₀ + Z β₁:``;
- ``tmv(r) = [Σ r, Zᵀ r]``;
- ``hessian(d) = [[Σ d, (Zᵀ d)ᵀ], [Zᵀ d, Zᵀ D Z]]``, ``Zᵀ D Z`` from row
  blocks of Z itself, each densified, scaled and shifted (no rank-1 term).

The ``*_t`` methods take and return tensors on the design's device; the
others NumPy arrays.  :func:`irls` is ``reference/irls.py``'s IRLS (the same
objective, start and stopping rule) with each Newton step solved on the
design's device by a Cholesky factorisation in float64: at 10,001 columns
NumPy's solve on the host would take tens of seconds a step.
"""

import numpy as np
import torch

from glmbench.reference.standardized import StandardizedDesign


class StandardizedInterceptDesign:
    def __init__(self, indptr, indices, data, shape, weights, center_predictors: bool,
                 scale_predictors: bool, device=None):
        self.z = StandardizedDesign(indptr, indices, data, shape, weights, center_predictors,
                                    scale_predictors, device)
        self.device = self.z.device
        self.shape = (self.z.shape[0], self.z.shape[1] + 1)

    def _vector(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device)

    def matvec_t(self, beta):
        z = self.z
        v = beta[1:]
        out = torch.zeros(z.shape[0], dtype=torch.float64, device=self.device)
        out.index_add_(0, z.rows, z.vals * (z.mult * v)[z.cols])
        return out + (z.shift @ v + beta[0])

    def tmv_t(self, r):
        z = self.z
        out = torch.zeros(z.shape[1], dtype=torch.float64, device=self.device)
        out.index_add_(0, z.cols, z.vals * r[z.rows])
        total = r.sum()
        return torch.cat([total.reshape(1), out * z.mult + z.shift * total])

    def hessian_t(self, d):
        z = self.z
        k = z.shape[1]
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            inner = torch.zeros((k, k), dtype=torch.float64, device=self.device)
            for lo, hi, B in z._blocks():
                B.mul_(z.mult).add_(z.shift)
                inner.addmm_(B.T, B * d[lo:hi, None])
            H = torch.empty((k + 1, k + 1), dtype=torch.float64, device=self.device)
            H[1:, 1:] = inner
            del inner
            border = self.tmv_t(d)
            H[0, :] = border
            H[1:, 0] = border[1:]
            return H
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def matvec(self, beta):
        return self.matvec_t(self._vector(beta)).cpu().numpy()

    def tmv(self, r):
        return self.tmv_t(self._vector(r)).cpu().numpy()

    def hessian(self, d):
        return self.hessian_t(self._vector(d)).cpu().numpy()


def family_terms(family: str, eta):
    """(mu, IRLS weight without the sample weight), as ``irls.family_terms``."""
    if family == "poisson":
        mu = torch.exp(eta)
        return mu, mu
    if family == "gaussian":
        return eta, torch.ones_like(eta)
    raise ValueError(f"the reference has no family {family!r}")


def irls(design, y, sample_weight, family: str = "poisson", l2: float = 0.0, ps=None,
         max_iter: int = 60, rtol: float = 1e-13):
    """β of the penalised fit as a NumPy array, and the Newton steps taken:
    ``reference/irls.py``'s ``irls`` on the design's ``*_t`` methods, each
    step solved by ``torch.linalg.cholesky`` and ``cholesky_solve``."""
    k = design.shape[1]
    y, sample_weight = design._vector(y), design._vector(sample_weight)
    ps = design._vector(np.ones(k) if ps is None else ps)
    beta = torch.zeros(k, dtype=torch.float64, device=design.device)
    sizes = []
    for it in range(max_iter):
        mu, w_irls = family_terms(family, design.matvec_t(beta))
        grad = design.tmv_t(sample_weight * (y - mu)) - l2 * ps * beta
        H = design.hessian_t(sample_weight * w_irls)
        H.diagonal().add_(l2 * ps)
        delta = torch.cholesky_solve(grad[:, None], torch.linalg.cholesky(H))[:, 0]
        del H
        beta = beta + delta
        size = float(delta.abs().max())
        sizes.append(size)
        if size <= rtol * max(1.0, float(beta.abs().max())):
            return beta.cpu().numpy(), it + 1
        if it >= 5 and sizes[-1] >= 0.5 * sizes[-2] and sizes[-2] >= 0.5 * sizes[-3]:
            return beta.cpu().numpy(), it + 1
    return beta.cpu().numpy(), max_iter
