"""The reference of a standardized sparse design, in plain PyTorch and NumPy.

The design is ``Z = X diag(mult) + 1 shiftᵀ``: each column of the sparse X
scaled and shifted.  Everything comes from the generator's CSC arrays and
the row weights, never from a layout or a parameter the program built, in
float64 on the CUDA card when one is present, else on the CPU
(``reference/sparse.py``'s triplets):

- the weighted column means ``μ = Σ w x / Σ w`` and, by a second pass, the
  variances ``Σ w (x − μ)² / Σ w``, each over X's row blocks densified.
  With weights that sum to one, as glum's do, these are tabmat's ``E[x]``
  and ``E[x²] − E[x]²``;
  ``mult = 1 / std``, or 1 where the std is below 1e-7 (tabmat's rule), and
  ``shift = −μ · mult``; without centring the shift is 0, without scaling
  the multiplier 1;
- ``matvec`` and ``tmv``: ``index_add_`` over the triplets, with ``mult``
  on the columns, plus the shift's terms ``shift · v`` and ``shift Σ r``;
- ``hessian(d)``: row blocks of Z itself, each densified, scaled and
  shifted, and its ``B.T @ (B * d)`` added into one (k, k) matrix, with
  TF32 off.  No rank-1 correction is formed.
"""

import torch

from glmbench.reference.sparse import BLOCK_ROWS, SparseDesign

# a std below this is a constant column: multiplier 1 (tabmat's
# one_over_var_inf_to_val)
ZERO_STD = 1e-7


class StandardizedDesign(SparseDesign):
    def __init__(self, indptr, indices, data, shape, weights, center_predictors: bool,
                 scale_predictors: bool, device=None):
        super().__init__(indptr, indices, data, shape, device)
        k = self.shape[1]
        w = self._vector(weights)
        total = w.sum()
        self.mean = sum(B.T @ w[lo:hi] for lo, hi, B in self._blocks()) / total
        squares = sum(((B - self.mean) ** 2).T @ w[lo:hi] for lo, hi, B in self._blocks())
        self.std = (squares / total).sqrt()
        self.mult = torch.ones(k, dtype=torch.float64, device=self.device)
        if scale_predictors:
            self.mult = torch.where(self.std < ZERO_STD, self.mult, 1.0 / self.std)
        self.shift = torch.zeros_like(self.mult)
        if center_predictors:
            self.shift = -self.mean * self.mult

    def _blocks(self):
        """(first row, end row, the rows of X densified) of each row block."""
        n, k = self.shape
        for lo in range(0, n, BLOCK_ROWS):
            hi = min(lo + BLOCK_ROWS, n)
            a, b = int(self.row_start[lo]), int(self.row_start[hi])
            B = torch.zeros((hi - lo, k), dtype=torch.float64, device=self.device)
            B.index_put_((self.rows[a:b] - lo, self.cols[a:b]), self.vals[a:b],
                         accumulate=True)
            yield lo, hi, B

    def matvec(self, v):
        v = self._vector(v)
        out = torch.zeros(self.shape[0], dtype=torch.float64, device=self.device)
        out.index_add_(0, self.rows, self.vals * (self.mult * v)[self.cols])
        return (out + self.shift @ v).cpu().numpy()

    def tmv(self, r):
        r = self._vector(r)
        out = torch.zeros(self.shape[1], dtype=torch.float64, device=self.device)
        out.index_add_(0, self.cols, self.vals * r[self.rows])
        return (out * self.mult + self.shift * r.sum()).cpu().numpy()

    def hessian(self, d):
        d = self._vector(d)
        k = self.shape[1]
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            H = torch.zeros((k, k), dtype=torch.float64, device=self.device)
            for lo, hi, B in self._blocks():
                B.mul_(self.mult).add_(self.shift)
                H.addmm_(B.T, B * d[lo:hi, None])
            return H.cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
