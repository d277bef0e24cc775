"""The reference of a sparse design, in plain PyTorch and NumPy.

It takes the generator's CSC arrays (``indptr``, ``indices``, ``data``),
never a layout the program built, and computes in float64 on the CUDA card
when one is present (a ``sparse_wide`` Hessian is 8·10¹² operations, minutes
on the host), else on the CPU:

- ``matvec`` and ``tmv``: ``index_add_`` of the entries' products over the
  rows or the columns of the COO triplets;
- ``hessian(d)``: row blocks of at most ``BLOCK_ROWS`` rows, each densified
  and its ``B.T @ (B * d)`` added into one (k, k) matrix, with TF32 off.
"""

import numpy as np
import torch

BLOCK_ROWS = 4096


class SparseDesign:
    def __init__(self, indptr, indices, data, shape, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.shape = (int(shape[0]), int(shape[1]))
        n, k = self.shape
        indptr = np.asarray(indptr, dtype=np.int64)
        rows = np.asarray(indices, dtype=np.int64)
        cols = np.repeat(np.arange(k, dtype=np.int64), np.diff(indptr))
        vals = np.asarray(data, dtype=np.float64)
        # the triplets in row order, for the row blocks of the Hessian
        order = np.argsort(rows, kind="stable")
        self.row_start = np.searchsorted(rows[order], np.arange(n + 1))
        self.rows = torch.as_tensor(rows[order], device=self.device)
        self.cols = torch.as_tensor(cols[order], device=self.device)
        self.vals = torch.as_tensor(vals[order], device=self.device)

    def _vector(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device)

    def matvec(self, v):
        v = self._vector(v)
        out = torch.zeros(self.shape[0], dtype=torch.float64, device=self.device)
        out.index_add_(0, self.rows, self.vals * v[self.cols])
        return out.cpu().numpy()

    def tmv(self, r):
        r = self._vector(r)
        out = torch.zeros(self.shape[1], dtype=torch.float64, device=self.device)
        out.index_add_(0, self.cols, self.vals * r[self.rows])
        return out.cpu().numpy()

    def hessian(self, d):
        d = self._vector(d)
        n, k = self.shape
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            H = torch.zeros((k, k), dtype=torch.float64, device=self.device)
            for lo in range(0, n, BLOCK_ROWS):
                hi = min(lo + BLOCK_ROWS, n)
                a, b = int(self.row_start[lo]), int(self.row_start[hi])
                B = torch.zeros((hi - lo, k), dtype=torch.float64, device=self.device)
                B.index_put_((self.rows[a:b] - lo, self.cols[a:b]), self.vals[a:b],
                             accumulate=True)
                H.addmm_(B.T, B * d[lo:hi, None])
            return H.cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
