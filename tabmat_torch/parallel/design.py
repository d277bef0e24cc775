"""DeviceDesign: a dense design as the operator the GLM layer drives.

Port of the dense-block part of ``tabmat_tpu/parallel/design.py``.  The
reference turns any MatrixBase into a jit-compatible pytree of blocks; the
port runs eagerly, and this slice carries one kind of block: a dense X,
optionally standardized (``x -> mult * x + shift`` per column).
Categorical, sparse and split designs are ROADMAP A2-A4.

``sandwich`` calls ``dense_ops.sandwich`` in both dtypes, so the explicit
IRLS Hessian runs the CUDA kernel at f64 and at f32.  The reference used the
v4 Pallas kernel at f64 and a jnp einsum at f32 (``design.py:728-765``).
``column_absmax`` runs the range prepass that scales the f32 Hessian.
"""

import torch

from ..ops import dense_ops, sandwich_kernel


class DeviceDesign:
    """A dense (optionally standardized) design on one device."""

    # widest design for which the explicit (k, k) Hessian is built
    SANDWICH_MAX_COLS = 4096

    def __init__(self, X: torch.Tensor, shift=None, mult=None):
        self.X = X
        self.shape = tuple(X.shape)
        self.shift = shift  # standardization: x -> mult*x + shift (per col)
        self.mult = mult
        self._f32 = None  # the float32 copy, built once by astype_float

    @classmethod
    def from_matrix(cls, mat) -> "DeviceDesign":
        """Convert a DenseMatrix or a StandardizedMatrix over one."""
        from ..models.dense import DenseMatrix
        from ..models.standardized import StandardizedMatrix

        if isinstance(mat, StandardizedMatrix):
            inner = cls.from_matrix(mat.mat)
            def param(x):
                return torch.as_tensor(x, device=inner.X.device, dtype=inner.X.dtype)

            mult = None if mat.mult is None else param(mat.mult)
            return cls(inner.X, param(mat.shift), mult)
        if isinstance(mat, DenseMatrix):
            return cls(mat.unpack())
        raise NotImplementedError(
            f"DeviceDesign of a {type(mat).__name__} is not ported to "
            "tabmat_torch yet: categorical, sparse and split designs are "
            "ROADMAP A2-A4"
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.X.dtype

    @property
    def device(self) -> torch.device:
        return self.X.device

    def astype_float(self, dtype) -> "DeviceDesign":
        """The design with its float tensors cast to ``dtype``.

        The float32 copy of X is built on the first call and kept, so an
        IRLS loop with a float32 inner solve casts X once per design instead
        of once per step (200 MB of traffic per step at 1M x 50).
        """
        if dtype == self.X.dtype:
            return self
        if dtype != torch.float32:
            raise ValueError(f"astype_float supports float32, got {dtype}")
        if self._f32 is None:

            def cast(x):
                return None if x is None else x.to(dtype)

            self._f32 = DeviceDesign(self.X.to(dtype), cast(self.shift), cast(self.mult))
        return self._f32

    # -- ops -----------------------------------------------------------------

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``X @ v``."""
        v_eff = v * self.mult if self.mult is not None else v
        out = dense_ops.matvec(self.X, v_eff)
        if self.shift is not None:
            out = out + torch.dot(self.shift, v)
        return out

    def transpose_matvec(self, r: torch.Tensor) -> torch.Tensor:
        """``X.T @ r``."""
        out = dense_ops.transpose_matvec(self.X, r)
        if self.mult is not None:
            out = out * self.mult
        if self.shift is not None:
            out = out + self.shift * torch.sum(r)
        return out

    @property
    def supports_sandwich(self) -> bool:
        """True when the explicit sandwich is available.

        Standardized designs take the Hessian-vector path, as in the
        reference.
        """
        return (
            self.shape[1] <= self.SANDWICH_MAX_COLS
            and self.shift is None
            and self.mult is None
        )

    def sandwich(self, w: torch.Tensor) -> torch.Tensor:
        """Explicit ``Xᵀ diag(w) X`` → (k, k), through the CUDA kernel on a GPU."""
        return dense_ops.sandwich(self.X, w)

    def column_absmax(self, w: torch.Tensor) -> torch.Tensor:
        """``max_i |X[i, j]| · |w[i]|`` → (k,) float64, for the float32 copy.

        The CUDA prepass kernel on a GPU; ``w`` is float64, so weights beyond
        the float32 range give a finite maximum.
        """
        return sandwich_kernel.column_absmax(self.X, w)

    # operator sugar so glm.irls_step treats designs and tensors alike
    def __matmul__(self, v):
        return self.matvec(v)

    @property
    def T(self):
        return _TransposedDesign(self)


class _TransposedDesign:
    def __init__(self, design: DeviceDesign):
        self._design = design

    def __matmul__(self, r):
        return self._design.transpose_matvec(r)
