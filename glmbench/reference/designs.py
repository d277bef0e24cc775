"""The reference's designs: each encodes its inputs again with NumPy and
gives ``matvec``, ``tmv`` and ``hessian`` in float64.

They take only the inputs the benchmark made (frames, arrays of values and
codes), never anything the program built.
"""

import numpy as np


class FormulaDesign:
    """The freMTPL2 formula's design, dense: the intercept, VehPower,
    VehAge, DrivAge and BonusMalus, one column for each level but the first
    declared one of Area, VehBrand, VehGas and Region (in ``levels``' order),
    and np.log(Density) last; the column order of ``from_formula``."""

    def __init__(self, frame, levels: dict):
        cols = [np.ones(len(frame))]
        cols += [frame[name].to_numpy(np.float64)
                 for name in ("VehPower", "VehAge", "DrivAge", "BonusMalus")]
        for name, names in levels.items():
            codes = frame[name].cat.codes.to_numpy()
            cat_names = list(frame[name].cat.categories)
            if cat_names != list(names):
                raise ValueError(f"{name}'s levels {cat_names} are not the declared {names}")
            cols += [(codes == j).astype(np.float64) for j in range(1, len(names))]
        cols.append(np.log(frame["Density"].to_numpy(np.float64)))
        self.X = np.column_stack(cols)
        self.shape = self.X.shape

    def matvec(self, v):
        return self.X @ v

    def tmv(self, r):
        return self.X.T @ r

    def hessian(self, w):
        return (self.X * w[:, None]).T @ self.X


class DenseCatDesign:
    """Dense columns followed by one-hot blocks of categorical codes, each
    block with all its levels (tabmat's ``dense_cat`` layout).  Every
    categorical sum is a ``bincount``, so nothing of size rows × levels is
    ever formed."""

    def __init__(self, dense: np.ndarray, codes: list, levels: list):
        self.dense = np.asarray(dense, dtype=np.float64)
        self.codes = [np.asarray(c, dtype=np.int64) for c in codes]
        self.levels = list(levels)
        self.kd = self.dense.shape[1]
        self.offsets = np.cumsum([self.kd] + self.levels)
        self.shape = (self.dense.shape[0], int(self.offsets[-1]))

    def _cat_slices(self):
        return [slice(int(lo), int(hi)) for lo, hi in zip(self.offsets[:-1], self.offsets[1:])]

    def matvec(self, v):
        out = self.dense @ v[: self.kd]
        for c, s in zip(self.codes, self._cat_slices()):
            out = out + v[s][c]
        return out

    def tmv(self, r):
        parts = [self.dense.T @ r]
        parts += [np.bincount(c, weights=r, minlength=m) for c, m in zip(self.codes, self.levels)]
        return np.concatenate(parts)

    def hessian(self, w):
        k, kd = self.shape[1], self.kd
        H = np.zeros((k, k))
        H[:kd, :kd] = (self.dense * w[:, None]).T @ self.dense
        slices = self._cat_slices()
        for i, (c, m, s) in enumerate(zip(self.codes, self.levels, slices)):
            cross = np.stack([np.bincount(c, weights=w * self.dense[:, j], minlength=m)
                              for j in range(kd)], axis=1)
            H[s, :kd] = cross
            H[:kd, s] = cross.T
            H[s, s] = np.diag(np.bincount(c, weights=w, minlength=m))
            for c2, m2, s2 in zip(self.codes[i + 1:], self.levels[i + 1:], slices[i + 1:]):
                block = np.bincount(c * m2 + c2, weights=w, minlength=m * m2).reshape(m, m2)
                H[s, s2] = block
                H[s2, s] = block.T
        return H


def relerr(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
