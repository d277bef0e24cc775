"""How the dataframe layer reads a frame: narwhals, or pandas alone.

The constructors and the formula engine read frames through narwhals'
``stable.v2`` API, as the JAX package does, so that pandas, pyarrow and
polars frames all work.  Where narwhals is not installed, :data:`nw` is
:class:`PandasFrames` instead: the part of that API which the dataframe
layer calls, over pandas frames and series alone.  The layer treats
narwhals' ``Enum`` as ``Categorical``, ``Object`` as ``String`` and
``Boolean`` as a number, so this reader gives a pandas categorical the
kind ``Categorical``, a string or object column ``String``, a boolean or
numeric one a numeric kind, and a sparse column no kind the layer routes
(narwhals' ``Unknown``).
"""

import numpy as np

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None


class _DType:
    def is_numeric(self) -> bool:
        return False


class _Numeric(_DType):
    def is_numeric(self) -> bool:
        return True


def _dtype_of(native) -> _DType:
    """The dtype kind of a pandas series, as the layer reads narwhals'."""
    dt = native.dtype
    if isinstance(dt, pd.CategoricalDtype):
        return PandasFrames.Categorical()
    if isinstance(dt, pd.SparseDtype):
        return _DType()
    if isinstance(dt, pd.StringDtype) or dt == object:
        return PandasFrames.String()
    if getattr(dt, "kind", "") in ("b", "i", "u", "f"):
        return _Numeric()
    return _DType()


class _Series:
    """A pandas series seen through narwhals' Series API."""

    def __init__(self, native):
        self._native = native

    @property
    def dtype(self) -> _DType:
        return _dtype_of(self._native)

    def cast(self, dtype):
        """To ``Categorical``, the one cast the layer makes of a pandas series
        (``from_df``'s ``object_as_cat``)."""
        if dtype is not PandasFrames.Categorical:
            raise NotImplementedError(f"cast to {dtype.__name__}")
        return _Series(self._native.astype("category"))

    def to_numpy(self) -> np.ndarray:
        """As narwhals gives it: a nullable numeric column with missing
        values becomes float64 with NaN."""
        s = self._native
        dt = s.dtype
        masked = isinstance(dt, pd.api.extensions.ExtensionDtype) and not isinstance(
            dt, pd.SparseDtype)
        if masked and dt.kind in ("i", "u", "f", "b") and s.hasnans:
            return s.to_numpy(dtype=np.float64, na_value=np.nan)
        return s.to_numpy()

    def to_pandas(self):
        return self._native

    def __ne__(self, other):
        return _Series(self._native != other)

    def mean(self):
        return self._native.mean()


class _DataFrame:
    """A pandas frame seen through narwhals' eager DataFrame API."""

    def __init__(self, native):
        self._native = native

    @property
    def columns(self) -> list:
        return list(self._native.columns)

    @property
    def shape(self) -> tuple:
        return self._native.shape

    def __getitem__(self, key):
        if isinstance(key, str):
            return _Series(self._native[key])
        _, cols = key
        if isinstance(cols, (int, np.integer)):
            return _Series(self._native.iloc[:, int(cols)])
        return _DataFrame(self._native.iloc[:, list(cols)])

    def to_numpy(self) -> np.ndarray:
        return np.column_stack([self[:, j].to_numpy() for j in range(self.shape[1])])


class PandasFrames:
    """The ``narwhals.stable.v2`` calls of the dataframe layer, on pandas.
    ``Enum``, ``Object`` and ``Boolean`` exist for the layer's type tests;
    this reader never gives them."""

    Series = _Series

    class Categorical(_DType):
        pass

    class Enum(_DType):
        pass

    class String(_DType):
        pass

    class Object(_DType):
        pass

    class Boolean(_DType):
        pass

    @staticmethod
    def from_native(obj, eager_only=False, series_only=False, pass_through=False):
        if isinstance(obj, (_Series, _DataFrame)):
            return obj
        if pd is not None and isinstance(obj, pd.Series) and not eager_only:
            return _Series(obj)
        if pd is not None and isinstance(obj, pd.DataFrame) and not series_only:
            return _DataFrame(obj)
        if pass_through:
            return obj
        raise TypeError(
            f"without narwhals, tabmat_torch reads pandas frames only, not {type(obj).__name__}"
        )

    @staticmethod
    def to_native(obj, pass_through=False):
        if isinstance(obj, (_Series, _DataFrame)):
            return obj._native
        if pass_through:
            return obj
        raise TypeError(f"{type(obj).__name__} is not a frame or a series")


try:
    import narwhals.stable.v2 as nw
except ImportError:  # pragma: no cover  (an installation with pandas and no narwhals)
    nw = PandasFrames
