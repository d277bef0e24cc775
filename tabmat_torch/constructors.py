"""Dataframe / sparse-matrix ingestion: ``from_df``, ``from_pandas``, ``from_csc``.

Port of ``tabmat_tpu/constructors.py``.  Ingestion is host-side column
routing: categorical dtypes become CategoricalMatrix (or one-hot split parts
when below ``cat_threshold``), numeric/boolean columns are routed dense vs
sparse by observed density, and everything is assembled into a SplitMatrix.
Every block goes to ``device``: None means the CUDA card, and raises
without one; ``device="cpu"`` asks for the CPU.  A categorical column that
is only exploded into one-hot parts never moves its codes to the device.
"""

import warnings
from typing import Union

import numpy as np
from scipy import sparse as sps

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

from ._config import resolve_device
from ._frames import nw
from .models.base import MatrixBase
from .models.categorical import CategoricalMatrix
from .models.dense import DenseMatrix
from .models.sparse import SparseMatrix
from .models.split import SplitMatrix


def _split_sparse_and_dense_parts(
    arg1: sps.csc_matrix,
    threshold: float = 0.1,
    column_names=None,
    term_names=None,
    device=None,
) -> tuple[DenseMatrix, SparseMatrix, np.ndarray, np.ndarray]:
    """Split a CSC matrix into dense and sparse column groups by density."""
    if not isinstance(arg1, sps.csc_matrix):
        raise TypeError(
            "X must be of type scipy.sparse.csc_matrix or matrix.SparseMatrix,"
            f"not {type(arg1)}"
        )
    if not 0 <= threshold <= 1:
        raise ValueError("Threshold must be between 0 and 1.")
    densities = np.diff(arg1.indptr) / arg1.shape[0]
    dense_indices = np.where(densities > threshold)[0]
    sparse_indices = np.setdiff1d(np.arange(densities.shape[0]), dense_indices)

    if column_names is None:
        column_names = [None] * arg1.shape[1]
    if term_names is None:
        term_names = column_names

    X_dense = DenseMatrix(
        arg1[:, dense_indices].toarray(),
        column_names=[column_names[i] for i in dense_indices],
        term_names=[term_names[i] for i in dense_indices],
        device=device,
    )
    X_sparse = SparseMatrix(
        arg1[:, sparse_indices],
        column_names=[column_names[i] for i in sparse_indices],
        term_names=[term_names[i] for i in sparse_indices],
        device=device,
    )
    return X_dense, X_sparse, dense_indices, sparse_indices


class _CatSlot:
    """The span of output columns owned by one categorical dataframe column.

    When a low-cardinality categorical is exploded into dense + sparse parts,
    both parts index into the *same* slot via their ``local`` offsets; the
    slot's ``base`` is therefore assigned once per original column.  With
    ``cat_position='end'`` bases stay unresolved during the scan and are
    handed out after all numeric columns have claimed theirs.
    """

    __slots__ = ("width", "base")

    def __init__(self, width: int):
        self.width = width
        self.base = None


def _is_stringy(col) -> bool:
    if isinstance(col.dtype, (nw.String, nw.Object)):
        return True
    if pd is not None and isinstance(
        getattr(nw.to_native(col), "dtype", None), pd.StringDtype
    ):
        return True
    return False


def _encode_categorical_column(col, name, dtype, device, **cat_kwargs):
    """One dataframe column -> list of (matrix, local_offsets) pieces.

    High-cardinality columns become a single CategoricalMatrix piece; below
    ``cat_threshold`` levels the one-hot expansion is rerouted through the
    density splitter so near-constant indicator columns land in the sparse
    part (reference behavior, ``tabmat/constructor.py:125-147``).  The
    exploded CategoricalMatrix is read on the host only (``tocsr``), so its
    codes never go to the device.
    """
    cat_threshold = cat_kwargs.pop("cat_threshold")
    sparse_threshold = cat_kwargs.pop("sparse_threshold")
    cat = CategoricalMatrix(
        col, dtype=dtype, column_name=name, term_name=name, device=device, **cat_kwargs
    )
    if len(cat.categories) >= cat_threshold:
        return [(cat, np.arange(cat.shape[1], dtype=np.int64))]
    dense_part, sparse_part, dense_local, sparse_local = (
        _split_sparse_and_dense_parts(
            sps.csc_matrix(cat.tocsr(), dtype=dtype),
            threshold=sparse_threshold,
            column_names=cat.get_names("column"),
            term_names=cat.get_names("term"),
            device=device,
        )
    )
    return [(dense_part, dense_local), (sparse_part, sparse_local)]


def from_df(
    df,
    dtype=np.float64,
    sparse_threshold: float = 0.1,
    cat_threshold: int = 4,
    object_as_cat: bool = False,
    cat_position: str = "expand",
    drop_first: bool = False,
    categorical_format: str = "{name}[{category}]",
    cat_missing_method: str = "fail",
    cat_missing_name: str = "(MISSING)",
    device=None,
) -> MatrixBase:
    """Convert a dataframe (pandas, or anything narwhals supports) to a SplitMatrix.

    Column routing (same decisions as reference ``tabmat/constructor.py:29-212``):
    categorical dtype → CategoricalMatrix (one-hot split parts when the column
    has fewer than ``cat_threshold`` levels); numeric/boolean → dense if
    density > ``sparse_threshold`` else sparse; other dtypes are warned about
    and skipped.  ``cat_position`` 'expand' keeps original column order, 'end'
    moves all categorical spans past the numeric columns.  Every block goes
    to ``device`` (None: the CUDA card).

    Examples
    --------
    >>> import numpy as np, pandas as pd, tabmat_torch as tt
    >>> df = pd.DataFrame({
    ...     "x": [1.0, 2.0, 3.0, 4.0],
    ...     "c": pd.Categorical(["a", "b", "a", "b"]),
    ... })
    >>> X = tt.from_df(df, device="cpu")
    >>> type(X).__name__, X.shape
    ('SplitMatrix', (4, 3))
    >>> X.column_names
    ['x', 'c[a]', 'c[b]']
    >>> X.toarray()
    array([[1., 1., 0.],
           [2., 0., 1.],
           [3., 1., 0.],
           [4., 0., 1.]])
    """
    device = resolve_device(device)
    df = nw.from_native(df, eager_only=True)

    cat_pieces: list = []  # (matrix, slot, local_offsets) in scan order
    dense_route: list[tuple[int, int]] = []  # (df position, output column)
    sparse_route: list[tuple[int, int]] = []
    skipped: list[str] = []
    cursor = 0  # next unclaimed output column (numeric-only when 'end')

    for df_pos, name in enumerate(df.columns):
        col = df[:, df_pos]
        if object_as_cat and _is_stringy(col):
            col = col.cast(nw.Categorical)

        # narwhals reports pandas SparseDtype as plain numeric-ish; catch it
        # before the dtype switch so the data never densifies (non-pandas
        # natives — pyarrow ChunkedArray etc. — carry no .dtype at all)
        native_dtype = getattr(nw.to_native(col), "dtype", None)
        if pd is not None and isinstance(native_dtype, pd.SparseDtype):
            sparse_route.append((df_pos, cursor))
            cursor += 1
            continue

        if isinstance(col.dtype, (nw.Categorical, nw.Enum)):
            pieces = _encode_categorical_column(
                col,
                name,
                dtype,
                device,
                cat_threshold=cat_threshold,
                sparse_threshold=sparse_threshold,
                drop_first=drop_first,
                column_name_format=categorical_format,
                cat_missing_method=cat_missing_method,
                cat_missing_name=cat_missing_name,
            )
            slot = _CatSlot(sum(len(loc) for _, loc in pieces))
            if cat_position == "expand":
                slot.base = cursor
                cursor += slot.width
            cat_pieces.extend((mat, slot, loc) for mat, loc in pieces)
        elif isinstance(col.dtype, nw.Boolean) or col.dtype.is_numeric():
            zero = False if isinstance(col.dtype, nw.Boolean) else 0
            route = dense_route if (col != zero).mean() > sparse_threshold else sparse_route
            route.append((df_pos, cursor))
            cursor += 1
        else:
            skipped.append(name)

    if skipped:
        warnings.warn(
            f"Columns {skipped} were ignored. Make sure they have a valid dtype."
        )
    for _, slot, _ in cat_pieces:  # 'end': hand out deferred bases in scan order
        if slot.base is None:
            slot.base = cursor
            cursor += slot.width

    matrices: list[Union[DenseMatrix, SparseMatrix, CategoricalMatrix]] = []
    out_cols: list[np.ndarray] = []
    for mat, slot, local in cat_pieces:
        matrices.append(mat)
        out_cols.append(slot.base + np.asarray(local, dtype=np.int64))

    if dense_route:
        df_sel = [p for p, _ in dense_route]
        names_sel = [df.columns[p] for p in df_sel]
        matrices.append(
            DenseMatrix(
                df[:, df_sel].to_numpy().astype(dtype, copy=False),
                column_names=names_sel,
                term_names=names_sel,
                device=device,
            )
        )
        out_cols.append(np.asarray([c for _, c in dense_route], dtype=np.int64))
    if sparse_route:
        df_sel = [p for p, _ in sparse_route]
        names_sel = [df.columns[p] for p in df_sel]
        native = nw.to_native(df)
        if pd is not None and isinstance(native, pd.DataFrame):
            raw = native.iloc[:, df_sel]  # keeps pandas SparseDtype columns sparse
        else:
            raw = df[:, df_sel].to_numpy()
        matrices.append(
            SparseMatrix(
                sps.coo_matrix(raw, dtype=dtype),
                dtype=dtype,
                column_names=names_sel,
                term_names=names_sel,
                device=device,
            )
        )
        out_cols.append(np.asarray([c for _, c in sparse_route], dtype=np.int64))

    if len(matrices) > 1:
        return SplitMatrix(matrices, out_cols)
    elif len(matrices) == 0:
        raise ValueError("DataFrame contained no valid column")
    else:
        return matrices[0]


def from_pandas(
    df,
    dtype=np.float64,
    sparse_threshold: float = 0.1,
    cat_threshold: int = 4,
    object_as_cat: bool = False,
    cat_position: str = "expand",
    drop_first: bool = False,
    categorical_format: str = "{name}[{category}]",
    cat_missing_method: str = "fail",
    cat_missing_name: str = "(MISSING)",
    device=None,
) -> MatrixBase:
    """Deprecated alias of :func:`from_df` for pandas inputs."""
    return from_df(
        df,
        dtype=dtype,
        sparse_threshold=sparse_threshold,
        cat_threshold=cat_threshold,
        object_as_cat=object_as_cat,
        cat_position=cat_position,
        drop_first=drop_first,
        categorical_format=categorical_format,
        cat_missing_method=cat_missing_method,
        cat_missing_name=cat_missing_name,
        device=device,
    )


def from_csc(mat: sps.csc_matrix, threshold=0.1, column_names=None, term_names=None,
             device=None):
    """Convert a CSC matrix to a SplitMatrix with density-based routing;
    both blocks go to ``device`` (None: the CUDA card)."""
    dense, sparse, dense_idx, sparse_idx = _split_sparse_and_dense_parts(
        mat, threshold, column_names=column_names, term_names=term_names,
        device=resolve_device(device),
    )
    return SplitMatrix([dense, sparse], [dense_idx, sparse_idx])
