"""Formula materializer: evaluate parsed terms against a dataframe.

Port of ``tabmat_tpu/formula/engine.py``, the JAX package's own version of
the reference's formulaic-based materializer (``tabmat/formula.py:35-810``),
with the same encoding/interaction algebra:

- numeric factors → dense or sparse single columns by observed density;
- categorical factors → code vectors with sentinels (-1 missing, -2 drop);
- numeric × numeric → elementwise product;
- categorical × numeric → per-row multipliers on the categorical;
- categorical × categorical → product categories via code arithmetic
  ``right.codes * card(left) + left.codes`` (cf. ``formula.py:627-667``);
- reduced-rank encoding drops the first level by marking its rows -2;
- stateful re-materialization: the returned matrix carries a
  ``model_spec`` whose ``get_model_matrix(new_data)`` re-encodes new data
  with the remembered category levels, on the device it was built on.

Every matrix goes to ``device`` (None: the CUDA card).  The encoding itself
is host code (numpy, scipy, pandas), as in the JAX package.

Full-rank logic (``ensure_full_rank=True``) follows formulaic's
structurally-full-rank algorithm (pinned by the reference's vendored
formulaic tests, ``tests/test_formula.py:948+``): each term expands over the
powerset of its intercept-spanning categorical factors, pieces spanned by
earlier terms are dropped, and the survivors are greedily re-merged into the
minimal set of encodings (``A:B`` with an intercept becomes ``B⁻ + A⁻:B``).
"""

from dataclasses import dataclass, field
from functools import reduce
from itertools import combinations, product
from typing import Any, Optional

import numpy as np
from scipy import sparse as sps

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

from .. import _trace
from .._config import resolve_device
from .._frames import nw
from ..constructors import _split_sparse_and_dense_parts
from ..models.categorical import CategoricalMatrix, _extract_codes_and_categories
from ..models.dense import DenseMatrix
from ..models.sparse import SparseMatrix
from ..models.split import SplitMatrix
from .parser import parse_formula


# ----------------------------------------------------------------------
# factor slots (the interaction algebra operands)
# ----------------------------------------------------------------------


@dataclass
class NumericSlot:
    """A numeric column (optionally the product of several factors)."""

    values: np.ndarray  # (n,)
    name: str


@dataclass
class MultiNumericSlot:
    """A multi-column numeric factor (``poly()``, ``bs()`` bases).

    ``labels`` are the per-column suffix labels; output column names are
    ``f"{name}[{label}]"`` (the formulaic convention for basis factors).
    """

    values: np.ndarray  # (n, k)
    labels: list  # k suffixes
    name: str

    @property
    def column_names(self) -> list:
        # interaction products already carry full column names as labels
        # (re-wrapping them as name[label] would mangle 3-factor terms
        # like poly(x, 2):a:b)
        if getattr(self, "_labels_are_full_names", False):
            return list(self.labels)
        return [f"{self.name}[{lb}]" for lb in self.labels]


@dataclass
class CategoricalSlot:
    """A categorical column with sentinel codes (-1 missing, -2 drop)."""

    codes: np.ndarray  # (n,) int64
    categories: list  # formatted column labels, one per live category
    multipliers: np.ndarray  # (n,) accumulated numeric interaction factors
    name: str


@dataclass
class BundleSlot:
    """An ordered bundle of slots materializing side by side.

    Produced by basis × categorical interactions (``poly(x, 2):c``): each
    basis column interacts with the categorical independently, yielding one
    member slot per basis column (basis-major, category-fastest column
    order — matching how the categorical algebra expands everywhere else).
    """

    members: list
    name: str


def interact(left, right, separator=":"):
    """Interact two slots (order-preserving names)."""
    if isinstance(left, BundleSlot) or isinstance(right, BundleSlot):
        lm = left.members if isinstance(left, BundleSlot) else [left]
        rm = right.members if isinstance(right, BundleSlot) else [right]
        return BundleSlot(
            [interact(a, b, separator) for a in lm for b in rm],
            name=f"{left.name}{separator}{right.name}",
        )
    if isinstance(left, MultiNumericSlot) or isinstance(right, MultiNumericSlot):
        return _interact_multi(left, right, separator)
    if isinstance(left, NumericSlot) and isinstance(right, NumericSlot):
        return NumericSlot(
            left.values * right.values, f"{left.name}{separator}{right.name}"
        )
    if isinstance(left, NumericSlot) and isinstance(right, CategoricalSlot):
        return CategoricalSlot(
            codes=right.codes,
            categories=[f"{left.name}{separator}{c}" for c in right.categories],
            multipliers=right.multipliers * left.values,
            name=f"{left.name}{separator}{right.name}",
        )
    if isinstance(left, CategoricalSlot) and isinstance(right, NumericSlot):
        return CategoricalSlot(
            codes=left.codes,
            categories=[f"{c}{separator}{right.name}" for c in left.categories],
            multipliers=left.multipliers * right.values,
            name=f"{left.name}{separator}{right.name}",
        )
    # categorical × categorical: product categories by code arithmetic
    card_left = len(left.categories)
    new_codes = right.codes * card_left + left.codes
    na = (left.codes == -1) | (right.codes == -1)
    drop = (left.codes == -2) | (right.codes == -2)
    new_codes[na] = -1
    new_codes[drop] = -2
    new_categories = [
        f"{lc}{separator}{rc}" for rc, lc in product(right.categories, left.categories)
    ]
    return CategoricalSlot(
        codes=new_codes,
        categories=new_categories,
        multipliers=left.multipliers * right.multipliers,
        name=f"{left.name}{separator}{right.name}",
    )


def _interact_multi(left, right, separator):
    """Interactions involving a multi-column numeric basis factor.

    numeric × multi and multi × multi cross every column pair
    (left-fastest ordering, consistent with the categorical algebra);
    multi × categorical spreads into a BundleSlot — one per-basis-column
    categorical interaction, materialized side by side (the reference's
    formulaic backend spreads these the same way).
    """
    if isinstance(left, CategoricalSlot) or isinstance(right, CategoricalSlot):
        # basis × categorical: one member per basis column, each a
        # categorical slot carrying that column as its multiplier
        if isinstance(left, MultiNumericSlot):
            multi, other, multi_left = left, right, True
        else:
            multi, other, multi_left = right, left, False
        names = multi.column_names
        members = []
        for i in range(multi.values.shape[1]):
            col = NumericSlot(values=multi.values[:, i], name=names[i])
            pair = (col, other) if multi_left else (other, col)
            members.append(interact(pair[0], pair[1], separator))
        return BundleSlot(
            members, name=f"{left.name}{separator}{right.name}"
        )
    lv = left.values if left.values.ndim == 2 else left.values[:, None]
    rv = right.values if right.values.ndim == 2 else right.values[:, None]
    llabels = (
        left.column_names if isinstance(left, MultiNumericSlot) else [left.name]
    )
    rlabels = (
        right.column_names if isinstance(right, MultiNumericSlot) else [right.name]
    )
    cols = []
    labels = []
    for j in range(rv.shape[1]):
        for i in range(lv.shape[1]):
            cols.append(lv[:, i] * rv[:, j])
            labels.append(f"{llabels[i]}{separator}{rlabels[j]}")
    out = MultiNumericSlot(
        values=np.column_stack(cols),
        labels=labels,
        name=f"{left.name}{separator}{right.name}",
    )
    # labels are already full column names; mark so conversion skips wrapping
    out._labels_are_full_names = True
    return out


# ----------------------------------------------------------------------
# factor evaluation
# ----------------------------------------------------------------------


@dataclass
class FactorState:
    """Remembered encoding state for out-of-sample re-materialization."""

    kind: str  # 'numeric' | 'categorical' | 'poly' | 'bs'
    categories: Optional[list] = None  # raw levels (categorical only)
    spans_intercept: bool = True
    # categorical: training data had missings converted to a named category
    add_missing_category: bool = False
    missing_method: Optional[str] = None  # per-factor override via C()
    missing_name: Optional[str] = None
    # poly (orthogonal): three-term recurrence coefficients from training
    poly_alpha: Optional[np.ndarray] = None
    poly_norm2: Optional[np.ndarray] = None
    # bs: full knot vector (with boundary repeats) + degree from training
    bs_knots: Optional[np.ndarray] = None
    bs_degree: Optional[int] = None
    # center/scale: training location and spread
    loc: Optional[float] = None
    spread: Optional[float] = None
    # categorical: contrast coding requested via C(x, contr.*)
    contrasts: Optional[object] = None


def _split_call(expr: str, fname: str):
    """Split ``fname(arg0, arg1, key=val, ...)`` into (arg0_src, args, kwargs).

    Arguments are source strings split at top-level commas; the caller
    evaluates them as needed.
    """
    inner = expr[len(fname) + 1 : -1]
    depth = 0
    parts = []
    start = 0
    for i, ch in enumerate(inner):
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(inner[start:i])
            start = i + 1
    parts.append(inner[start:])
    data_expr = parts[0].strip()
    args = []
    kwargs = {}
    for p in parts[1:]:
        eq = p.find("=")
        # a top-level '=' not part of '==' marks a keyword argument
        if eq > 0 and (eq + 1 >= len(p) or p[eq + 1] != "=") and p[eq - 1] not in "<>!":
            kwargs[p[:eq].strip()] = p[eq + 1 :].strip()
        else:
            args.append(p.strip())
    return data_expr, args, kwargs


def _parse_C_call(expr: str):
    """Split a ``C(...)`` factor into (inner_expression, args_src, kwargs_src).

    One positional argument beyond the data is allowed — the contrasts
    spec (formulaic's calling convention: ``C(x, contr.sum())``).
    """
    data_expr, args, kwargs = _split_call(expr, "C")
    if len(args) > 1:
        raise ValueError(f"Unsupported positional argument in C(): {args[1]!r}")
    return data_expr, args, kwargs


# ----------------------------------------------------------------------
# basis transforms: poly() and bs()
# ----------------------------------------------------------------------


def _poly_orthogonal(x: np.ndarray, degree: int, state: Optional[FactorState]):
    """R-style orthogonal polynomial basis via the three-term recurrence.

    Training computes the recurrence coefficients (``alpha``, ``norm2``)
    with a QR factorization of the Vandermonde matrix (what R's ``poly``
    and formulaic's ``poly`` do); prediction re-evaluates the recurrence
    with the remembered coefficients so out-of-sample columns line up.
    """
    x = np.asarray(x, dtype=np.float64)
    if state is not None and state.poly_alpha is not None:
        alpha, norm2 = state.poly_alpha, state.poly_norm2
    else:
        if degree >= len(np.unique(x)):
            raise ValueError(
                "'degree' must be less than the number of unique points."
            )
        V = np.vander(x, degree + 1, increasing=True)
        Q, R = np.linalg.qr(V)
        # raw (unnormalized) orthogonal columns and their squared norms
        Z = Q * np.diag(R)
        norm2 = np.concatenate([[1.0], (Z * Z).sum(axis=0)])
        alpha = (x[:, None] * Z * Z).sum(axis=0)[:degree] / norm2[1 : degree + 1]
    # evaluate p_0..p_degree with the recurrence, then normalize
    n = len(x)
    Z = np.empty((n, degree + 1))
    Z[:, 0] = 1.0
    if degree >= 1:
        Z[:, 1] = x - alpha[0]
    for k in range(1, degree):
        Z[:, k + 1] = (x - alpha[k]) * Z[:, k] - (
            norm2[k + 1] / norm2[k]
        ) * Z[:, k - 1]
    Z = Z / np.sqrt(norm2[1:])
    return Z[:, 1:], alpha, norm2


def _eval_poly(x, args, kwargs, state: Optional[FactorState]):
    """poly(x, degree, raw=False) → (values (n, degree), alpha, norm2)."""
    degree = int(args[0]) if args else int(kwargs.get("degree", 1))
    raw = kwargs.get("raw", "False") in ("True", "true", "1")
    x = np.asarray(x, dtype=np.float64)
    if raw:
        vals = np.column_stack([x**p for p in range(1, degree + 1)])
        return vals, None, None
    return _poly_orthogonal(x, degree, state)


def _eval_bs(x, args, kwargs, state: Optional[FactorState]):
    """bs(x, df, degree=3) → B-spline basis (n, df) via Cox–de Boor.

    Training places ``df - degree`` internal knots at quantiles of ``x``
    (formulaic/patsy convention, no intercept column); prediction reuses
    the remembered knot vector.
    """
    from scipy.interpolate import BSpline

    x = np.asarray(x, dtype=np.float64)
    if state is not None and state.bs_knots is not None:
        knots, degree = state.bs_knots, state.bs_degree
    else:
        degree = int(kwargs.get("degree", 3))
        df = int(args[0]) if args else int(kwargs.get("df", degree))
        if df < degree:
            raise ValueError(f"bs() requires df >= degree, got df={df}.")
        n_internal = df - degree
        if n_internal > 0:
            qs = np.linspace(0, 1, n_internal + 2)[1:-1]
            internal = np.quantile(x, qs)
        else:
            internal = np.array([])
        lo, hi = float(np.min(x)), float(np.max(x))
        knots = np.concatenate(
            [[lo] * (degree + 1), internal, [hi] * (degree + 1)]
        )
    n_basis = len(knots) - degree - 1
    # out-of-sample values must fail loudly at re-materialization (the
    # formulaic/patsy contract) — silent boundary clamping would
    # constant-extrapolate predictions
    if state is not None and state.bs_knots is not None:
        oob = (x < knots[0]) | (x > knots[-1])
        if np.any(oob):
            raise ValueError(
                f"bs(): {int(oob.sum())} value(s) outside the training "
                f"range [{knots[0]:g}, {knots[-1]:g}]."
            )
    design = BSpline.design_matrix(
        np.clip(x, knots[0], knots[-1]), knots, degree, extrapolate=False
    ).toarray()
    # drop the first (intercept-spanning) column: bs() returns df columns
    return design[:, 1:n_basis], knots, degree


class _Evaluator:
    """Evaluate factor expressions against a dataframe + context."""

    def __init__(self, df, context, state: dict, use_state: bool):
        self.df = df  # narwhals frame
        self.context = dict(context or {})
        self.state = state  # factor expr -> FactorState
        self.use_state = use_state

    def _column(self, name: str):
        if name in self.df.columns:
            return self.df[name]
        return None

    def _eval_python(self, expr: str):
        ns = dict(self.context)
        ns.setdefault("np", np)
        ns.setdefault("I", lambda v: v)  # patsy-style identity transform
        ns.setdefault("log", np.log)
        ns.setdefault("exp", np.exp)
        ns.setdefault("sqrt", np.sqrt)
        # expose dataframe columns as names
        for col in self.df.columns:
            if col.isidentifier():
                ns[col] = self._to_numpy_or_series(self.df[col])
        return eval(expr, {"__builtins__": {}}, ns)  # noqa: S307

    @staticmethod
    def _to_numpy_or_series(col):
        native = nw.to_native(col)
        if pd is None or isinstance(native, pd.Series):
            return native
        # non-pandas natives (pyarrow ChunkedArray, polars Series) don't
        # support python arithmetic in {expr} transforms — hand eval a
        # pandas Series for categoricals (keeps C()/level semantics) and
        # a plain numpy array otherwise
        if isinstance(col.dtype, (nw.Categorical, nw.Enum)):
            return col.to_pandas()
        return col.to_numpy()

    @staticmethod
    def _is_categorical_like(values) -> bool:
        if pd is not None and isinstance(values, (pd.Categorical, pd.Series)):
            if isinstance(values, pd.Series):
                return isinstance(values.dtype, pd.CategoricalDtype) or (
                    values.dtype == object
                )
            return True
        if isinstance(values, np.ndarray):
            return values.dtype == object or values.dtype.kind in "US"
        return False

    def eval_factor(self, expr: str, cat_missing_method: str, cat_missing_name: str):
        """Evaluate one factor expression → Numeric/MultiNumeric/Categorical slot."""
        spans_intercept = True
        levels = None

        if expr.startswith("C(") and expr.endswith(")"):
            data_expr, args, kwargs = _parse_C_call(expr)
            if "levels" in kwargs:
                levels = list(eval(kwargs["levels"], {"__builtins__": {}}, {"np": np}))  # noqa: S307
            if "spans_intercept" in kwargs:
                spans_intercept = kwargs["spans_intercept"] == "True"
            # per-factor missing handling (reference formula.py:670-711)
            if "missing_method" in kwargs:
                cat_missing_method = kwargs["missing_method"].strip("\"'")
            if "missing_name" in kwargs:
                cat_missing_name = kwargs["missing_name"].strip("\"'")
            contrasts = None
            contrasts_src = args[0] if args else kwargs.get("contrasts")
            if contrasts_src is not None:
                from .contrasts import parse_contrasts_arg

                contrasts = parse_contrasts_arg(contrasts_src, self.context)
            col = self._column(data_expr)
            values = col if col is not None else self._eval_python(data_expr)
            return self._encode_categorical(
                expr, values, levels, spans_intercept, cat_missing_method,
                cat_missing_name, contrasts=contrasts,
            )

        if (
            expr.startswith("center(") or expr.startswith("scale(")
        ) and expr.endswith(")"):
            # stateful location/spread transforms (formulaic's center/scale:
            # training statistics are remembered and reused out-of-sample).
            # scale(x, center=True, ddof=1): (x − mean) / std.
            fname = "center" if expr.startswith("center(") else "scale"
            data_expr, args, kwargs = _split_call(expr, fname)
            col = self._column(data_expr)
            if col is not None:
                x = np.asarray(col.to_numpy(), dtype=np.float64)
            else:
                x = np.asarray(self._eval_python(data_expr), dtype=np.float64)
            prior = self.state.get(expr) if self.use_state else None
            if prior is not None:
                loc, spread = prior.loc, prior.spread
            else:
                do_center = kwargs.get("center", "True") not in (
                    "False", "false", "0",
                )
                loc = float(np.nanmean(x)) if do_center else 0.0
                spread = 1.0
                if fname == "scale":
                    ddof = int(kwargs.get("ddof", 1))
                    n_eff = max(np.sum(~np.isnan(x)) - ddof, 1)
                    spread = float(
                        np.sqrt(np.nansum((x - np.nanmean(x)) ** 2) / n_eff)
                    ) or 1.0
                if not self.use_state:
                    self.state[expr] = FactorState(
                        kind=fname, loc=loc, spread=spread
                    )
            return NumericSlot(values=(x - loc) / spread, name=expr)

        if (expr.startswith("poly(") or expr.startswith("bs(")) and expr.endswith(")"):
            fname = "poly" if expr.startswith("poly(") else "bs"
            data_expr, args, kwargs = _split_call(expr, fname)
            col = self._column(data_expr)
            if col is not None:
                x = np.asarray(col.to_numpy(), dtype=np.float64)
            else:
                x = np.asarray(self._eval_python(data_expr), dtype=np.float64)
            prior = self.state.get(expr) if self.use_state else None
            if fname == "poly":
                vals, alpha, norm2 = _eval_poly(x, args, kwargs, prior)
                if not self.use_state:
                    self.state[expr] = FactorState(
                        kind="poly", poly_alpha=alpha, poly_norm2=norm2
                    )
            else:
                vals, knots, degree = _eval_bs(x, args, kwargs, prior)
                if not self.use_state:
                    self.state[expr] = FactorState(
                        kind="bs", bs_knots=knots, bs_degree=degree
                    )
            return MultiNumericSlot(
                values=vals,
                labels=[str(i + 1) for i in range(vals.shape[1])],
                name=expr,
            )

        col = self._column(expr)
        if (
            self.use_state
            and (st := self.state.get(expr)) is not None
            and st.kind == "categorical"
        ):
            # a remembered categorical factor stays categorical on
            # re-materialization even if the live column's dtype is
            # numeric — upstream formulaic raises on the kind mismatch,
            # which here surfaces as unseen categories
            values = col if col is not None else self._eval_python(expr)
            return self._encode_categorical(
                expr, values, levels, spans_intercept,
                cat_missing_method, cat_missing_name,
            )
        if col is not None:
            dtype = col.dtype
            if isinstance(dtype, (nw.Categorical, nw.Enum, nw.String, nw.Object)):
                return self._encode_categorical(
                    expr, col, levels, spans_intercept,
                    cat_missing_method, cat_missing_name,
                )
            values = col.to_numpy()
            return NumericSlot(np.asarray(values, dtype=np.float64), expr)

        values = self._eval_python(expr)
        if self._is_categorical_like(values):
            return self._encode_categorical(
                expr, values, levels, spans_intercept,
                cat_missing_method, cat_missing_name,
            )
        values = np.asarray(values, dtype=np.float64)
        if values.ndim == 0 or values.size == 1:
            # scalar transform result → constant column
            values = np.full(self.df.shape[0], float(np.ravel(values)[0]))
        elif values.ndim != 1:
            values = values.reshape(-1)
        return NumericSlot(values, expr)

    @staticmethod
    def _is_missing(val) -> bool:
        if val is None or (isinstance(val, float) and val != val):
            return True
        if pd is not None and val is pd.NA:
            return True
        return False

    @classmethod
    def _map_to_codes(cls, raw, lookup):
        """Vectorized value→code mapping for stateful re-materialization.

        Same semantics as the per-row loop it replaces (value lookup with a
        str-spelling fallback, missings → -1), but C-speed through pandas
        Categoricals — the loop made out-of-sample encoding O(n) Python
        calls per factor.  Falls back to the loop for exotic values.
        """
        raw_arr = np.asarray(raw, dtype=object)
        n = len(raw_arr)
        codes = np.full(n, -1, dtype=np.int64)
        if pd is not None and n:
            try:
                s = pd.Series(raw_arr)
                miss = s.isna().to_numpy()
                live_vals = raw_arr[~miss]
                live_keys = list(lookup)
                # positional match via get_indexer (-1 for unseen values);
                # pandas 4 deprecates Categorical(values, categories=...)
                # with out-of-dtype entries, so avoid that constructor
                sub = (
                    pd.Index(live_keys)
                    .get_indexer(pd.Index(live_vals))
                    .astype(np.int64)
                )
                # remap positional codes to the lookup's code values
                # (identical when lookup is dense 0..K-1, which it is)
                order = np.asarray([lookup[c] for c in live_keys], np.int64)
                hit = sub >= 0
                sub[hit] = order[sub[hit]]
                if (~hit).any():
                    # str-spelling fallback for the few non-exact matches
                    rest = live_vals[~hit]
                    sub2 = np.full(len(rest), -1, dtype=np.int64)
                    for i, val in enumerate(rest):
                        code = lookup.get(
                            val if isinstance(val, str) else str(val)
                        )
                        if code is not None:
                            sub2[i] = code
                    sub[~hit] = sub2
                codes[~miss] = sub
                unseen = {
                    str(v) for v in live_vals[sub < 0]
                } if (sub < 0).any() else set()
                return codes, bool(miss.any()), unseen
            except (TypeError, ValueError):
                codes[:] = -1
        unseen = set()
        has_missing = False
        for i, val in enumerate(raw_arr):
            if cls._is_missing(val):
                has_missing = True
                continue
            key = str(val) if not isinstance(val, str) else val
            code = lookup.get(val, lookup.get(key))
            if code is None:
                unseen.add(str(val))
            else:
                codes[i] = code
        return codes, has_missing, unseen

    def _encode_categorical(
        self, expr, values, levels, spans_intercept, missing_method,
        missing_name, contrasts=None,
    ):
        if self.use_state and expr in self.state:
            st = self.state[expr]
            spans_intercept = st.spans_intercept
            missing_method = st.missing_method or missing_method
            missing_name = st.missing_name or missing_name
            contrasts = st.contrasts
            categories = list(st.categories)
            raw = self._raw_values(values)
            lookup = {c: i for i, c in enumerate(categories)}
            if st.add_missing_category:
                # training converted missings; live categories exclude the
                # missing column which is appended below
                live = [c for c in categories if c != missing_name]
                lookup = {c: i for i, c in enumerate(live)}
            codes, has_missing, unseen = self._map_to_codes(raw, lookup)
            if unseen:
                raise ValueError(
                    f"Column {expr!r} contains unseen categories: {sorted(unseen)}."
                )
            if has_missing:
                if st.add_missing_category:
                    codes[codes == -1] = len(lookup)
                elif missing_method == "fail":
                    raise ValueError(
                        "Categorical data can't have missing values "
                        "if cat_missing_method='fail'."
                    )
                elif missing_method == "convert":
                    # training saw no missings, so there is no missing column
                    raise ValueError(
                        f"Column {expr!r} contains unseen categories: "
                        f"[{missing_name!r}]."
                    )
                # 'zero': -1 codes stay and yield all-zero rows
        else:
            if levels is not None:
                raw = self._raw_values(values)
                # numeric data with declared levels: compare as strings
                # (reference formula.py:714-780 casts both sides)
                if np.asarray(raw).dtype.kind in "ifu":
                    raw = [None if self._is_missing(v) else str(v) for v in raw]
                    levels = [str(lv) for lv in levels]
                lookup = {c: i for i, c in enumerate(levels)}
                codes = np.empty(len(raw), dtype=np.int64)
                unseen = set()
                for i, v in enumerate(raw):
                    if self._is_missing(v):
                        codes[i] = -1
                    else:
                        code = lookup.get(v)
                        if code is None:
                            unseen.add(str(v))
                            codes[i] = -1
                        else:
                            codes[i] = code
                if unseen:
                    raise ValueError(
                        f"Column {expr!r} contains unseen categories: "
                        f"{sorted(unseen)}."
                    )
                categories = list(levels)
            else:
                codes, cats = _extract_codes_and_categories(values)
                codes = codes.astype(np.int64)
                categories = list(cats)

            add_missing = missing_method == "convert" and bool((codes == -1).any())
            self.state[expr] = FactorState(
                kind="categorical",
                categories=list(categories)
                + ([missing_name] if add_missing else []),
                spans_intercept=spans_intercept,
                add_missing_category=add_missing,
                missing_method=missing_method,
                missing_name=missing_name,
                contrasts=contrasts,
            )
            if missing_method == "fail" and (codes == -1).any():
                raise ValueError(
                    "Categorical data can't have missing values "
                    "if cat_missing_method='fail'."
                )
            if add_missing:
                if missing_name in categories:
                    raise ValueError(
                        f"Missing category {missing_name} already exists."
                    )
                codes = np.where(codes == -1, len(categories), codes)
                categories = categories + [missing_name]
            # 'zero': leave -1 codes; they produce all-zero rows downstream

        slot = CategoricalSlot(
            codes=codes,
            categories=categories,
            multipliers=np.ones(len(codes)),
            name=expr,
        )
        slot.spans_intercept = spans_intercept
        slot.contrasts = contrasts
        return slot

    @staticmethod
    def _raw_values(values):
        maybe = nw.from_native(values, series_only=True, pass_through=True)
        if isinstance(maybe, nw.Series):
            return maybe.to_numpy()
        if pd is not None and isinstance(values, pd.Series):
            return values.to_numpy()
        return np.asarray(values)


def _reduce_rank(slot: CategoricalSlot, base_idx: int = 0) -> CategoricalSlot:
    """Drop one live category (rows of it get sentinel -2).

    ``base_idx`` picks the reference level — 0 by default, or the
    ``contr.treatment(base=...)`` choice.
    """
    codes = slot.codes.copy()
    codes[codes == base_idx] = -2
    codes[codes > base_idx] -= 1
    out = CategoricalSlot(
        codes=codes,
        categories=slot.categories[:base_idx] + slot.categories[base_idx + 1 :],
        multipliers=slot.multipliers,
        name=slot.name,
    )
    out.spans_intercept = getattr(slot, "spans_intercept", True)
    return out


def _contrast_coded_slot(slot, factor_name, spec, reduced, categorical_format):
    """Materialize a non-treatment contrast coding as dense columns.

    The coded factor is ``M[codes, :]`` (missing rows → zeros) scaled by
    any accumulated interaction multipliers: a dense block, whose sandwich
    goes through the width dispatch of ``ops/sandwich_kernel.py``.
    """
    M, frag_labels = spec.coding(list(slot.categories), reduced)
    k, m = M.shape
    M_pad = np.vstack([M, np.zeros((1, m))])
    codes = np.where(slot.codes >= 0, slot.codes, k)
    values = M_pad[codes, :] * slot.multipliers[:, None]
    labels = [
        categorical_format.format(name=factor_name, category=lb)
        for lb in frag_labels
    ]
    out = MultiNumericSlot(values=values, labels=labels, name=factor_name)
    out._labels_are_full_names = True
    return out


# ----------------------------------------------------------------------
# slot → matrix conversion
# ----------------------------------------------------------------------


def _numeric_to_matrix(slot: NumericSlot, dtype, sparse_threshold, device):
    values = slot.values.astype(dtype)
    density = float(np.mean(values != 0)) if len(values) else 1.0
    if density > sparse_threshold:
        return DenseMatrix(values.reshape(-1, 1), column_names=[slot.name],
                           term_names=[slot.name], device=device)
    return SparseMatrix(
        sps.csc_matrix(values.reshape(-1, 1)),
        column_names=[slot.name],
        term_names=[slot.name],
        device=device,
    )


def _multi_to_matrix(slot: MultiNumericSlot, dtype, sparse_threshold, device):
    """Convert a basis factor (poly/bs) to dense or sparse columns."""
    values = slot.values.astype(dtype)
    if getattr(slot, "_labels_are_full_names", False):
        names = list(slot.labels)
    else:
        names = slot.column_names
    density = float(np.mean(values != 0)) if values.size else 1.0
    if density > sparse_threshold:
        return DenseMatrix(values, column_names=names, term_names=[slot.name] * len(names),
                           device=device)
    return SparseMatrix(
        sps.csc_matrix(values),
        column_names=names,
        term_names=[slot.name] * len(names),
        device=device,
    )


def _categorical_to_matrix(slot: CategoricalSlot, dtype, sparse_threshold, cat_threshold,
                           device):
    """Convert, handling -2 drop sentinels via a synthetic dropped level."""
    codes = slot.codes.copy()
    categories = list(slot.categories)
    if (codes == -2).any():
        if (codes == -2).all():
            return SparseMatrix(
                sps.csc_matrix((len(codes), len(categories)), dtype=dtype),
                column_names=categories,
                term_names=[slot.name] * len(categories),
                device=device,
            )
        codes[codes >= 0] += 1
        codes[codes == -2] = 0
        categories = ["__drop__"] + categories
        drop_first = True
    else:
        drop_first = False

    cat = CategoricalMatrix(
        codes,
        categories=np.asarray(categories, dtype=object),
        drop_first=drop_first,
        dtype=dtype,
        column_name=slot.name,
        term_name=slot.name,
        column_name_format="{category}",
        cat_missing_method="zero",  # missing already handled upstream
        device=device,
    )
    if (slot.multipliers == 1).all() and cat.shape[1] >= cat_threshold:
        return cat

    scaled = sps.csc_matrix(
        cat.tocsr().multiply(slot.multipliers[:, np.newaxis]).astype(dtype)
    )
    dense_part, sparse_part, dense_idx, sparse_idx = _split_sparse_and_dense_parts(
        scaled,
        sparse_threshold,
        column_names=cat.get_names("column"),
        term_names=[slot.name] * cat.shape[1],
        device=device,
    )
    return SplitMatrix([dense_part, sparse_part], [dense_idx, sparse_idx])


# ----------------------------------------------------------------------
# the materializer
# ----------------------------------------------------------------------


@dataclass
class FormulaModelSpec:
    """Stateful formula spec: re-materialize new data with remembered levels.

    ``options`` holds the device the matrix was built on, so that
    :meth:`get_model_matrix` builds on it too.
    """

    formula: str
    terms: list = field(default_factory=list)
    intercept: bool = False
    factor_states: dict = field(default_factory=dict)
    options: dict = field(default_factory=dict)
    column_names: tuple = ()
    term_names: tuple = ()

    def get_model_matrix(self, data):
        """Encode ``data`` using this spec's remembered factor states."""
        return _materialize(
            self.terms,
            self.intercept,
            data,
            state=self.factor_states,
            use_state=True,
            spec=self,
            **self.options,
        )


def materialize_response(formula: str, data, context=None) -> np.ndarray:
    """Evaluate the left-hand side of ``lhs ~ rhs`` as a response vector."""
    from .parser import parse_formula

    lhs_terms, _, _ = parse_formula(formula)
    if not lhs_terms:
        raise ValueError(f"Formula {formula!r} has no left-hand side.")
    if len(lhs_terms) != 1 or lhs_terms[0].degree != 1:
        raise ValueError("The response must be a single term, e.g. 'y ~ ...'.")
    df = nw.from_native(data, eager_only=True)
    evaluator = _Evaluator(df, context, {}, use_state=False)
    slot = evaluator.eval_factor(lhs_terms[0].factors[0], "fail", "(MISSING)")
    if not isinstance(slot, NumericSlot):
        raise ValueError("The response must evaluate to a numeric vector.")
    return slot.values


def materialize_formula(
    formula: str,
    data,
    ensure_full_rank: bool = False,
    na_action: str = "ignore",
    dtype=np.float64,
    sparse_threshold: float = 0.1,
    cat_threshold: int = 4,
    interaction_separator: str = ":",
    categorical_format: str = "{name}[{category}]",
    cat_missing_method: str = "fail",
    cat_missing_name: str = "(MISSING)",
    intercept_name: str = "Intercept",
    include_intercept: bool = False,
    add_column_for_intercept: bool = True,
    cluster_by: str = "none",
    context: Optional[dict] = None,
    device=None,
):
    """Parse + materialize a formula against a dataframe → SplitMatrix on
    ``device`` (None: the CUDA card)."""
    with _trace.span("formula"):
        device = resolve_device(device)
        with _trace.span("formula.parse"):
            _, terms, intercept = parse_formula(formula, include_intercept)

        options = dict(
            ensure_full_rank=ensure_full_rank,
            na_action=na_action,
            dtype=dtype,
            sparse_threshold=sparse_threshold,
            cat_threshold=cat_threshold,
            interaction_separator=interaction_separator,
            categorical_format=categorical_format,
            cat_missing_method=cat_missing_method,
            cat_missing_name=cat_missing_name,
            intercept_name=intercept_name,
            add_column_for_intercept=add_column_for_intercept,
            cluster_by=cluster_by,
            context=context,
            device=device,
        )
        spec = FormulaModelSpec(
            formula=formula, terms=terms, intercept=intercept, options=options
        )
        return _materialize(
            terms,
            intercept,
            data,
            state=spec.factor_states,
            use_state=False,
            spec=spec,
            **options,
        )


def _materialize(
    terms,
    intercept,
    data,
    state,
    use_state,
    spec,
    ensure_full_rank=False,
    na_action="ignore",
    dtype=np.float64,
    sparse_threshold=0.1,
    cat_threshold=4,
    interaction_separator=":",
    categorical_format="{name}[{category}]",
    cat_missing_method="fail",
    cat_missing_name="(MISSING)",
    intercept_name="Intercept",
    add_column_for_intercept=True,
    cluster_by="none",
    context=None,
    device=None,
):
    if na_action not in ("ignore", "drop", "raise"):
        raise ValueError(
            f"na_action must be one of 'ignore', 'drop', 'raise'; "
            f"got {na_action!r}."
        )
    if cluster_by not in ("none", "numerical_factors"):
        raise ValueError(
            f"cluster_by must be 'none' or 'numerical_factors'; "
            f"got {cluster_by!r}."
        )
    with _trace.span("formula.factors"):
        df = nw.from_native(data, eager_only=True)
        evaluator = _Evaluator(df, context, state, use_state)

        # evaluate every distinct factor once
        factor_slots: dict[str, Any] = {}
        for term in terms:
            for f in term.factors:
                if f not in factor_slots:
                    factor_slots[f] = evaluator.eval_factor(
                        f, cat_missing_method, cat_missing_name
                    )

        n_rows = df.shape[0]

        # na_action over evaluated factors
        if na_action in ("drop", "raise"):
            na_mask = np.zeros(n_rows, dtype=bool)
            for slot in factor_slots.values():
                if isinstance(slot, CategoricalSlot):
                    na_mask |= slot.codes == -1
                elif isinstance(slot, MultiNumericSlot):
                    na_mask |= ~np.isfinite(slot.values).all(axis=1)
                else:
                    na_mask |= ~np.isfinite(slot.values)
            if na_mask.any():
                if na_action == "raise":
                    raise ValueError("Missing values in formula data (na_action='raise').")
                keep = ~na_mask
                n_rows = int(keep.sum())
                for name, slot in factor_slots.items():
                    if isinstance(slot, CategoricalSlot):
                        slot.codes = slot.codes[keep]
                        slot.multipliers = slot.multipliers[keep]
                        if not use_state:
                            # levels are defined by the post-drop data
                            # (formulaic drops rows before encoding); restrict
                            # to observed categories, preserving order
                            observed = np.unique(slot.codes[slot.codes >= 0])
                            if len(observed) < len(slot.categories):
                                remap = np.full(len(slot.categories), -1, np.int64)
                                remap[observed] = np.arange(len(observed))
                                live = slot.codes >= 0
                                slot.codes[live] = remap[slot.codes[live]]
                                slot.categories = [
                                    slot.categories[i] for i in observed
                                ]
                                if name in state:
                                    state[name].categories = list(slot.categories)
                    else:
                        slot.values = slot.values[keep]

    with _trace.span("formula.matrices"):
        # full-rank bookkeeping: the set of factor-subsets already spanned
        spanned: set[frozenset] = set()
        if intercept:
            spanned.add(frozenset())

        matrices = []
        term_names = []

        def _append(mat, term_label):
            # blocks are appended in consecutive column order; SplitMatrix
            # derives indices itself (handles nested splits from mixed-density
            # categorical encodings)
            matrices.append(mat)
            term_names.extend([term_label] * mat.shape[1])

        if intercept and add_column_for_intercept:
            ones = NumericSlot(np.ones(n_rows), intercept_name)
            # the intercept TERM is "1" (formulaic convention); only its
            # column is named by intercept_name
            _append(_numeric_to_matrix(ones, dtype, -1.0, device), "1")

        def _encode_factor(f, mode):
            """Encoded slot of factor ``f`` in ``mode`` 'full'/'reduced'/'asis'."""
            slot = factor_slots[f]
            if not isinstance(slot, CategoricalSlot):
                return slot
            reduced = mode == "reduced"
            cspec = getattr(slot, "contrasts", None)
            if cspec is not None and cspec.kind != "treatment":
                return _contrast_coded_slot(
                    slot, f, cspec, reduced, categorical_format
                )
            base_idx = 0
            if cspec is not None and cspec.base is not None:
                cats = list(slot.categories)
                scats = [str(c) for c in cats]
                if cspec.base in cats:
                    base_idx = cats.index(cspec.base)
                elif str(cspec.base) in scats:
                    base_idx = scats.index(str(cspec.base))
                else:
                    raise ValueError(
                        f"Base level {cspec.base!r} is not among the "
                        f"levels of {f!r}: {cats}."
                    )
            formatted = CategoricalSlot(
                codes=slot.codes,
                categories=[
                    categorical_format.format(name=f, category=c)
                    for c in slot.categories
                ],
                multipliers=slot.multipliers,
                name=f,
            )
            formatted.spans_intercept = getattr(slot, "spans_intercept", True)
            return _reduce_rank(formatted, base_idx) if reduced else formatted

        ordered_terms = sorted(terms, key=lambda t: (t.degree,))
        if cluster_by == "numerical_factors":
            # group terms sharing the same numeric-factor set adjacently,
            # clusters ordered by first appearance (the formulaic option)
            def _numkey(t):
                return frozenset(
                    f
                    for f in t.factors
                    if not isinstance(factor_slots[f], CategoricalSlot)
                )

            cluster_keys: list = []
            for t in ordered_terms:
                kk = _numkey(t)
                if kk not in cluster_keys:
                    cluster_keys.append(kk)
            ordered_terms = [
                t for kk in cluster_keys for t in ordered_terms if _numkey(t) == kk
            ]

        for term in ordered_terms:
            # Structurally-full-rank encoding: expand the term over the powerset
            # of its intercept-spanning categorical factors (each contributes
            # "absent" or "reduced"), drop pieces whose factor set an earlier
            # term already spans, then greedily re-merge piece pairs
            # P = Q ∪ {f⁻} into P with f unreduced — the minimal-piece-count
            # simplification the reference inherits from formulaic's
            # materializer (its vendored tests pin this exact behavior).
            exp = [
                f
                for f in term.factors
                if isinstance(factor_slots[f], CategoricalSlot)
                and getattr(factor_slots[f], "spans_intercept", True)
            ]
            if ensure_full_rank:
                fixed_key = frozenset(f for f in term.factors if f not in exp)
                pieces = []  # dict: present exp factor -> "reduced"/"full"
                for r in range(len(exp) + 1):
                    for subset in combinations(exp, r):
                        key = fixed_key | frozenset(subset)
                        if key in spanned:
                            continue
                        spanned.add(key)
                        pieces.append(dict.fromkeys(subset, "reduced"))
                # iterate to fixpoint: merging can enable further merges
                # ((1 + A⁻)(1 + B⁻) collapses all the way to A:B full when
                # nothing is pre-spanned — the reference's cat:cat - 1 case)
                merged = sorted(pieces, key=len)
                changed = True
                while changed:
                    changed = False
                    for i, p in enumerate(merged):
                        for j, q in enumerate(merged):
                            extra = set(p) - set(q)
                            if (
                                i != j
                                and len(p) == len(q) + 1
                                and len(extra) == 1
                                and all(p[g] == q[g] for g in q)
                                and p[next(iter(extra))] == "reduced"
                            ):
                                newp = dict(p)
                                newp[next(iter(extra))] = "full"
                                merged[j] = newp
                                del merged[i]
                                changed = True
                                break
                        if changed:
                            break
                piece_list = sorted(merged, key=len)
            else:
                spanned.add(frozenset(term.factors))
                piece_list = [dict.fromkeys(exp, "full")]

            for piece in piece_list:
                slots = []
                for f in term.factors:
                    if f in exp and f not in piece:
                        continue
                    slots.append(_encode_factor(f, piece.get(f, "asis")))
                if not slots:
                    continue  # constant piece — covered by the intercept column
                combined = reduce(
                    lambda a, b: interact(a, b, interaction_separator), slots
                )
                members = (
                    combined.members
                    if isinstance(combined, BundleSlot)
                    else [combined]
                )
                for m in members:
                    if isinstance(m, NumericSlot):
                        mat = _numeric_to_matrix(m, dtype, sparse_threshold, device)
                    elif isinstance(m, MultiNumericSlot):
                        mat = _multi_to_matrix(m, dtype, sparse_threshold, device)
                    else:
                        mat = _categorical_to_matrix(
                            m, dtype, sparse_threshold, cat_threshold, device
                        )
                    if mat.shape[1] == 0:
                        continue  # piece vanished (all levels dropped)
                    _append(mat, term.name(interaction_separator))

        if not matrices:
            # an empty formula ("0") materializes to an (n, 0) matrix — the
            # contract the reference inherits from formulaic (vendored
            # ``test_empty``), not an error
            empty = DenseMatrix(np.empty((n_rows, 0), dtype=dtype), device=device)
            empty.model_spec = spec
            spec.column_names = ()
            spec.term_names = ()
            return empty

        result = SplitMatrix(matrices)
        result.set_names(term_names, type="term")
        result.model_spec = spec
        spec.column_names = tuple(result.column_names)
        spec.term_names = tuple(term_names)
        return result
