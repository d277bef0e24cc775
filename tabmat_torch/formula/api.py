"""Wilkinson-formula interface: ``from_formula``.

Port of ``tabmat_tpu/formula/api.py`` (reference
``tabmat/constructor.py:305-404`` + ``formula.py``).  Like the JAX package,
the port ships its own small formula engine (``tabmat_torch.formula.engine``)
covering the Wilkinson surface used in practice: ``+``, ``-``, ``:``, ``*``, ``1``/``0`` intercepts, ``C()``
categorical coercion, function transforms evaluated in a caller context,
and stateful re-materialization for out-of-sample data.
"""

import sys
from typing import Any, Mapping, Optional, Union

import numpy as np


def from_formula(
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
    context: Optional[Union[int, Mapping[str, Any]]] = None,
    device=None,
):
    """Build a SplitMatrix from a Wilkinson formula and a dataframe, on
    ``device`` (None: the CUDA card, raising without one).

    An integer ``context`` evaluates the formula's expressions in the
    namespace of the frame that many levels above this call: 0 is the
    caller of ``from_formula`` itself, so nothing may wrap this function.

    Examples
    --------
    >>> import numpy as np, pandas as pd, tabmat_torch as tt
    >>> df = pd.DataFrame({
    ...     "x": [1.0, 2.0, 3.0, 4.0],
    ...     "c": pd.Categorical(["u", "v", "u", "v"]),
    ... })
    >>> X = tt.from_formula("1 + x + c", df, ensure_full_rank=True, device="cpu")
    >>> X.column_names
    ['Intercept', 'x', 'c[v]']
    >>> X.toarray()
    array([[1., 1., 0.],
           [1., 2., 1.],
           [1., 3., 0.],
           [1., 4., 1.]])
    """
    from .engine import materialize_formula

    if isinstance(context, int):
        if hasattr(sys, "_getframe"):
            frame = sys._getframe(context + 1)
            ctx = dict(frame.f_globals)
            ctx.update(frame.f_locals)
            context = ctx
        else:  # pragma: no cover
            context = None

    return materialize_formula(
        formula,
        data,
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
        include_intercept=include_intercept,
        add_column_for_intercept=add_column_for_intercept,
        cluster_by=cluster_by,
        context=context,
        device=device,
    )
