"""The port's dataframe constructors against ``tabmat_tpu``'s on the CPU.

The reference tests of ``from_df``, ``from_pandas`` and ``from_csc``
(``tests/test_constructor.py``, ``tests/test_pyarrow_inputs.py`` and
``tests/test_degenerate_shapes.py::test_from_df_single_row``) run here once
more with their ``tm`` replaced by :data:`TWIN`: each constructor call goes
through ``tabmat_tpu`` and through ``tabmat_torch`` with ``device="cpu"``,
the two results are compared, and the reference test goes on with the JAX
package's result.  A pandas frame goes through the port twice, once read by
narwhals and once by pandas alone (``tabmat_torch._frames.PandasFrames``,
the reader of an installation without narwhals).  Where the JAX package
raises, the port must raise the same exception type.

A compared pair has the same type, shape, dtype, block types and column
maps, column and term names, and ``toarray()`` exactly; ``matvec``,
``transpose_matvec`` and ``sandwich``, with and without ``rows=`` and
``cols=``, agree within ``atol=1e-12`` in float64 (the zoo's tolerance,
``tests/test_matrices.py``) and within 1e-5 of the largest entry in
float32, for numpy operands and for CPU tensors.  A formula matrix also
carries the same model spec, and its ``get_model_matrix`` on another frame
is compared the same way.  The formula tests build on this module.
"""

import doctest
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch
from _pytest.mark.structures import ParameterSet
from scipy import sparse as sps

import jax  # noqa: F401  (the JAX package runs on the CPU, as its own tests run it)
import tabmat_tpu as tm

import tabmat_torch as tt
import tabmat_torch.constructors
import tabmat_torch.formula.api
import tabmat_torch.formula.engine
import tabmat_torch.models.categorical
import tabmat_torch.models.dense
from tabmat_torch import _frames
from tabmat_torch.models.categorical import _extract_codes_and_categories
from tabmat_tpu.models.categorical import (
    _extract_codes_and_categories as ref_extract_codes_and_categories,
)

pa = pytest.importorskip("pyarrow")

import test_constructor  # noqa: E402
import test_degenerate_shapes  # noqa: E402
import test_pyarrow_inputs  # noqa: E402

ATOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-5}

# the modules that read frames through ``_frames.nw``
FRAME_MODULES = (
    tabmat_torch.constructors,
    tabmat_torch.formula.engine,
    tabmat_torch.models.categorical,
)


# ----------------------------------------------------------------------
# the twin: both packages, one input
# ----------------------------------------------------------------------


def _backends(data) -> list:
    """The frame readers a port call runs under for ``data``."""
    return ["narwhals", "pandas"] if isinstance(data, pd.DataFrame) else ["narwhals"]


def _under(backend: str, call):
    """``call()`` with the port's frame reader set to ``backend``."""
    with pytest.MonkeyPatch.context() as mp:
        if backend == "pandas":
            for module in FRAME_MODULES:
                mp.setattr(module, "nw", _frames.PandasFrames)
        return call()


def _np(x) -> np.ndarray:
    if hasattr(x, "toarray"):  # a DiagonalResult
        x = x.toarray()
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _block_layout(mat) -> list:
    if type(mat).__name__ != "SplitMatrix":
        return [type(mat).__name__]
    return [(type(m).__name__, np.asarray(i).tolist()) for m, i in zip(mat.matrices, mat.indices)]


def _ops(mat, n: int, k: int, operand) -> dict:
    """Every op of ``mat`` once whole and once restricted, on one seed, with
    operands of the matrix's dtype."""
    rng = np.random.default_rng(n * 1009 + k)
    v, r, d = rng.standard_normal(k), rng.standard_normal(n), rng.random(n) + 0.1
    rows, cols = np.arange(0, n, 2), np.arange(0, k, 2)
    v, r, d = (operand(a.astype(np.dtype(mat.dtype))) for a in (v, r, d))
    return {
        "matvec": mat.matvec(v),
        "matvec cols": mat.matvec(v, cols=cols),
        "transpose_matvec": mat.transpose_matvec(r),
        "transpose_matvec rows cols": mat.transpose_matvec(r, rows=rows, cols=cols),
        "sandwich": mat.sandwich(d),
        "sandwich rows cols": mat.sandwich(d, rows=rows, cols=cols),
    }


def assert_same_matrix(ref, got, backend: str = "narwhals") -> None:
    """``got`` (tabmat_torch) is ``ref`` (tabmat_tpu): see the module docstring."""
    where = f"(port read the frame with {backend})"
    assert type(got).__name__ == type(ref).__name__, where
    assert tuple(got.shape) == tuple(ref.shape), where
    assert np.dtype(got.dtype) == np.dtype(ref.dtype), where
    assert got.device == torch.device("cpu")
    assert _block_layout(got) == _block_layout(ref), where
    assert got.column_names == list(ref.column_names), where
    assert got.term_names == list(ref.term_names), where
    for g, r in zip(getattr(got, "matrices", [got]), getattr(ref, "matrices", [ref])):
        if type(r).__name__ == "CategoricalMatrix":
            assert list(g.categories) == list(r.categories), where
            np.testing.assert_array_equal(g.indices, np.asarray(r.indices))
    want = np.asarray(ref.toarray())
    np.testing.assert_array_equal(got.toarray(), want, err_msg=where)

    n, k = ref.shape
    if n and k:
        dtype = np.dtype(ref.dtype)
        ref_ops = _ops(ref, n, k, np.asarray)
        scale = max(1.0, max(np.abs(_np(x)).max() for x in ref_ops.values()))
        for operand in (np.asarray, torch.tensor):
            for name, res in _ops(got, n, k, operand).items():
                np.testing.assert_allclose(
                    _np(res).astype(np.float64), _np(ref_ops[name]).astype(np.float64),
                    rtol=0, atol=ATOL[dtype] * (1.0 if dtype == np.float64 else scale),
                    err_msg=f"{name} with {operand.__name__} operands {where}",
                )

    spec_ref = getattr(ref, "model_spec", None)
    if spec_ref is not None:
        spec = got.model_spec
        assert spec.formula == spec_ref.formula
        assert spec.intercept == spec_ref.intercept
        assert [t.factors for t in spec.terms] == [t.factors for t in spec_ref.terms]
        assert spec.column_names == tuple(spec_ref.column_names)
        assert spec.term_names == tuple(spec_ref.term_names)
        assert set(spec.factor_states) == set(spec_ref.factor_states)
        for name, state in spec.factor_states.items():
            ref_state = spec_ref.factor_states[name]
            assert state.kind == ref_state.kind
            assert state.categories == ref_state.categories
        assert spec.options["device"] == got.device
        assert {key: v for key, v in spec.options.items() if key != "device"} == dict(
            spec_ref.options)


def twin_call(ref_call, port_calls) -> object:
    """``ref_call()``'s result, after holding each of ``port_calls``
    (``(backend, call)`` pairs) to it; where the reference raises, each
    port call must raise the same exception type."""
    try:
        ref = ref_call()
    except Exception as exc:
        for backend, call in port_calls:
            with pytest.raises(Exception) as caught:
                _under(backend, call)
            assert type(caught.value) is type(exc), (backend, caught.value, exc)
        raise
    ports = []
    for backend, call in port_calls:
        got = _under(backend, call)
        assert_same_matrix(ref, got, backend)
        ports.append((backend, got.model_spec if hasattr(got, "model_spec") else None))
    if getattr(ref, "model_spec", None) is not None:
        ref.model_spec = TwinSpec(ref.model_spec, ports)
    return ref


class TwinSpec:
    """A reference model spec whose ``get_model_matrix`` also runs the
    port's specs and holds them to it; everything else is the reference's."""

    def __init__(self, ref, ports):
        self.ref, self.ports = ref, ports

    def __getattr__(self, name):
        if name in ("ref", "ports") or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.ref, name)

    def get_model_matrix(self, data):
        return twin_call(
            lambda: self.ref.get_model_matrix(data),
            [(b, lambda s=s: s.get_model_matrix(data))
             for b, s in self.ports if b in _backends(data)],
        )


class Twin:
    """``tabmat_tpu`` whose constructors run on both packages (:func:`twin_call`)."""

    def __getattr__(self, name):
        return getattr(tm, name)

    @staticmethod
    def _both(name, data, args, kwargs):
        return twin_call(
            lambda: getattr(tm, name)(*args, **kwargs),
            [(b, lambda: getattr(tt, name)(*args, **kwargs, device="cpu"))
             for b in _backends(data)],
        )

    def from_df(self, df, *args, **kwargs):
        return self._both("from_df", df, (df,) + args, kwargs)

    def from_pandas(self, df, *args, **kwargs):
        return self._both("from_pandas", df, (df,) + args, kwargs)

    def from_csc(self, mat, *args, **kwargs):
        return self._both("from_csc", mat, (mat,) + args, kwargs)

    def from_formula(self, formula, data, *args, context=None, **kwargs):
        if isinstance(context, int):  # the caller's namespace, as from_formula reads it
            frame = sys._getframe(context + 1)
            context = {**frame.f_globals, **frame.f_locals}
        return self._both("from_formula", data, (formula, data) + args,
                          dict(kwargs, context=context))


TWIN = Twin()


def _drops(value) -> bool:
    """A parametrize case that skips here (a frame library not installed)."""
    return isinstance(value, ParameterSet) and any(
        m.name == "skipif" and m.args and m.args[0] for m in value.marks)


def mirror(fn):
    """A copy of the reference test ``fn`` that reads its module's globals
    (so that its ``tm`` can be the twin), without the parametrize cases
    that skip here."""
    marks = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            argnames, argvalues = mark.args[0], list(mark.args[1])
            kwargs = dict(mark.kwargs)
            keep = [not _drops(v) for v in argvalues]
            if isinstance(kwargs.get("ids"), (list, tuple)):
                kwargs["ids"] = [i for i, k in zip(kwargs["ids"], keep) if k]
            mark = pytest.mark.parametrize(
                argnames, [v for v, k in zip(argvalues, keep) if k], **kwargs).mark
        marks.append(mark)
    copy = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__, fn.__defaults__,
                              fn.__closure__)
    copy.__dict__.update(fn.__dict__)
    copy.pytestmark = marks
    return copy


def mirror_module(module, prefix: str, namespace: dict, skip=()) -> None:
    """Put a mirror of each of ``module``'s test functions into ``namespace``
    as ``test_<prefix>__<name>``."""
    for name, fn in vars(module).items():
        if name.startswith("test_") and isinstance(fn, types.FunctionType) and name not in skip:
            namespace[f"test_{prefix}__{name[5:]}"] = mirror(fn)


def use_twin(monkeypatch, *modules) -> None:
    for module in modules:
        monkeypatch.setattr(module, "tm", TWIN)


# ----------------------------------------------------------------------
# the reference constructor tests, on both packages
# ----------------------------------------------------------------------

df = test_constructor.df
columns = test_pyarrow_inputs.columns
mirror_module(test_constructor, "constructor", globals())
# its CategoricalMatrix calls are held to the port in
# test_categorical_matrix_from_pyarrow_and_list below
mirror_module(test_pyarrow_inputs, "pyarrow_inputs", globals(),
              skip=("test_categorical_matrix_pyarrow_and_list",))
test_degenerate_shapes__from_df_single_row = mirror(test_degenerate_shapes.test_from_df_single_row)


@pytest.fixture(autouse=True)
def _twin(monkeypatch):
    use_twin(monkeypatch, test_constructor, test_pyarrow_inputs, test_degenerate_shapes)


def test_frame_modules_are_all_switched():
    """Every module of the port that reads frames is in FRAME_MODULES, so the
    pandas-only reader is held to the JAX package wherever it is used."""
    readers = {name for name, module in sys.modules.items()
               if name.startswith("tabmat_torch.") and name != "tabmat_torch._frames"
               and getattr(module, "nw", None) is _frames.nw}
    assert readers == {m.__name__ for m in FRAME_MODULES}


# ----------------------------------------------------------------------
# the extraction repair: the JAX package's codes and categories
# ----------------------------------------------------------------------


def _narwhals_series(values):
    import narwhals.stable.v2 as nw

    return nw.from_native(pd.Series(values), series_only=True)


EXTRACTION_CASES = {
    "narwhals categorical, declared order": lambda: _narwhals_series(
        pd.Categorical(["b", "a", "c", "b"], categories=["c", "b", "a"])),
    "pandas categorical, declared order": lambda: pd.Categorical(
        ["b", "a", "c", "b"], categories=["c", "b", "a"]),
    "mixed object vector": lambda: np.array(["b", 1, "a"], dtype=object),
    "narwhals string series": lambda: _narwhals_series(["b", None, "a", "b"]),
    "pyarrow dictionary array": lambda: pa.array(["b", None, "a", "b"]).dictionary_encode(),
    "list with None": lambda: ["b", None, "a", "b"],
}


@pytest.mark.parametrize("case", EXTRACTION_CASES)
def test_extraction_matches_the_reference(case):
    codes, categories = _extract_codes_and_categories(EXTRACTION_CASES[case]())
    ref_codes, ref_categories = ref_extract_codes_and_categories(EXTRACTION_CASES[case]())
    np.testing.assert_array_equal(codes, ref_codes)
    assert list(categories) == list(ref_categories)
    assert [type(c) for c in categories] == [type(c) for c in ref_categories]


@pytest.mark.parametrize("method", ["fail", "zero", "convert"])
@pytest.mark.parametrize("kind", ["chunked", "chunked dictionary"])
def test_categorical_matrix_from_a_chunked_array(kind, method):
    """A pyarrow ChunkedArray has ``.type`` and no ``.dtype``: both packages
    read it through ``np.asarray``, and agree on its codes and categories,
    or both raise.  (pyarrow turns the null of a chunked dictionary array
    into one of its levels on that way, in both packages: ROADMAP C3.)"""
    values = ["b", None, "a", "b", "c"]
    chunks = [pa.array(values[:2]), pa.array(values[2:])]
    if kind == "chunked dictionary":
        chunks = [c.dictionary_encode() for c in chunks]
    vec = pa.chunked_array(chunks)
    assert not hasattr(vec, "dtype")
    kwargs = dict(cat_missing_method=method, column_name="c")
    try:
        ref = tm.CategoricalMatrix(vec, **kwargs)
    except ValueError:
        with pytest.raises(ValueError, match="missing"):
            tt.CategoricalMatrix(vec, **kwargs, device="cpu")
        assert kind == "chunked" and method == "fail"
        return
    got = tt.CategoricalMatrix(vec, **kwargs, device="cpu")
    assert_same_matrix(ref, got)


@pytest.mark.parametrize("kind", ["dictionary", "list"])
def test_categorical_matrix_from_pyarrow_and_list(kind):
    """The port's side of ``test_pyarrow_inputs.py::test_categorical_matrix_pyarrow_and_list``."""
    c = np.random.default_rng(0).choice(list("abc"), 60)
    vec = pa.array(c).dictionary_encode() if kind == "dictionary" else list(c)
    ref = tm.CategoricalMatrix(vec)
    got = tt.CategoricalMatrix(vec, device="cpu")
    assert_same_matrix(ref, got)
    assert [str(x) for x in got.categories] == [
        str(x) for x in tt.CategoricalMatrix(pd.Categorical(c), device="cpu").categories]


def test_ordered_frame_keeps_its_category_order():
    """from_df hands each categorical column on as a narwhals series: the
    declared order survives, as in the JAX package."""
    frame = pd.DataFrame({
        "x": np.arange(6.0),
        "c": pd.Categorical(list("bacbca"), categories=["c", "b", "a"]),
        "small": pd.Categorical(list("yxyxyy"), categories=["y", "x"]),
    })
    X = TWIN.from_df(frame, cat_threshold=3)
    assert X.column_names == ["x", "c[c]", "c[b]", "c[a]", "small[y]", "small[x]"]


# ----------------------------------------------------------------------
# device, dtype and block layout
# ----------------------------------------------------------------------


def _frame(seed=0, n=120):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "dense": rng.standard_normal(n),
        "sparse": np.where(rng.random(n) < 0.05, rng.standard_normal(n), 0.0),
        "big": pd.Categorical(rng.choice(list("abcdefg"), n), categories=list("gfedcba")),
        "small": pd.Categorical(rng.choice(["u", "v"], n, p=[0.95, 0.05])),
        "flag": rng.random(n) < 0.5,
        "pdsparse": pd.arrays.SparseArray(np.where(rng.random(n) < 0.03, 1.0, 0.0)),
    })


def test_no_device_asks_for_the_card(monkeypatch):
    """Without a card, a constructor given no device raises: nothing
    silently lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = _frame()
    for call in (lambda: tt.from_df(frame), lambda: tt.from_pandas(frame),
                 lambda: tt.from_csc(sps.csc_matrix(np.eye(3))),
                 lambda: tt.from_formula("dense + big", frame)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("constructor", ["from_df", "from_pandas"])
@pytest.mark.parametrize("cat_position", ["expand", "end"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_every_route_in_one_frame(constructor, cat_position, dtype):
    """Dense, sparse, pandas-sparse, boolean, kept and exploded categorical
    columns in one frame, in both dtypes and both categorical positions."""
    kwargs = dict(dtype=dtype, cat_position=cat_position, cat_threshold=4)
    X = getattr(TWIN, constructor)(_frame(), **kwargs)
    assert {type(m).__name__ for m in X.matrices} == {
        "DenseMatrix", "SparseMatrix", "CategoricalMatrix"}
    got = getattr(tt, constructor)(_frame(), **kwargs, device="cpu")
    assert all(np.dtype(m.dtype) == np.dtype(dtype) for m in got.matrices)


def test_exploded_categorical_stays_on_the_host(monkeypatch):
    """A categorical column below ``cat_threshold`` is only exploded into
    one-hot blocks: its codes never become a device tensor, and neither do
    the codes of a kept one before its first op."""
    made = []
    real = tt.CategoricalMatrix.eff_codes

    def watched(self):
        made.append(self.get_names("term")[0])
        return real.fget(self)

    monkeypatch.setattr(tt.CategoricalMatrix, "eff_codes", property(watched))
    X = tt.from_df(_frame(), cat_threshold=4, device="cpu")
    assert made == []
    X.matvec(np.ones(X.shape[1]))
    assert made == ["big"]


@pytest.mark.parametrize("density", [0.0, 1.0])
def test_from_csc_with_an_empty_part(density):
    """All columns dense, or all sparse: the other part has no columns and
    the SplitMatrix keeps the non-empty one."""
    rng = np.random.default_rng(3)
    mat = sps.csc_matrix(np.where(rng.random((50, 4)) < density, rng.standard_normal((50, 4)), 0.0))
    X = TWIN.from_csc(mat, threshold=0.1, column_names=list("abcd"))
    assert X.column_names == list("abcd")


@pytest.mark.parametrize("module", [
    tabmat_torch.constructors, tabmat_torch.formula.api, tabmat_torch.models.categorical,
    tabmat_torch.models.dense,
], ids=lambda m: m.__name__)
def test_module_doctests(module):
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0 and results.attempted > 0
