"""The port's formula engine against ``tabmat_tpu``'s on the CPU.

The reference formula tests (``tests/test_formula.py``,
``tests/test_formula_battery.py`` and ``tests/test_formulaic_upstream.py``)
run here once more with their ``tm`` replaced by the twin of
``test_torch_constructors.py``: every ``from_formula`` and ``from_df`` call,
and every ``model_spec.get_model_matrix`` on a second frame, goes through
both packages, the port with ``device="cpu"`` (a pandas frame once through
narwhals and once through pandas alone), and the results are held to each
other as that module's docstring says: ``toarray()`` exactly, names, block
types and ops within ``atol=1e-12``; where the JAX package raises, the port
raises the same exception type.  The reference test then goes on with the
JAX package's result.  ``test_interact_slots``, which calls the engine's
slot algebra directly, is held here case by case instead; the integer
``context`` of ``from_formula``, which the twin resolves for both, is held
on the port's own ``from_formula`` here.
"""

import pickle

import numpy as np
import pandas as pd
import pytest

import tabmat_tpu as tm
from tabmat_tpu.formula import engine as ref_engine

import tabmat_torch as tt
from tabmat_torch.formula import engine

import test_formula  # noqa: E402
import test_formula_battery  # noqa: E402
import test_formulaic_upstream  # noqa: E402
from test_torch_constructors import TWIN, assert_same_matrix, mirror, mirror_module, use_twin

# ----------------------------------------------------------------------
# the reference formula tests, on both packages
# ----------------------------------------------------------------------

df = test_formula_battery.df
data = test_formulaic_upstream.data
data_with_nulls = test_formulaic_upstream.data_with_nulls
mirror_module(test_formula, "formula", globals())
mirror_module(test_formula_battery, "formula_battery", globals(), skip=("test_interact_slots",))


class TestFormulaicTests(test_formulaic_upstream.TestFormulaicTests):
    """The mirror of ``test_formulaic_upstream.py::TestFormulaicTests``."""


for _name, _fn in vars(test_formulaic_upstream.TestFormulaicTests).items():
    if _name.startswith("test_"):
        setattr(TestFormulaicTests, _name, mirror(_fn))


@pytest.fixture(autouse=True)
def _twin(monkeypatch):
    use_twin(monkeypatch, test_formula, test_formula_battery, test_formulaic_upstream)


# ----------------------------------------------------------------------
# what the twin cannot reach
# ----------------------------------------------------------------------


def _port_slot(slot):
    """The port engine's twin of a reference slot."""
    if type(slot).__name__ == "BundleSlot":
        return engine.BundleSlot([_port_slot(m) for m in slot.members], slot.name)
    cls = getattr(engine, type(slot).__name__)
    out = cls.__new__(cls)
    out.__dict__.update(vars(slot))
    return out


def _assert_same_slot(got, ref):
    assert type(got).__name__ == type(ref).__name__
    assert got.name == ref.name
    if type(ref).__name__ == "BundleSlot":
        assert len(got.members) == len(ref.members)
        for g, r in zip(got.members, ref.members):
            _assert_same_slot(g, r)
        return
    for key, value in vars(ref).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(got, key), value)
        else:
            assert getattr(got, key) == value, key


@pytest.mark.parametrize("left_key", ["dense", "multi", "cat_full", "cat_reduced"])
@pytest.mark.parametrize("right_key", ["dense", "multi", "cat_full", "cat_reduced"])
def test_interact_slots(left_key, right_key):
    """``test_formula_battery.py::test_interact_slots``: the port's slot
    algebra gives the reference's slot, value for value."""
    slots = test_formula_battery._slot_instances()
    left, right = slots[left_key], slots[right_key]
    ref = ref_engine.interact(left, right)
    got = engine.interact(_port_slot(left), _port_slot(right))
    _assert_same_slot(got, ref)


DF = test_formula.DF


def _nested(formula, context):
    return tt.from_formula(formula, DF, context=context, device="cpu")


def test_context_capture():
    """``context=0`` reads the caller of the port's ``from_formula``, and
    ``context=1`` its caller's caller: no frame of the port stands between."""
    my_scale = 10.0  # noqa: F841
    res = tt.from_formula("I(my_scale * x)", DF, context=0, device="cpu")
    np.testing.assert_array_equal(np.squeeze(res.toarray()), 10.0 * DF["x"].to_numpy())
    res = _nested("I(my_scale * x)", 1)
    np.testing.assert_array_equal(np.squeeze(res.toarray()), 10.0 * DF["x"].to_numpy())
    with pytest.raises(NameError):
        _nested("I(my_scale * x)", 0)


def test_materialize_response_matches():
    frame = DF.assign(y=np.arange(6.0) ** 2)
    for formula in ("y ~ x + cat", "np.log(y + 1) ~ x"):
        np.testing.assert_array_equal(engine.materialize_response(formula, frame),
                                      ref_engine.materialize_response(formula, frame))
    for bad in ("x + cat", "y + x ~ cat", "cat ~ x"):
        with pytest.raises(ValueError):
            ref_engine.materialize_response(bad, frame)
        with pytest.raises(ValueError):
            engine.materialize_response(bad, frame)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_every_route_in_one_formula(dtype):
    """Dense, sparse, kept and exploded categoricals, cat × numeric (a nested
    split), cat × cat, a basis and a coded factor, in both dtypes: float32
    blocks on every route, and a second frame through the kept spec."""
    n = 300

    def frame(seed):
        r = np.random.default_rng(seed)
        return pd.DataFrame({
            "x": r.standard_normal(n),
            "s": np.where(r.random(n) < 0.04, r.standard_normal(n), 0.0),
            "big": pd.Categorical(r.choice(list("abcdef"), n), categories=list("fedcba")),
            "small": pd.Categorical(r.choice(["u", "v", "w"], n)),
        })

    formula = ("1 + x + s + big + small + x:small + big:small + poly(x, 2) "
               "+ C(small, contr.sum)")
    X = TWIN.from_formula(formula, frame(1), ensure_full_rank=True, dtype=dtype)
    got = tt.from_formula(formula, frame(1), ensure_full_rank=True, dtype=dtype, device="cpu")
    assert {type(m).__name__ for m in got.matrices} == {
        "DenseMatrix", "SparseMatrix", "CategoricalMatrix"}
    assert all(np.dtype(m.dtype) == np.dtype(dtype) for m in got.matrices)
    X.model_spec.get_model_matrix(frame(2))


def test_spec_pickles_with_its_device():
    X = tt.from_formula("1 + x + cat", DF, device="cpu")
    spec = pickle.loads(pickle.dumps(X.model_spec))
    again = spec.get_model_matrix(DF)
    assert again.device == X.device
    np.testing.assert_array_equal(again.toarray(), X.toarray())
    assert_same_matrix(tm.from_formula("1 + x + cat", DF), again)


CARRIED_FORMULAS = [
    "1 + x + cat + x:z",
    "C(cat, contr.sum) + poly(x, 2) + center(z)",
    "cat:cat2 + scale(x) - 1",
    "C(cat, contr.treatment('b')) + bs(x, 3)",
]


@pytest.mark.parametrize("formula", CARRIED_FORMULAS)
def test_carried_formula_matrix_re_encodes_a_new_frame(formula):
    """``from_tabmat_tpu`` carries a formula matrix with its model spec:
    the port's spec re-encodes a new frame as the JAX package's does."""
    from tabmat_torch.convert import from_tabmat_tpu

    ref = tm.from_formula(formula, DF, ensure_full_rank=True)
    got = from_tabmat_tpu(ref, device="cpu")
    assert_same_matrix(ref, got)
    new = pd.DataFrame({
        "x": [2.5, 1.0, 6.0], "z": [0.1, -0.2, 0.3],
        "cat": pd.Categorical(["c", "a", "b"], categories=["a", "b", "c"]),
        "cat2": pd.Categorical(["v", "u", "v"]),
    })
    assert_same_matrix(ref.model_spec.get_model_matrix(new), got.model_spec.get_model_matrix(new))
