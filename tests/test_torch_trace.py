"""The program's spans and counters (``tabmat_torch/_trace.py``).

A small design with every kind of block (dense, sparse, two categoricals)
goes from a frame through ``from_formula``, ``DeviceDesign.from_matrix``, an
IRLS fit, a FISTA fit and the matrix API, once with tracing on and once
off.  On the CPU the segment sums and sparse products take their plain
routes, so no kernel table is built: ``tables_built`` reads 0 here.  The
one test marked ``gpu`` builds them on the card and skips without one
(``python -m pytest --noconftest tests/test_torch_trace.py -m gpu``).
"""

import numpy as np
import pandas as pd
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tabmat_torch as tt
from tabmat_torch import _trace
from tabmat_torch.ops.segments import build_plan
from tabmat_torch.parallel.design import DeviceDesign

FORMULA = "y ~ x + s + a + b"
CATEGORICALS = 2  # a and b: one plan each and one cross plan for the pair
# s: its pair plan, kept on its SparseMatrix, and a (code, column) plan in
# each of the two designs (the fit's and the matrix API's)
SPARSE_PLANS = 3


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    _trace.disable()
    _trace.take()
    yield
    _trace.disable()
    _trace.take()


def _frame(n: int = 400, seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "x": rng.normal(size=n),
        "s": np.where(rng.random(n) < 0.05, rng.normal(size=n), 0.0),  # a sparse column
        "a": pd.Categorical(rng.choice(list("pqrst"), n)),
        "b": pd.Categorical(rng.choice(list("uvwxyz"), n)),
        "y": rng.poisson(1.0, n).astype(np.float64),
    })


def _pipeline() -> dict:
    """Every traced layer once; the results and the IRLS fit's steps."""
    df = _frame()
    X = tt.from_formula(FORMULA, df, include_intercept=True, ensure_full_rank=True,
                        device="cpu")
    design = DeviceDesign.from_matrix(X)
    y = df["y"].to_numpy()
    beta, n_iter = tt.fit_glm(design, y, family="poisson", l2=1.0, device="cpu")
    beta_l1, _ = tt.fit_glm(design, y, family="poisson", l1=0.01, l2=1.0, max_iter=2,
                            device="cpu")
    gen = torch.Generator().manual_seed(1)
    v = torch.randn(X.shape[1], generator=gen, dtype=torch.float64)
    r = torch.randn(X.shape[0], generator=gen, dtype=torch.float64)
    d = torch.rand(X.shape[0], generator=gen, dtype=torch.float64) + 0.1
    return {"beta": beta, "beta_l1": beta_l1, "matvec": X.matvec(v),
            "tmv": X.transpose_matvec(r), "sandwich": X.sandwich(d), "n_iter": n_iter,
            "kinds": [type(m).__name__ for m in X.matrices]}


@pytest.fixture(scope="module")
def traced():
    """(the pipeline's results with tracing on, what it recorded, results off)."""
    _trace.disable()
    _trace.take()
    off = _pipeline()
    _trace.enable()
    try:
        on = _pipeline()
    finally:
        _trace.disable()
    return on, _trace.take(), off


# span → the spans that may enclose it directly (None: a root)
PARENTS = {
    "formula": {None},
    "formula.parse": {"formula"},
    "formula.factors": {"formula"},
    "formula.matrices": {"formula"},
    "from_matrix": {None, "api.matvec", "api.tmv", "api.sandwich"},
    "from_matrix.dense": {"from_matrix"},
    "from_matrix.cat": {"from_matrix"},
    "from_matrix.sparse": {"from_matrix"},
    "plan.build": {"from_matrix.cat", "from_matrix.sparse"},
    "fit": {None},
    "fit.converge": {"fit"},
    "fit.epoch": {"fit"},
    "step": {"fit"},
    "step.matvec": {"step"},
    "step.family": {"step"},
    "step.tmv": {"step"},
    "step.scale": {"step"},
    "step.sandwich": {"step"},
    "step.cg": {"step"},
    "api.matvec": {None},
    "api.tmv": {None},
    "api.sandwich": {None},
    "design.matvec": {"step.matvec", "fit", "fit.epoch", "api.matvec"},
    "design.tmv": {"step.tmv", "fit", "fit.epoch", "api.tmv"},
    "design.sandwich": {"step.sandwich", "api.sandwich"},
    "sandwich.dense": {"design.sandwich"},
    "sandwich.cat": {"design.sandwich"},
    "sandwich.cat_dense": {"design.sandwich"},
    "sandwich.sparse": {"design.sandwich"},
    "sandwich.assemble": {"design.sandwich"},
}


def test_pipeline_has_every_block_kind(traced):
    on, _, _ = traced
    assert on["kinds"] == ["DenseMatrix", "SparseMatrix", "CategoricalMatrix",
                           "CategoricalMatrix"]


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_recorded_under_its_parent(traced, name):
    _, taken, _ = traced
    spans = taken["spans"]
    mine = [s for s in spans if s["name"] == name]
    assert mine, f"no span {name!r}"
    for s in mine:
        parent = None if s["parent"] is None else spans[s["parent"]]["name"]
        assert parent in PARENTS[name], (name, parent)
        assert s["start_ns"] <= s["end_ns"]


def test_no_span_outside_the_table(traced):
    _, taken, _ = traced
    assert {s["name"] for s in taken["spans"]} == set(PARENTS)


@pytest.mark.parametrize("name,expected", [
    # two categoricals: a plan each and one cross plan, which the matrix
    # API's own design reuses; and the sparse block's plans
    ("plans_built", CATEGORICALS + CATEGORICALS * (CATEGORICALS - 1) // 2 + SPARSE_PLANS),
    # the categoricals' from the codes already on the plan's device; the
    # sparse plans' keys are made on the host
    ("plans_from_device_keys", CATEGORICALS + CATEGORICALS * (CATEGORICALS - 1) // 2),
    # the plain CPU routes build no kernel table
    ("tables_built", 0),
])
def test_counter_reads_what_the_design_implies(traced, name, expected):
    _, taken, _ = traced
    assert taken["counters"].get(name, 0) == expected


def test_design_builds_its_plans_from_device_keys():
    """A design of three categoricals builds six plans (three categories,
    three crosses), each from keys already on the plan's device; a plan
    from a host array counts in ``plans_built`` only."""
    rng = np.random.default_rng(3)
    cats = [tt.CategoricalMatrix(rng.integers(-1, k, 300), categories=np.arange(k),
                                 drop_first=first, cat_missing_method="zero", device="cpu")
            for k, first in ((4, False), (5, True), (6, False))]
    _trace.enable()
    DeviceDesign.from_matrix(tt.SplitMatrix(cats))
    counters = _trace.take()["counters"]
    assert counters["plans_from_device_keys"] == counters["plans_built"] == 6
    _trace.enable()
    build_plan(np.array([0, 2, -1, 1]), 3, "cpu")
    build_plan(torch.tensor([0, 2, -1, 1]), 3, "cpu")
    assert _trace.take()["counters"] == {"plans_built": 2, "plans_from_device_keys": 1}


def test_steps_counter_reads_the_fit_steps(traced):
    on, taken, _ = traced
    assert taken["counters"]["steps"] == on["n_iter"]
    assert sum(s["name"] == "step" for s in taken["spans"]) == on["n_iter"]


def test_children_lie_inside_their_parents_and_share_their_root(traced):
    _, taken, _ = traced
    spans = taken["spans"]
    roots = {s["root"] for s in spans if s["parent"] is None}
    assert len(roots) == sum(s["parent"] is None for s in spans)
    for i, s in enumerate(spans):
        if s["parent"] is None:
            continue
        p = spans[s["parent"]]
        assert s["parent"] < i
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert s["root"] == p["root"]


@pytest.mark.parametrize("key", ["beta", "beta_l1", "matvec", "tmv", "sandwich"])
def test_results_bit_for_bit_with_tracing_on(traced, key):
    on, _, off = traced
    assert torch.equal(on[key], off[key])


@pytest.mark.parametrize("shape", [
    # (name, parent's position or None) in opening order
    [("a", None), ("b", 0), ("c", 1), ("d", 0)],
    [("a", None), ("b", None), ("c", 1)],
])
def test_nesting_parents_and_roots(shape):
    _trace.enable()

    def run(i):
        name, _ = shape[i]
        with _trace.span(name):
            for j in range(i + 1, len(shape)):
                if shape[j][1] == i:
                    run(j)

    for i, (_, parent) in enumerate(shape):
        if parent is None:
            run(i)
    spans = _trace.take()["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == shape
    for s in spans:
        expected = s["root"] if s["parent"] is None else spans[s["parent"]]["root"]
        assert s["root"] == expected
    assert len({s["root"] for s in spans if s["parent"] is None}) == sum(
        p is None for _, p in shape)


def test_take_clears_and_counts():
    _trace.enable()
    _trace.count("steps")
    _trace.count("steps", 2)
    with _trace.span("a"):
        pass
    first = _trace.take()
    assert first["counters"] == {"steps": 3} and len(first["spans"]) == 1
    assert _trace.take() == {"spans": [], "counters": {}}


def test_take_with_a_span_open_raises():
    _trace.enable()
    with _trace.span("a"):
        with pytest.raises(RuntimeError):
            _trace.take()


def test_disable_stops_recording():
    _trace.enable()
    _trace.disable()
    with _trace.span("a"):
        _trace.count("steps")
    assert _trace.take() == {"spans": [], "counters": {}}


def test_off_span_is_one_shared_no_op():
    assert _trace.span("a") is _trace.span("b")


def test_context_zero_reads_callers_locals_with_tracing_on():
    df = _frame(60)

    def twice(x):
        return 2.0 * x

    scale = 3.0  # noqa: F841 -- read by the formula through context=0
    formula = "y ~ twice(x) + I(scale * x)"
    off = tt.from_formula(formula, df, context=0, device="cpu").toarray()
    _trace.enable()
    on = tt.from_formula(formula, df, context=0, device="cpu").toarray()
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on[:, 0], 2.0 * df["x"].to_numpy())
    np.testing.assert_array_equal(on[:, 1], 3.0 * df["x"].to_numpy())


def _small_fit():
    df = _frame(200, seed=3)
    X = tt.from_formula(FORMULA, df, include_intercept=True, ensure_full_rank=True,
                        device="cpu")
    return tt.fit_glm(X, df["y"].to_numpy(), family="poisson", l2=1.0, max_iter=3,
                      device="cpu")


def _program_ranges(prof) -> list:
    return [e for e in prof.events() if e.name.startswith(_trace.PREFIX)]


def test_profiler_session_holds_the_program_ranges_nested():
    _trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _small_fit()
    ranges = _program_ranges(prof)
    taken = _trace.take()
    assert sorted(e.name for e in ranges) == sorted(
        _trace.PREFIX + s["name"] for s in taken["spans"])
    fits = [e for e in ranges if e.name == _trace.PREFIX + "fit"]
    steps = [e for e in ranges if e.name == _trace.PREFIX + "step"]
    assert len(fits) == 1 and len(steps) == taken["counters"]["steps"]
    fit = fits[0].time_range
    for e in steps:
        assert fit.start <= e.time_range.start <= e.time_range.end <= fit.end


@pytest.mark.parametrize("enabled,session", [(False, True), (True, False)])
def test_no_range_opens_off_or_without_a_session(monkeypatch, enabled, session):
    """Off, no range opens even under the profiler; on, none opens without a
    session (the spans are recorded all the same)."""
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    if enabled:
        _trace.enable()
    if session:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _small_fit()
        assert not _program_ranges(prof)
    else:
        _small_fit()
    assert not [name for name in opened if name.startswith(_trace.PREFIX)]
    assert bool(_trace.take()["spans"]) == enabled


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_tables_built_once_per_plan_on_the_card(cuda):
    """On the card a new design's first sandwich builds its kernel tables,
    each in a ``tables.build`` span inside a sandwich cell; the second
    builds none."""
    df = _frame()
    X = tt.from_formula(FORMULA, df, include_intercept=True, ensure_full_rank=True,
                        device=cuda)
    design = DeviceDesign.from_matrix(X)
    w = torch.rand(X.shape[0], dtype=torch.float64, device=cuda) + 0.1
    _trace.enable()
    first = design.sandwich(w)
    built = _trace.take()
    second = design.sandwich(w)
    again = _trace.take()
    assert torch.equal(first, second)
    spans = built["spans"]
    tables = [s for s in spans if s["name"] == "tables.build"]
    assert built["counters"]["tables_built"] == len(tables) > 0
    for s in tables:
        assert spans[s["parent"]]["name"].startswith("sandwich.")
    assert "tables_built" not in again["counters"]
    assert not [s for s in again["spans"] if s["name"] == "tables.build"]
