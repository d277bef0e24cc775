"""``fit_glm`` on glum's standardized design with an intercept, against the
benchmark's plain reference (``glmbench/reference/standardized_intercept.py``),
and the counters of ``irls_step``'s Hessian-vector route.

The design is the benchmark's generator (``glmbench/data/sparse_wide.py``)
at 3,000 rows by 400 columns at 2%, with an all-zero column and a constant
one, and the program's matrix is built as the cell ``sparse_wide_std.fit``
builds it (``glmbench/data/sparse_wide_std_poisson.py``): the
``StandardizedMatrix`` of ``[1 | X]``, X centred and scaled with weights
1/n, the intercept's column shifted by 0 and scaled by 1 and not penalised.
A standardized design refuses the explicit Hessian, so every step takes the
Hessian-vector CG route.  Limit: β within 1e-9 of the reference's exact
IRLS, of its largest entry, at both inner precisions (float64 gradients
give the same fixed point).
"""

import gc
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse as sps

import tabmat_torch as tt
from glmbench.data import sparse_wide_std_poisson as data_module
from glmbench.reference.standardized_intercept import StandardizedInterceptDesign, irls
from tabmat_torch import _trace
from tabmat_torch.models import sparse as sparse_model
from tabmat_torch.parallel.design import DeviceDesign

N, K, DENSITY = 3000, 400, 0.02
SEED = 2**31 + 29
ZERO_COL, CONST_COL, CONST = 3, 250, 0.5
L2 = 3.0  # glum's alpha 1e-3 times the rows, as the cell's l2
N_CG, TOL, MAX_ITER = 25, 1e-8, 50
LIMIT = 1e-9
CONFIG = {"rows": N, "cols": K, "density": DENSITY,
          "standardize": {"weights": "1/n", "center_predictors": True,
                          "scale_predictors": True}}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    _trace.disable()
    _trace.take()
    yield
    _trace.disable()
    _trace.take()


@pytest.fixture(scope="module")
def data():
    """The generator's dataset with column 3 of X all zero and column 250
    constant; the response is the generator's."""
    out = data_module.make(CONFIG, SEED, 1)[0]
    X = out["csc"]
    zero = sps.csc_matrix((N, 1))
    const = sps.csc_matrix(np.full((N, 1), CONST))
    X = sps.hstack([X[:, :ZERO_COL], zero, X[:, ZERO_COL + 1:CONST_COL], const,
                    X[:, CONST_COL + 1:]], format="csc")
    X.sort_indices()
    return dict(out, csc=X)


@pytest.fixture(scope="module")
def reference(data):
    """β of the reference's exact IRLS."""
    design = data_module.reference_design(data, CONFIG)
    beta, _ = irls(design, data["y"], data["weights"], "poisson", l2=L2,
                   ps=data_module.penalty_scale(CONFIG, K + 1))
    return beta


def _matrix(data):
    return data_module.to_program(tt, data, CONFIG, np.float64, "cpu")


def _fit(X, data, inner="float32", ps=None, y=None, weights=None):
    ps = data_module.penalty_scale(CONFIG, K + 1) if ps is None else ps
    return tt.fit_glm(X, data["y"] if y is None else y,
                      sample_weight=data["weights"] if weights is None else weights,
                      family="poisson", max_iter=MAX_ITER, tol=TOL, n_cg=N_CG, l2=L2,
                      inner_precision=inner, penalty_scale=ps, device="cpu")


def _relerr(got, want) -> float:
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("inner", ["float64", "float32"])
def test_fit_matches_the_reference_irls(data, reference, inner):
    beta, n_iter = _fit(_matrix(data), data, inner)
    assert n_iter < MAX_ITER
    assert _relerr(beta, reference) <= LIMIT


def test_the_matrix_is_the_standardized_split_of_one_and_x(data):
    X = _matrix(data)
    assert isinstance(X, tt.StandardizedMatrix) and isinstance(X.mat, tt.SplitMatrix)
    assert [type(m).__name__ for m in X.mat.matrices] == ["DenseMatrix", "SparseMatrix"]
    assert X.shape == (N, K + 1)
    dense = np.hstack([np.ones((N, 1)), data["csc"].toarray()]) * X.mult + X.shift
    ref = data_module.reference_design(data, CONFIG)
    np.testing.assert_allclose(ref.matvec(np.eye(K + 1)[5]), dense[:, 5], rtol=0, atol=1e-12)


def test_the_intercept_is_not_standardized_on_any_copy(data):
    X = _matrix(data)
    assert X.shift[0] == 0.0 and X.mult[0] == 1.0
    design = DeviceDesign.from_matrix(X)
    f32 = design.astype_float(torch.float32)
    for d in (design, f32):
        assert float(d.shift[0]) == 0.0 and float(d.mult[0]) == 1.0
    assert f32.shift.dtype == f32.mult.dtype == torch.float32
    np.testing.assert_array_equal(f32.shift.numpy(), X.shift.astype(np.float32))
    np.testing.assert_array_equal(f32.mult.numpy(), X.mult.astype(np.float32))
    # the all-zero and the constant columns become zero columns, multiplier 1
    for j in (1 + ZERO_COL, 1 + CONST_COL):
        assert X.mult[j] == 1.0
        assert X.shift[j] == pytest.approx(-(CONST if j == 1 + CONST_COL else 0.0), abs=1e-12)


def test_the_float32_copy_is_charged_its_blocks_shift_and_mult(data):
    """Under a budget the kept float32 design is charged its sparse
    layouts' and pair plan's values, the intercept's column and the float32
    ``shift`` and ``mult``, and refunded when the design goes."""
    from tabmat_torch import _config

    X = _matrix(data)
    _config.set_cache_budget_mb(100)
    try:
        design = DeviceDesign.from_matrix(X)
        before = _config.cache_spent_bytes()  # the SparseMatrix's pair plan
        f32 = design.astype_float(torch.float32)
        assert design._f32 is f32
        pair = design._block("sparse").pair[0].numel()
        values = 2 * data["csc"].nnz + pair + N
        assert _config.cache_spent_bytes() - before == 4 * (values + 2 * (K + 1))
        del design, f32
        gc.collect()
        assert _config.cache_spent_bytes() == before
    finally:
        _config.set_cache_budget_mb(None)
        _config._cache_refund(_config.cache_spent_bytes())


def test_the_intercept_is_not_penalised(data, reference):
    X = _matrix(data)
    beta, _ = _fit(X, data, "float64")
    mu = np.exp(np.asarray(X.matvec(beta.numpy())))
    # its score is 0 at the optimum: Σ w (y - μ) against Σ w y
    assert abs(np.sum(data["y"] - mu)) <= 1e-9 * np.sum(data["y"])
    penalised, _ = _fit(X, data, "float64", ps=np.ones(K + 1))
    assert _relerr(penalised, reference) > 1e3 * LIMIT


def test_numpy_and_tensor_inputs_give_the_same_fit(data):
    X = _matrix(data)
    from_numpy, n_numpy = _fit(X, data)
    ps = torch.as_tensor(data_module.penalty_scale(CONFIG, K + 1))
    from_tensors, n_tensors = _fit(X, data, ps=ps, y=torch.as_tensor(data["y"]),
                                   weights=torch.as_tensor(data["weights"]))
    assert n_numpy == n_tensors
    assert torch.equal(from_numpy, from_tensors)


def test_hvp_counters_read_the_steps_and_products(data):
    _trace.enable()
    _, n_iter = _fit(_matrix(data), data)
    counters = _trace.take()["counters"]
    assert counters["steps"] == counters["hvp_steps"] == n_iter
    assert counters["hvp"] == n_iter * N_CG
    assert counters["hvp_route.standardized"] == n_iter
    assert "hvp_route.wide" not in counters and "hvp_route.plan" not in counters
    assert "cg_graph_replays" not in counters


def _raw(data):
    """``[1 | X]`` without the standardization."""
    return tt.hstack([np.ones((N, 1)), tt.SparseMatrix(data["csc"], device="cpu")])


@pytest.mark.parametrize("case,reasons", [
    ("explicit", ()),
    ("standardized", ("standardized",)),
    ("wide", ("wide",)),
    ("plan", ("plan",)),
    ("all", ("standardized", "wide", "plan")),
])
def test_route_reasons(data, monkeypatch, case, reasons):
    """Each reason the explicit Hessian is refused counts once a step; a
    design that keeps it counts nothing of the Hessian-vector route."""
    if case in ("wide", "all"):
        monkeypatch.setattr(DeviceDesign, "SANDWICH_MAX_COLS", K)
    if case in ("plan", "all"):
        monkeypatch.setattr(sparse_model, "PAIR_SANDWICH_MAX_PAIRS", 10)
    X = _matrix(data) if case in ("standardized", "all") else _raw(data)
    design = DeviceDesign.from_matrix(X)
    assert design.sandwich_refusals == reasons
    assert design.supports_sandwich == (not reasons)
    y = torch.as_tensor(data["y"])
    _trace.enable()
    tt.glm.irls_step(design, y, torch.ones(N, dtype=torch.float64),
                     torch.zeros(K + 1, dtype=torch.float64), family="poisson", n_cg=4, l2=L2)
    counters = _trace.take()["counters"]
    routed = {name: n for name, n in counters.items() if name.startswith("hvp")}
    if not reasons:
        assert routed == {}
    else:
        expected = {"hvp_steps": 1, "hvp": 4}
        expected.update({f"hvp_route.{reason}": 1 for reason in reasons})
        assert routed == expected


def test_nothing_is_recorded_off_and_results_are_bit_for_bit(data):
    X = _matrix(data)
    off, n_off = _fit(X, data)
    assert _trace.take() == {"spans": [], "counters": {}}
    _trace.enable()
    on, n_on = _fit(X, data)
    assert _trace.take()["counters"]["hvp_steps"] == n_on
    assert n_on == n_off and torch.equal(on, off)


def test_the_reference_matches_a_dense_design(data):
    """The reference's three ops against ``[1 | Z]`` densified with NumPy."""
    ref = data_module.reference_design(data, CONFIG)
    assert isinstance(ref, StandardizedInterceptDesign) and ref.shape == (N, K + 1)
    A = data["csc"].toarray()
    mean = A.mean(axis=0)
    std = np.sqrt(((A - mean) ** 2).mean(axis=0))
    mult = np.where(std < 1e-7, 1.0, 1.0 / np.where(std < 1e-7, 1.0, std))
    Z = np.hstack([np.ones((N, 1)), (A - mean) * mult])
    rng = np.random.default_rng(1)
    v, r, d = rng.standard_normal(K + 1), rng.standard_normal(N), rng.random(N) + 0.05
    assert _relerr(ref.matvec(v), Z @ v) <= 1e-12
    assert _relerr(ref.tmv(r), Z.T @ r) <= 1e-12
    assert _relerr(ref.hessian(d), (Z * d[:, None]).T @ Z) <= 1e-12


def test_the_reference_imports_no_jax_and_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import glmbench.reference.standardized_intercept\n"
        "found = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(found & {'jax', 'jaxlib', 'flax', 'tabmat_tpu', 'tabmat_torch'}))\n"
        "print('torch' in found)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["[]", "True"]
