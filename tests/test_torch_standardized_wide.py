"""The port's ``StandardizedMatrix`` over a cut-down ``sparse_wide`` design
against the benchmark's plain reference (``glmbench/reference/standardized.py``),
and the spans, counters and kept device parameters of
``models/standardized.py``.

The design is the benchmark's generator (``glmbench/data/sparse_wide.py``)
at 3,000 rows by 500 columns at 2%, with an all-zero column and a constant
one, standardized as the cell ``sparse_wide_std.ops`` does: weights 1/n,
centred and scaled.  Tolerances, of the largest entry: float64 1e-12 (the
expansion's corrections cancel mildly; rounding reads about 1e-15),
float32 1e-5 (the float32 path's standardization and expansion read a few
times 1e-7, against a reference computed in float64 on the float32 values).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse as sps

import tabmat_torch as tt
from glmbench.data import sparse_wide, sparse_wide_std
from glmbench.reference.standardized import StandardizedDesign
from tabmat_torch import _trace

N, K, DENSITY = 3000, 500, 0.02
SEED = 2**31 + 27
ZERO_COL, CONST_COL, CONST = 3, 250, 0.5
TOL = {np.float64: 1e-12, np.float32: 1e-5}
WEIGHTS = np.full(N, 1.0 / N)
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
def csc():
    """The generator's design with column 3 all zero and column 250 constant."""
    X = sparse_wide.make({"rows": N, "cols": K, "density": DENSITY}, SEED, 1)[0]["csc"]
    zero = sps.csc_matrix((N, 1))
    const = sps.csc_matrix(np.full((N, 1), CONST))
    X = sps.hstack([X[:, :ZERO_COL], zero, X[:, ZERO_COL + 1:CONST_COL], const,
                    X[:, CONST_COL + 1:]], format="csc")
    X.sort_indices()
    return X


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    return {"v": rng.standard_normal(K), "r": rng.standard_normal(N), "d": rng.random(N) + 0.05}


def _standardized(X, dtype=np.float64, center=True, scale=True):
    return tt.SparseMatrix(X.astype(dtype), device="cpu").standardize(WEIGHTS, center, scale)


def _reference(X, dtype=np.float64, center=True, scale=True):
    """The reference of the design in ``dtype``'s values, computed in float64."""
    Xd = X.astype(dtype).astype(np.float64)
    return StandardizedDesign(Xd.indptr, Xd.indices, Xd.data, Xd.shape, WEIGHTS, center, scale,
                              device="cpu")


def _relerr(got, want) -> float:
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _as(kind, x, dtype):
    x = x.astype(dtype)
    return torch.as_tensor(x) if kind == "tensor" else x


def test_design_has_a_zero_and_a_constant_column(csc):
    A = csc.toarray()
    assert not A[:, ZERO_COL].any() and (A[:, CONST_COL] == CONST).all()
    assert csc.has_sorted_indices and csc.shape == (N, K)


def test_reference_matches_dense_numpy(csc, inputs):
    ref = _reference(csc)
    A = csc.toarray()
    mean = WEIGHTS @ A
    std = np.sqrt(WEIGHTS @ (A - mean) ** 2)
    mult = np.where(std < 1e-7, 1.0, 1.0 / np.where(std < 1e-7, 1.0, std))
    Z = (A - mean) * mult
    d = inputs["d"]
    assert _relerr(ref.hessian(d), (Z * d[:, None]).T @ Z) <= 1e-13
    assert _relerr(ref.matvec(inputs["v"]), Z @ inputs["v"]) <= 1e-13
    assert _relerr(ref.tmv(inputs["r"]), Z.T @ inputs["r"]) <= 1e-13
    np.testing.assert_allclose(ref.mult.numpy(), mult, rtol=1e-12)
    assert ref.mult[ZERO_COL] == ref.mult[CONST_COL] == 1.0


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_standardize_matches_the_reference(csc, dtype):
    m, means, stds = _standardized(csc, dtype)
    ref = _reference(csc, dtype)
    tol = TOL[dtype]
    assert _relerr(means, ref.mean.numpy()) <= tol
    # the constant column's std is rounding either way, under tabmat's 1e-7
    np.testing.assert_allclose(stds, ref.std.numpy(), rtol=tol, atol=1e-7)
    assert stds[ZERO_COL] == 0.0 and stds[CONST_COL] < 1e-7
    np.testing.assert_allclose(m.mult, ref.mult.numpy(), rtol=tol)
    assert m.mult[ZERO_COL] == m.mult[CONST_COL] == 1.0
    assert _relerr(m.shift, ref.shift.numpy()) <= tol


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_ops_match_the_reference(csc, inputs, dtype, kind):
    m = _standardized(csc, dtype)[0]
    ref = _reference(csc, dtype)
    v, r, d = (_as(kind, inputs[name], dtype) for name in ("v", "r", "d"))
    got = {"matvec": m.matvec(v), "tmv": m.transpose_matvec(r), "sandwich": m.sandwich(d)}
    for value in got.values():
        assert torch.is_tensor(value) == (kind == "tensor")
    tol = TOL[dtype]
    assert _relerr(got["matvec"], ref.matvec(inputs["v"].astype(dtype))) <= tol
    assert _relerr(got["tmv"], ref.tmv(inputs["r"].astype(dtype))) <= tol
    assert _relerr(got["sandwich"], ref.hessian(inputs["d"].astype(dtype))) <= tol


@pytest.mark.parametrize("center, scale", [(True, False), (False, True)])
def test_one_of_centring_and_scaling(csc, inputs, center, scale):
    m = _standardized(csc, center=center, scale=scale)[0]
    ref = _reference(csc, center=center, scale=scale)
    d = torch.as_tensor(inputs["d"])
    assert _relerr(m.sandwich(d), ref.hessian(inputs["d"])) <= TOL[np.float64]
    assert _relerr(m.matvec(inputs["v"]), ref.matvec(inputs["v"])) <= TOL[np.float64]
    assert _relerr(m.transpose_matvec(inputs["r"]), ref.tmv(inputs["r"])) <= TOL[np.float64]


# -- the parameters kept on the device ------------------------------------------


def _ops(m, tensors):
    return m.matvec(tensors["v"]), m.transpose_matvec(tensors["r"]), m.sandwich(tensors["d"])


def test_parameters_are_copied_once_and_results_are_a_fresh_matrixs(csc, inputs, monkeypatch):
    """After the first call no op on all rows and columns makes a tensor
    from host data: neither the parameters nor a column index."""
    m = _standardized(csc)[0]
    tensors = {name: torch.as_tensor(x) for name, x in inputs.items()}
    first = _ops(m, tensors)
    assert list(m._device_params) == [(torch.device("cpu"), torch.float64)]
    kept = m._device_params[(torch.device("cpu"), torch.float64)]

    copies = []
    as_tensor = torch.as_tensor

    def counting(data, *args, **kwargs):
        copies.append(data)
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counting)
    again = _ops(m, tensors)
    monkeypatch.undo()
    assert copies == []
    assert m._device_params[(torch.device("cpu"), torch.float64)] is kept
    fresh = _ops(tt.StandardizedMatrix(m.mat, m.shift, m.mult), tensors)
    for a, b, c in zip(first, again, fresh):
        assert torch.equal(a, b) and torch.equal(a, c)
    # each promoted dtype gets copies of its own
    m32 = tt.StandardizedMatrix(m.mat.astype(np.float32), m.shift.astype(np.float32),
                                m.mult.astype(np.float32))
    m32.matvec(torch.as_tensor(inputs["v"], dtype=torch.float32))
    m32.matvec(torch.as_tensor(inputs["v"]))
    assert sorted(str(dt) for _, dt in m32._device_params) == ["torch.float32", "torch.float64"]


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def test_results_are_the_four_term_expansion_bit_for_bit(csc, inputs):
    """The operations of the expansion in their order, written out here: the
    arithmetic the class had before its spans and kept parameters."""
    m = _standardized(csc)[0]
    v, r, d = (torch.as_tensor(inputs[name]) for name in ("v", "r", "d"))
    shift, mult = torch.as_tensor(m.shift), torch.as_tensor(m.mult)
    term1 = m.mat.sandwich(d)
    d_mat = m.mat.transpose_matvec(d) * mult
    res = _outer(d_mat, shift) + _outer(shift, d_mat) + _outer(shift, shift) * d.sum()
    want = {"sandwich": res + term1 * _outer(mult, mult),
            "matvec": m.mat.matvec(mult * v) + shift @ v,
            "tmv": m.mat.transpose_matvec(r) * mult + _outer(shift, r.sum(0)).reshape(K)}
    for _ in range(2):  # the first call copies the parameters, the second keeps them
        assert torch.equal(m.sandwich(d), want["sandwich"])
        assert torch.equal(m.matvec(v), want["matvec"])
        assert torch.equal(m.transpose_matvec(r), want["tmv"])


# -- spans and counters -----------------------------------------------------------


def _record(m, inputs, kind="tensor"):
    v, r, d = (_as(kind, inputs[name], np.float64) for name in ("v", "r", "d"))
    _trace.enable()
    m.matvec(v)
    m.transpose_matvec(r)
    m.sandwich(d)
    _trace.disable()
    return _trace.take()


def _named(spans):
    """(name, parent's name) of each span, in the order they opened."""
    return [(s["name"], None if s["parent"] is None else spans[s["parent"]]["name"])
            for s in spans]


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_spans_nest_as_named(csc, inputs, kind):
    m = _standardized(csc)[0]
    spans = _record(m, inputs, kind)["spans"]
    named = _named(spans)
    std = [(n, p) for n, p in named if n.startswith("std.")]
    assert std == [("std.matvec", None), ("std.tmv", None), ("std.sandwich", None),
                   ("std.sandwich.inner", "std.sandwich"),
                   ("std.sandwich.rank1", "std.sandwich")]
    # the inner matrix's spans sit under the standardized op that called them
    assert ("sparse.matvec", "std.matvec") in named and ("sparse.tmv", "std.tmv") in named
    assert ("sparse.sandwich", "std.sandwich.inner") in named
    assert ("sparse.tmv", "std.sandwich.inner") in named
    assert not any(p == "std.sandwich.rank1" for _, p in named)
    for s in spans:
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
            assert s["root"] == p["root"]


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("scale, temporaries", [(True, 9), (False, 7)], ids=["scaled", "centred"])
def test_counters_count_sandwiches_and_the_expansions_bytes(csc, inputs, kind, scale,
                                                             temporaries):
    """Scaled: three outer products, the scaled one, two sums, ``M``,
    ``M ∘ T`` and the last sum; centred alone: no ``M`` and no product."""
    m = _standardized(csc, scale=scale)[0]
    counters = _record(m, inputs, kind)["counters"]
    assert counters["std_sandwich"] == 1
    assert counters["std_rank1_bytes"] == temporaries * K * K * 8


def test_a_diagonal_inner_sandwich_counts_its_diagonal_matrix():
    """A categorical's sandwich is diagonal: the diagonal made a matrix and
    one sum after the six shared temporaries."""
    codes = np.random.default_rng(3).integers(0, 40, N)
    cat = tt.CategoricalMatrix(codes, device="cpu")
    m = cat.standardize(WEIGHTS, True, True)[0]
    d = torch.rand(N, dtype=torch.float64) + 0.05
    _trace.enable()
    S = m.sandwich(d)
    _trace.disable()
    k = cat.shape[1]
    assert _trace.take()["counters"] == {"std_sandwich": 1, "std_rank1_bytes": 8 * k * k * 8}
    Z = m.toarray()
    dn = d.numpy()
    assert _relerr(S, (Z * dn[:, None]).T @ Z) <= TOL[np.float64]


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_nothing_recorded_when_off_and_results_bit_for_bit(csc, inputs, kind):
    m = _standardized(csc)[0]
    v, r, d = (_as(kind, inputs[name], np.float64) for name in ("v", "r", "d"))
    off = (m.matvec(v), m.transpose_matvec(r), m.sandwich(d))
    assert _trace.take() == {"spans": [], "counters": {}}
    _trace.enable()
    on = (m.matvec(v), m.transpose_matvec(r), m.sandwich(d))
    _trace.disable()
    for a, b in zip(on, off):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the benchmark's data module and the reference's imports ------------------------


def test_data_module_standardizes_as_the_configuration_says(csc, inputs):
    config = {"rows": N, "cols": K, "density": DENSITY,
              "standardize": {"weights": "1/n", "center_predictors": True,
                              "scale_predictors": True}}
    m = sparse_wide_std.to_program(tt, {"csc": csc}, config, np.float64, "cpu")
    ref = sparse_wide_std.reference_design({"csc": csc}, config)
    assert isinstance(m, tt.StandardizedMatrix) and isinstance(ref, StandardizedDesign)
    assert _relerr(m.sandwich(inputs["d"]), ref.hessian(inputs["d"])) <= TOL[np.float64]
    np.testing.assert_array_equal(sparse_wide_std.weights(config), WEIGHTS)
    with pytest.raises(ValueError):
        sparse_wide_std.weights(dict(config, standardize={"weights": "exposure"}))


def test_the_reference_imports_no_jax_and_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import glmbench.reference.standardized\n"
        "found = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(found & {'jax', 'jaxlib', 'flax', 'tabmat_tpu', 'tabmat_torch'}))\n"
        "print('torch' in found)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["[]", "True"]
