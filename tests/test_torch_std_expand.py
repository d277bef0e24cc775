"""The standardized sandwich's expansion kernel, ``std_expand<T>``
(``ops/std_expand_kernel.py``), on the CPU: its plain version through the
glue ``StandardizedMatrix`` runs on the card (``_expand_kernel``) against
the torch expansion the CPU keeps, bit for bit; the wrapper's checks; the
counters of both paths.  The kernel itself is held to the torch expansion
on the card (``tests/test_torch_kernels_gpu.py``, ``-k std_expand``).
"""

import numpy as np
import pytest
import torch

import tabmat_torch as tt
from tabmat_torch import _trace
from tabmat_torch.models import standardized
from tabmat_torch.ops import std_expand_kernel as ek

N = 120
# case -> (k, with mult, a non-symmetric T, rows, cols, T's dtype differs,
# T a transposed (non-contiguous) view)
CASES = {
    "symmetric": (37, True, False, False, False, False, False),
    "non_symmetric": (37, True, True, False, False, False, False),
    "centred": (37, False, False, False, False, False, False),
    "centred_non_symmetric": (37, False, True, False, False, False, False),
    "cols": (37, True, False, False, True, False, False),
    "rows": (37, True, False, True, False, False, False),
    "rows_and_cols_centred": (37, False, False, True, True, False, False),
    "k0": (0, True, False, False, False, False, False),
    "k1": (1, True, False, False, False, False, False),
    "k6": (6, True, True, False, False, False, False),  # not a multiple of f32's 4 a vector
    "k8": (8, True, False, False, False, False, False),
    "cast": (37, True, False, False, False, True, False),
    "cast_centred": (37, False, True, True, True, True, False),
    "transposed": (37, True, True, False, False, False, True),
    "cast_transposed": (37, True, True, False, False, True, True),
}
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(autouse=True)
def _tracing_off():
    _trace.disable()
    _trace.take()
    yield
    _trace.disable()
    _trace.take()


def _case(name, dtype):
    """``(m, term1, d_mat, d, rows, cols)`` of one case on the CPU."""
    k, scaled, non_symmetric, by_rows, by_cols, cast, transposed = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    X = rng.standard_normal((N, k)).astype(np_dtype)
    shift = rng.standard_normal(k).astype(np_dtype)
    mult = (rng.random(k) + 0.5).astype(np_dtype) if scaled else None
    m = tt.StandardizedMatrix(tt.DenseMatrix(X, device="cpu"), shift, mult)
    d = torch.as_tensor(rng.random(N) - 0.2, dtype=dtype)
    rows = np.sort(rng.choice(N, N // 3, replace=False)) if by_rows else None
    cols = np.sort(rng.choice(k, k // 2, replace=False)) if by_cols else None
    term1 = m.mat.sandwich(d, rows, cols)
    if non_symmetric:
        term1 = term1 + torch.as_tensor(rng.standard_normal(term1.shape), dtype=dtype)
    if cast:
        term1 = term1.to(torch.float32 if dtype == torch.float64 else torch.float64)
    if transposed:
        term1 = term1.T
    return m, term1, m.mat.transpose_matvec(d, rows, cols), d, rows, cols


@pytest.fixture
def kernel_glue(monkeypatch):
    """``_expand`` routed as on the card: the kernel's glue, with the plain
    version where the CPU has no kernel."""
    monkeypatch.setattr(standardized, "_kernel_serves",
                        lambda d, term1: not standardized._is_diag(term1))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", CASES)
def test_plain_version_is_the_torch_expansion_bit_for_bit(case, dtype, monkeypatch):
    m, term1, d_mat, d, rows, cols = _case(case, dtype)
    want = m._expand(term1.clone(), d_mat, d, rows, cols)
    monkeypatch.setattr(standardized, "_kernel_serves", lambda d, term1: True)
    T = term1.clone()
    got = m._expand(T, d_mat, d, rows, cols)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    # in place where T needs no cast and no contiguous copy
    assert (got is T) == (T.dtype == want.dtype and T.is_contiguous())
    assert got.is_contiguous()


def test_a_diagonal_inner_sandwich_keeps_the_torch_expansion(kernel_glue):
    codes = np.random.default_rng(3).integers(0, 9, N)
    m = tt.CategoricalMatrix(codes, device="cpu").standardize(np.full(N, 1.0 / N), True,
                                                              True)[0]
    d = torch.rand(N, dtype=torch.float64)
    _trace.enable()
    S = m.sandwich(d)
    _trace.disable()
    assert "std_expand_kernel" not in _trace.take()["counters"]
    Z = m.toarray()
    want = (Z * d.numpy()[:, None]).T @ Z
    assert float(np.abs(S.numpy() - want).max()) <= 1e-13 * float(np.abs(want).max())


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_cpu_path_counts_its_temporaries_and_no_kernel(kind):
    m, _, _, d, _, _ = _case("symmetric", torch.float64)
    k = m.shape[1]
    _trace.enable()
    m.sandwich(d.numpy() if kind == "numpy" else d)
    _trace.disable()
    counters = _trace.take()["counters"]
    assert counters == {"std_sandwich": 1, "std_rank1_bytes": 9 * k * k * 8}


@pytest.mark.parametrize("case, copied", [("symmetric", False), ("centred", False),
                                          ("cast", True), ("transposed", True)])
def test_kernel_path_counts_one_expansion_and_only_a_cast_copy(case, copied, kernel_glue):
    m, term1, d_mat, d, rows, cols = _case(case, torch.float64)
    k = m.shape[1]
    _trace.enable()
    m._expand(term1, d_mat, d, rows, cols)
    m.sandwich(d)
    _trace.disable()
    counters = _trace.take()["counters"]
    assert counters["std_expand_kernel"] == 2
    # the sandwich's own inner result has T's dtype: nothing copied there
    assert counters["std_rank1_bytes"] == (k * k * 8 if copied else 0)
    assert counters["std_sandwich"] == 1


def _operands(k=5, dtype=torch.float64, scaled=True):
    gen = torch.Generator().manual_seed(k)
    T = torch.randn(k, k, dtype=dtype, generator=gen)
    t, s = torch.randn(k, dtype=dtype, generator=gen), torch.randn(k, dtype=dtype, generator=gen)
    m = torch.rand(k, dtype=dtype, generator=gen) + 0.5 if scaled else None
    return {"T": T, "t": t, "shift": s, "mult": m, "sigma": torch.ones((), dtype=dtype)}


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "centred"])
def test_wrapper_on_cpu_is_the_plain_version_in_place(scaled):
    ops = _operands(scaled=scaled)
    want = ek.std_expand_plain(**dict(ops, T=ops["T"].clone()))
    T = ops["T"]
    before = dict(ek.launches)
    assert ek.std_expand(**ops) is T
    assert torch.equal(T, want)
    assert ek.launches == before


def _noncontiguous(x):
    return torch.stack([x, x], -1)[..., 0]


@pytest.mark.parametrize("change, error", [
    ({"T": torch.zeros(5, 5, dtype=torch.int64)}, TypeError),
    ({"t": torch.zeros(5, dtype=torch.float32)}, TypeError),
    ({"mult": torch.zeros(5, dtype=torch.float32)}, TypeError),
    ({"sigma": torch.zeros((), dtype=torch.float32)}, TypeError),
    ({"shift": np.zeros(5)}, TypeError),
    ({"T": torch.zeros(5, 4, dtype=torch.float64)}, ValueError),
    ({"T": torch.zeros(5, dtype=torch.float64)}, ValueError),
    ({"t": torch.zeros(4, dtype=torch.float64)}, ValueError),
    ({"mult": torch.zeros(5, 1, dtype=torch.float64)}, ValueError),
    ({"sigma": torch.zeros(2, dtype=torch.float64)}, ValueError),
    ({"t": torch.zeros(5, dtype=torch.float64, device="meta")}, ValueError),
    ("all on meta", ValueError),
    ({"T": _noncontiguous(torch.zeros(5, 5, dtype=torch.float64))}, ValueError),
    ({"shift": _noncontiguous(torch.zeros(5, dtype=torch.float64))}, ValueError),
], ids=["T_int", "t_f32", "mult_f32", "sigma_f32", "shift_numpy", "T_not_square", "T_1d",
        "t_short", "mult_2d", "sigma_two", "t_other_device", "meta_device", "T_strided",
        "shift_strided"])
def test_wrapper_checks_raise(change, error):
    ops = _operands()
    if change == "all on meta":
        ops = {key: x.to("meta") for key, x in ops.items()}
    else:
        ops.update(change)
    T = ops["T"].clone() if torch.is_tensor(ops["T"]) else ops["T"]
    with pytest.raises(error):
        ek.std_expand(**ops)
    if torch.is_tensor(T) and T.device.type == "cpu":
        assert torch.equal(ops["T"], T)  # nothing written


def test_launch_counts_name_both_instantiations_and_reset():
    assert set(ek.launches) == {"std_expand<double>", "std_expand<float>"}
    ek.launches["std_expand<double>"] += 3
    ek.reset_launch_counts()
    assert set(ek.launches.values()) == {0}
