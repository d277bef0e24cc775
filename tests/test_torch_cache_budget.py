"""The port's device-cache budget ledger (``tabmat_torch/_config.py``) and
the routes its refusals take.

The first four tests mirror ``tests/test_cache_budget.py`` on the port's
ledger.  The rest hold the charge sites: a SparseMatrix's pair plan and
densified mirror (``models/sparse.py``) and a DeviceDesign's float32 copy
(``parallel/design.py``), each against its cache-free route and, for the
sparse sandwich, against the JAX package.
"""

import gc

import jax  # noqa: F401  (both packages are imported by the parity tests)
import numpy as np
import pytest
import torch
from scipy import sparse as sps

import tabmat_tpu as tm
import tabmat_torch as tt
from tabmat_torch import _config, glm
from tabmat_torch.bench.generate import make_sparse_matrix
from tabmat_torch.parallel.design import DeviceDesign
from tabmat_torch.utils import tensor_bytes

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_budget():
    _config.set_cache_budget_mb(None)
    _config._cache_refund(_config.cache_spent_bytes())
    yield
    _config.set_cache_budget_mb(None)
    _config._cache_refund(_config.cache_spent_bytes())


def test_unlimited_by_default():
    assert _config.cache_budget_bytes() is None
    assert _config.cache_charge(1 << 40) is True  # never refused
    assert _config.cache_spent_bytes() == 0  # unlimited → nothing ledgered


def test_budget_refuses_past_cap():
    _config.set_cache_budget_mb(1)  # 1 MB
    assert _config.cache_charge(512 * 1024) is True
    assert _config.cache_spent_bytes() == 512 * 1024
    assert _config.cache_charge(768 * 1024) is False  # would exceed
    assert _config.cache_spent_bytes() == 512 * 1024
    assert _config.cache_charge(512 * 1024) is True  # exactly fills
    assert _config.cache_charge(1) is False


def test_refund_on_owner_gc():
    _config.set_cache_budget_mb(1)

    class Owner:
        pass

    o = Owner()
    assert _config.cache_charge(1 << 20, owner=o) is True
    assert _config.cache_charge(1, owner=Owner()) is False
    del o
    gc.collect()
    assert _config.cache_spent_bytes() == 0
    assert _config.cache_charge(1 << 20) is True


def test_budgeted_matrix_still_correct():
    # with a zero budget every cache is refused; results come from the
    # cache-free routes
    _config.set_cache_budget_mb(0)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((500, 8))
    d = rng.random(500)
    m = tt.DenseMatrix(X, device=CPU)
    np.testing.assert_allclose(np.asarray(m.sandwich(d)), X.T @ (d[:, None] * X), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(m.transpose_matvec(d)), X.T @ d, rtol=1e-12)
    assert _config.cache_spent_bytes() == 0


def _sparse(n=2000, k=100):
    """The bench's ``sparse`` design (seed 7, 1%) at ``n`` rows."""
    return make_sparse_matrix(n, k, device=CPU)


def _pair_bytes(m) -> int:
    prod, plan = m._pair_parts()
    return tensor_bytes((prod, plan.perm, plan.bounds))


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_zero_budget_sparse_keeps_no_cache():
    d = np.random.default_rng(1).random(2000)
    free = _sparse()
    want = free.sandwich(d)
    assert free._pair and free._dense is None  # the pair plan served it

    _config.set_cache_budget_mb(0)
    m = _sparse()
    got = m.sandwich(d)
    assert m._pair == () and m._dense is None  # both refused: row panels
    assert _config.cache_spent_bytes() == 0
    _close(got, want)
    ref = tm.SparseMatrix(sps.csc_matrix(m.array_csc)).sandwich(d)
    _close(got, ref)
    # the other ops charge nothing and are unchanged
    v = np.random.default_rng(2).standard_normal(100)
    np.testing.assert_array_equal(m.matvec(v), free.matvec(v))
    assert _config.cache_spent_bytes() == 0


def test_budget_that_fits_the_pair_plan_only():
    d = np.random.default_rng(1).random(2000)
    want = _sparse().sandwich(d)
    pair = _pair_bytes(_sparse())
    mirror = 8 * 2000 * 100
    assert pair < mirror
    _config.set_cache_budget_mb(pair / (1 << 20))
    a = _sparse()
    _close(a.sandwich(d), want)
    assert a._pair and a._dense is None
    assert _config.cache_spent_bytes() == pair
    # the ledger is full: a second matrix gets neither the plan nor the mirror
    b = _sparse()
    _close(b.sandwich(d), want)
    assert b._pair == () and b._dense is None
    assert _config.cache_spent_bytes() == pair


def test_mirror_is_charged_where_the_pair_plan_is_past_its_bounds(monkeypatch):
    from tabmat_torch.models import sparse as sparse_model

    monkeypatch.setattr(sparse_model, "PAIR_SANDWICH_MAX_PAIRS", 0)
    d = np.random.default_rng(1).random(2000)
    _config.set_cache_budget_mb(100)
    m = _sparse()
    S = m.sandwich(d)
    assert m._pair == () and m._dense is not None
    assert _config.cache_spent_bytes() == 8 * 2000 * 100 == tensor_bytes(m._dense)
    A = m.toarray()
    _close(S, A.T @ (d[:, None] * A))


def test_refund_when_a_sparse_matrix_is_collected():
    _config.set_cache_budget_mb(100)
    m = _sparse()
    m.sandwich(np.ones(2000))
    spent = _config.cache_spent_bytes()
    assert spent == _pair_bytes(m) > 0
    del m
    gc.collect()
    assert _config.cache_spent_bytes() == 0


def _design_inputs(seed=3, n=600):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6))
    cat = tt.CategoricalMatrix(rng.integers(0, 5, n), device=CPU)
    mat = tt.SplitMatrix([tt.DenseMatrix(X, device=CPU), cat])
    y = torch.as_tensor(rng.poisson(1.0, n).astype(float))
    w = torch.full((n,), 1.0 / n, dtype=torch.float64)
    beta = torch.as_tensor(rng.standard_normal(mat.shape[1]) * 0.01)
    return mat, y, w, beta


def test_refused_f32_design_is_not_kept_and_the_step_matches():
    mat, y, w, beta = _design_inputs()
    want = glm.irls_step(DeviceDesign.from_matrix(mat), y, w, beta, family="poisson",
                         n_cg=8, inner_precision="float32")

    _config.set_cache_budget_mb(0)
    design = DeviceDesign.from_matrix(mat)
    X32 = design.astype_float(torch.float32)
    assert X32.dtype == torch.float32 and design._f32 is None
    assert design.astype_float(torch.float32) is not X32  # cast anew each call
    got = glm.irls_step(design, y, w, beta, family="poisson", n_cg=8,
                        inner_precision="float32")
    assert design._f32 is None and _config.cache_spent_bytes() == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kept_f32_design_is_charged_its_blocks():
    mat, *_ = _design_inputs()
    _config.set_cache_budget_mb(100)
    design = DeviceDesign.from_matrix(mat)
    X32 = design.astype_float(torch.float32)
    assert design._f32 is X32 and design.astype_float(torch.float32) is X32
    assert _config.cache_spent_bytes() == 4 * 600 * 6  # the dense block in f32
    del design, X32
    gc.collect()
    assert _config.cache_spent_bytes() == 0


def test_env_budget_is_read_lazily(monkeypatch):
    monkeypatch.setenv("TABMAT_TORCH_CACHE_BUDGET_MB", "2")
    monkeypatch.setattr(_config, "_cache_budget", "unset")
    assert _config.cache_budget_bytes() == 2 << 20
    # the JAX package's variable is not the port's
    monkeypatch.setenv("TABMAT_TPU_CACHE_BUDGET_MB", "1")
    monkeypatch.delenv("TABMAT_TORCH_CACHE_BUDGET_MB")
    monkeypatch.setattr(_config, "_cache_budget", "unset")
    assert _config.cache_budget_bytes() is None
