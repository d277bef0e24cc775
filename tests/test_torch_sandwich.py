"""The port's sandwich and range prepass (plain versions on the CPU) against
the Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as their own tests run
them.  Inputs are made from a seed with numpy and handed to both packages.
The CUDA kernel itself is compared with the plain version on the card in
``tests/test_torch_kernels_gpu.py`` and in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tabmat_tpu  # noqa: F401  (x64 on)
from tabmat_tpu.ops import dense_ops as tpu_dense_ops
from tabmat_tpu.ops import pallas_kernels
from tabmat_tpu.ops import pallas_sandwich_v4 as v4

from tabmat_torch import _build
from tabmat_torch.ops import dense_ops, sandwich_kernel as sk

SHAPES = [(3001, 7), (2050, 50)]


def _rand(n, k, seed, scaled=True):
    """Columns over 2^±8 and weights over 2^±4 of both signs, as the v4
    tests draw them, with some zero weights (masked rows)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, k))
    d = rng.random(n) - 0.3
    if scaled:
        X = X * np.exp2(rng.uniform(-8, 8, size=(1, k)))
        d = d * np.exp2(rng.uniform(-4, 4, size=n))
    d[::13] = 0.0
    return X, d


def _relerr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n,k", SHAPES)
def test_plain_f64_matches_v4_interpret(n, k):
    X, d = _rand(n, k, seed=n + k)
    cache = v4.build_plane_cache(jnp.asarray(X))
    S_tpu = v4._sandwich_v4_jit(
        cache.xsh, cache.xsl, cache.bstk, cache.exps, jnp.asarray(d),
        cache.n, cache.k, cache.G, interpret=True,
    )
    S = dense_ops.sandwich(torch.tensor(X), torch.tensor(d))
    assert S.dtype == torch.float64 and S.shape == (k, k)
    assert _relerr(S.numpy(), S_tpu) < 1e-13


@pytest.mark.parametrize("n,k", SHAPES)
def test_plain_f32_matches_pallas_f32_interpret(n, k):
    X, d = _rand(n, k, seed=2 * n + k, scaled=False)
    X32, d32 = X.astype(np.float32), d.astype(np.float32)
    S_tpu = pallas_kernels.dense_sandwich_f32(
        jnp.asarray(X32), jnp.asarray(d32), interpret=True
    )
    S = dense_ops.sandwich(torch.tensor(X32), torch.tensor(d32))
    assert S.dtype == torch.float32
    # the Pallas f32 sandwich's own bar (tests/test_pallas_kernels.py:19)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_tpu), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("n,k", SHAPES)
def test_plain_matches_reference_dense_ops(n, k):
    X, d = _rand(n, k, seed=3 * n + k, scaled=False)
    X = X / np.sqrt(n)  # entries of S near 1, where atol is meaningful
    S_tpu = tpu_dense_ops.sandwich(jnp.asarray(X), jnp.asarray(d))
    S = dense_ops.sandwich(torch.tensor(X), torch.tensor(d))
    np.testing.assert_allclose(S.numpy(), np.asarray(S_tpu), rtol=0, atol=1e-12)


@pytest.mark.parametrize("cols", [None, np.array([4, 0, 2])])
@pytest.mark.parametrize("masked", [False, True])
def test_sandwich_restricted(cols, masked):
    X, d = _rand(500, 6, seed=11, scaled=False)
    mask = None
    rows = np.arange(500)
    if masked:
        rows = np.arange(0, 500, 3)
        m = np.zeros(500)
        m[rows] = 1.0
        mask = torch.tensor(m)
    c = np.arange(6) if cols is None else cols
    sub = X[np.ix_(rows, c)]
    got = dense_ops.sandwich_restricted(torch.tensor(X), torch.tensor(d), mask, cols)
    np.testing.assert_allclose(got.numpy(), (sub * d[rows, None]).T @ sub, atol=1e-12)


def test_transpose_square_dot_weights_matches_reference():
    X, _ = _rand(400, 5, seed=5, scaled=False)
    rng = np.random.default_rng(6)
    w, shift = rng.random(400), rng.standard_normal(5)
    ref = tpu_dense_ops.transpose_square_dot_weights(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(shift)
    )
    got = dense_ops.transpose_square_dot_weights(
        torch.tensor(X), torch.tensor(w), torch.tensor(shift)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_cpu_tensor_takes_the_plain_version():
    X, d = _rand(300, 4, seed=1, scaled=False)
    Xt, dt = torch.tensor(X), torch.tensor(d)
    before = dict(sk.launches)
    assert torch.equal(sk.sandwich(Xt, dt), sk.sandwich_plain(Xt, dt))
    assert sk.launches == before  # no kernel launched on the CPU


def test_empty_rows_give_zeros():
    S = sk.sandwich(torch.zeros((0, 3), dtype=torch.float64), torch.zeros(0, dtype=torch.float64))
    assert torch.equal(S, torch.zeros((3, 3), dtype=torch.float64))


@pytest.mark.parametrize(
    "X,d,err",
    [
        (torch.ones(4, 2), torch.ones(4, dtype=torch.float64), TypeError),
        (torch.ones(4, 2, dtype=torch.int64), torch.ones(4, dtype=torch.int64), TypeError),
        (torch.ones(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64), ValueError),
        (torch.ones(4, 2, dtype=torch.float64), torch.ones(5, dtype=torch.float64), ValueError),
        (np.ones((4, 2)), np.ones(4), TypeError),
        (torch.ones(4, 2, device="meta"), torch.ones(4, device="meta"), ValueError),
    ],
    ids=["dtype-mismatch", "int", "rank", "rows", "numpy", "meta-device"],
)
def test_wrapper_rejects(X, d, err):
    with pytest.raises(err):
        sk.sandwich(X, d)


@pytest.mark.parametrize("n,k", [(1_000_000, 50), (100_003, 200), (5, 3), (10**9, 1)])
def test_absmax_plan_covers_rows_in_one_wave(n, k):
    splits, rps = sk.absmax_plan(n, k, 132)
    col_blocks = -(-k // sk.AM_COLS)
    assert 1 <= splits <= sk.MAX_SPLITS
    assert (splits - 1) * rps < n <= splits * rps
    assert col_blocks * splits <= max(132 * 8, col_blocks)


# -- the range prepass: per-column max |x| * |d| ---------------------------


def _max_prepass_reference(X32, d32):
    """``pallas_sandwich_v4._max_prepass`` in interpret mode, with X in the
    lanes of one row group (G = 1) and |d| in the first sublane."""
    n, k = X32.shape
    n_pad = -(-n // v4.SUB) * v4.SUB
    xsh = np.zeros((n_pad, v4.LANE), np.float32)
    xsh[:n, :k] = X32
    dabs = np.zeros((8, n_pad), np.float32)
    dabs[0, :n] = np.abs(d32)
    m8 = v4._max_prepass(jnp.asarray(xsh), jnp.asarray(dabs), k, 1, interpret=True)
    return np.asarray(m8).max(axis=0)[:k]


@pytest.mark.parametrize("n,k", SHAPES)
def test_column_absmax_matches_max_prepass_interpret(n, k):
    X, d = _rand(n, k, seed=4 * n + k)
    X32, d32 = X.astype(np.float32), d.astype(np.float32)
    ref = _max_prepass_reference(X32, d32)
    got = sk.column_absmax(torch.tensor(X32), torch.tensor(d32.astype(np.float64)))
    assert got.dtype == torch.float64 and got.shape == (k,)
    # the Pallas kernel rounds each product to f32; the port keeps it in f64
    np.testing.assert_allclose(got.numpy(), ref, rtol=2.0**-23, atol=0)


def test_column_absmax_edges():
    X = torch.tensor([[1.0, -2.0], [3.0, 0.5], [-4.0, 1.0]], dtype=torch.float32)
    d = torch.tensor([2.0, -1e40, 0.0], dtype=torch.float64)  # beyond float32
    np.testing.assert_array_equal(sk.column_absmax(X, d).numpy(), [3e40, 5e39])
    d[2] = float("nan")
    assert torch.isnan(sk.column_absmax(X, d)).all()  # NaN propagates
    empty = sk.column_absmax(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.float64))
    assert torch.equal(empty, torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize(
    "X,d,err",
    [
        (torch.ones(4, 2, dtype=torch.float64), torch.ones(4, dtype=torch.float64), TypeError),
        (torch.ones(4, 2), torch.ones(4), TypeError),
        (torch.ones(4, 2), torch.ones(5, dtype=torch.float64), ValueError),
        (torch.ones(4, 2, device="meta"), torch.ones(4, dtype=torch.float64, device="meta"),
         ValueError),
    ],
    ids=["f64-X", "f32-d", "rows", "meta-device"],
)
def test_column_absmax_rejects(X, d, err):
    with pytest.raises(err):
        sk.column_absmax(X, d)


def test_cpu_column_absmax_launches_nothing():
    X, d = _rand(300, 4, seed=2, scaled=False)
    before = dict(sk.launches)
    sk.column_absmax(torch.tensor(X, dtype=torch.float32), torch.tensor(d))
    assert sk.launches == before


def test_launch_counts_reset_and_sum():
    saved = dict(sk.launches)
    try:
        sk.launches.update({"sandwich_narrow<double>": 2, "sandwich_mma<double>": 3,
                            "column_absmax": 4})
        assert sk.sandwich_launches == 5
        sk.reset_launch_counts()
        assert set(sk.launches.values()) == {0} and sk.sandwich_launches == 0
    finally:
        sk.launches.update(saved)


def test_build_flags_and_location():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    path = _build.library_path("sandwich")
    assert path == _build.library_path("sandwich")  # keyed by content
    assert path.parent.parent == _build.BUILD_ROOT
    assert (_build.CSRC / "sandwich.cu").exists()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
