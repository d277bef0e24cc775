"""The CUDA kernels (the sandwiches and their width dispatch, range
prepass, gather, segment sum, sparse segment product, the standardized
sandwich's expansion) against their plain versions, and the default
device, on the card.

Marked ``gpu``: here, without a card, each test skips with its reason.  On
the card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Whether a card is present is decided inside the fixture, never at import,
so every pytest-xdist worker collects the same tests.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import tabmat_torch as tt
from tabmat_torch.ops import sandwich_kernel as sk

pytestmark = pytest.mark.gpu

EDGE_KS = [1, 7, 64, 128, 200]
# f32: ten times the largest full-f32 reading on the card (chip_smoke.F32_TOL)
TOL = {torch.float64: 1e-13, torch.float32: 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    return torch.device("cuda", 0)


def _inputs(n, k, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(n, k, device=device, dtype=dtype, generator=gen)
    d = torch.randn(n, device=device, dtype=dtype, generator=gen)
    d[::5] = 0.0
    return X, d


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", EDGE_KS)
def test_kernel_matches_plain(cuda, k, dtype):
    X, d = _inputs(100_003, k, dtype, cuda, seed=k)
    before = sk.sandwich_launches
    S = sk.sandwich(X, d)
    P = sk.sandwich_plain(X, d)
    torch.cuda.synchronize()
    assert sk.sandwich_launches == before + 1
    assert torch.equal(S, S.T)
    assert float((S - P).abs().max() / P.abs().max()) <= TOL[dtype]


def _held_against_plain(name, wrapper, X, d):
    """Two launches of ``wrapper``: bit-identical, exactly symmetric, within
    the dtype's limit of the plain version; then one that adds into ``out``."""
    before = sk.launches[name]
    S, again = wrapper(X, d), wrapper(X, d)
    P = sk.sandwich_plain(X, d)
    torch.cuda.synchronize()
    assert sk.launches[name] == before + 2
    assert torch.equal(S, again) and torch.equal(S, S.T)
    assert float((S - P).abs().max() / P.abs().max()) <= TOL[X.dtype]
    out = torch.ones_like(S)
    assert wrapper(X, d, out=out) is out
    assert sk.launches[name] == before + 3
    assert torch.equal(out, S + 1)


def _narrow_name(dtype):
    return f"sandwich_narrow<{'double' if dtype == torch.float64 else 'float'}>"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [1, 2, 4, 5, 8, 9, 10, 11, 12, 16, 17, 24, 25, 31, 32])
def test_narrow_kernel_matches_plain(cuda, k, dtype):
    """Every width where the plan changes: whole rows a thread at k <= 10
    (16-, 8-byte and single row loads); past it 2 to 4 column blocks of 8
    in FP64 tensor-core tiles (f64) and 3 to 8 micro-tiles of 4 a side
    (f32), and past k = 15 the splits summed by several blocks; 100,003
    rows end mid-stage; d has zeros and negatives."""
    X, d = _inputs(100_003, k, dtype, cuda, seed=k)
    _held_against_plain(_narrow_name(dtype), sk.sandwich_narrow, X, d)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [2, 5, 10, 32])
@pytest.mark.parametrize("n", [1, 3, 4, 7, 1001])
def test_narrow_kernel_few_rows(cuda, n, k, dtype):
    """One row, fewer rows than one aligned run (4), and a single stage
    that ends off 16 bytes (the threads copy it)."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    X = torch.randn(n, k, device=cuda, dtype=dtype, generator=gen)
    d = torch.rand(n, device=cuda, dtype=dtype, generator=gen) + 0.5
    d[1::3] *= -1.0
    d[2::5] = 0.0
    _held_against_plain(_narrow_name(dtype), sk.sandwich_narrow, X, d)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [5, 10, 32])
def test_narrow_kernel_unaligned_rows(cuda, k, dtype):
    """A contiguous X one element past a 16-byte boundary: every stage is
    copied by the threads, and summed by the same code."""
    X, d = _inputs(100_003, k, dtype, cuda, seed=k)
    shifted = torch.empty(X.numel() + 1, device=cuda, dtype=dtype)[1:].view(X.shape)
    shifted.copy_(X)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    _held_against_plain(_narrow_name(dtype), sk.sandwich_narrow, shifted, d)


def test_narrow_kernel_leaves_its_tickets_at_zero(cuda):
    """The last block sets the ticket counter back to 0, and a second stream
    takes a counter of its own."""
    X, d = _inputs(200_003, 5, torch.float64, cuda, seed=5)
    S = sk.sandwich_narrow(X, d)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        S_side = sk.sandwich_narrow(X, d)
    torch.cuda.synchronize()
    assert torch.equal(S, S_side)
    keys = [key for key in sk._tickets if key[0] == cuda.index]
    assert len(keys) >= 2 and (torch.cuda.current_stream(cuda).cuda_stream in
                               [key[1] for key in keys])
    assert all(int(sk._tickets[key]) == 0 for key in keys)


@pytest.mark.parametrize("k", [33, 49, 50, 63, 64, 65, 100, 128, 160, 175, 176])
def test_tri_kernel_matches_plain(cuda, k):
    """Widths around the micro-tile edge (8), the 16-byte row (k % 4) and
    the block's last micro-tile (176); d has zeros and negatives."""
    X, d = _inputs(100_003, k, torch.float32, cuda, seed=k)
    _held_against_plain("sandwich_tri<float>", sk.sandwich_tri, X, d)


@pytest.mark.parametrize("k", [50, 160])
@pytest.mark.parametrize("n", [1, 7, 40])
def test_tri_kernel_few_rows(cuda, n, k):
    """One row, a few rows, and fewer rows than one stage (51 at k = 160)."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    X = torch.randn(n, k, device=cuda, generator=gen)
    d = torch.rand(n, device=cuda, generator=gen) + 0.5
    d[1::3] *= -1.0
    d[2::5] = 0.0
    _held_against_plain("sandwich_tri<float>", sk.sandwich_tri, X, d)


@pytest.mark.parametrize("k", [177, 178, 180, 200, 255, 256, 257, 1000, 1024])
def test_wide_kernel_matches_plain(cuda, k):
    """Widths around the 128-column tile, the 16-, 8- and 4-byte copies
    (k % 4, k % 2) and a narrow last tile (177: 49 columns); d has zeros
    and negatives."""
    X, d = _inputs(100_003 if k < 1000 else 20_011, k, torch.float32, cuda, seed=k)
    _held_against_plain("sandwich_wide<float>", sk.sandwich_wide, X, d)


@pytest.mark.parametrize("k", [200, 257])
@pytest.mark.parametrize("n", [1, 7, 40])
def test_wide_kernel_few_rows(cuda, n, k):
    """One row, a few rows, and fewer rows than two stages (32 rows each)."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    X = torch.randn(n, k, device=cuda, generator=gen)
    d = torch.rand(n, device=cuda, generator=gen) + 0.5
    d[1::3] *= -1.0
    d[2::5] = 0.0
    _held_against_plain("sandwich_wide<float>", sk.sandwich_wide, X, d)


def test_wide_kernel_unaligned_rows(cuda):
    """A contiguous X at k = 256 that starts 4 bytes past a 16-byte
    boundary: the kernel takes 4-byte copies there."""
    X, d = _inputs(50_001, 256, torch.float32, cuda, seed=3)
    shifted = torch.empty(X.numel() + 1, device=cuda)[1:].view(X.shape)
    shifted.copy_(X)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    _held_against_plain("sandwich_wide<float>", sk.sandwich_wide, shifted, d)


@pytest.mark.parametrize("k", [33, 40, 48, 49, 50, 64, 65, 96, 100, 127, 128])
def test_mma_tri_kernel_matches_plain(cuda, k):
    """Widths around the 8-column and 16-row blocks, the 16-byte copy (odd
    k), the one-group instantiations (96, 100) and the last width (128); d
    has zeros and negatives."""
    X, d = _inputs(100_003, k, torch.float64, cuda, seed=k)
    _held_against_plain("sandwich_mma_tri<double>", sk.sandwich_mma_tri, X, d)


@pytest.mark.parametrize("k", [50, 128])
@pytest.mark.parametrize("n", [1, 7, 40])
def test_mma_tri_kernel_few_rows(cuda, n, k):
    """One row, a few rows, and fewer rows than one stage."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    X = torch.randn(n, k, device=cuda, dtype=torch.float64, generator=gen)
    d = torch.rand(n, device=cuda, dtype=torch.float64, generator=gen) + 0.5
    d[1::3] *= -1.0
    d[2::5] = 0.0
    _held_against_plain("sandwich_mma_tri<double>", sk.sandwich_mma_tri, X, d)


def test_mma_tri_kernel_rejects_float32(cuda):
    X, d = _inputs(100, 50, torch.float32, cuda, seed=1)
    with pytest.raises(TypeError):
        sk.sandwich_mma_tri(X, d)


@pytest.mark.parametrize("k", [129, 137, 160, 200, 255, 256, 257, 1000, 1024])
def test_mma_kernel_matches_plain(cuda, k):
    """Odd widths (8-byte copies), the 128-column tile's edges and a last
    tile of one column (129, 257); d has zeros and negatives; with ``out=``
    the second pass adds S into it."""
    X, d = _inputs(100_003 if k < 1000 else 20_011, k, torch.float64, cuda, seed=k)
    _held_against_plain("sandwich_mma<double>", sk.sandwich_mma, X, d)


@pytest.mark.parametrize("k", [129, 160, 257, 1000])
@pytest.mark.parametrize("n", [1, 7, 40])
def test_mma_kernel_few_rows(cuda, n, k):
    """One row, a few rows, and fewer rows than two stages (32 rows each):
    most pairs' splits then hold no rows and write zeros."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    X = torch.randn(n, k, device=cuda, dtype=torch.float64, generator=gen)
    d = torch.rand(n, device=cuda, dtype=torch.float64, generator=gen) + 0.5
    d[1::3] *= -1.0
    d[2::5] = 0.0
    _held_against_plain("sandwich_mma<double>", sk.sandwich_mma, X, d)


@pytest.mark.parametrize("k", [1025, 2100])
def test_mma_kernel_past_one_band(cuda, k):
    """Past 1024 columns the launch table orders the pairs by bands of 8
    tiles."""
    X, d = _inputs(3_001, k, torch.float64, cuda, seed=k)
    _held_against_plain("sandwich_mma<double>", sk.sandwich_mma, X, d)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [1, 32, 33, 128, 129, 176, 177])
def test_dispatch_launches_the_routed_kernel(cuda, k, dtype):
    X, d = _inputs(5_003, k, dtype, cuda, seed=k)
    name = sk.route(k, dtype)
    before = dict(sk.launches)
    sk.sandwich(X, d)
    assert [key for key in sk.launches if sk.launches[key] != before[key]] == [name]


def test_mma_kernel_rejects_float32(cuda):
    X, d = _inputs(100, 130, torch.float32, cuda, seed=1)
    with pytest.raises(TypeError):
        sk.sandwich_mma(X, d)


def test_sparse_sandwich_past_both_budgets_on_card(cuda, monkeypatch):
    """Row panels densified on the card and summed through the tensor-core
    kernel, against scipy: layouts with int64 bounds (``INT32_MAX`` cut to
    0), which the Gram kernel has no instantiation for."""
    from scipy import sparse as sps

    from tabmat_torch.models import sparse as port_sparse
    from tabmat_torch.ops import sparse_ops

    monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
    monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_ELEMENTS", 3_000 * 700)
    monkeypatch.setattr(sparse_ops, "INT32_MAX", 0)
    rng = np.random.default_rng(6)
    Xs = sps.random(10_007, 700, density=0.02, format="csc", random_state=rng)
    d = rng.random(10_007) - 0.3
    m = tt.SparseMatrix(Xs)
    before = sk.launches["sandwich_mma<double>"]
    S = m.sandwich(d)
    assert sk.launches["sandwich_mma<double>"] == before + 4  # four panels
    ref = (Xs.T @ sps.csr_matrix(Xs.multiply(d[:, None]))).toarray()
    assert np.abs(S - ref).max() / np.abs(ref).max() <= 1e-13
    np.testing.assert_array_equal(S, S.T)
    rows, cols = np.arange(0, 10_007, 2), np.arange(0, 700, 7)
    sub = Xs.tocsr()[rows][:, cols]
    sub_ref = (sub.T @ sps.csr_matrix(sub.multiply(d[rows, None]))).toarray()
    got = m.sandwich(d, rows=rows, cols=cols)  # 100 columns: the f64 triangle kernel
    assert np.abs(got - sub_ref).max() / np.abs(sub_ref).max() <= 1e-13


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(4_000, 1_000, 0.01), (4_000, 30_000, 0.01)],
                         ids=["sparse_wide_cut_down", "wider_than_a_chunk"])
def test_sparse_gram_matches_plain_and_repeats(cuda, shape, dtype):
    """``sparse_gram<T>`` against its plain version on the card: the
    benchmark's ``sparse_wide`` design cut to 4,000 rows and 1,000 columns,
    and a 1% design of 30,000 columns (15 chunks of the kernel's
    accumulator); exactly symmetric, bit for bit across two launches."""
    from scipy import sparse as sps

    from tabmat_torch.ops import sparse_gram_kernel as gk
    from tabmat_torch.ops import sparse_ops

    n, k, density = shape
    rng = np.random.default_rng(k)
    X = sps.random(n, k, density=density, format="csc", random_state=rng).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    csr_parts = sparse_ops.compressed_layout(X.tocsr(), k, cuda)
    csc_parts = sparse_ops.compressed_layout(X, n, cuda)
    d = torch.as_tensor(rng.random(n) - 0.3, dtype=dtype, device=cuda)
    d[::7] = 0.0
    name = f"sparse_gram<{'double' if dtype == torch.float64 else 'float'}>"
    before = gk.launches[name]
    first = gk.sparse_gram(*csr_parts, *csc_parts, d)
    second = gk.sparse_gram(*csr_parts, *csc_parts, d)
    torch.cuda.synchronize()
    assert gk.launches[name] == before + 2
    assert torch.equal(first, first.T) and torch.equal(first, second)
    data, plan = csr_parts
    want = gk.sparse_gram_plain(data.double(), plan.perm, plan.bounds, d.double(), k)
    assert float((first.double() - want).abs().max() / want.abs().max()) <= TOL[dtype]


def test_sparse_sandwich_takes_the_gram_kernel_on_card(cuda):
    """Past both budgets a 1% matrix takes ``sparse_gram<double>``, one launch
    a sandwich and no panel; against scipy, with ``rows=`` and ``cols=``."""
    from scipy import sparse as sps

    from tabmat_torch.ops import sparse_gram_kernel as gk

    rng = np.random.default_rng(8)
    Xs = sps.random(20_000, 9_000, density=0.01, format="csc", random_state=rng)
    d = rng.random(20_000) - 0.3
    m = tt.SparseMatrix(Xs)
    assert m._pair_parts() is None and m._dense_mirror() is None
    before, panels = gk.launches["sparse_gram<double>"], sk.launches["sandwich_mma<double>"]
    S = m.sandwich(d)
    assert gk.launches["sparse_gram<double>"] == before + 1
    assert sk.launches["sandwich_mma<double>"] == panels
    np.testing.assert_array_equal(S, S.T)
    ref = (Xs.T @ sps.csr_matrix(Xs.multiply(d[:, None]))).toarray()
    assert np.abs(S - ref).max() / np.abs(ref).max() <= 1e-13
    rows, cols = np.arange(0, 20_000, 3), np.sort(rng.choice(9_000, 700, replace=False))
    sub = Xs.tocsr()[rows][:, cols]
    sub_ref = (sub.T @ sps.csr_matrix(sub.multiply(d[rows, None]))).toarray()
    got = m.sandwich(d, rows=rows, cols=cols)
    assert gk.launches["sparse_gram<double>"] == before + 2
    assert np.abs(got - sub_ref).max() / np.abs(sub_ref).max() <= 1e-13


def test_sparse_gram_tables_follow_the_cache_ledger_on_card(cuda):
    """The Gram kernel's tables stay on the card where the device-cache
    ledger takes their bytes, and are built a call at a time where it
    refuses them (a zero budget): the same S either way."""
    from scipy import sparse as sps

    from tabmat_torch import _config
    from tabmat_torch.ops import sparse_gram_kernel as gk

    # 9,000 columns: past the pair plan's k² segments and the densified matrix
    Xs = sps.random(6_000, 9_000, density=0.01, format="csc",
                    random_state=np.random.default_rng(9))
    d = np.random.default_rng(10).random(6_000)
    _config._cache_refund(_config.cache_spent_bytes())
    try:
        _config.set_cache_budget_mb(1 << 20)
        kept = tt.SparseMatrix(Xs)
        S = kept.sandwich(d)
        nbytes = gk.table_bytes(kept._csr_parts()[1], kept._csc_parts()[1])
        assert kept._gram and _config.cache_spent_bytes() == nbytes
        assert [key[0] for key in kept._csc_parts()[1].tables] == ["sparse_gram"]
        _config.set_cache_budget_mb(0)
        refused = tt.SparseMatrix(Xs)
        np.testing.assert_array_equal(refused.sandwich(d), S)
        np.testing.assert_array_equal(refused.sandwich(d), S)
        assert refused._gram is False and not refused._csc_parts()[1].tables
        assert _config.cache_spent_bytes() == nbytes
    finally:
        _config.set_cache_budget_mb(None)
        _config._cache_refund(_config.cache_spent_bytes())


def test_sparse_gram_refuses_int64_bounds_on_card(cuda):
    from scipy import sparse as sps

    from tabmat_torch.ops import sparse_gram_kernel as gk
    from tabmat_torch.ops import sparse_ops
    from tabmat_torch.ops.segments import SegmentPlan

    X = sps.random(100, 50, density=0.1, format="csc", random_state=np.random.default_rng(1))
    data, plan = sparse_ops.compressed_layout(X.tocsr(), 50, cuda)
    wide = SegmentPlan(plan.perm, plan.bounds.long(), plan.n_rows)
    with pytest.raises(TypeError, match="int32 bounds"):
        gk.sparse_gram(data, wide, *sparse_ops.compressed_layout(X, 100, cuda),
                       torch.ones(100, dtype=torch.float64, device=cuda))


@pytest.mark.parametrize("k", EDGE_KS)
def test_column_absmax_matches_plain(cuda, k):
    X, d = _inputs(100_003, k, torch.float32, cuda, seed=k)
    d = d.double()
    d[3] = 1e300  # beyond float32
    before = sk.launches["column_absmax"]
    got = sk.column_absmax(X, d)
    assert sk.launches["column_absmax"] == before + 1
    assert torch.equal(got, sk.column_absmax_plain(X, d))
    d[7] = float("nan")
    assert torch.isnan(sk.column_absmax(X, d)).all()


def test_kernel_rejects_noncontiguous(cuda):
    X, d = _inputs(1000, 8, torch.float64, cuda, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        sk.sandwich(X.T.contiguous().T, d)
    with pytest.raises(ValueError, match="contiguous"):
        sk.column_absmax(X.float().T.contiguous().T, d)


def test_empty_rows_launch_nothing(cuda):
    before = sk.sandwich_launches
    S = sk.sandwich(torch.zeros((0, 4), device=cuda, dtype=torch.float64),
                    torch.zeros(0, device=cuda, dtype=torch.float64))
    assert sk.sandwich_launches == before
    assert torch.equal(S.cpu(), torch.zeros((4, 4), dtype=torch.float64))


def test_dense_matrix_on_card(cuda):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((20_001, 9))
    d = rng.random(20_001) - 0.5
    dm = tt.DenseMatrix(X, device=cuda)
    rows, cols = np.arange(0, 20_001, 3), np.array([8, 0, 4])
    sub = X[np.ix_(rows, cols)]
    got = dm.sandwich(d, rows=rows, cols=cols)
    np.testing.assert_allclose(got, (sub * d[rows, None]).T @ sub, rtol=1e-12, atol=1e-12)
    before = dict(sk.launches)
    beta, _ = tt.fit_glm(dm, X @ rng.standard_normal(9), max_iter=2, tol=0.0)
    assert beta.device.type == "cuda"
    # the default float32 inner step: the prepass, then the f32 sandwich of
    # the width dispatch (k = 9: the narrow kernel)
    name = sk.route(9, torch.float32)
    assert name == "sandwich_narrow<float>"
    assert sk.launches[name] >= before[name] + 2
    assert sk.launches["column_absmax"] >= before["column_absmax"] + 2


def test_f32_step_with_weights_beyond_float32(cuda):
    from tabmat_torch import glm
    from tabmat_torch.parallel.design import DeviceDesign

    rng = np.random.default_rng(1)
    X = rng.standard_normal((50_001, 6))
    design = DeviceDesign.from_matrix(tt.DenseMatrix(X, device=cuda))
    y = torch.as_tensor(X @ rng.standard_normal(6), device=cuda)
    w = torch.full((50_001,), 1e40, dtype=torch.float64, device=cuda)
    b0 = torch.zeros(6, dtype=torch.float64, device=cuda)
    steps = {inner: glm.irls_step(design, y, w, b0, n_cg=8, inner_precision=inner)
             for inner in ("float32", "float64")}
    assert torch.isfinite(steps["float32"]).all()
    rel = (steps["float32"] - steps["float64"]).abs().max() / steps["float64"].abs().max()
    assert float(rel) < 1e-4


def test_default_device_is_the_card(cuda):
    """Asked for no device, the constructors and the fit put their data on the card."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((1000, 3))
    codes = rng.integers(0, 5, 1000)
    assert tt.DenseMatrix(X).device.type == "cuda"
    cat = tt.CategoricalMatrix(codes, categories=np.arange(5))
    assert cat.device.type == "cuda"
    split = tt.SplitMatrix([tt.DenseMatrix(X), cat])
    assert split.device.type == "cuda"
    beta, _ = tt.fit_glm(X, X @ np.ones(3), max_iter=2, tol=0.0)
    assert beta.device.type == "cuda"
    est = tt.GeneralizedLinearRegressor(max_iter=2).fit(split, rng.random(1000))
    assert est.coef_.shape == (8,)
    # numpy input to the estimator: the intercept column and X go to the card
    est = tt.GeneralizedLinearRegressor(max_iter=2)
    assert est._design(X).device.type == "cuda"
    assert np.all(np.isfinite(est.fit(X, rng.random(1000)).coef_))


_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 7, 8, 9])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 7, 33, 100_003])
def test_gather_matches_plain_exactly(cuda, n, offset, C, dtype):
    """Every n % 4 (a thread takes runs of 4 rows in f32, 2 in f64), codes
    views at offsets of 0 to 3 elements (planes off their runs' alignment,
    each by its own amount) and past 3 planes (taken a plane at a time): bit
    for bit the plain version, and again on a second launch."""
    from tabmat_torch.ops import gather_kernel as gk

    rng = np.random.default_rng(C)
    width = 777
    flat = torch.as_tensor(rng.integers(-3, width + 3, C * n + offset).astype(np.int32),
                           device=cuda)
    codes = flat[offset:]
    table = torch.as_tensor(rng.standard_normal(width), dtype=dtype, device=cuda)
    name = f"gather<{'double' if dtype == torch.float64 else 'float'}>"
    before = gk.launches[name]
    got, again = gk.gather(table, codes, n), gk.gather(table, codes, n)
    assert gk.launches[name] == before + 2
    bits = _BITS[dtype]
    assert torch.equal(got.view(bits), gk.gather_plain(table, codes, n).view(bits))
    assert torch.equal(got.view(bits), again.view(bits))
    # an empty table (drop_first of a single level) gathers zeros
    assert torch.equal(gk.gather(table[:0], codes, n), torch.zeros_like(got))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_gather_edge_cases_match_plain_exactly(cuda, dtype):
    """chip_smoke.py's phase-3 gather cases at 100,003 rows: all-sentinel
    codes, an empty table, a 100,000-entry table, -0.0 with inf and NaN
    behind the sentinels, among the others; bit for bit, and repeated."""
    from tabmat_torch.ops import gather_kernel as gk

    bits = _BITS[dtype]
    for label, table, codes, n in _chip_smoke().gather_cases(
            np.random.default_rng(5), cuda, dtype, 100_003):
        got, again = gk.gather(table, codes, n), gk.gather(table, codes, n)
        want = gk.gather_plain(table, codes, n)
        assert torch.equal(got.view(bits), want.view(bits)), label
        assert torch.equal(got.view(bits), again.view(bits)), label


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("m", [1, 5, 8, 9, 50])
@pytest.mark.parametrize("W", [1, 7, 1000, "stacked", 1_000_000, "one_tile"])
@pytest.mark.parametrize("n", [100_003, 1_000_000])
def test_segsum_matches_plain_and_repeats(cuda, n, W, m, dtype):
    """chip_smoke.py's phase-3 plans: sentinels and empty segments, the
    stacked plan of two 1000-level categoricals, 10^6 segments (the slots
    route) and rows that all fall in one tile."""
    from tabmat_torch.ops import segsum_kernel as ssk

    rng = np.random.default_rng(m + (0 if isinstance(W, str) else W))
    plan = _chip_smoke().segsum_plan(rng, n, W, cuda)
    gen = torch.Generator(device=cuda).manual_seed(m)
    shape = (n,) if m == 1 else (n, m)
    v = torch.randn(shape, dtype=dtype, device=cuda, generator=gen)
    before = dict(ssk.launches)
    first, second = ssk.segsum(v, plan), ssk.segsum(v, plan)
    rose = {k: ssk.launches[k] - before[k] for k in before if ssk.launches[k] != before[k]}
    T = "double" if dtype == torch.float64 else "float"
    assert rose in ({f"segsum<{T}>": 2}, {f"segsum_slots<{T}>": 2})
    if W == 1_000_000:
        assert rose == {f"segsum_slots<{T}>": 2}
    if W == "stacked" and n == 1_000_000:
        assert rose == {f"segsum<{T}>": 2}
    assert torch.equal(first, second)
    want = ssk.segsum_plain(v, plan.perm, plan.bounds)
    scale = ssk.segsum_plain(v.abs().double(), plan.perm, plan.bounds).clamp_min(1e-300)
    rel = float(((first.double() - want.double()).abs() / scale).max())
    assert rel <= TOL[dtype]


@pytest.mark.parametrize("m", [1, 5])
def test_segsum_of_a_view_off_16_bytes(cuda, m):
    """Values one element into their storage: the tiles take cp.async
    copies instead of the bulk ones, and the sums stay the same."""
    from tabmat_torch.ops import segsum_kernel as ssk

    rng = np.random.default_rng(m)
    n = 100_003
    plan = _chip_smoke().segsum_plan(rng, n, "stacked", cuda)
    gen = torch.Generator(device=cuda).manual_seed(m)
    base = torch.randn((n + 1) * m, dtype=torch.float64, device=cuda, generator=gen)
    v = base[m:].view(n, m) if m > 1 else base[1:]
    assert v.data_ptr() % 16 != 0 and v.is_contiguous()
    got = ssk.segsum(v, plan)
    assert torch.equal(got, ssk.segsum(v.clone(), plan))


def _spmv_layout(rng, lengths, n_src, cuda):
    from tabmat_torch.ops.segments import SegmentPlan

    bounds = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    idx = rng.integers(0, n_src, int(bounds[-1])).astype(np.int32)
    return SegmentPlan(torch.as_tensor(idx, device=cuda), torch.as_tensor(bounds, device=cuda),
                       n_src)


# merge items per tile of csrc/spmv.cu: 128 threads x 7 for m = 1, 256 x 3
# for m > 1 (groups of 4 columns in f64, 8 in f32)
SPMV_TILE = {1: 128 * 7, "m>1": 256 * 3}


@pytest.mark.parametrize("bounds", ["int32", "int64"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("with_scale", [False, True], ids=["a", "a*scale"])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 17])
@pytest.mark.parametrize("layout", ["empty_and_long", "one_segment", "mostly_empty",
                                    "ends_on_tile_edges", "long_among_empties", "w1_e1",
                                    "trailing_empties"])
def test_spmv_matches_plain_and_repeats(cuda, layout, m, with_scale, dtype, bounds):
    """Each instantiation against its plain version; the int64-bounds one
    (``spmv<T,int64>``) also bit for bit the int32 one on the same layout."""
    from tabmat_torch.ops import spmv_kernel as spk
    from tabmat_torch.ops.segments import SegmentPlan

    rng = np.random.default_rng(m + 10 * with_scale)
    n_src = 50_003
    tile = SPMV_TILE[1 if m == 1 else "m>1"]
    lengths = {
        "empty_and_long": np.r_[0, 0, rng.integers(0, 40, 20_000), 0, 70_000, 0],
        "one_segment": [123_457],
        "mostly_empty": np.where(rng.random(300_000) < 0.03, rng.integers(1, 5, 300_000), 0),
        # a segment of tile - 1 elements ends on a tile's last merge item,
        # one of tile elements on the next tile's first
        "ends_on_tile_edges": np.r_[[tile - 1] * 4, [tile] * 3, 0, [tile - 1] * 2, 0, 0,
                                    [2 * tile - 1] * 2],
        "long_among_empties": np.r_[[0] * 5000, 200 * tile, [0] * 5000],
        "w1_e1": [1],
        "trailing_empties": np.r_[rng.integers(0, 30, 3000), [0] * 20_000],
    }[layout]
    plan = _spmv_layout(rng, lengths, n_src, cuda)
    E = plan.perm.shape[0]
    shape = (n_src,) if m == 1 else (n_src, m)
    v = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    a = torch.as_tensor(rng.standard_normal(E), dtype=dtype, device=cuda)
    scale = (torch.as_tensor(rng.random(n_src) + 0.5, dtype=dtype, device=cuda)
             if with_scale else None)
    name = f"spmv<{'double' if dtype == torch.float64 else 'float'}>"
    if bounds == "int64":
        narrow = spk.spmv(v, plan, a, scale)
        plan = SegmentPlan(plan.perm, plan.bounds.long(), n_src)
        name = name[:-1] + ",int64>"
    before = spk.launches[name]
    first, second = spk.spmv(v, plan, a, scale), spk.spmv(v, plan, a, scale)
    assert spk.launches[name] == before + 2
    assert torch.equal(first, second)
    if bounds == "int64":
        assert torch.equal(first, narrow)
    want = spk.spmv_plain(v, plan.perm, plan.bounds, a, scale)
    mag = spk.spmv_plain(v.abs().double(), plan.perm, plan.bounds, a.abs().double(),
                         None if scale is None else scale.abs().double()).clamp_min(1e-300)
    assert float(((first.double() - want.double()).abs() / mag).max()) <= TOL[dtype]
    empty = torch.as_tensor(np.asarray(lengths) == 0, device=cuda)
    assert not first[empty].any()


def test_spmv_rejects_noncontiguous_and_launches_nothing_when_empty(cuda):
    from tabmat_torch.ops import spmv_kernel as spk

    rng = np.random.default_rng(3)
    plan = _spmv_layout(rng, [3, 0, 5], 10, cuda)
    a = torch.ones(8, dtype=torch.float64, device=cuda)
    V = torch.zeros(4, 10, dtype=torch.float64, device=cuda).T
    with pytest.raises(ValueError, match="contiguous"):
        spk.spmv(V, plan, a)
    empty = _spmv_layout(rng, [0, 0], 10, cuda)
    before = dict(spk.launches)
    got = spk.spmv(torch.ones(10, device=cuda, dtype=torch.float64), empty,
                   torch.zeros(0, dtype=torch.float64, device=cuda))
    assert spk.launches == before and torch.equal(got.cpu(), torch.zeros(2, dtype=torch.float64))


def test_sparse_design_on_card(cuda):
    """A dense + sparse + categorical design built for the card: its ops
    launch spmv<T>, and the f64 Hessian is exactly symmetric."""
    from scipy import sparse as sps

    from tabmat_torch.ops import spmv_kernel as spk
    from tabmat_torch.parallel.design import DeviceDesign

    rng = np.random.default_rng(4)
    n = 100_003
    Xs = sps.random(n, 40, density=0.02, format="csc", random_state=rng)
    split = tt.SplitMatrix([tt.DenseMatrix(rng.standard_normal((n, 3))), tt.SparseMatrix(Xs),
                            tt.CategoricalMatrix(rng.integers(0, 30, n), categories=np.arange(30))])
    design = DeviceDesign.from_matrix(split)
    assert design.device.type == "cuda" and design.supports_sandwich
    w = torch.as_tensor(rng.random(n), device=cuda)
    before = dict(spk.launches)
    H = design.sandwich(w)
    H32 = design.astype_float(torch.float32).sandwich(w.float())
    torch.cuda.synchronize()
    assert spk.launches["spmv<double>"] == before["spmv<double>"] + 3
    assert spk.launches["spmv<float>"] == before["spmv<float>"] + 3
    assert torch.equal(H, H.T)
    X = split.toarray()
    H_ref = (X * w.cpu().numpy()[:, None]).T @ X
    assert float((H.cpu() - torch.as_tensor(H_ref)).abs().max() / np.abs(H_ref).max()) <= 1e-13
    assert float((H32.double().cpu() - torch.as_tensor(H_ref)).abs().max()
                 / np.abs(H_ref).max()) <= 2e-5
    sm = tt.SparseMatrix(Xs)
    v = rng.standard_normal(40)
    np.testing.assert_allclose(sm.matvec(v), Xs @ v, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sm.sandwich(np.ones(n)), (Xs.T @ Xs).toarray(), rtol=0,
                               atol=1e-11)


def test_sparse_design_past_the_limit_on_card(cuda, monkeypatch):
    """The same design with ``sparse_ops.INT32_MAX`` lowered below its
    layouts' sizes: every sparse op launches ``spmv<T,int64>`` and none
    ``spmv<T>``, and each result is bit for bit the int32 layouts' one."""
    from scipy import sparse as sps

    from tabmat_torch.ops import sparse_ops
    from tabmat_torch.ops import spmv_kernel as spk
    from tabmat_torch.parallel.design import DeviceDesign

    rng = np.random.default_rng(5)
    n = 100_003
    Xs = sps.random(n, 40, density=0.02, format="csc", random_state=rng)
    Xd, codes = rng.standard_normal((n, 3)), rng.integers(0, 30, n)
    w = torch.as_tensor(rng.random(n), device=cuda)
    v = torch.as_tensor(rng.standard_normal(3 + 40 + 30), device=cuda)
    results = {}
    for limit in (sparse_ops.INT32_MAX, 1000):
        monkeypatch.setattr(sparse_ops, "INT32_MAX", limit)
        design = DeviceDesign.from_matrix(tt.SplitMatrix([
            tt.DenseMatrix(Xd), tt.SparseMatrix(Xs),
            tt.CategoricalMatrix(codes, categories=np.arange(30))]))
        before = dict(spk.launches)
        results[limit] = [design.sandwich(w), design.matvec(v), design.transpose_matvec(w),
                          design.astype_float(torch.float32).sandwich(w.float())]
        torch.cuda.synchronize()
        launched = {k: spk.launches[k] - before[k] for k in before}
        wide = limit == 1000
        assert launched["spmv<double,int64>"] == (5 if wide else 0)
        assert launched["spmv<float,int64>"] == (3 if wide else 0)
        assert launched["spmv<double>"] == (0 if wide else 5)
        assert launched["spmv<float>"] == (0 if wide else 3)
    for narrow, wide in zip(*results.values()):
        assert torch.equal(narrow, wide)


@pytest.mark.parametrize("W", [1, 22, 1000, 10**6])
def test_plan_sorted_on_the_card_is_the_host_plan(cuda, W):
    """``build_plan``'s stable sort on the card, from host keys, int64 or
    int32 keys on the card, gives the plan of its sort on the CPU (which the
    CPU tests hold to the JAX package's host argsort) bit for bit, and a
    categorical's cross plan, its keys combined on the card, the plan of
    ``_native.combine_codes``'s keys."""
    from tabmat_torch import _native
    from tabmat_torch.ops.segments import build_plan

    rng = np.random.default_rng(W)
    keys = rng.integers(-1, W + 2, 678_013)
    host = build_plan(keys, W, "cpu")
    for given in (keys, torch.as_tensor(keys, device=cuda),
                  torch.as_tensor(keys.astype(np.int32), device=cuda)):
        plan = build_plan(given, W, cuda)
        assert plan.perm.device == plan.bounds.device == cuda
        assert plan.perm.dtype == plan.bounds.dtype == torch.int32
        assert torch.equal(plan.perm.cpu(), host.perm)
        assert torch.equal(plan.bounds.cpu(), host.bounds)
    k2 = 1000 if W > 1000 else 7
    a = tt.CategoricalMatrix(rng.integers(-1, 1000, 678_013), categories=np.arange(1000),
                             drop_first=True, cat_missing_method="zero", device=cuda)
    b = tt.CategoricalMatrix(rng.integers(-1, k2, 678_013), categories=np.arange(k2),
                             cat_missing_method="zero", device=cuda)
    cross, _ = a._cross_plan(b)
    combined = _native.combine_codes(a._eff_codes_np, b._eff_codes_np, b.shape[1])
    host = build_plan(combined, a.shape[1] * b.shape[1], "cpu")
    assert torch.equal(cross.perm.cpu(), host.perm)
    assert torch.equal(cross.bounds.cpu(), host.bounds)


# -- the explicit-Hessian CG solve, replayed as a CUDA graph ------------------


def _spd(k, dtype, device, seed):
    """A symmetric positive definite (k, k) ``H`` and a ``b``, in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn(k, k, device=device, dtype=torch.float64, generator=gen)
    H = A @ A.T / k + torch.eye(k, device=device, dtype=torch.float64)
    b = torch.randn(k, device=device, dtype=torch.float64, generator=gen)
    return ((H + H.T) / 2).to(dtype).contiguous(), b.to(dtype)


def _eager_cg(H, b, n_iter):
    from tabmat_torch import glm

    return glm._cg_solve(lambda v: H @ v, b, n_iter)


@pytest.fixture
def graph_counters():
    """``_trace`` on and the graph cache empty for the test; yields a
    function returning the counters recorded so far."""
    from tabmat_torch import _trace, glm

    glm._cg_graphs.clear()
    _trace.disable()
    _trace.take()
    _trace.enable()
    seen = {}

    def counters():
        seen.update({k: seen.get(k, 0) + v for k, v in _trace.take()["counters"].items()})
        return dict(seen)

    yield counters
    _trace.disable()
    _trace.take()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n_iter", [1, 8, 100])
@pytest.mark.parametrize("k", [1, 7, 43, 300])
def test_cg_graph_is_the_eager_loop_bit_for_bit(cuda, k, n_iter, dtype):
    """The captured call and a replay each give the eager loop's result, bit
    for bit."""
    from tabmat_torch import glm

    H, b = _spd(k, dtype, cuda, seed=k * 1000 + n_iter)
    want = _eager_cg(H, b, n_iter)
    first, again = glm._cg_solve_dense(H, b, n_iter), glm._cg_solve_dense(H, b, n_iter)
    torch.cuda.synchronize()
    bits = _BITS[dtype]
    assert torch.isfinite(want).all()
    assert torch.equal(first.view(bits), want.view(bits))
    assert torch.equal(again.view(bits), want.view(bits))


def test_cg_graph_new_inputs_and_results_held_apart(cuda, graph_counters):
    """A replay with a new H and b gives their answer, not the last one; two
    results held at once are two tensors, neither the graph's own buffer."""
    from tabmat_torch import glm

    (H1, b1), (H2, b2) = _spd(43, torch.float32, cuda, 1), _spd(43, torch.float32, cuda, 2)
    x1 = glm._cg_solve_dense(H1, b1, 100)
    x2 = glm._cg_solve_dense(H2, b2, 100)
    want1, want2 = _eager_cg(H1, b1, 100), _eager_cg(H2, b2, 100)
    torch.cuda.synchronize()
    assert torch.equal(x1, want1) and torch.equal(x2, want2)
    assert not torch.equal(x1, x2)
    x_static = glm._cg_graphs[(cuda, torch.float32, 43, 100)][3]
    ptrs = {x1.data_ptr(), x2.data_ptr(), x_static.data_ptr()}
    assert len(ptrs) == 3
    assert graph_counters() == {"cg_graph_captures": 1, "cg_graph_replays": 2}


def test_cg_graph_captured_once_per_key(cuda, graph_counters):
    """One capture for each (device, dtype, k, n_iter), every call a replay;
    the cache keeps the most recently used entries and no more."""
    from tabmat_torch import glm

    calls = [(43, torch.float32, 100)] * 3 + [(7, torch.float32, 100), (43, torch.float64, 100),
                                              (43, torch.float32, 8), (43, torch.float32, 100)]
    for k, dtype, n_iter in calls:
        H, b = _spd(k, dtype, cuda, seed=k)
        glm._cg_solve_dense(H, b, n_iter)
    assert graph_counters() == {"cg_graph_captures": 4, "cg_graph_replays": len(calls)}
    H, b = _spd(9, torch.float64, cuda, seed=9)
    glm._cg_solve_dense(H, b, 5)
    assert len(glm._cg_graphs) == glm._CG_GRAPHS_KEPT
    # the least recently used key, (7, float32, 100), went
    assert (cuda, torch.float32, 7, 100) not in glm._cg_graphs
    assert (cuda, torch.float32, 43, 100) in glm._cg_graphs
    assert graph_counters() == {"cg_graph_captures": 5, "cg_graph_replays": len(calls) + 1}


def test_cg_graph_shared_by_threads_and_streams(cuda, graph_counters):
    """Sixteen threads, every other one on a stream of its own, each solving
    its own system twenty times through one graph, the interpreter switching
    threads every microsecond: every result is its own system's."""
    import sys
    import threading

    from tabmat_torch import glm

    systems = [_spd(43, torch.float32, cuda, seed=100 + i) for i in range(16)]
    wants = [_eager_cg(H, b, 100) for H, b in systems]
    glm._cg_solve_dense(*systems[0], 100)  # the capture, before the threads
    torch.cuda.synchronize()
    wrong, raised = [], []

    def work(i):
        try:
            stream = torch.cuda.Stream() if i % 2 else torch.cuda.current_stream()
            with torch.cuda.stream(stream):
                got = [glm._cg_solve_dense(*systems[i], 100) for _ in range(20)]
            stream.synchronize()
            wrong.extend(i for x in got if not torch.equal(x, wants[i]))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            raised.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert raised == [] and wrong == []
    assert graph_counters() == {"cg_graph_captures": 1, "cg_graph_replays": 1 + 16 * 20}


def test_cg_graph_inside_a_callers_capture_runs_eagerly(cuda, graph_counters):
    """While the stream is captured into a caller's graph the solve is the
    eager loop, recorded into that graph."""
    from tabmat_torch import glm

    H, b = _spd(43, torch.float64, cuda, seed=3)
    want = _eager_cg(H, b, 8)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _eager_cg(H, b, 8)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer, stream=stream):
        x = glm._cg_solve_dense(H, b, 8)
    outer.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, want)
    assert graph_counters() == {}


@pytest.mark.parametrize("inner", ["float32", "float64"])
def test_fit_glm_with_the_cg_graph_is_the_eager_fit(cuda, monkeypatch, graph_counters, inner):
    """``fit_glm`` on the smoke's freMTPL2-shaped design (its formula, 678,013
    rows) at the benchmark's settings: the same beta bit for bit and the same
    number of steps with the graph as with the eager solve; one capture, a
    replay a step."""
    from tabmat_torch import glm
    from tabmat_torch.parallel.design import DeviceDesign

    cs = _chip_smoke()
    frame = cs.freq_frame(cs.FREQ_N, np.random.default_rng(6))
    X = tt.from_formula(cs.FREQ_FORMULA, frame, include_intercept=True, ensure_full_rank=True,
                        device=cuda)
    design = DeviceDesign.from_matrix(X)
    y = frame["ClaimNb"].to_numpy(np.float64)
    exposure = frame["Exposure"].to_numpy(np.float64)
    ps = np.r_[0.0, np.ones(design.shape[1] - 1)]

    def fit():
        return tt.fit_glm(design, y, sample_weight=exposure, family="poisson", max_iter=50,
                          tol=1e-8, n_cg=100, l2=6.78, inner_precision=inner, penalty_scale=ps)

    beta, n_iter = fit()
    counters = graph_counters()
    assert counters["cg_graph_captures"] == 1
    assert counters["cg_graph_replays"] == counters["steps"] == n_iter
    monkeypatch.setattr(glm, "_cg_solve_dense", _eager_cg)
    eager, eager_iter = fit()
    assert 1 < n_iter < 50 and n_iter == eager_iter
    assert torch.equal(beta, eager)


def test_sharded_irls_with_the_cg_graph_on_card(cuda):
    """The user path's sharded step and fit (``tests/torch_multichip_cases``)
    on eight gloo ranks sharing the card: on every rank the graph's results
    are the eager solve's bit for bit and every rank holds the same bits; the
    steps are within the multi-device tests' limits of the one-device step
    on the card; each rank captured once a key and replayed a step."""
    import torch_multichip_cases as cases

    from tabmat_torch import glm
    from tabmat_torch.parallel import launch
    from tabmat_torch.parallel.design import DeviceDesign

    ranks = launch.run(cases.graph_step_cases, cases.WORLD, "gloo", None, timeout=600)
    first = ranks[0]
    assert first["supports_sandwich"]
    for got in ranks:
        for inner in cases.INNER:
            assert np.array_equal(got[f"step_{inner}_graph"], got[f"step_{inner}_eager"])
            assert np.array_equal(got[f"step_{inner}_graph"], first[f"step_{inner}_graph"])
        assert np.array_equal(got["fit_glm_graph"][0], got["fit_glm_eager"][0])
        assert got["fit_glm_graph"][1] == got["fit_glm_eager"][1]
        graph = got["counters_graph"]
        # two steps and the fit's steps; keys (float64, 5), (float32, 5), (float64, 16)
        assert graph["cg_graph_captures"] == 3
        assert graph["cg_graph_replays"] == graph["steps"] == 2 + got["fit_glm_graph"][1]
        assert "cg_graph_replays" not in got["counters_eager"]
    p = cases.user_problem()
    whole = DeviceDesign.from_matrix(cases.user_split(p, tt, device=cuda))
    y = torch.as_tensor(p["y"]["poisson"], device=cuda)
    ones = torch.ones_like(y)
    b0 = torch.zeros(whole.shape[1], dtype=torch.float64, device=cuda)
    for inner in cases.INNER:
        single = glm.irls_step(whole, y, ones, b0, family="poisson", n_cg=cases.N_CG,
                               inner_precision=inner).cpu().numpy()
        got = first[f"step_{inner}_graph"]
        if inner == "float64":
            np.testing.assert_allclose(got, single, rtol=1e-8, atol=1e-10)
        else:
            assert np.abs(got - single).max() <= 1e-4 * np.abs(single).max()


# -- the Hessian-vector CG solve, replayed as a CUDA graph --------------------------

# glum's standardized [1 | X] (the cell sparse_wide_std.fit's generator) at
# 3,000 x 401: the standardization refuses the explicit Hessian
STD_FIT = {"rows": 3000, "cols": 400, "density": 0.02,
           "standardize": {"weights": "1/n", "center_predictors": True,
                           "scale_predictors": True}}
STD_L2, STD_N_CG = 3.0, 25


@pytest.fixture(scope="module")
def std_fit_data():
    from glmbench.data import sparse_wide_std_poisson

    return sparse_wide_std_poisson.make(STD_FIT, 2**31 + 30, 1)[0]


def _std_fit_design(cuda, data):
    from glmbench.data import sparse_wide_std_poisson
    from tabmat_torch.parallel.design import DeviceDesign

    design = DeviceDesign.from_matrix(
        sparse_wide_std_poisson.to_program(tt, data, STD_FIT, np.float64, cuda))
    assert design.sandwich_refusals == ("standardized",)
    return design


def _std_fit(design, data, inner):
    return tt.fit_glm(design, data["y"], sample_weight=data["weights"], family="poisson",
                      max_iter=50, tol=1e-8, n_cg=STD_N_CG, l2=STD_L2, inner_precision=inner,
                      penalty_scale=np.r_[0.0, np.ones(STD_FIT["cols"])])


def _eager_hvp(monkeypatch):
    """Every Hessian-vector solve eager from here on."""
    from tabmat_torch import glm

    monkeypatch.setattr(glm, "_hvp_graphs", lambda X, Xs: None)


@pytest.mark.parametrize("inner", ["float32", "float64"])
def test_hvp_graph_fit_is_the_eager_fit(cuda, monkeypatch, graph_counters, std_fit_data, inner):
    """``fit_glm`` on the standardized design: β bit for bit the eager loop's
    and the same steps; one capture a design, held by it, so a second fit on
    it replays every step; a replay and 25 products a step."""
    from tabmat_torch import glm

    design = _std_fit_design(cuda, std_fit_data)
    beta, n_iter = _std_fit(design, std_fit_data, inner)
    again, n_again = _std_fit(design, std_fit_data, inner)
    counters = graph_counters()
    assert 1 < n_iter < 50 and n_again == n_iter
    steps = counters["steps"]
    assert steps == counters["hvp_steps"] == 2 * n_iter
    assert counters["hvp_graph_captures"] == 1
    assert counters["hvp_graph_replays"] == steps and counters["hvp"] == STD_N_CG * steps
    holder = design._f32 if inner == "float32" else design
    dtype = torch.float32 if inner == "float32" else torch.float64
    assert list(holder._hvp_graphs) == [(dtype, STD_FIT["cols"] + 1, STD_N_CG, STD_L2)]
    _eager_hvp(monkeypatch)
    eager, eager_iter = _std_fit(_std_fit_design(cuda, std_fit_data), std_fit_data, inner)
    assert eager_iter == n_iter
    assert torch.equal(beta.view(torch.int64), eager.view(torch.int64))
    assert torch.equal(again.view(torch.int64), eager.view(torch.int64))
    after = graph_counters()
    assert after["hvp_graph_captures"] == 1
    assert after["hvp_graph_replays"] == counters["hvp_graph_replays"]
    assert glm._cg_graphs == {}


def test_hvp_graph_new_inputs_and_results_held_apart(cuda, graph_counters, std_fit_data):
    """A replay with new weights, ``ps`` and ``b`` gives their answer, not the
    last one; two results held at once are two tensors, neither the graph's
    own buffer; another ``l2`` is another graph."""
    from tabmat_torch import glm

    design = _std_fit_design(cuda, std_fit_data)
    X32 = design.astype_float(torch.float32)
    k = design.shape[1]
    gen = torch.Generator(device=cuda).manual_seed(30)
    inputs = [(torch.rand(design.shape[0], device=cuda, generator=gen) + 0.5,
               torch.rand(k, device=cuda, generator=gen),
               torch.randn(k, device=cuda, generator=gen)) for _ in range(2)]
    got = [glm._cg_solve_hvp(design, X32, w, ps, b, STD_L2, STD_N_CG) for w, ps, b in inputs]
    want = [glm._cg_solve(glm._hessian_product(X32, w, ps, STD_L2), b, STD_N_CG)
            for w, ps, b in inputs]
    torch.cuda.synchronize()
    assert all(torch.equal(g, e) for g, e in zip(got, want))
    assert not torch.equal(got[0], got[1])
    x_static = X32._hvp_graphs[(torch.float32, k, STD_N_CG, STD_L2)][4]
    assert len({got[0].data_ptr(), got[1].data_ptr(), x_static.data_ptr()}) == 3
    counters = {name: n for name, n in graph_counters().items() if name.startswith("hvp")}
    assert counters == {"hvp_graph_captures": 1, "hvp_graph_replays": 2, "hvp": 2 * STD_N_CG}
    w, ps, b = inputs[0]
    other = glm._cg_solve_hvp(design, X32, w, ps, b, 2 * STD_L2, STD_N_CG)
    assert torch.equal(other, glm._cg_solve(glm._hessian_product(X32, w, ps, 2 * STD_L2), b,
                                            STD_N_CG))
    assert len(X32._hvp_graphs) == 2 and design._hvp_graphs == {}


@pytest.mark.parametrize("inner", ["float32", "float64"])
def test_hvp_graph_fit_counts_the_launches_it_runs(cuda, monkeypatch, graph_counters,
                                                   std_fit_data, inner):
    """``spmv``'s launch counts over a fit are the eager fit's and the one
    product that runs before the capture: the capture's own count is taken
    back and every replay adds the launches it runs."""
    from tabmat_torch import glm
    from tabmat_torch.ops import spmv_kernel

    def launches(fn):
        before = dict(spmv_kernel.launches)
        out = fn()
        torch.cuda.synchronize()
        return out, {name: n - before[name] for name, n in spmv_kernel.launches.items()}

    design = _std_fit_design(cuda, std_fit_data)
    (_, n_iter), graph = launches(lambda: _std_fit(design, std_fit_data, inner))
    assert graph_counters()["hvp_graph_captures"] == 1
    Xs = design.astype_float(torch.float32) if inner == "float32" else design
    v = torch.ones(design.shape[1], dtype=Xs.dtype, device=cuda)
    w = torch.ones(design.shape[0], dtype=Xs.dtype, device=cuda)
    _, product = launches(lambda: glm._hessian_product(Xs, w, v, STD_L2)(v))
    _eager_hvp(monkeypatch)
    fresh = _std_fit_design(cuda, std_fit_data)  # its standardization launches spmv too
    (_, eager_iter), eager = launches(lambda: _std_fit(fresh, std_fit_data, inner))
    assert eager_iter == n_iter
    name = "spmv<float>" if inner == "float32" else "spmv<double>"
    assert product[name] == 2
    assert graph == {k: eager[k] + product[k] for k in eager}
    assert graph[name] >= 2 * STD_N_CG * n_iter


def test_hvp_graph_not_captured_for_a_cast_the_ledger_refused(cuda, monkeypatch, graph_counters,
                                                               std_fit_data):
    """With the float32 design's charge refused, its cast lives for one step,
    so the float32 fit runs eagerly, captures nothing and gives the eager
    fit's β."""
    from tabmat_torch import _config

    design = _std_fit_design(cuda, std_fit_data)
    _config.set_cache_budget_mb(_config.cache_spent_bytes() / (1 << 20))
    try:
        beta, n_iter = _std_fit(design, std_fit_data, "float32")
        assert design._f32 is None
    finally:
        _config.set_cache_budget_mb(None)
    counters = graph_counters()
    assert counters["hvp_steps"] == n_iter and counters["hvp"] == STD_N_CG * n_iter
    assert not [name for name in counters if name.startswith("hvp_graph")]
    _eager_hvp(monkeypatch)
    eager, eager_iter = _std_fit(_std_fit_design(cuda, std_fit_data), std_fit_data, "float32")
    assert eager_iter == n_iter and torch.equal(beta, eager)


# -- the standardized sandwich's expansion, std_expand<T> -------------------------


def _torch_expansion(term1, d_mat, d_rows, shift, mult):
    """The torch expansion ``std_expand<T>`` replaces on the card
    (``StandardizedMatrix._expand`` before the kernel), written out."""
    a = d_mat if mult is None else d_mat * mult
    res = torch.outer(a, shift) + torch.outer(shift, a) + torch.outer(shift, shift) * d_rows.sum()
    term1 = term1.to(shift.dtype)
    if mult is not None:
        term1 = term1 * torch.outer(mult, mult)
    return res + term1


def _expand_name(dtype):
    return f"std_expand<{'double' if dtype == torch.float64 else 'float'}>"


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "non_symmetric"])
@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "centred"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 6, 8, 31, 513, 1_000, 1_001, 2_053])
def test_std_expand_is_the_torch_expansion_bit_for_bit(cuda, k, dtype, scaled, symmetric,
                                                       offset):
    """``std_expand<T>`` in place on T, bit for bit the torch expansion: k of
    0, 1, odd, and not a multiple of the 16-byte vector (2 in f64, 4 in f32);
    T at an offset of one value takes the unpacked route."""
    from tabmat_torch.ops import std_expand_kernel as ek

    gen = torch.Generator(device=cuda).manual_seed(k)
    T = torch.empty(k * k + offset, device=cuda, dtype=dtype)[offset:].view(k, k)
    T.copy_(torch.randn(k, k, device=cuda, dtype=dtype, generator=gen))
    if symmetric:
        T.copy_(T + T.T)
    t, s = (torch.randn(k, device=cuda, dtype=dtype, generator=gen) for _ in range(2))
    m = torch.rand(k, device=cuda, dtype=dtype, generator=gen) + 0.5 if scaled else None
    d = torch.rand(777, device=cuda, dtype=dtype, generator=gen) - 0.3
    want = _torch_expansion(T, t, d, s, m)
    plain = ek.std_expand_plain(T.clone(), t, s, m, d.sum())
    name = _expand_name(dtype)
    before = ek.launches[name]
    got = ek.std_expand(T, t, s, m, d.sum())
    torch.cuda.synchronize()
    assert got is T and ek.launches[name] == before + (k > 0)
    assert torch.equal(got, want) and torch.equal(plain, want)


def _std_designs(cuda, dtype):
    """Inner formats on the card: the sparse Gram route (a symmetric T from
    ``sparse_gram<T>``: 4,000 x 10,000 at 1%), a DenseMatrix and a
    SplitMatrix of a dense and a categorical block."""
    from scipy import sparse as sps

    rng = np.random.default_rng(28)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    wide = sps.random(4_000, 10_000, density=0.01, format="csc", random_state=rng)
    dense = rng.standard_normal((4_000, 333)).astype(np_dtype)
    codes = rng.integers(0, 40, 4_000)
    split = tt.SplitMatrix([tt.DenseMatrix(dense[:, :7], device=cuda),
                            tt.CategoricalMatrix(codes, dtype=np_dtype, device=cuda)])
    return {"sparse_gram": tt.SparseMatrix(wide.astype(np_dtype), device=cuda),
            "dense": tt.DenseMatrix(dense, device=cuda), "split": split}


@pytest.mark.parametrize("restrict", ["all", "rows", "cols", "rows_and_cols"])
@pytest.mark.parametrize("scale", [True, False], ids=["scaled", "centred"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_standardized_sandwich_takes_std_expand_on_card(cuda, dtype, scale, restrict):
    """``StandardizedMatrix.sandwich`` with a CUDA ``d`` over each inner
    format: one ``std_expand<T>`` a sandwich, bit for bit the torch expansion
    of the same inner results; ``std_expand_kernel`` counts it and
    ``std_rank1_bytes`` reads 0; a second sandwich with the same ``d`` gives
    the same result (nothing cached was written over)."""
    from tabmat_torch import _trace
    from tabmat_torch.ops import std_expand_kernel as ek

    for label, inner in _std_designs(cuda, dtype).items():
        n, k = inner.shape
        rng = np.random.default_rng(k)
        m = inner.standardize(np.full(n, 1.0 / n), True, scale)[0]
        # standardize keeps float64 parameters: in float32 the view's own
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        m = tt.StandardizedMatrix(m.mat, m.shift.astype(np_dtype),
                                  None if m.mult is None else m.mult.astype(np_dtype))
        d = torch.as_tensor(rng.random(n) + 0.05, device=cuda, dtype=dtype)
        rows = np.sort(rng.choice(n, n // 2, replace=False)) if "rows" in restrict else None
        cols = np.sort(rng.choice(k, k // 3, replace=False)) if "cols" in restrict else None
        _, shift, mult = m._params(d)
        name = _expand_name(dtype)
        idx = slice(None) if cols is None else torch.as_tensor(cols, device=cuda)
        d_rows = d if rows is None else d[torch.as_tensor(rows, device=cuda)]
        want = _torch_expansion(m.mat.sandwich(d, rows, cols),
                                m.mat.transpose_matvec(d, rows, cols), d_rows, shift[idx],
                                None if mult is None else mult[idx])
        before = ek.launches[name]
        _trace.disable()
        _trace.take()
        _trace.enable()
        try:
            first = m.sandwich(d, rows, cols)
            second = m.sandwich(d, rows, cols)
        finally:
            _trace.disable()
        counters = _trace.take()["counters"]
        torch.cuda.synchronize()
        assert ek.launches[name] == before + 2, label
        assert counters["std_expand_kernel"] == 2 and counters["std_rank1_bytes"] == 0, label
        assert torch.equal(first, want) and torch.equal(second, want), label


def test_std_expand_casts_a_term_of_another_dtype_once(cuda):
    """An inner result in float32 under a float64 ``d``: cast once, then the
    kernel in place on the copy; ``std_rank1_bytes`` counts that copy."""
    from tabmat_torch import _trace
    from tabmat_torch.ops import std_expand_kernel as ek

    rng = np.random.default_rng(5)
    k, n = 257, 3_000
    m = tt.DenseMatrix(rng.standard_normal((n, k)), device=cuda).standardize(
        np.full(n, 1.0 / n), True, True)[0]
    d = torch.as_tensor(rng.random(n), device=cuda)
    term1 = m.mat.sandwich(d).float()
    d_mat = m.mat.transpose_matvec(d)
    _, shift, mult = m._params(d)
    want = _torch_expansion(term1, d_mat, d, shift, mult)
    before = ek.launches["std_expand<double>"]
    _trace.disable()
    _trace.take()
    _trace.enable()
    try:
        got = m._expand(term1, d_mat, d, None, None)
    finally:
        _trace.disable()
    counters = _trace.take()["counters"]
    torch.cuda.synchronize()
    assert ek.launches["std_expand<double>"] == before + 1
    assert got.dtype == torch.float64 and torch.equal(got, want)
    assert counters == {"std_expand_kernel": 1, "std_rank1_bytes": k * k * 8}


def test_a_diagonal_inner_sandwich_keeps_the_torch_expansion_on_card(cuda):
    from tabmat_torch.ops import std_expand_kernel as ek

    n = 5_000
    codes = np.random.default_rng(6).integers(0, 50, n)
    m = tt.CategoricalMatrix(codes, device=cuda).standardize(np.full(n, 1.0 / n), True,
                                                             True)[0]
    d = torch.rand(n, device=cuda, dtype=torch.float64)
    before = dict(ek.launches)
    S = m.sandwich(d)
    assert ek.launches == before
    Z = m.toarray()
    want = (Z * d.cpu().numpy()[:, None]).T @ Z
    assert float(np.abs(S.cpu().numpy() - want).max()) <= 1e-13 * float(np.abs(want).max())
