"""The CUDA kernels (the sandwiches and their width dispatch, range
prepass, gather, segment sum, sparse segment product) against their plain
versions, and the default device, on the card.

Marked ``gpu``: here, without a card, each test skips with its reason.  On
the card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Whether a card is present is decided inside the fixture, never at import,
so every pytest-xdist worker collects the same tests.
"""

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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [1, 2, 5, 10, 31, 32])
def test_narrow_kernel_matches_plain(cuda, k, dtype):
    X, d = _inputs(100_003, k, dtype, cuda, seed=k)
    suffix = "double" if dtype == torch.float64 else "float"
    _held_against_plain(f"sandwich_narrow<{suffix}>", sk.sandwich_narrow, X, d)


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


@pytest.mark.parametrize("k", [129, 160, 200, 1000])
def test_mma_kernel_matches_plain(cuda, k):
    X, d = _inputs(100_003 if k < 1000 else 20_011, k, torch.float64, cuda, seed=k)
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
    kernel, against scipy."""
    from scipy import sparse as sps

    from tabmat_torch.models import sparse as port_sparse

    monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
    monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_ELEMENTS", 3_000 * 700)
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
    got = m.sandwich(d, rows=rows, cols=cols)  # 100 columns: the tiled kernel
    assert np.abs(got - sub_ref).max() / np.abs(sub_ref).max() <= 1e-13


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_gather_matches_plain_exactly(cuda, C, dtype):
    from tabmat_torch.ops import gather_kernel as gk

    rng = np.random.default_rng(C)
    n, width = 100_003, 777
    codes = torch.as_tensor(rng.integers(-3, width + 3, C * n).astype(np.int32), device=cuda)
    table = torch.as_tensor(rng.standard_normal(width), dtype=dtype, device=cuda)
    name = f"gather<{'double' if dtype == torch.float64 else 'float'}>"
    before = gk.launches[name]
    got = gk.gather(table, codes, n)
    assert gk.launches[name] == before + 1
    assert torch.equal(got, gk.gather_plain(table, codes, n))
    # an empty table (drop_first of a single level) gathers zeros
    assert torch.equal(gk.gather(table[:0], codes, n), torch.zeros_like(got))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("m", [1, 5, 11])
@pytest.mark.parametrize("W", [1, 7, 1000, 300_000])
def test_segsum_matches_plain_and_repeats(cuda, W, m, dtype):
    from tabmat_torch.ops import segsum_kernel as ssk
    from tabmat_torch.ops.segments import build_plan

    rng = np.random.default_rng(W + m)
    n = 200_003
    keys = rng.integers(-1, W, n)
    if W > 2:
        keys[np.isin(keys, [0, W // 2])] = -1  # empty segments
    keys[: n // 3] = -1  # a run of sentinels
    plan = build_plan(keys, W, cuda)
    shape = (n,) if m == 1 else (n, m)
    v = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    name = f"segsum<{'double' if dtype == torch.float64 else 'float'}>"
    before = ssk.launches[name]
    first, second = ssk.segsum(v, plan), ssk.segsum(v, plan)
    assert ssk.launches[name] == before + 2
    assert torch.equal(first, second)
    want = ssk.segsum_plain(v, plan.perm, plan.bounds)
    scale = ssk.segsum_plain(v.abs().double(), plan.perm, plan.bounds).clamp_min(1e-300)
    rel = float(((first.double() - want.double()).abs() / scale).max())
    assert rel <= TOL[dtype]


def _spmv_layout(rng, lengths, n_src, cuda):
    from tabmat_torch.ops.segments import SegmentPlan

    bounds = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    idx = rng.integers(0, n_src, int(bounds[-1])).astype(np.int32)
    return SegmentPlan(torch.as_tensor(idx, device=cuda), torch.as_tensor(bounds, device=cuda),
                       n_src)


# merge items per tile of csrc/spmv.cu: 128 threads x 7 for m = 1, 256 x 3
# for m > 1 (groups of 4 columns in f64, 8 in f32)
SPMV_TILE = {1: 128 * 7, "m>1": 256 * 3}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("with_scale", [False, True], ids=["a", "a*scale"])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 17])
@pytest.mark.parametrize("layout", ["empty_and_long", "one_segment", "mostly_empty",
                                    "ends_on_tile_edges", "long_among_empties", "w1_e1",
                                    "trailing_empties"])
def test_spmv_matches_plain_and_repeats(cuda, layout, m, with_scale, dtype):
    from tabmat_torch.ops import spmv_kernel as spk

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
    before = spk.launches[name]
    first, second = spk.spmv(v, plan, a, scale), spk.spmv(v, plan, a, scale)
    assert spk.launches[name] == before + 2
    assert torch.equal(first, second)
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
