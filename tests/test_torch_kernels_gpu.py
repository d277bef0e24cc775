"""The CUDA kernels (sandwich and range prepass) against their plain
versions, on the card.

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
    # the default float32 inner step: the prepass, then the f32 sandwich
    assert sk.launches["sandwich<float>"] >= before["sandwich<float>"] + 2
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
