"""The port's sandwich at the widths of the narrow and wide exact-f64 Pallas
kernels, of the f32 and f64 triangle kernels and of the wide f32 kernel,
and its width dispatch, against ``tabmat_tpu`` on the CPU.

The Pallas kernels (queue B rows 4-8: ``_v5_kernel``, ``_v3_kernel``,
``_v3p_kernel``, ``_pairs_kernel``, ``_sliced_pairs_kernel``) run in
interpret mode, as their own tests run them (``tests/test_sandwich_v3.py``,
``tests/test_sandwich_v5.py``, ``tests/test_pallas_pairs.py``); the slice
pairs are combined in f64 as ``ozaki._sandwich_cached_mixed_jit`` combines
them.  On CPU tensors the port's wrappers take the plain version, so these
tests hold the function each CUDA kernel computes; the kernels themselves
are held against the plain version on the card (``tests/
test_torch_kernels_gpu.py``, ``chip_smoke.py``).  The reference kernels
agree with the exact product to about 5e-15 relative; 1e-13 between the
packages leaves room for both roundings.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tabmat_tpu as tm
from tabmat_tpu import glm as tpu_glm
from tabmat_tpu.ops import ozaki, pallas_pairs
from tabmat_tpu.ops.pallas_kernels import dense_sandwich_f32
from tabmat_tpu.ops import pallas_sandwich_v3 as v3
from tabmat_tpu.ops import pallas_sandwich_v4 as v4
from tabmat_tpu.ops import pallas_sandwich_v5 as v5
from tabmat_tpu.parallel.design import DeviceDesign as TpuDesign

import tabmat_torch as tt
from tabmat_torch import glm
from tabmat_torch.convert import from_tabmat_tpu
from tabmat_torch.ops import dense_ops, sandwich_kernel as sk
from tabmat_torch.parallel.design import DeviceDesign

TOL = 1e-13
STEP_RTOL = {"float64": 1e-10, "float32": 1e-4}


def _rand(n, k, seed):
    """Columns over 2^±8 and weights over 2^±3, some of them zero, as the
    reference kernels' tests draw them."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, k)) * np.exp2(rng.uniform(-8, 8, size=(1, k)))
    d = rng.uniform(0.1, 1.0, n) * np.exp2(rng.uniform(-3, 3, size=n))
    d[::13] = 0.0
    return X, d


def _port(X, d):
    S = dense_ops.sandwich(torch.tensor(X), torch.tensor(d))
    assert S.dtype == torch.float64 and S.shape == (X.shape[1], X.shape[1])
    return S.numpy()


def _relerr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n,k", [(1024, 60), (1500, 100)])
def test_matches_v3_interpret(n, k):
    """Row 5: the self-slicing v3 kernel, unpacked k ≤ 100."""
    X, d = _rand(n, k, seed=n + k)
    cache = v3.build_plane_cache(jnp.asarray(X))
    S_tpu = v3.sandwich_v3(cache.xsh, cache.xsl, cache.exps, jnp.asarray(d), interpret=True)
    assert _relerr(_port(X, d), S_tpu) < TOL


@pytest.mark.parametrize("k", [3, 5, 10])
def test_matches_v3_packed_interpret(k):
    """Row 6: v3 with G = ⌊100/k⌋ row groups packed into the lanes."""
    X, d = _rand(1024, k, seed=k)
    assert v3.pack_group(k) > 1
    S_tpu = v3.sandwich_v3_packed(v3.build_plane_cache_packed(jnp.asarray(X)), jnp.asarray(d),
                                  interpret=True)
    assert _relerr(_port(X, d), S_tpu) < TOL


@pytest.mark.parametrize("k", [10, 50, 128])
def test_matches_v5_interpret(k):
    """Row 4: the all-pairs v5 kernel (packed at k = 10)."""
    X, d = _rand(1024, k, seed=2 * k)
    cache = v5.build_plane_cache(jnp.asarray(X))
    S_tpu = v5._sandwich_v5_jit(
        cache.xsh, cache.xsl, cache.bstk, cache.exps, jnp.asarray(d),
        cache.n, cache.k, cache.G, interpret=True,
    )
    assert _relerr(_port(X, d), S_tpu) < TOL


def _pairs_sandwich(X, d, sliced: bool):
    """Rows 7-8 in interpret mode, combined in f64 as
    ``ozaki._sandwich_cached_mixed_jit`` combines them: the T8 slices of X
    against the T7 slices of A = d·X, built outside the kernel (row 7) or
    inside it from A's two f32 planes (row 8)."""
    n, k = X.shape
    QB, eB = ozaki.slice_matrix(jnp.asarray(X))
    n_pad = QB.shape[1] * QB.shape[2]
    qb = QB.reshape(QB.shape[0], n_pad, k)
    pairs = ozaki._mixed_pairs(7, QB.shape[0])
    A = jnp.asarray(X * d[:, None])
    if sliced:
        e = jnp.ceil(jnp.log2(jnp.maximum(jnp.max(jnp.abs(A), axis=0), 1e-300)))
        eA = jnp.exp2(e)
        scaled = A * jnp.exp2(-e)
        yh = scaled.astype(jnp.float32)
        yl = (scaled - yh.astype(jnp.float64)).astype(jnp.float32)
        pad = [(0, n_pad - n), (0, 0)]
        parts = pallas_pairs.pair_contractions_sliced(jnp.pad(yh, pad), jnp.pad(yl, pad), qb,
                                                      pairs, interpret=True)
    else:
        QA, eA = ozaki.slice_matrix_f32planes(A)
        qa = jnp.pad(QA, [(0, 0), (0, n_pad - n), (0, 0)])
        parts = pallas_pairs.pair_contractions(qa, qb, pairs, interpret=True)
    parts = np.asarray(parts)
    tot = parts[:, 0].astype(np.float64) + parts[:, 1].astype(np.float64)
    w = np.array([0.5 ** (ozaki.T7 * (p + 1) + ozaki.T * (q + 1)) for p, q in pairs])
    return np.einsum("pij,p->ij", tot, w) * np.outer(np.asarray(eA), np.asarray(eB))


@pytest.mark.parametrize("sliced", [False, True], ids=["pairs", "sliced_pairs"])
@pytest.mark.parametrize("k", [129, 160])
def test_matches_pair_contractions_interpret(k, sliced):
    """Rows 7-8: the slice-pair contractions, the JAX package's default for
    f64 128 < k ≤ 160, which the port's FP64 tensor-core kernel replaces."""
    X, d = _rand(256, k, seed=k + sliced)
    S_tpu = _pairs_sandwich(X, d, sliced)
    assert _relerr(S_tpu, (X * d[:, None]).T @ X) < TOL  # the reference's own bar
    assert _relerr(_port(X, d), S_tpu) < TOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [1, 32, 33, 128, 129, 176, 177, 1000, 10_000])
def test_route(k, dtype):
    suffix = "double" if dtype == torch.float64 else "float"
    if k <= 32:
        want = f"sandwich_narrow<{suffix}>"
    elif dtype == torch.float32:
        want = "sandwich_tri<float>" if k <= 176 else "sandwich_wide<float>"
    elif k > 128:
        want = "sandwich_mma<double>"
    else:
        want = "sandwich_mma_tri<double>"
    assert sk.route(k, dtype) == want
    assert want in sk.launches and want in sk.KERNEL_WRAPPERS


@pytest.mark.parametrize("n,n_sm,per_sm", [(4_000_000, 132, 3), (1_000_000, 132, 2), (17, 4, 1),
                                          (10**9, 132, 3)])
def test_narrow_plan_fills_one_wave(n, n_sm, per_sm):
    splits, rps = sk.narrow_plan(n, n_sm, per_sm)
    assert 1 <= splits <= min(n_sm * per_sm, sk.MAX_SPLITS)
    assert (splits - 1) * rps < n <= splits * rps  # every split has rows
    if n >= 100 * n_sm * per_sm * sk.ROWS:
        assert splits >= 0.9 * n_sm * per_sm


@pytest.mark.parametrize("n", [1, 100_003, 1_000_000, 4_000_000])
@pytest.mark.parametrize("n_sm,per_sm", [(132, 2), (132, 1), (4, 1)])
def test_tri_plan_fills_one_wave(n, n_sm, per_sm):
    """The row split of both triangle kernels, ``sandwich_tri<float>`` and
    ``sandwich_mma_tri<double>``; a split is whole k-steps of either."""
    splits, rps = sk.tri_plan(n, n_sm, per_sm)
    assert 1 <= splits <= min(n_sm * per_sm, sk.MAX_SPLITS)  # one wave, never more
    assert (splits - 1) * rps < n <= splits * rps  # every split has rows
    assert rps % sk.ROWS == 0
    if n >= 100 * n_sm * per_sm * sk.ROWS:
        assert splits >= 0.9 * n_sm * per_sm


@pytest.mark.parametrize("k,nt", [(1, 1), (33, 5), (50, 7), (160, 20), (176, 22)])
def test_tri_partial_size(k, nt):
    """64 floats for each upper 8 × 8 micro-tile of an nt × nt grid; at
    k = 176 the 253 micro-tiles still fit one 256-thread block."""
    assert sk.tri_partial_size(k) == nt * (nt + 1) // 2 * 64
    assert nt * (nt + 1) // 2 <= 256


@pytest.mark.parametrize("k", [50, 160])
def test_tri_wrapper_matches_pallas_f32_interpret(k):
    """Row 1 at the triangle kernel's widths: the wrapper on CPU tensors is
    the plain version, held against ``dense_sandwich_f32`` in interpret mode
    as ``tests/test_pallas_kernels.py`` runs it.  Both are full-f32 sums in
    other orders, each within about 1e-6 of the exact product here; 2e-5 is
    the port's f32 limit (``chip_smoke.F32_TOL``), which a TF32 product fails."""
    rng = np.random.default_rng(k)
    X = rng.standard_normal((2050, k)).astype(np.float32)
    d = (rng.random(2050) - 0.25).astype(np.float32)
    d[::7] = 0.0
    got = sk.sandwich_tri(torch.from_numpy(X), torch.from_numpy(d))
    assert got.dtype == torch.float32 and torch.equal(got, sk.sandwich_plain(
        torch.from_numpy(X), torch.from_numpy(d)))
    want = np.asarray(dense_sandwich_f32(jnp.asarray(X), jnp.asarray(d), interpret=True))
    assert _relerr(got.numpy(), want) <= 2e-5
    exact = (X.astype(np.float64) * d[:, None]).T @ X.astype(np.float64)
    assert _relerr(got.numpy(), exact) <= 2e-5


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda: sk.sandwich_tri(torch.ones(4, 177), torch.ones(4)), ValueError),
        (lambda: sk.sandwich_tri(torch.ones(4, 32), torch.ones(4)), ValueError),
        (lambda: sk.sandwich_tri(torch.ones(4, 50, dtype=torch.float64),
                                 torch.ones(4, dtype=torch.float64)), TypeError),
    ],
    ids=["too-wide", "too-narrow", "float64"],
)
def test_tri_wrapper_rejects(call, err):
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("k", [177, 200, 256, 257, 1000, 2048])
@pytest.mark.parametrize("n", [1, 100_003, 200_000, 400_000, 1_000_000])
@pytest.mark.parametrize("n_sm,per_sm", [(132, 2), (132, 1), (4, 1)])
def test_wide_plan_fills_one_wave(n, k, n_sm, per_sm):
    """The row split of ``sandwich_wide<float>``: one entry of the table a
    tile pair; the splits that hold rows, summed over the pairs, never
    exceed one wave (one split a pair once the pairs alone fill it); each
    split is whole stages; the grid's splits are the most of any pair, so
    every pair's splits cover its rows; a split keeps its busiest scheduler
    (⌈active warps / 4⌉ warps) about as long in every pair; no smaller
    ``sched_rows`` fits the wave."""
    warps = sk.wide_active_warps(k)
    assert len(warps) == sk.wide_pairs(k) and min(warps) >= 1 and max(warps) <= 8
    costs = [-(-a // 4) for a in warps]
    wave = n_sm * per_sm
    splits, rows = sk.wide_plan(n, k, n_sm, per_sm)
    sched_rows = sk._least_sched_rows(n, costs, wave)
    assert list(rows) == [sk._wide_rows(sched_rows, c) for c in costs]
    per_pair = [-(-n // r) for r in rows]
    assert all(r > 0 and r % sk.WIDE_ROWS == 0 for r in rows)
    assert splits == max(per_pair) <= sk.MAX_SPLITS
    assert all(splits * r >= n for r in rows)
    assert sum(per_pair) <= wave or set(per_pair) == {1}
    if sum(per_pair) <= wave and sched_rows > 1:  # the least sched_rows that fits
        fewer = [-(-n // sk._wide_rows(sched_rows - 1, c)) for c in costs]
        assert sum(fewer) > wave
    for c, r in zip(costs, rows):  # a split's busiest scheduler: sched_rows, within a stage
        assert sched_rows <= c * r < sched_rows + c * sk.WIDE_ROWS


@pytest.mark.parametrize("k,warps", [(177, [6, 4, 2]), (200, [6, 6, 4]), (256, [6, 8, 6]),
                                     (257, [6, 8, 2, 6, 2, 1])])
def test_wide_active_warps(k, warps):
    """The warp tiles (64 rows × 32 columns) of each 128-column tile pair
    that start inside it and reach a diagonal pair's diagonal."""
    assert sk.wide_active_warps(k) == warps
    assert sk.wide_active_warps(1000).count(8) == 28


@pytest.mark.parametrize("k,pairs", [(177, 3), (200, 3), (256, 3), (257, 6), (1000, 36),
                                     (2048, 136)])
def test_wide_pairs(k, pairs):
    """Upper pairs of 128-column tiles, the last tile the remainder."""
    assert sk.wide_pairs(k) == pairs
    nt = -(-k // sk.WIDE_TILE)
    assert (nt - 1) * sk.WIDE_TILE < k <= nt * sk.WIDE_TILE


@pytest.mark.parametrize("k", [200, 257])
def test_wide_wrapper_matches_pallas_f32_interpret(k):
    """Row 1 past the triangle kernel's widths: the wrapper on CPU tensors
    is the plain version, held against ``dense_sandwich_f32`` in interpret
    mode within the port's f32 limit (2e-5, ``chip_smoke.F32_TOL``), and
    against the exact product."""
    rng = np.random.default_rng(k)
    X = rng.standard_normal((2050, k)).astype(np.float32)
    d = (rng.random(2050) - 0.25).astype(np.float32)
    d[::7] = 0.0
    Xt, dt = torch.from_numpy(X), torch.from_numpy(d)
    got = sk.sandwich_wide(Xt, dt)
    assert got.dtype == torch.float32 and torch.equal(got, sk.sandwich_plain(Xt, dt))
    want = np.asarray(dense_sandwich_f32(jnp.asarray(X), jnp.asarray(d), interpret=True))
    assert _relerr(got.numpy(), want) <= 2e-5
    exact = (X.astype(np.float64) * d[:, None]).T @ X.astype(np.float64)
    assert _relerr(got.numpy(), exact) <= 2e-5


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda: sk.sandwich_wide(torch.ones(4, 176), torch.ones(4)), ValueError),
        (lambda: sk.sandwich_wide(torch.ones(4, 32), torch.ones(4)), ValueError),
        (lambda: sk.sandwich_wide(torch.ones(4, 200, dtype=torch.float64),
                                  torch.ones(4, dtype=torch.float64)), TypeError),
    ],
    ids=["too-narrow", "narrow", "float64"],
)
def test_wide_wrapper_rejects(call, err):
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("k,tiles", [(33, 9), (40, 9), (48, 12), (50, 16), (64, 20), (65, 25),
                                     (100, 49), (128, 72)])
def test_mma_tri_partial_size(k, tiles):
    """128 doubles for each upper m16n8k8 tile (r, c), c ≥ 2r: the tiles
    cover every upper entry of S once, and no tile lies wholly below."""
    assert sk.mma_tri_tiles(k) == tiles
    assert sk.mma_tri_partial_size(k) == tiles * 128
    c_blocks, r_blocks = -(-k // 8), -(-k // 16)
    kept = [(r, c) for r in range(r_blocks) for c in range(c_blocks) if 8 * c + 7 >= 16 * r]
    assert len(kept) == tiles
    covered = {(16 * r + u, 8 * c + v) for r, c in kept for u in range(16) for v in range(8)}
    assert {(i, j) for i in range(k) for j in range(i, k)} <= covered


@pytest.mark.parametrize("k", [33, 50, 64, 100, 128])
def test_mma_tri_wrapper_matches_v4_interpret(k):
    """Rows 2, 4 and 5 at the f64 triangle kernel's widths: the wrapper on
    CPU tensors is the plain version, held against the exact-f64 v4 kernel
    in interpret mode as ``tests/test_torch_sandwich.py`` runs it."""
    X, d = _rand(700, k, seed=5 * k)
    cache = v4.build_plane_cache(jnp.asarray(X))
    S_tpu = v4._sandwich_v4_jit(
        cache.xsh, cache.xsl, cache.bstk, cache.exps, jnp.asarray(d),
        cache.n, cache.k, cache.G, interpret=True,
    )
    Xt, dt = torch.tensor(X), torch.tensor(d)
    got = sk.sandwich_mma_tri(Xt, dt)
    assert got.dtype == torch.float64 and torch.equal(got, sk.sandwich_plain(Xt, dt))
    assert _relerr(got.numpy(), S_tpu) < TOL


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda: sk.sandwich_mma_tri(torch.ones(4, 32, dtype=torch.float64),
                                     torch.ones(4, dtype=torch.float64)), ValueError),
        (lambda: sk.sandwich_mma_tri(torch.ones(4, 129, dtype=torch.float64),
                                     torch.ones(4, dtype=torch.float64)), ValueError),
        (lambda: sk.sandwich_mma_tri(torch.ones(4, 50), torch.ones(4)), TypeError),
    ],
    ids=["too-narrow", "too-wide", "float32"],
)
def test_mma_tri_wrapper_rejects(call, err):
    with pytest.raises(err):
        call()


def test_route_rejects_other_dtypes():
    with pytest.raises(TypeError):
        sk.route(10, torch.float16)


@pytest.mark.parametrize("wrapper", [sk.sandwich, sk.sandwich_tiled, sk.sandwich_narrow,
                                     sk.sandwich_mma, sk.sandwich_tri, sk.sandwich_mma_tri,
                                     sk.sandwich_wide])
def test_wrappers_add_into_out_on_cpu(wrapper):
    f32 = wrapper in (sk.sandwich_tri, sk.sandwich_wide)  # float32 only
    k = {sk.sandwich_tri: 40, sk.sandwich_mma_tri: 40, sk.sandwich_wide: 180}.get(wrapper, 20)
    X, d = _rand(300, k, seed=4)
    dtype = torch.float32 if f32 else torch.float64
    Xt, dt = torch.tensor(X, dtype=dtype), torch.tensor(d, dtype=dtype)
    before = dict(sk.launches)
    out = torch.ones(k, k, dtype=dtype)
    assert wrapper(Xt, dt, out=out) is out
    torch.testing.assert_close(out, 1 + sk.sandwich_plain(Xt, dt), rtol=0, atol=0)
    assert torch.equal(wrapper(Xt, dt), sk.sandwich_plain(Xt, dt))
    assert sk.launches == before  # the CPU launches nothing


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda: sk.sandwich_narrow(torch.ones(4, 33, dtype=torch.float64),
                                    torch.ones(4, dtype=torch.float64)), ValueError),
        (lambda: sk.sandwich_mma(torch.ones(4, 130), torch.ones(4)), TypeError),
        (lambda: sk.sandwich(torch.ones(4, 3, dtype=torch.float64), torch.ones(4, dtype=torch.float64),
                             out=torch.zeros(3, 4, dtype=torch.float64)), ValueError),
        (lambda: sk.sandwich(torch.ones(4, 3, dtype=torch.float64), torch.ones(4, dtype=torch.float64),
                             out=torch.zeros(3, 3)), ValueError),
        (lambda: sk.sandwich_wide(torch.ones(4, 100), torch.ones(4)), ValueError),
        (lambda: sk.sandwich_wide(torch.ones(4, 300, dtype=torch.float64),
                                  torch.ones(4, dtype=torch.float64)), TypeError),
        (lambda: sk.sandwich_wide(torch.ones(4, 200), torch.ones(4), out=torch.zeros(200, 200,
                                  dtype=torch.float64)), ValueError),
    ],
    ids=["narrow-too-wide", "mma-f32", "out-shape", "out-dtype", "wide-too-narrow", "wide-f64",
         "wide-out-dtype"],
)
def test_wrappers_reject(call, err):
    with pytest.raises(err):
        call()


def _problem(n, k, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, k)) * 0.5
    eta = X @ (rng.standard_normal(k) * 0.05)
    return X, rng.poisson(np.exp(eta)).astype(np.float64), rng.random(n) + 0.5, rng


@pytest.mark.parametrize("k", [10, 160])
def test_dense_matrix_matches_reference(k):
    """Paths (a) and (b) at cut-down rows: DenseMatrix ops with active sets."""
    X, _, w, rng = _problem(1500, k, seed=k)
    ref = tm.DenseMatrix(X)
    port = from_tabmat_tpu(ref, device="cpu")
    rows = np.sort(rng.choice(1500, 700, replace=False))
    cols = np.arange(0, k, 3)
    for kw in ({}, {"rows": rows}, {"cols": cols}, {"rows": rows, "cols": cols}):
        assert _relerr(port.sandwich(w, **kw), ref.sandwich(w, **kw)) < TOL
        r = rng.standard_normal(1500)
        assert _relerr(port.transpose_matvec(r, **kw), ref.transpose_matvec(r, **kw)) < 1e-12
    v = rng.standard_normal(k)
    assert _relerr(port.matvec(v, cols=cols), ref.matvec(v, cols=cols)) < 1e-12
    std_ref, _, _ = ref.standardize(np.full(1500, 1 / 1500), True, True)
    std_port, _, _ = port.standardize(np.full(1500, 1 / 1500), True, True)
    assert _relerr(std_port.sandwich(w), std_ref.sandwich(w)) < 1e-12


@pytest.mark.parametrize("k,inner", [(10, "float64"), (10, "float32"), (160, "float64"),
                                     (160, "float32"), (200, "float32")])
def test_design_and_fit_match_reference(k, inner):
    """The design's explicit sandwich, one IRLS step and a short fit, with CG
    run to k iterations so that the f32 solves converge (ROADMAP C).  At
    k = 200 the default f32 step's Hessian is the wide f32 kernel's."""
    X, y, w, rng = _problem(1500, k, seed=3 * k)
    ref = tm.DenseMatrix(X)
    ref_design, port_design = TpuDesign.from_matrix(ref), DeviceDesign.from_matrix(
        from_tabmat_tpu(ref, device="cpu"))
    assert _relerr(port_design.sandwich(torch.tensor(w)), ref_design.sandwich(jnp.asarray(w))) < TOL
    beta0 = rng.standard_normal(k) * 0.01
    got = glm.irls_step(port_design, torch.tensor(y), torch.tensor(w), torch.tensor(beta0),
                        family="poisson", n_cg=k, inner_precision=inner)
    want = tpu_glm.irls_step(ref_design, jnp.asarray(y), jnp.asarray(w), jnp.asarray(beta0),
                             family="poisson", n_cg=k, inner_precision=inner)
    assert _relerr(got, want) < STEP_RTOL[inner]
    kw = dict(sample_weight=w, family="poisson", max_iter=3, tol=0.0, n_cg=k, inner_precision=inner)
    got, n_got = tt.fit_glm(from_tabmat_tpu(ref, device="cpu"), y, **kw, device="cpu")
    want, n_want = tpu_glm.fit_glm(ref, y, **kw)
    assert n_got == n_want == 3
    assert _relerr(got, want) < STEP_RTOL[inner]
