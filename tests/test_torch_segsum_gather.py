"""The port's segment sum and gather (plain versions, on the CPU) against
the JAX functions their modules replace.

The JAX package runs as its own tests run it here: ``SegmentPlan`` on its
argsort/cumsum route and ``take_matvec``, and the two Pallas kernels that
have an interpret mode (``pallas_segsum_bucketed``, ``pallas_window_take``)
interpreted at the sizes of ``tests/test_segsum_bucketed.py`` and
``tests/test_window_take.py``.  ``pallas_gather``'s kernels, which take no
``interpret`` argument, run interpreted with ``pallas_call`` patched to
interpret for the test's duration, unjitted.  Tolerances: ``atol=1e-12`` as in
``tests/test_matrices.py``, except where a test says why otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from functools import partial

from tabmat_tpu import _native as tpu_native
from tabmat_tpu.ops import categorical_ops as tpu_cat_ops
from tabmat_tpu.ops import pallas_gather
from tabmat_tpu.ops import pallas_segsum_bucketed as psb
from tabmat_tpu.ops import pallas_window_take as wt
from tabmat_tpu.ops import segments as tpu_segments
from tabmat_tpu.ops.pallas_segsum import build_codes_col

from tabmat_torch import _native
from tabmat_torch.ops import categorical_ops, gather_kernel, segsum_kernel, sparse_ops
from tabmat_torch.ops.segments import build_plan, stack

CPU = torch.device("cpu")


def _keys(rng, n, W, missing=0.1):
    keys = rng.integers(0, W, n)
    keys[rng.random(n) < missing] = -1
    return keys


def _host_plan(keys, W):
    """The JAX package's plan of ``keys``, its host argsort
    (``tabmat_tpu/_native``), with its invalid keys dropped, as the port's
    plans hold them: ``(perm, bounds)``, int32 both."""
    ref = tpu_segments.build_plan(keys, W)
    perm, bounds = np.asarray(ref.perm), np.asarray(ref.bounds)
    return perm[bounds[0] : bounds[-1]], bounds - bounds[0]


@pytest.mark.parametrize("W", [1, 2, 7, 11, 300, 2000])
@pytest.mark.parametrize("m", [0, 1, 3])
def test_segment_plan_matches_reference(W, m):
    rng = np.random.default_rng(W * 10 + m)
    n = 2000
    keys = _keys(rng, n, W)
    port, ref = build_plan(keys, W, CPU), tpu_segments.build_plan(keys, W)
    if m == 0:
        v = rng.standard_normal(n)
        got, want = port.sum(torch.tensor(v)), ref.sum(jnp.asarray(v))
    else:
        # the port's sum takes the (n, m) values at once; the reference's
        # segment sum, one column at a time
        v = rng.standard_normal((n, m))
        got = port.sum(torch.tensor(v))
        want = jnp.stack([ref.sum(jnp.asarray(v[:, j])) for j in range(m)], axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_plan_layout_and_sentinels():
    """Sentinel keys fall in no segment, and the plan holds int32 tensors."""
    keys = np.array([2, -1, 0, 2, -1, 5, 0, 7])  # 7 is past W = 6
    plan = build_plan(keys, 6, CPU)
    assert plan.perm.dtype == plan.bounds.dtype == torch.int32
    assert plan.perm.tolist() == [2, 6, 0, 3, 5]
    assert plan.bounds.tolist() == [0, 2, 2, 4, 4, 4, 5]
    v = torch.arange(1.0, 9.0, dtype=torch.float64)
    assert plan.sum(v).tolist() == [3 + 7, 0, 1 + 4, 0, 0, 6]
    empty = build_plan(np.full(5, -1), 3, CPU)
    assert empty.sum(torch.ones(5, dtype=torch.float64)).tolist() == [0, 0, 0]


def _plan_cases():
    """Each case: the (keys, W) of the plans it builds, stacked where more
    than one."""
    rng = np.random.default_rng(22)
    mixed = rng.integers(0, 310, 5000)  # past W = 300 too
    mixed[rng.random(5000) < 0.1] = -1
    return {
        "sentinels": [(np.array([2, -1, 0, 2, -1, 5, 0, 7, 6, -3]), 6)],
        "mixed": [(mixed, 300)],
        "all_invalid": [(np.array([-1, 4, -2, 9]), 4)],
        "empty": [(np.array([], dtype=np.int64), 5)],
        "one_segment": [(rng.integers(-1, 2, 1000), 1)],
        "wide": [(rng.integers(-1, 10**6, 200_000), 10**6)],
        "stacked": [(_keys(rng, 3000, 7), 7), (_keys(rng, 3000, 1000), 1000),
                    (_keys(rng, 3000, 1), 1)],
    }


PLAN_CASES = _plan_cases()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("source", ["host", "device"])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_device_plan_equals_host_plan(case, source, device):
    """``build_plan``'s one stable sort on the plan's device, from host keys
    or from keys already there, gives the host argsort's plan and the JAX
    package's, bit for bit, alone and stacked."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    dev = torch.device(device, 0) if device == "cuda" else CPU
    plans, want_perm, want_bounds, offset = [], [], [], 0
    for keys, W in PLAN_CASES[case]:
        perm, bounds = _host_plan(keys, W)
        given = torch.as_tensor(keys, device=dev) if source == "device" else keys
        plan = build_plan(given, W, dev)
        assert plan.perm.device == plan.bounds.device == dev
        assert plan.perm.dtype == plan.bounds.dtype == torch.int32
        assert perm.dtype == bounds.dtype == np.int32
        np.testing.assert_array_equal(plan.perm.cpu().numpy(), perm)
        np.testing.assert_array_equal(plan.bounds.cpu().numpy(), bounds)
        assert (plan.num_segments, plan.n_rows) == (W, len(keys))
        plans.append(plan)
        want_perm.append(perm)
        want_bounds.append(bounds[:-1] + offset)
        offset += len(perm)
    stacked = stack(plans)
    np.testing.assert_array_equal(stacked.perm.cpu().numpy(), np.concatenate(want_perm))
    np.testing.assert_array_equal(stacked.bounds.cpu().numpy(),
                                  np.concatenate(want_bounds + [[offset]]))


def test_stacked_plan_is_the_plans_in_turn():
    rng = np.random.default_rng(4)
    n = 500
    ka, kb = _keys(rng, n, 7), _keys(rng, n, 11)
    a, b = build_plan(ka, 7, CPU), build_plan(kb, 11, CPU)
    v = torch.tensor(rng.standard_normal(n))
    got = stack([a, b]).sum(v)
    assert torch.equal(got, torch.cat([a.sum(v), b.sum(v)]))


def test_native_helpers_match_reference():
    rng = np.random.default_rng(5)
    keys = _keys(rng, 3000, 50).astype(np.int32)
    plan = build_plan(keys, 50, CPU)
    for got, want in zip((plan.perm, plan.bounds), _host_plan(keys, 50)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    a, b = _keys(rng, 3000, 9).astype(np.int32), _keys(rng, 3000, 13).astype(np.int32)
    np.testing.assert_array_equal(_native.combine_codes(a, b, 13),
                                  tpu_native.combine_codes(a, b, 13))
    with pytest.raises(OverflowError):
        _native.combine_codes(np.array([70_000], np.int32), np.array([0], np.int32), 40_000)


def _pair_csr(case):
    """A CSR matrix of the pair plan's cases: a third of its rows empty, one
    nonzero a row, or a row that stores one column twice (scipy keeps a
    CSR's duplicates as given)."""
    from scipy import sparse as sps

    rng = np.random.default_rng(6)
    if case == "duplicate":
        return sps.csr_matrix((np.array([1.0, 2.0, -3.0, 0.5, 4.0, 7.0]),
                               np.array([0, 2, 2, 1, 3, 0]), np.array([0, 1, 5, 5, 6])),
                              shape=(4, 4))
    if case == "one_per_row":
        n, k, counts = 200, 9, np.ones(200, np.int64)
    else:
        n, k, counts = 300, 12, rng.integers(1, 6, 300)
        counts[::3] = 0
    indices = np.concatenate([np.sort(rng.choice(k, c, replace=False)) for c in counts])
    return sps.csr_matrix((rng.standard_normal(counts.sum()), indices,
                           np.concatenate([[0], np.cumsum(counts)])), shape=(n, k))


@pytest.mark.parametrize("case", ["empty_rows", "one_per_row", "duplicate", "int64_bounds"])
def test_pair_plan_is_the_host_argsorts(monkeypatch, case):
    """The sparse pair plan, sorted by ``build_plan`` on the plan's device:
    the JAX package's host argsort of the upper pairs' keys, bit for bit in
    the products, the rows and the bounds, values and dtypes; int64 bounds
    past ``INT32_MAX`` elements."""
    if case == "int64_bounds":
        monkeypatch.setattr(sparse_ops, "INT32_MAX", 0)
    csr = _pair_csr("empty_rows" if case == "int64_bounds" else case)
    n, k = csr.shape
    prod, plan = sparse_ops.pair_plan(csr, CPU)
    ia, ib, row = tpu_native.expand_pairs_csr(csr.indptr)
    ca, cb = csr.indices[ia].astype(np.int64), csr.indices[ib].astype(np.int64)
    upper = ca <= cb
    perm, bounds = _host_plan(ca[upper] * k + cb[upper], k * k)
    assert prod.dtype == torch.float64 and plan.perm.dtype == torch.int32
    assert plan.bounds.dtype == (torch.int64 if case == "int64_bounds" else torch.int32)
    np.testing.assert_array_equal(prod.numpy(), (csr.data[ia] * csr.data[ib])[upper][perm])
    np.testing.assert_array_equal(plan.perm.numpy(), row[upper][perm])
    np.testing.assert_array_equal(plan.bounds.numpy(), bounds)
    assert (plan.num_segments, plan.n_rows) == (k * k, n)


@pytest.mark.parametrize("compress", [False, True], ids=["cells", "compressed"])
@pytest.mark.parametrize("C", [1, 2])
def test_code_column_plan_is_the_host_argsorts(compress, C):
    """The (code, column) plan of ``C`` stacked code vectors with codes
    below 0 and past ``n_codes`` (in no column), sorted by ``build_plan``:
    the JAX package's host argsort of its keys, bit for bit in the data, the
    rows and the bounds, values and dtypes; compressed, over the observed
    cells only."""
    from scipy import sparse as sps

    rng = np.random.default_rng(7 + C)
    n, k, n_codes = 400, 6, 5
    csc = sps.random(n, k, density=0.3, format="csc", random_state=rng)
    codes = rng.integers(-1, n_codes + 2, C * n)
    a, plan, uniq = sparse_ops.code_column_plan(codes, n_codes, n, csc, CPU, compress=compress)
    rows = np.tile(csc.indices.astype(np.int64), C)
    cols = np.tile(np.repeat(np.arange(k), np.diff(csc.indptr)), C)
    code = codes[np.repeat(np.arange(C) * n, csc.nnz) + rows]
    keys = np.where((code >= 0) & (code < n_codes), code * k + cols, -1)
    W = n_codes * k
    if compress:
        valid = keys >= 0
        cells, inverse = np.unique(keys[valid], return_inverse=True)
        keys[valid] = inverse
        W = len(cells)
        np.testing.assert_array_equal(uniq.numpy(), cells)
    else:
        assert uniq is None
    perm, bounds = _host_plan(keys, W)
    assert a.dtype == torch.float64 and plan.perm.dtype == plan.bounds.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), np.tile(csc.data, C)[perm])
    np.testing.assert_array_equal(plan.perm.numpy(), rows[perm])
    np.testing.assert_array_equal(plan.bounds.numpy(), bounds)
    assert (plan.num_segments, plan.n_rows) == (W, n)


@pytest.mark.parametrize("kc", [1, 11, 300])
def test_mixed_design_plan_is_the_host_argsorts(kc):
    """The mixed design's ``cat_perm`` and ``cat_bounds``, built by
    ``build_plan``: the JAX package's host argsort of its codes, bit for
    bit, int32 both (at 300 levels on 1,000 rows, some segments empty)."""
    from scipy import sparse as sps

    from tabmat_torch.parallel import distributed

    rng = np.random.default_rng(kc)
    n = 1000
    codes = rng.integers(0, kc, n).astype(np.int32)
    sp = sps.random(n, 4, density=0.2, format="csr", random_state=rng)
    dz = distributed._mixed_design(rng.standard_normal((n, 3)), sp, codes, kc, CPU)
    perm, bounds = _host_plan(codes, kc)
    assert dz.cat_perm.dtype == dz.cat_bounds.dtype == torch.int32
    np.testing.assert_array_equal(dz.cat_perm.numpy(), perm)
    np.testing.assert_array_equal(dz.cat_bounds.numpy(), bounds)


@pytest.mark.parametrize(
    "n,W", [(5000, 3000), (20000, 100000), (4096, 1500), (2048, 1025), (100, 2000)]
)
def test_segsum_matches_interpreted_bucketed_kernel(n, W):
    """The sizes of tests/test_segsum_bucketed.py; its bar of 1e-13 relative."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, W, n).astype(np.int32)
    codes[rng.choice(n, max(n // 50, 1), replace=False)] = -1
    v = rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 3)
    want = np.asarray(psb.segsum_bucketed(
        jnp.asarray(v), jnp.asarray(build_codes_col(codes)), W, interpret=True))
    got = build_plan(codes, W, CPU).sum(torch.tensor(v)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


def _pair_representable(rng, n, dtype):
    """Values the TPU's (hi, lo) f32 pair holds exactly, as in
    tests/test_window_take.py, so that the interpreted take is exact."""
    if dtype == np.float32:
        return (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))).astype(np.float32)
    hi = rng.standard_normal(n).astype(np.float32).astype(np.float64)
    lo = (rng.standard_normal(n).astype(np.float32) * 2.0**-30).astype(np.float64)
    return (hi + lo) * np.exp2(rng.integers(-8, 8, size=n))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,src_len", [(1000, 500), (40_000, 40_000), (70_000, 3_000)])
def test_gather_of_sorted_indices_matches_interpreted_window_take(dtype, n, src_len):
    """A sorted index vector is the window take's case: exactly equal."""
    rng = np.random.default_rng(n + src_len)
    idx = np.sort(rng.integers(0, src_len, n))
    plan = wt.build_plan(idx)
    src = _pair_representable(rng, src_len, dtype)
    want = np.asarray(wt.monotone_take(
        jnp.asarray(src), plan, jnp.asarray(plan.codes2d), jnp.asarray(plan.ws),
        interpret=True))
    got = gather_kernel.gather(torch.tensor(src), torch.tensor(idx.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def _interpreted_gather(monkeypatch, table, codes, n):
    """``Σ_c table[codes[c·n + i]]`` through ``pallas_gather``'s kernel
    (f32, or f64 as two f32 planes) interpreted, a plane at a time, the
    planes summed in order in the table's type."""
    monkeypatch.setattr(pallas_gather.pl, "pallas_call",
                        partial(pallas_gather.pl.pallas_call, interpret=True))
    fn = pallas_gather._gather_f64 if table.dtype == np.float64 else pallas_gather._gather_f32
    out = None
    for plane in codes.reshape(-1, n):
        got = np.asarray(fn.__wrapped__(jnp.asarray(table),
                                        jnp.asarray(pallas_gather.build_codes2d(plane)), n))
        out = got if out is None else out + got
    return out


def _port_gather(table, codes, n, offset):
    """The port's gather of ``codes`` handed over as a view at ``offset``."""
    flat = torch.zeros(codes.size + offset, dtype=torch.int32)
    flat[offset:] = torch.tensor(codes)
    return gather_kernel.gather(torch.tensor(table), flat[offset:], n).numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("n,offset", [(1, 0), (6, 1), (33, 2), (1003, 3), (1000, 0)])
def test_gather_matches_interpreted_pallas_gather(monkeypatch, dtype, C, n, offset):
    """C stacked planes (each offset by the widths before it, the pad code
    past them), rows that leave every n % 4, codes views at offsets: equal
    to the interpreted kernel's planes summed in order."""
    rng = np.random.default_rng(C * 1000 + n)
    width = 50
    table = _pair_representable(rng, C * width, dtype)
    codes = np.concatenate([np.where(rng.random(n) < 0.1, C * width,
                                     rng.integers(0, width, n) + c * width)
                            for c in range(C)]).astype(np.int32)
    codes[rng.random(C * n) < 0.05] = -1
    want = _interpreted_gather(monkeypatch, table, codes, n)
    np.testing.assert_array_equal(_port_gather(table, codes, n, offset), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("C", [1, 2])
def test_gather_signed_zero_and_inf_behind_sentinels(monkeypatch, dtype, C):
    """A table with inf and NaN that only sentinels would reach (a clamped
    or multiplied-by-0 sentinel would read them) and -0.0 that codes do:
    equal to the interpreted kernel, and -0.0 kept where every term of a
    row is -0.0 (the sum starts from the first term, not from 0)."""
    rng = np.random.default_rng(C)
    n, width = 1003, 40
    table = _pair_representable(rng, width, dtype)
    table[[0, 1, width - 1]] = (np.inf, -0.0, np.nan)
    codes = rng.integers(1, width - 1, C * n)
    codes[rng.random(C * n) < 0.4] = 1
    pick = rng.random(C * n) < 0.2
    codes[pick] = rng.choice(np.array([-1, -2, width, width + 5]), int(pick.sum()))
    codes = codes.astype(np.int32)
    got = _port_gather(table, codes, n, offset=1)
    np.testing.assert_array_equal(got, _interpreted_gather(monkeypatch, table, codes, n))
    assert np.all(np.isfinite(got))
    planes = codes.reshape(C, n)
    all_neg_zero = np.all(planes == 1, axis=0)
    assert all_neg_zero.any()
    np.testing.assert_array_equal(np.signbit(got) & (got == 0), all_neg_zero)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,offset", [(1001, 1), (1002, 2), (1003, 3)])
def test_window_take_edges_match_interpreted(dtype, n, offset):
    """The window take's sorted indices at n % 4 != 0, handed over as views
    at offsets: exactly equal to the interpreted window kernel."""
    rng = np.random.default_rng(n)
    src_len = 700
    idx = np.sort(rng.integers(0, src_len, n))
    plan = wt.build_plan(idx)
    src = _pair_representable(rng, src_len, dtype)
    want = np.asarray(wt.monotone_take(
        jnp.asarray(src), plan, jnp.asarray(plan.codes2d), jnp.asarray(plan.ws),
        interpret=True))
    np.testing.assert_array_equal(_port_gather(src, idx.astype(np.int32), n, offset), want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
@pytest.mark.parametrize("width", [0, 1, 9])
def test_matvecs_match_reference_take(dtype, width):
    rng = np.random.default_rng(width)
    codes = rng.integers(-2, width + 1, 2000).astype(np.int32)
    codes[codes >= width] = -1  # a categorical's codes lie below its width
    v = (rng.standard_normal(width) * 10).astype(dtype)
    want = np.asarray(tpu_cat_ops.take_matvec(jnp.asarray(codes), jnp.asarray(v)))
    for fn in (categorical_ops.take_matvec, categorical_ops.routed_matvec):
        got = fn(torch.tensor(codes), torch.tensor(v))
        assert got.dtype == torch.tensor(v).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_sentinels_and_stacks():
    """Codes below 0 or past the table gather exactly 0; C stacked code
    vectors sum their C terms in order."""
    table = torch.tensor([1.5, -2.0, 4.0], dtype=torch.float64)
    codes = torch.tensor([0, -1, 2, 3, -7, 1], dtype=torch.int32)
    assert gather_kernel.gather(table, codes).tolist() == [1.5, 0, 4.0, 0, 0, -2.0]
    got = gather_kernel.gather(table, codes, 3)  # C = 2 rows of 3
    assert got.tolist() == [1.5 + 0, 0 + 0, 4.0 - 2.0]
    assert gather_kernel.gather(table[:0], codes).tolist() == [0.0] * 6


def test_wrappers_do_not_fall_back():
    """A tensor that lies neither on the CPU nor on a card raises: the plain
    version is taken only for a CPU tensor."""
    meta = torch.device("meta")
    table = torch.zeros(4, dtype=torch.float64, device=meta)
    codes = torch.zeros(6, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        gather_kernel.gather(table, codes)
    plan = build_plan(np.array([0, 1, 1]), 2, CPU)
    plan.perm, plan.bounds = plan.perm.to(meta), plan.bounds.to(meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        segsum_kernel.segsum(torch.zeros(3, dtype=torch.float64, device=meta), plan)
    with pytest.raises(TypeError):
        gather_kernel.gather(torch.zeros(4), torch.zeros(6, dtype=torch.int64))
    with pytest.raises(ValueError, match="rows"):
        segsum_kernel.segsum(torch.zeros(4, dtype=torch.float64), build_plan(np.zeros(3), 1, CPU))


def _decode_tiles(layout):
    """(tile, segment, local row, padding) of each position of a tiles-route
    layout."""
    off = layout["tile_off"].long()
    tile = torch.repeat_interleave(torch.arange(off.shape[0] - 1), off[1:] - off[:-1])
    words = layout["words"].long()
    row = words >> 16
    return tile, words & 0xFFFF, row, row == layout["R"]


def _layout_plans(rng, n, W):
    """A plan with sentinels, the stacked plan of two categoricals, and one
    whose rows all fall in tile 0 (rows past 300 are sentinels)."""
    keys = _keys(rng, n, W, missing=0.3)
    single = build_plan(keys, W, CPU)
    stacked = stack([single, build_plan(_keys(rng, n, W), W, CPU)])
    low = keys.copy()
    low[300:] = -1
    return {"sentinels": single, "stacked": stacked, "one_tile": build_plan(low, W, CPU)}


def _plan_pairs(plan):
    seg = torch.repeat_interleave(torch.arange(plan.num_segments), plan.bounds.diff().long())
    return seg, plan.perm.long()


@pytest.mark.parametrize("R", [1, 7, 512, 4096])
@pytest.mark.parametrize("W", [1, 7, 300])
@pytest.mark.parametrize("which", ["sentinels", "stacked", "one_tile"])
def test_tile_layout_holds_each_element_once_in_tile_order(which, W, R):
    """The tiles route's layout: every element of the plan once, tiles in
    order, (segment, row) order inside a tile, local rows below R, and
    padding to a multiple of ITEMS that reads the zero row R and keeps the
    tile's last segment."""
    rng = np.random.default_rng(W * 7 + R)
    n = 3001
    plan = _layout_plans(rng, n, W)[which]
    layout = segsum_kernel.tile_layout(plan, R)
    off = layout["tile_off"].long()
    assert off.shape[0] == -(-n // R) + 1 and off[0] == 0
    assert bool((off % segsum_kernel.ITEMS == 0).all()) and bool((off.diff() >= 0).all())
    tile, seg, row, pad = _decode_tiles(layout)
    real = ~pad
    assert bool((row[real] < R).all())
    grow = tile * R + row
    # the plan's (segment, row) pairs, each once; sentinel rows in none
    got = sorted(zip(seg[real].tolist(), grow[real].tolist()))
    want = sorted(zip(*(x.tolist() for x in _plan_pairs(plan))))
    assert got == want
    # inside a tile, (segment, row) increases; padding repeats the last segment
    key = tile * (1 << 40) + seg * (1 << 20) + grow
    same_tile = tile[1:] == tile[:-1]
    assert bool((key[1:][same_tile & real[1:]] > key[:-1][same_tile & real[1:]]).all())
    assert bool((seg[1:][pad[1:]] == seg[:-1][pad[1:]]).all())
    assert int(pad.sum()) < segsum_kernel.ITEMS * (off.shape[0] - 1)
    if which == "one_tile" and R >= 300:
        assert int((off.diff() > 0).sum()) == 1
    if which == "stacked":  # both copies of a row in its one tile
        first, second = plan.perm[: plan.perm.shape[0] // 2], plan.perm[plan.perm.shape[0] // 2:]
        assert set(first.tolist()) | set(second.tolist()) == set(grow[real].tolist())


@pytest.mark.parametrize("R", [1, 64, 4096])
@pytest.mark.parametrize("W", [1, 7, 3001])
@pytest.mark.parametrize("which", ["sentinels", "stacked", "one_tile"])
def test_slot_layout_puts_a_segments_slots_together_in_tile_order(which, W, R):
    """The slots route's layout: one slot per (tile, segment) run, a
    segment's slots together from ``slot_bounds[s]`` in tile order, and the
    same element order, rows and padding as the tiles route."""
    rng = np.random.default_rng(W * 11 + R)
    n = 3001
    plan = _layout_plans(rng, n, W)[which]
    layout = segsum_kernel.slot_layout(plan, R)
    off = layout["tile_off"].long()
    tile = torch.repeat_interleave(torch.arange(off.shape[0] - 1), off[1:] - off[:-1])
    row, slots = layout["rows"].long(), layout["slots"].long()
    sb = layout["slot_bounds"].long()
    assert sb.shape[0] == plan.num_segments + 1 and sb[0] == 0
    assert sb[-1] == layout["n_slots"] == int(slots.unique().numel())
    seg = torch.searchsorted(sb, slots, right=True) - 1  # the segment of each slot
    pad = row == R
    real = ~pad
    got = sorted(zip(seg[real].tolist(), (tile * R + row)[real].tolist()))
    assert got == sorted(zip(*(x.tolist() for x in _plan_pairs(plan))))
    # a run's elements share its slot; slots increase inside a tile
    runs = {}
    for t, s, k in zip(tile.tolist(), seg.tolist(), slots.tolist()):
        assert runs.setdefault((t, s), k) == k
    ordered = sorted(runs.items(), key=lambda item: item[1])
    assert [key for key, _ in ordered] == sorted(runs, key=lambda ts: (ts[1], ts[0]))
    # the tiles route sees the same elements in the same places
    if plan.num_segments <= 1 << 16:
        twin = segsum_kernel.tile_layout(plan, R)
        assert torch.equal(twin["tile_off"], layout["tile_off"])
        assert torch.equal(twin["words"].long() >> 16, row)
        assert torch.equal(twin["words"].long() & 0xFFFF, seg)


def _emulate(values, plan, route, R, blocks):
    """Passes 1 and 2 on the layout in plain torch: a tile's runs summed
    from its staged rows (padding reads a zero row), blocks over contiguous
    tile ranges; the tiles route adds each run to its block's accumulator
    and sums the blocks in order, the slots route writes each run to its
    slot and sums each segment's slots in order."""
    n, m = values.shape
    W = plan.num_segments
    tiles = -(-n // R)
    layout = (segsum_kernel.tile_layout if route == "tiles" else segsum_kernel.slot_layout)(
        plan, R)
    off = layout["tile_off"].long()
    tile = torch.repeat_interleave(torch.arange(tiles), off[1:] - off[:-1])
    if route == "tiles":
        row, key = layout["words"].long() >> 16, layout["words"].long() & 0xFFFF
    else:
        row, key = layout["rows"].long(), layout["slots"].long()
    staged = torch.cat([values, values.new_zeros(1, m)])
    grow = torch.where(row == R, n, tile * R + row)
    terms = staged[grow]
    # block b owns tiles [b·T/B, (b+1)·T/B)
    block = torch.searchsorted(torch.arange(blocks + 1) * tiles // blocks, tile, right=True) - 1
    if route == "tiles":
        partial = torch.zeros(blocks * W, m, dtype=values.dtype)
        partial.index_add_(0, block * W + key, terms)
        return partial.view(blocks, W, m).sum(0)
    slot_val = torch.zeros(layout["n_slots"], m, dtype=values.dtype)
    slot_val.index_add_(0, key, terms)
    sb = layout["slot_bounds"].long()
    return torch.stack([slot_val[sb[s]:sb[s + 1]].sum(0) for s in range(W)])


@pytest.mark.parametrize("route", ["tiles", "slots"])
@pytest.mark.parametrize("m", [1, 5, 9])
@pytest.mark.parametrize("W", [1, 7, 2000, "n"])
def test_row_tile_passes_equal_the_plain_sum(W, m, route):
    """A plain-torch emulation of both passes on the layouts equals
    ``segsum_plain`` to 1e-13 of each segment's sum of |v| (f64)."""
    rng = np.random.default_rng(m)
    n = 2503
    W = n if W == "n" else W
    plan = build_plan(_keys(rng, n, W, missing=0.2), W, CPU)
    if W == 2000:  # the stacked plan of two 1000-level categoricals
        plan = stack([build_plan(_keys(rng, n, 1000), 1000, CPU) for _ in range(2)])
    v = torch.tensor(rng.standard_normal((n, m)) * np.exp(rng.uniform(-3, 3, (n, m))))
    want = segsum_kernel.segsum_plain(v, plan.perm, plan.bounds)
    scale = segsum_kernel.segsum_plain(v.abs(), plan.perm, plan.bounds).clamp_min(1e-300)
    for R, blocks in ((64, 5), (1024, 2), (16384, 1)):
        got = _emulate(v, plan, route, R, min(blocks, -(-n // R)))
        assert float(((got - want).abs() / scale).max()) < 1e-13


def test_route_choice():
    """The tiles route with the widest column group and then the most rows a
    tile whose block fits, where the blocks' partials are no more than the
    elements; else the slots route.  At 1M rows on 132 SMs, two blocks an
    SM; the stacked plan holds two elements a row."""
    ssk = segsum_kernel
    wave = lambda R, G: 264  # noqa: E731
    n = 1_000_000
    assert ssk.choose_route(2000, 1, 2 * n, n, 2, 8, 132, wave) == ("tiles", 1024, 1)
    assert ssk.choose_route(2000, 5, 2 * n, n, 2, 8, 132, wave) == ("tiles", 1024, 5)
    assert ssk.choose_route(2000, 9, 2 * n, n, 2, 8, 132, wave) == ("tiles", 512, 8)
    assert ssk.choose_route(2000, 50, 2 * n, n, 2, 4, 132, wave) == ("tiles", 1024, 8)
    assert ssk.choose_route(10**6, 1, n, n, 1, 8, 132, wave) == ("slots", 1024, 1)
    assert ssk.choose_route(10**6, 50, n, n, 1, 4, 132, wave) == ("slots", 1024, 8)
    assert ssk.choose_route(2000, 1, 100_000, 100_003, 1, 8, 132, wave) == ("slots", 1024, 1)
    for W, m, size in ((2000, 5, 8), (2000, 9, 8), (1, 8, 4), (20_000, 1, 8)):
        route, R, G = ssk.choose_route(W, m, 10 * n, n, 2, size, 132, wave)
        assert route == "tiles" and 0 < G <= min(m, 8)
        tpb, mt = ssk.tiles_per_block(n, R, 132), ssk.max_tile(2, R)
        assert ssk.smem_bytes(R, G, W, size, False, tpb, mt) <= ssk.SMEM_MAX
        low = ssk.MIN_TILE_ROWS
        wider = ssk.smem_bytes(low, G + 1, W, size, False, tpb, ssk.max_tile(2, low))
        assert G == min(m, 8) or wider > ssk.SMEM_MAX
    assert ssk.tiles_per_block(n, 1024, 132) == 8 and ssk.tiles_per_block(100, 1024, 132) == 1
    assert ssk.max_tile(2, 1024) == 2048 and ssk.max_tile(3, 5) == 16


def test_layout_rejects_tiles_past_int16_rows():
    plan = build_plan(np.arange(10) % 3, 3, CPU)
    with pytest.raises(ValueError, match="R must"):
        segsum_kernel.tile_layout(plan, segsum_kernel.MAX_TILE_ROWS + 1)
    with pytest.raises(ValueError, match="R must"):
        segsum_kernel.slot_layout(plan, 0)
    with pytest.raises(ValueError, match="2\\^16"):
        segsum_kernel.tile_layout(build_plan(np.arange(10), 70_000, CPU))
