"""The port's segment sum and gather (plain versions, on the CPU) against
the JAX functions their modules replace.

The JAX package runs as its own tests run it here: ``SegmentPlan`` on its
argsort/cumsum route and ``take_matvec``, and the two Pallas kernels that
have an interpret mode (``pallas_segsum_bucketed``, ``pallas_window_take``)
interpreted at the sizes of ``tests/test_segsum_bucketed.py`` and
``tests/test_window_take.py``.  Tolerances: ``atol=1e-12`` as in
``tests/test_matrices.py``, except where a test says why otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tabmat_tpu.ops import categorical_ops as tpu_cat_ops
from tabmat_tpu.ops import pallas_segsum_bucketed as psb
from tabmat_tpu.ops import pallas_window_take as wt
from tabmat_tpu.ops import segments as tpu_segments
from tabmat_tpu.ops.pallas_segsum import build_codes_col

from tabmat_torch import _native
from tabmat_torch.ops import categorical_ops, gather_kernel, segsum_kernel
from tabmat_torch.ops.segments import build_plan, stack

CPU = torch.device("cpu")


def _keys(rng, n, W, missing=0.1):
    keys = rng.integers(0, W, n)
    keys[rng.random(n) < missing] = -1
    return keys


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
        v = rng.standard_normal((n, m))
        got, want = port.sum2d(torch.tensor(v)), ref.sum2d(jnp.asarray(v))
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


def test_stacked_plan_is_the_plans_in_turn():
    rng = np.random.default_rng(4)
    n = 500
    ka, kb = _keys(rng, n, 7), _keys(rng, n, 11)
    a, b = build_plan(ka, 7, CPU), build_plan(kb, 11, CPU)
    v = torch.tensor(rng.standard_normal(n))
    got = stack([a, b]).sum(v)
    assert torch.equal(got, torch.cat([a.sum(v), b.sum(v)]))


def test_native_helpers_match_reference():
    from tabmat_tpu import _native as tpu_native

    rng = np.random.default_rng(5)
    keys = _keys(rng, 3000, 50).astype(np.int32)
    for got, want in zip(_native.counting_argsort(keys, 50),
                         tpu_native.counting_argsort(keys, 50)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    a, b = _keys(rng, 3000, 9).astype(np.int32), _keys(rng, 3000, 13).astype(np.int32)
    np.testing.assert_array_equal(_native.combine_codes(a, b, 13),
                                  tpu_native.combine_codes(a, b, 13))
    with pytest.raises(OverflowError):
        _native.combine_codes(np.array([70_000], np.int32), np.array([0], np.int32), 40_000)


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


def test_spanning_segments():
    """The segments the CUDA kernel's second pass joins: exactly those whose
    elements lie in more than one chunk."""
    C = segsum_kernel.CHUNK
    bounds = torch.tensor([0, 3, 3, C, C + 1, 3 * C + 2, 3 * C + 2], dtype=torch.int32)
    assert segsum_kernel.spanning_segments(bounds).tolist() == [4]
    bounds = torch.tensor([0, C + 1, C + 1, 2 * C], dtype=torch.int32)
    assert segsum_kernel.spanning_segments(bounds).tolist() == [0]
