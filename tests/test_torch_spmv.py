"""The sparse segment product's plain version (the CPU route of ``spmv``)
against a numpy loop, and the wrapper's checks.

Layouts cover empty segments at the start, in the middle and at the end,
one segment holding every element, segments that cross the kernel's
threads (7 merge items each for m = 1), m ∈ {1, 5, 9} and an optional
per-row scale, in f64 and f32.  Tolerances: the loop sums in another order than ``index_add_``; f64 is
held to 1e-13 and f32 to 2e-5 of each segment's Σ|term| (the limits
``chip_smoke.py`` holds the kernel to).
"""

import numpy as np
import pytest
import torch

from tabmat_torch.ops import spmv_kernel
from tabmat_torch.ops.segments import SegmentPlan
from tabmat_torch.ops.spmv_kernel import spmv, spmv_plain

CPU = torch.device("cpu")
C = 7  # merge items a thread of csrc/spmv.cu takes for m = 1
TOL = {torch.float64: 1e-13, torch.float32: 2e-5}

# segment lengths of each layout
LAYOUTS = {
    "empty_start_middle_end": [0, 0, 3, 0, 5, 0, 0, 2, 0],
    "one_segment": [4 * C + 3],
    "crossing_chunks": [C - 1, 2, C + 1, 3 * C, 1, 0, C],
    "many_empty": [0] * 50 + [1] + [0] * 50 + [2 * C + 5] + [0] * 20,
    "all_empty": [0, 0, 0],
}


def _plan(lengths, n_src, rng):
    bounds = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    idx = rng.integers(0, n_src, int(bounds[-1])).astype(np.int32)
    return SegmentPlan(torch.as_tensor(idx), torch.as_tensor(bounds), n_src)


def _loop(values, idx, bounds, a, scale):
    """out[s] = Σ_t a[t] · scale[idx[t]] · values[idx[t]] by a plain loop."""
    out = np.zeros((len(bounds) - 1,) + values.shape[1:])
    mag = np.zeros_like(out)
    for s in range(len(bounds) - 1):
        for t in range(bounds[s], bounds[s + 1]):
            f = a[t] * (1.0 if scale is None else scale[idx[t]])
            out[s] += f * values[idx[t]]
            mag[s] += np.abs(f * values[idx[t]])
    return out, mag


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("with_scale", [False, True], ids=["a", "a*scale"])
@pytest.mark.parametrize("m", [1, 5, 9])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_matches_loop(layout, m, with_scale, dtype):
    rng = np.random.default_rng(len(LAYOUTS[layout]) * 10 + m)
    n_src = 37
    plan = _plan(LAYOUTS[layout], n_src, rng)
    E = plan.perm.shape[0]
    values = rng.standard_normal((n_src,) if m == 1 else (n_src, m))
    a = rng.standard_normal(E) * np.exp(rng.uniform(-2, 2, E))
    scale = rng.random(n_src) + 0.5 if with_scale else None

    def t(x):
        return None if x is None else torch.as_tensor(x, dtype=dtype)

    got = spmv(t(values), plan, t(a), t(scale))
    assert got.dtype == dtype
    assert got.shape == (plan.num_segments,) + values.shape[1:]
    # the loop on the values as the tensors hold them
    as_dtype = [None if x is None else t(x).double().numpy() for x in (values, a, scale)]
    want, mag = _loop(as_dtype[0], plan.perm.numpy(), plan.bounds.numpy(), as_dtype[1],
                      as_dtype[2])
    err = np.abs(got.double().numpy() - want) / np.maximum(mag, np.finfo(np.float64).tiny)
    assert err.max() <= TOL[dtype]
    # empty segments are exactly 0
    empty = np.asarray(LAYOUTS[layout]) == 0
    assert not got.numpy()[empty].any()
    assert torch.equal(got, spmv_plain(t(values), plan.perm, plan.bounds, t(a), t(scale)))


def test_csr_and_csc_layouts_are_plans():
    """A CSR matrix's indices and indptr are a layout as they stand: spmv
    over them is ``X @ v``, over the CSC ones ``X.T @ r``."""
    from scipy import sparse as sps

    keep = np.ones((60, 1))
    keep[7] = 0  # an empty row
    X = sps.csr_matrix(sps.random(60, 9, density=0.2, format="csr", random_state=3).multiply(keep))
    X.eliminate_zeros()
    X.sort_indices()
    assert X.indptr[7] == X.indptr[8]
    csr = SegmentPlan(torch.as_tensor(X.indices.astype(np.int32)),
                      torch.as_tensor(X.indptr.astype(np.int32)), 9)
    v = np.random.default_rng(0).standard_normal(9)
    got = spmv(torch.tensor(v), csr, torch.tensor(X.data))
    np.testing.assert_allclose(got.numpy(), X @ v, rtol=0, atol=1e-14)
    Xc = X.tocsc()
    csc = SegmentPlan(torch.as_tensor(Xc.indices.astype(np.int32)),
                      torch.as_tensor(Xc.indptr.astype(np.int32)), 60)
    r = np.random.default_rng(1).standard_normal((60, 3))
    got = spmv(torch.tensor(r), csc, torch.tensor(Xc.data))
    np.testing.assert_allclose(got.numpy(), Xc.T @ r, rtol=0, atol=1e-14)


def test_wrapper_checks():
    rng = np.random.default_rng(5)
    plan = _plan([3, 0, 4], 10, rng)
    v, a = torch.zeros(10, dtype=torch.float64), torch.ones(7, dtype=torch.float64)
    with pytest.raises(TypeError):
        spmv(v.numpy(), plan, a)
    with pytest.raises(TypeError, match="dtype"):
        spmv(v, plan, a.float())
    with pytest.raises(TypeError, match="float64 or float32"):
        spmv(v.long(), plan, a.long())
    with pytest.raises(ValueError, match="rank"):
        spmv(torch.zeros(10, 2, 2, dtype=torch.float64), plan, a)
    with pytest.raises(ValueError, match="rows"):
        spmv(torch.zeros(9, dtype=torch.float64), plan, a)
    with pytest.raises(ValueError, match="elements"):
        spmv(v, plan, a[:6])
    with pytest.raises(ValueError, match="scale"):
        spmv(v, plan, a, torch.ones(9, dtype=torch.float64))
    # a tensor that lies neither on the CPU nor on a card raises: the plain
    # version is taken only for a CPU tensor
    meta = torch.device("meta")
    plan.perm, plan.bounds = plan.perm.to(meta), plan.bounds.to(meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmv(v.to(meta), plan, a.to(meta))
    with pytest.raises(ValueError, match="device"):
        spmv(v, plan, a)


def test_empty_plan_returns_zeros():
    plan = _plan([0, 0], 4, np.random.default_rng(0))
    before = dict(spmv_kernel.launches)
    got = spmv(torch.ones(4, 3, dtype=torch.float32), plan, torch.zeros(0, dtype=torch.float32))
    assert torch.equal(got, torch.zeros(2, 3))
    assert spmv_kernel.launches == before  # the CPU takes the plain version
