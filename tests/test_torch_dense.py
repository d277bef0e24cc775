"""DenseMatrix and StandardizedMatrix: the port against tabmat_tpu.

The dense and standardized rows of the ``tests/test_matrices.py`` contract.
Every case builds one input from numpy, runs it through both packages and
compares at that file's tolerance (atol 1e-12): sandwich, matvec and
transpose_matvec with ``rows``/``cols``, numpy ``out=`` updated in place,
tensor ``out=`` (in place in the port, functional in JAX), standardize,
and the dtype and shape errors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tabmat_tpu as tm
import tabmat_torch as tt
from tabmat_torch.convert import from_tabmat_tpu


def base_array(order="C") -> np.ndarray:
    return np.array(
        [
            [0.0, -0.1],
            [1.0, 0.0],
            [0.0, 2.3],
            [-2.4, 0.0],
            [1.2, 0.5],
            [0.0, 0.0],
            [0.7, -1.1],
            [0.0, 0.4],
        ],
        order=order,
    )


def dense_C():
    return tm.DenseMatrix(base_array("C")), tt.DenseMatrix(base_array("C"), device="cpu")


def dense_F():
    return tm.DenseMatrix(base_array("F")), tt.DenseMatrix(base_array("F"), device="cpu")


def dense_1d():
    return tm.DenseMatrix(base_array()[:, 0]), tt.DenseMatrix(base_array()[:, 0], device="cpu")


def dense_readonly():
    arr = base_array()
    arr.setflags(write=False)
    return tm.DenseMatrix(arr), tt.DenseMatrix(arr, device="cpu")


def dense_from_device_array():
    return tm.DenseMatrix(jnp.asarray(base_array())), tt.DenseMatrix(torch.tensor(base_array()))


def dense_converted():
    ref = tm.DenseMatrix(base_array(), column_names=["a", "b"])
    return ref, from_tabmat_tpu(ref, device="cpu")


def standardized_shift():
    shift = np.array([0.3, -0.1])
    ref = tm.StandardizedMatrix(tm.DenseMatrix(base_array()), shift)
    return ref, tt.StandardizedMatrix(tt.DenseMatrix(base_array(), device="cpu"), shift)


def standardized_shift_scale():
    shift, mult = np.array([0.3, -0.1]), np.array([0.7, 1.3])
    ref = tm.StandardizedMatrix(tm.DenseMatrix(base_array("F")), shift, mult)
    return ref, tt.StandardizedMatrix(tt.DenseMatrix(base_array("F"), device="cpu"), shift, mult)


def standardized_converted():
    ref = tm.StandardizedMatrix(
        tm.DenseMatrix(base_array()), np.array([0.2, 0.1]), np.array([2.0, 0.5])
    )
    return ref, from_tabmat_tpu(ref, device="cpu")


ZOO = [
    dense_C,
    dense_F,
    dense_1d,
    dense_readonly,
    dense_from_device_array,
    dense_converted,
    standardized_shift,
    standardized_shift_scale,
    standardized_converted,
]
DENSE_ZOO = [f for f in ZOO if f.__name__.startswith("dense")]
RESTRICT = ["rows", "cols", "both", "none"]


@pytest.fixture(params=ZOO, ids=[f.__name__ for f in ZOO])
def pair(request):
    return request.param()


def _np(x):
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


def _close(got, ref):
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-12)


def _restriction(mat, restrict):
    rows = np.array([0, 2, 3, 6], dtype=np.int32) if restrict in ("rows", "both") else None
    cols = (
        np.unique([0, mat.shape[1] - 1]).astype(np.int32)
        if restrict in ("cols", "both")
        else None
    )
    return rows, cols


def _rng(pair, salt):
    return np.random.default_rng(hash((pair[0].shape, salt)) % 2**32)


def test_shape_dtype_toarray(pair):
    ref, port = pair
    assert port.shape == ref.shape
    assert port.dtype == np.float64
    _close(port.toarray(), ref.toarray())


def test_matvec(pair):
    ref, port = pair
    v = _rng(pair, 1).standard_normal(ref.shape[1])
    got = port.matvec(v)
    assert isinstance(got, np.ndarray)
    _close(got, ref.matvec(v))


def test_matvec_cols(pair):
    ref, port = pair
    v = _rng(pair, 2).standard_normal(ref.shape[1])
    cols = np.unique([0, ref.shape[1] - 1]).astype(np.int32)
    _close(port.matvec(v, cols=cols), ref.matvec(v, cols=cols))


def test_matvec_numpy_out_in_place(pair):
    ref, port = pair
    rng = _rng(pair, 3)
    v = rng.standard_normal(ref.shape[1])
    out = rng.standard_normal(ref.shape[0])
    out_ref = out.copy()
    res = port.matvec(v, out=out)
    assert res is out
    _close(out, ref.matvec(v, out=out_ref))


def test_matvec_tensor_out_in_place(pair):
    ref, port = pair
    rng = _rng(pair, 4)
    v = rng.standard_normal(ref.shape[1])
    out0 = rng.standard_normal(ref.shape[0])
    out = torch.tensor(out0)
    res = port.matvec(torch.tensor(v), out=out)
    assert res is out  # the port updates a tensor out= in place
    _close(out, ref.matvec(jnp.asarray(v), out=jnp.asarray(out0)))


def test_matvec_wrong_shape_raises(pair):
    _, port = pair
    with pytest.raises(ValueError, match="not aligned"):
        port.matvec(np.ones(port.shape[1] + 1))


def test_transpose_matvec(pair):
    ref, port = pair
    v = _rng(pair, 5).standard_normal(ref.shape[0])
    _close(port.transpose_matvec(v), ref.transpose_matvec(v))


@pytest.mark.parametrize("restrict", RESTRICT)
def test_transpose_matvec_restricted(pair, restrict):
    ref, port = pair
    v = _rng(pair, 6).standard_normal(ref.shape[0])
    rows, cols = _restriction(ref, restrict)
    _close(port.transpose_matvec(v, rows, cols), ref.transpose_matvec(v, rows, cols))


@pytest.mark.parametrize("flavor", ["numpy", "tensor"])
def test_transpose_matvec_out(pair, flavor):
    ref, port = pair
    rng = _rng(pair, 7)
    v = rng.standard_normal(ref.shape[0])
    rows, cols = _restriction(ref, "both")
    out0 = rng.standard_normal(ref.shape[1])
    expected = np.asarray(ref.transpose_matvec(v, rows, cols, out=out0.copy()))
    out = out0.copy() if flavor == "numpy" else torch.tensor(out0)
    vec = v if flavor == "numpy" else torch.tensor(v)
    res = port.transpose_matvec(vec, rows, cols, out=out)
    assert res is out
    _close(out, expected)


def test_transpose_matvec_wrong_out_raises(pair):
    _, port = pair
    with pytest.raises(ValueError):
        port.transpose_matvec(np.ones(port.shape[0]), out=np.zeros(port.shape[1] + 2))


@pytest.mark.parametrize("restrict", RESTRICT)
def test_sandwich(pair, restrict):
    ref, port = pair
    d = _rng(pair, 8).random(ref.shape[0])
    rows, cols = _restriction(ref, restrict)
    got = port.sandwich(d, rows, cols)
    assert isinstance(got, np.ndarray)
    _close(got, ref.sandwich(d, rows, cols))


@pytest.mark.parametrize("restrict", RESTRICT)
def test_sandwich_tensor_flavor(pair, restrict):
    ref, port = pair
    d = _rng(pair, 9).random(ref.shape[0])
    rows, cols = _restriction(ref, restrict)
    got = port.sandwich(torch.tensor(d), rows, cols)
    assert torch.is_tensor(got)
    _close(got, ref.sandwich(jnp.asarray(d), rows, cols))


def test_sandwich_bad_dtype_raises(pair):
    _, port = pair
    d = np.ones(port.shape[0], dtype=np.float32)
    with pytest.raises(TypeError):
        port.sandwich(d)
    with pytest.raises(TypeError):
        port.sandwich(torch.tensor(d))


def test_sandwich_bad_shape_raises(pair):
    _, port = pair
    with pytest.raises(ValueError):
        port.sandwich(np.ones(port.shape[0] + 1))


def test_rmatmul_and_matmul(pair):
    ref, port = pair
    rng = _rng(pair, 10)
    v, u = rng.standard_normal(ref.shape[0]), rng.standard_normal(ref.shape[1])
    _close(v @ port, v @ ref)
    _close(port @ u, ref @ u)


def test_tensor_flavor_matvecs(pair):
    ref, port = pair
    rng = _rng(pair, 11)
    u, v = rng.standard_normal(ref.shape[1]), rng.standard_normal(ref.shape[0])
    got_mv = port.matvec(torch.tensor(u))
    got_tmv = port.transpose_matvec(torch.tensor(v))
    assert torch.is_tensor(got_mv) and torch.is_tensor(got_tmv)
    _close(got_mv, ref.matvec(jnp.asarray(u)))
    _close(got_tmv, ref.transpose_matvec(jnp.asarray(v)))


@pytest.mark.parametrize("make", DENSE_ZOO, ids=[f.__name__ for f in DENSE_ZOO])
@pytest.mark.parametrize("center,scale", [(True, True), (False, False), (False, True), (True, False)])
def test_standardize(make, center, scale):
    pair = make()
    ref, port = pair
    w = _rng(pair, 12).random(ref.shape[0])
    w /= w.sum()
    std_r, means_r, stds_r = ref.standardize(w, center, scale)
    std_p, means_p, stds_p = port.standardize(w, center, scale)
    _close(means_p, means_r)
    assert (stds_p is None) == (stds_r is None)
    if stds_r is not None:
        _close(stds_p, stds_r)
    _close(std_p.toarray(), std_r.toarray())
    assert std_p.unstandardize() is port
    d = _rng(pair, 13).random(ref.shape[0])
    _close(std_p.sandwich(d), std_r.sandwich(d))


def test_getcol_astype_names(pair):
    ref, port = pair
    for i in [0, ref.shape[1] - 1]:
        _close(port.getcol(i).toarray(), ref.getcol(i).toarray())
    assert port.astype(np.float32).dtype == np.float32
    assert port.astype(torch.float32).dtype == np.float32
    assert port.get_names(missing_prefix="_col_") == ref.get_names(missing_prefix="_col_")


@pytest.mark.parametrize(
    "key",
    [
        (slice(1, 5), slice(None)),
        (slice(None, None, -1), 0),
        ([0, 3, 5], slice(None)),
        ([0, 3], [1, 0]),
        2,
    ],
    ids=["slice", "reversed", "rows", "mesh", "int"],
)
def test_getitem(key):
    arr = np.arange(24.0).reshape(6, 4)
    ref = tm.DenseMatrix(arr, column_names=list("abcd"))
    port = tt.DenseMatrix(arr, column_names=list("abcd"), device="cpu")
    got, want = port[key], ref[key]
    _close(got.toarray(), want.toarray())
    assert got.column_names == want.column_names


def test_zero_sd_cols_standardize():
    X, _, _ = tt.DenseMatrix(np.ones([100, 1]), device="cpu").standardize(np.full(100, 0.01), True, True)
    np.testing.assert_allclose(X.mult, [1.0])
    assert np.all(np.isfinite(X.toarray()))


def test_bad_construction_raises():
    with pytest.raises(ValueError):
        tt.DenseMatrix(np.ones((2, 2, 2)), device="cpu")
    with pytest.raises(ValueError):
        tt.DenseMatrix(np.ones((3, 2)), column_names=["a"], device="cpu")
    with pytest.raises(TypeError):
        tt.StandardizedMatrix(np.ones((3, 2)), np.zeros(2))
    with pytest.raises(ValueError):
        tt.StandardizedMatrix(tt.DenseMatrix(np.ones((3, 2)), device="cpu"), np.zeros(3))


def test_host_input_is_copied():
    arr = base_array()
    port = tt.DenseMatrix(arr, device="cpu")
    arr[0, 0] = 99.0
    assert port.toarray()[0, 0] == 0.0


def test_hstack_and_as_tabmat():
    a, b = base_array(), base_array()[:, :1] * 2
    ref = tm.hstack([a, tm.DenseMatrix(b)])
    port = tt.hstack([a, tt.DenseMatrix(b, device="cpu")])
    assert isinstance(port, tt.DenseMatrix)
    _close(port.toarray(), ref.toarray())
    assert tt.as_tabmat(port) is port
    assert isinstance(tt.as_tabmat(torch.tensor(a)), tt.DenseMatrix)
    with pytest.raises(ValueError):
        tt.hstack([])


def test_not_ported_inputs_raise():
    from scipy import sparse as sps

    # scipy input is a SparseMatrix since ROADMAP A4
    got = tt.as_tabmat(sps.eye(3, format="csc"), device="cpu")
    assert isinstance(got, tt.SparseMatrix)
    np.testing.assert_array_equal(got.toarray(), np.eye(3))
    # as in the reference, a StandardizedMatrix is no block of a SplitMatrix
    std = tt.StandardizedMatrix(tt.DenseMatrix(base_array(), device="cpu"), np.zeros(2))
    with pytest.raises(ValueError, match="MatrixBase"):
        tt.hstack([np.ones((8, 1)), std])
    with pytest.raises(ValueError, match="MatrixBase"):
        tm.hstack([np.ones((8, 1)), tm.StandardizedMatrix(tm.DenseMatrix(base_array()), np.zeros(2))])
