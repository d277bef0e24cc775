"""The port's multi-device layer (``tabmat_torch.parallel``) on 8 CPU ranks.

One gloo world of 8 ranks, a (dp = 4) × (mp = 2) mesh, runs every case of
``tests/torch_multichip_cases.py`` once per module; each test below checks
one case's result on rank 0 against the JAX package's sharded form on its
8 virtual CPU devices (``tests/test_multichip.py``, run here in the parent)
and against the port on one device, and checks that every rank holds the
same bits where the result is whole.  The tests mirror
``tests/test_multichip.py`` by name; ``test_graft_entry_contract``'s is the
launcher's, and the smoke's phase 10 runs in ``tests/test_torch_smoke.py``.

Tolerances: a sandwich, a transpose-matvec or a segment sum atol 1e-11
(the reference's); a float64 step rtol 1e-8 / atol 1e-10; a step with the
float32 inner solve 1e-4 of the largest coefficient (``test_torch_glm.py``'s
rtol), since its Hessian is summed in float32 in another order.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import tabmat_tpu as tm
import tabmat_torch as tt
import torch_multichip_cases as cases
from tabmat_tpu import glm as tpu_glm
from tabmat_tpu.ops import dense_ops as tpu_dense_ops
from tabmat_tpu.parallel import distributed as tpu_distributed
from tabmat_tpu.parallel import shard_ops as tpu_shard_ops
from tabmat_tpu.parallel.design import DeviceDesign as TpuDesign
from tabmat_tpu.parallel.mesh import make_mesh as tpu_make_mesh
from tabmat_tpu.parallel.mesh import make_mesh_2level as tpu_make_mesh_2level
from tabmat_torch import glm
from tabmat_torch.convert import from_tabmat_tpu
from tabmat_torch.parallel import distributed, launch
from tabmat_torch.parallel.design import DeviceDesign

ATOL = 1e-11
STEP = {"rtol": 1e-8, "atol": 1e-10}
F32_STEP = 1e-4
TPU_STEP_KW = {"n_cg": cases.N_CG}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of every case, from one 8-rank gloo world."""
    return launch.run(cases.run_cases, cases.WORLD, "gloo", "cpu", timeout=300)


@pytest.fixture(scope="module")
def result(ranks):
    """name -> rank 0's result, after checking that the whole results agree
    bit for bit on every rank."""
    local = {"row_and_col_sharded_block", "user_ops", "user_rows", "standardized_ops",
             "uneven_rows", "budget_routes"}
    for name, value in ranks[0].items():
        if name in local:
            continue
        for rank, other in enumerate(ranks[1:], 1):
            for a, b in zip(_flat(value), _flat(other[name])):
                assert np.array_equal(a, b), f"{name} differs on rank {rank}"
    return ranks[0]


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return tpu_make_mesh(8, mp=2)


def _flat(value):
    return value if isinstance(value, tuple) else (value,)


def _rows(mesh, x, rows="dp"):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(rows)))


def _whole(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _check_step(got, ref, inner):
    if inner == "float64":
        np.testing.assert_allclose(got, np.asarray(ref), **STEP)
    else:
        assert _rel(got, ref) < F32_STEP


def _tpu_step(mesh, design, y, w, family, inner, rows="dp", dense_cols=None, **kw):
    """The JAX package's step on its sharded design."""
    k = design.shape[1]
    with mesh:
        got = tpu_glm.irls_step(
            design.shard(mesh, rows=rows, dense_cols=dense_cols), _rows(mesh, y, rows),
            _rows(mesh, w, rows), _whole(mesh, np.zeros(k)), family=family,
            inner_precision=inner, **TPU_STEP_KW, **kw)
        return np.asarray(got.block_until_ready())


def _port_step(design, y, w, family, inner, **kw):
    """The port's step on one device."""
    k = design.shape[1]
    return glm.irls_step(design, torch.as_tensor(y), torch.as_tensor(w),
                         torch.zeros(k, dtype=torch.float64), family=family, n_cg=cases.N_CG,
                         inner_precision=inner, **kw).numpy()


@pytest.fixture(scope="module")
def user():
    """The user path's problem, its JAX design and its port design on one device."""
    p = cases.user_problem()
    return (p, TpuDesign.from_matrix(cases.user_split(p, tm)),
            DeviceDesign.from_matrix(cases.user_split(p, tt, device="cpu")))


# -- the mirrors of tests/test_multichip.py --------------------------------


def test_row_sharded_sandwich_matches(result, mesh):
    X, d = cases.dense_problem(0, 1024, 6)
    with mesh:
        ref = tpu_dense_ops.sandwich(
            jax.device_put(jnp.asarray(X), NamedSharding(mesh, P("dp", None))), _rows(mesh, d))
    np.testing.assert_allclose(result["row_sharded_sandwich"], np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(result["row_sharded_sandwich"], (X * d[:, None]).T @ X,
                               atol=ATOL)


def test_row_and_col_sharded_sandwich(ranks, result, mesh):
    X, d = cases.dense_problem(1, 512, 8)
    with mesh:
        ref = tpu_dense_ops.sandwich(
            jax.device_put(jnp.asarray(X), NamedSharding(mesh, P("dp", "mp"))), _rows(mesh, d))
    np.testing.assert_allclose(result["row_and_col_sharded_sandwich"], np.asarray(ref),
                               atol=ATOL)
    # rank r holds rows (r // 2) * 128 : +128 and columns (r % 2) * 4 : +4
    for r, out in enumerate(ranks):
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(out["row_and_col_sharded_block"],
                                      X[i * 128:(i + 1) * 128, j * 4:(j + 1) * 4])


def test_sharded_segment_plan_sum(result, mesh):
    from tabmat_tpu.ops.segments import build_plan

    codes, v = cases.codes_problem(2, 4096, 32)
    with mesh:
        ref = build_plan(codes, 32).sum(_rows(mesh, v))
    np.testing.assert_allclose(result["sharded_segment_plan_sum"], np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(result["sharded_segment_plan_sum"],
                               np.bincount(codes, weights=v, minlength=32), atol=ATOL)


def test_mixed_design_step_matches_single_device(result, mesh):
    n, kd, ks, kc = cases.MIXED_SHAPE
    dz = tpu_distributed.build_mixed_design(n, kd, ks, kc, seed=1)
    y = cases.mixed_problem()
    k = kd + ks + kc
    dz_sharded = tpu_distributed.MixedDesign(
        dense=jax.device_put(dz.dense, NamedSharding(mesh, P("dp", "mp"))),
        **{name: _whole(mesh, getattr(dz, name)) for name in distributed.FIELDS[1:]
           if name not in ("cat_codes", "cat_perm")},
        cat_codes=_rows(mesh, dz.cat_codes), cat_perm=_rows(mesh, dz.cat_perm))
    with mesh:
        ref = tpu_distributed.mixed_irls_step(dz_sharded, _rows(mesh, y),
                                              _rows(mesh, np.ones(n)), _whole(mesh, np.zeros(k)),
                                              family="poisson", n_cg=6)
    np.testing.assert_allclose(result["mixed_step"], np.asarray(ref), **STEP)
    port = distributed.mixed_irls_step(
        distributed.build_mixed_design(n, kd, ks, kc, seed=1, device="cpu"), torch.as_tensor(y),
        torch.ones(n, dtype=torch.float64), torch.zeros(k, dtype=torch.float64), n_cg=6)
    np.testing.assert_allclose(result["mixed_step"], port.numpy(), **STEP)


def test_graft_entry_contract():
    """The launcher's contract: each rank's result comes back by rank, and
    a rank that raises fails the run with its traceback."""
    with pytest.raises(RuntimeError, match="rank 1 raised:(.|\n)*fails on purpose"):
        launch.run(cases.fail_on_rank, 3, "gloo", "cpu", 1, timeout=120)


def test_shard_map_sandwich(result, mesh):
    X, d = cases.dense_problem(10, 2048, 7)
    ref = tpu_shard_ops.sharded_sandwich(
        *tpu_shard_ops.place_row_sharded(mesh, jnp.asarray(X), jnp.asarray(d)), mesh)
    np.testing.assert_allclose(result["shard_map_sandwich"], np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(result["shard_map_sandwich"], (X * d[:, None]).T @ X, atol=ATOL)


def test_shard_map_pallas_v4_sandwich(result, mesh):
    """The plane sandwich's case (exponents over 2⁻⁶ to 2⁶) through the
    port's sharded sandwich: the int8 plane cache is the TPU's alone."""
    X, d = cases.dense_problem(12, 5000, 7, spread=True)
    ref = (X * d[:, None]).T @ X
    assert _rel(result["plane_case_sandwich"], ref) < 1e-13
    tpu = tpu_shard_ops.sharded_sandwich(
        *tpu_shard_ops.place_row_sharded(mesh, jnp.asarray(X), jnp.asarray(d)), mesh)
    assert _rel(result["plane_case_sandwich"], tpu) < 1e-13


def test_shard_map_tmv(result, mesh):
    X, v = cases.dense_problem(11, 1024, 5)
    ref = tpu_shard_ops.sharded_transpose_matvec(
        *tpu_shard_ops.place_row_sharded(mesh, jnp.asarray(X), jnp.asarray(v)), mesh)
    np.testing.assert_allclose(result["shard_map_tmv"], np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(result["shard_map_tmv"], X.T @ v, atol=ATOL)


def test_shard_map_segment_sum(result, mesh):
    codes, v = cases.codes_problem(12, 4096, 17)
    vs, cs = tpu_shard_ops.place_row_sharded(mesh, jnp.asarray(v), jnp.asarray(codes))
    ref = tpu_shard_ops.sharded_segment_sum(vs, cs, 17, mesh)
    np.testing.assert_allclose(result["shard_map_segment_sum"], np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(result["shard_map_segment_sum"],
                               np.bincount(codes, weights=v, minlength=17), atol=ATOL)


def test_user_path_sharded_irls(result, mesh, user):
    p, ref_design, port_design = user
    ones = np.ones(len(p["codes"]))
    got = result["user_step_poisson_float64"]
    _check_step(got, _tpu_step(mesh, ref_design, p["y"]["poisson"], ones, "poisson", "float64",
                               dense_cols="mp"), "float64")
    _check_step(got, _port_step(port_design, p["y"]["poisson"], ones, "poisson", "float64"),
                "float64")


def test_user_path_two_level_mesh(result):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh2 = tpu_make_mesh_2level(dcn=2, dp=4, mp=1)
    codes, y = cases.two_level_problem()
    ref_design = TpuDesign.from_matrix(tm.CategoricalMatrix(codes, categories=np.arange(7)))
    ones = np.ones(len(y))
    ref = _tpu_step(mesh2, ref_design, y, ones, "poisson", "float64", rows=("dcn", "dp"))
    _check_step(result["two_level_step"], ref, "float64")
    port = DeviceDesign.from_matrix(tt.CategoricalMatrix(codes, categories=np.arange(7),
                                                         device="cpu"))
    _check_step(result["two_level_step"], _port_step(port, y, ones, "poisson", "float64"),
                "float64")


# -- beyond the mirrors ------------------------------------------------------


@pytest.mark.parametrize("inner", cases.INNER)
@pytest.mark.parametrize("family", cases.FAMILIES)
def test_user_path_every_family(result, mesh, user, family, inner):
    p, ref_design, port_design = user
    ones = np.ones(len(p["codes"]))
    got = result[f"user_step_{family}_{inner}"]
    assert np.all(np.isfinite(got))
    _check_step(got, _tpu_step(mesh, ref_design, p["y"][family], ones, family, inner,
                               dense_cols="mp"), inner)
    _check_step(got, _port_step(port_design, p["y"][family], ones, family, inner), inner)


def test_user_path_ops_and_weights(ranks, result, user):
    """The sharded design's matvec is the rank's rows, its transpose-matvec
    and sandwich the whole; a weighted, ridge-penalized step."""
    p, _, port_design = user
    v = torch.linspace(-1, 1, port_design.shape[1], dtype=torch.float64)
    w = torch.as_tensor(p["weights"])
    full = port_design.matvec(v).numpy()
    for out in ranks:
        lo, hi = out["user_rows"]
        mv, tmv, H = out["user_ops"]
        np.testing.assert_allclose(mv, full[lo:hi], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tmv, port_design.transpose_matvec(w).numpy(), atol=ATOL)
        np.testing.assert_allclose(H, port_design.sandwich(w).numpy(), atol=ATOL)
    _check_step(result["user_step_weighted"],
                _port_step(port_design, p["y"]["poisson"], p["weights"], "poisson", "float64",
                           l2=0.1), "float64")


@pytest.mark.parametrize("inner", cases.INNER)
def test_standardized_design(ranks, result, mesh, inner):
    p = cases.user_problem()
    ref_design = TpuDesign.from_matrix(cases.standardized(cases.user_split(p, tm)))
    port = DeviceDesign.from_matrix(cases.standardized(cases.user_split(p, tt, device="cpu")))
    ones = np.ones(len(p["codes"]))
    got = result[f"standardized_step_{inner}"]
    _check_step(got, _tpu_step(mesh, ref_design, p["y"]["poisson"], ones, "poisson", inner,
                               dense_cols="mp"), inner)
    _check_step(got, _port_step(port, p["y"]["poisson"], ones, "poisson", inner), inner)
    v = torch.linspace(-1, 1, port.shape[1], dtype=torch.float64)
    tmv, mv, supports = result["standardized_ops"]
    assert not supports
    np.testing.assert_allclose(tmv, port.transpose_matvec(torch.as_tensor(p["weights"])).numpy(),
                               atol=ATOL)
    full = port.matvec(v).numpy()
    for out in ranks:
        lo, hi = out["user_rows"]
        np.testing.assert_allclose(out["standardized_ops"][1], full[lo:hi], rtol=1e-12,
                                   atol=1e-12)


def test_fit_glm(result, mesh, user):
    p, ref_design, port_design = user
    beta, n_iter = result["fit_glm"]
    with mesh:
        ref, ref_iter = tpu_glm.fit_glm(
            ref_design.shard(mesh, dense_cols="mp"), _rows(mesh, p["y"]["poisson"]),
            family="poisson", max_iter=20, tol=1e-8, n_cg=16, inner_precision="float64")
    port, port_iter = glm.fit_glm(port_design, p["y"]["poisson"], family="poisson", max_iter=20,
                                  tol=1e-8, n_cg=16, inner_precision="float64")
    assert n_iter == ref_iter == port_iter < 20
    np.testing.assert_allclose(beta, np.asarray(ref), **STEP)
    np.testing.assert_allclose(beta, port.numpy(), **STEP)


def test_fit_glm_l1(result, user):
    """An elastic-net fit runs FISTA epochs through the sharded design."""
    p, ref_design, port_design = user
    beta, n_iter = result["fit_glm_l1"]
    ref, _ = tpu_glm.fit_glm(ref_design, p["y"]["gaussian"], family="gaussian", l1=0.05,
                             max_iter=3, tol=0.0)
    port, _ = glm.fit_glm(port_design, p["y"]["gaussian"], family="gaussian", l1=0.05,
                          max_iter=3, tol=0.0)
    assert n_iter == 3
    np.testing.assert_allclose(beta, np.asarray(ref), **STEP)
    np.testing.assert_allclose(beta, port.numpy(), **STEP)


def test_uneven_rows(ranks, result):
    """1021 rows over dp = 4 split as ``np.array_split`` does."""
    q = cases.user_problem(cases.UNEVEN_N, seed=5)
    assert [out["uneven_rows"] for out in ranks] == [256, 256, 255, 255, 255, 255, 255, 255]
    ones = np.ones(cases.UNEVEN_N)
    ref_design = TpuDesign.from_matrix(cases.user_split(q, tm))
    port = DeviceDesign.from_matrix(cases.user_split(q, tt, device="cpu"))
    got = result["uneven_step"]
    # the JAX package's device_put refuses 1021 rows over 4 shards: its step
    # on one device
    ref = tpu_glm.irls_step(ref_design, jnp.asarray(q["y"]["poisson"]), jnp.asarray(ones),
                            jnp.zeros(ref_design.shape[1]), family="poisson",
                            inner_precision="float64", **TPU_STEP_KW)
    _check_step(got, ref, "float64")
    _check_step(got, _port_step(port, q["y"]["poisson"], ones, "poisson", "float64"), "float64")


def test_budget_refusing_on_one_rank(ranks, result, user):
    """A zero budget on rank 0 refuses its pair plan; the ranks agree on the
    Hessian-vector route, and the step is the sandwich route's."""
    assert [out["budget_routes"] for out in ranks] == [(False, False)] + [(True, False)] * 7
    p, _, port_design = user
    ones = np.ones(len(p["codes"]))
    _check_step(result["budget_step"],
                _port_step(port_design, p["y"]["poisson"], ones, "poisson", "float64"), "float64")


def test_make_mesh_errors(result):
    assert result["mesh_error_n_devices"] == "n_devices=8 not divisible by mp=3"
    assert result["mesh_error_world"] == "need 16 ranks, have 8"
    with pytest.raises(RuntimeError, match="no process group"):
        tt.parallel.make_mesh(1, device="cpu")


def test_build_mixed_design_bit_for_bit():
    ref = tpu_distributed.build_mixed_design(300, 4, 7, 11, seed=3, density=0.2)
    port = distributed.build_mixed_design(300, 4, 7, 11, seed=3, density=0.2, device="cpu")
    assert distributed.FIELDS == ref._fields
    for name in distributed.FIELDS:
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_from_tabmat_tpu_mixed_design():
    ref = tpu_distributed.build_mixed_design(300, 4, 7, 11, seed=4)
    port = from_tabmat_tpu(ref, device="cpu")
    assert isinstance(port, distributed.MixedDesign)
    rng = np.random.default_rng(0)
    v, r = rng.standard_normal(22), rng.standard_normal(300)
    np.testing.assert_allclose(distributed.design_matvec(port, torch.as_tensor(v)).numpy(),
                               np.asarray(tpu_distributed.design_matvec(ref, jnp.asarray(v))),
                               atol=1e-12)
    np.testing.assert_allclose(
        distributed.design_transpose_matvec(port, torch.as_tensor(r)).numpy(),
        np.asarray(tpu_distributed.design_transpose_matvec(ref, jnp.asarray(r))), atol=1e-12)


def test_parallel_imports_no_jax():
    """``tabmat_torch.parallel`` exports the JAX package's names and imports
    nothing of JAX."""
    import tabmat_tpu.parallel as tpu_parallel

    public = {n for n, v in vars(tpu_parallel).items()
              if not n.startswith("_") and not type(v).__name__ == "module"}
    assert public <= set(dir(tt.parallel))
    code = ("import sys, tabmat_torch.parallel, tabmat_torch.parallel.shard_ops, "
            "tabmat_torch.parallel.launch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tabmat_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "[]"
