"""The rank side of ``tests/test_torch_multichip.py``: every case, run once
by each rank of one world.

The ranks are spawned processes that import this module by name, so it
imports numpy, scipy, torch and the port, and never JAX.  The inputs are
made here from seeds, for the ranks and for the parent's references alike.
"""

import numpy as np
import torch
from scipy import sparse as sps

import tabmat_torch as tt
from tabmat_torch import _config
from tabmat_torch.glm import fit_glm, irls_step
from tabmat_torch.parallel import shard_ops
from tabmat_torch.parallel.design import DeviceDesign
from tabmat_torch.parallel.distributed import (build_mixed_design, mixed_irls_step,
                                               shard_mixed_design)
from tabmat_torch.parallel.mesh import (make_mesh, make_mesh_2level, row_range, shard_rows,
                                        shard_rows_cols)

WORLD, DP, MP = 8, 4, 2
FAMILIES = ("gaussian", "poisson", "logistic", "gamma", "inverse_gaussian", "tweedie")
INNER = ("float64", "float32")
N_CG = 5


def dense_problem(seed: int, n: int, k: int, spread: bool = False):
    """``(X, d)`` of a sandwich case; ``spread`` scales columns and weights
    over 2⁻⁶ to 2⁶ and 2⁻³ to 2³ (the plane sandwich's case)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, k))
    if spread:
        X = X * np.exp2(rng.uniform(-6, 6, size=(1, k)))
        return X, rng.random(n) * np.exp2(rng.uniform(-3, 3, size=n))
    return X, rng.random(n)


def codes_problem(seed: int, n: int, K: int):
    """``(codes, values)`` of a segment-sum case."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, K, n).astype(np.int32)
    return codes, rng.random(n)


def user_problem(n: int = 1024, seed: int = 21):
    """The user path's design (``tests/test_multichip.py:214-228``): 4
    dense columns, 5 sparse at 10%, a 9-level categorical, and a target for
    each family, all from one seed."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, 4))
    sparse = sps.random(n, 5, density=0.1, random_state=4, format="csc")
    codes = rng.integers(0, 9, n).astype(np.int32)
    y = {"poisson": rng.poisson(1.5, n).astype(np.float64)}
    y["gaussian"] = rng.standard_normal(n)
    y["logistic"] = (rng.random(n) < 0.4).astype(np.float64)
    positive = rng.gamma(2.0, 0.5, n)
    for family in ("gamma", "inverse_gaussian", "tweedie"):
        y[family] = positive
    return {"dense": dense, "sparse": sparse, "codes": codes, "y": y,
            "weights": rng.random(n) + 0.5}


def user_split(p: dict, package, **kw):
    """The user path's SplitMatrix in ``package`` (the port or the JAX one)."""
    return package.SplitMatrix([
        package.DenseMatrix(p["dense"], **kw),
        package.SparseMatrix(p["sparse"], **kw),
        package.CategoricalMatrix(p["codes"], categories=np.arange(9), **kw),
    ])


def standardized(split):
    """The split standardized with uniform weights (centred and scaled)."""
    n = split.shape[0]
    std, _, _ = split.standardize(np.full(n, 1.0 / n), True, True)
    return std


def two_level_problem():
    """The two-level mesh's case (``tests/test_multichip.py:260-268``)."""
    rng = np.random.default_rng(22)
    codes = rng.integers(0, 7, 512).astype(np.int32)
    return codes, rng.poisson(1.0, 512).astype(np.float64)


def mixed_problem(n: int = 512):
    """The mixed design's step (``tests/test_multichip.py:78-83``)."""
    rng = np.random.default_rng(3)
    return rng.poisson(2.0, n).astype(np.float64)


MIXED_SHAPE = (512, 8, 6, 10)
UNEVEN_N = 1021


def _np(t):
    return t.detach().cpu().numpy()


def _step(design, mesh, y, w, family, inner, rows="dp", **kw):
    k = design.shape[1]
    return _np(irls_step(design, shard_rows(y, mesh, rows), shard_rows(w, mesh, rows),
                         torch.zeros(k, dtype=torch.float64, device=design.device),
                         family=family, n_cg=N_CG, inner_precision=inner, **kw))


def run_cases(device) -> dict:
    """Every case on this rank's share of a (4 × 2) mesh; returns name ->
    numpy result, the same on every rank where the result is whole."""
    out = {}
    mesh = make_mesh(WORLD, mp=MP, device=device)
    for label, fn in (("n_devices", lambda: make_mesh(WORLD, mp=3, device=device)),
                      ("world", lambda: make_mesh(2 * WORLD, device=device))):
        try:
            fn()
            out["mesh_error_" + label] = None
        except ValueError as e:
            out["mesh_error_" + label] = str(e)

    # the shard_map kernels
    X, d = dense_problem(0, 1024, 6)
    out["row_sharded_sandwich"] = _np(shard_ops.sharded_sandwich(
        shard_rows(X, mesh), shard_rows(d, mesh), mesh))
    X, d = dense_problem(1, 512, 8)
    out["row_and_col_sharded_block"] = _np(shard_rows_cols(X, mesh))
    dm = DeviceDesign.from_matrix(tt.DenseMatrix(X, device="cpu"))
    out["row_and_col_sharded_sandwich"] = _np(
        dm.shard(mesh, dense_cols="mp").sandwich(shard_rows(d, mesh)))
    codes, v = codes_problem(2, 4096, 32)
    cat = DeviceDesign.from_matrix(tt.CategoricalMatrix(codes, categories=np.arange(32),
                                                        device="cpu"))
    out["sharded_segment_plan_sum"] = _np(cat.shard(mesh).transpose_matvec(shard_rows(v, mesh)))
    X, d = dense_problem(10, 2048, 7)
    Xs, ds = shard_ops.place_row_sharded(mesh, X, d)
    out["shard_map_sandwich"] = _np(shard_ops.sharded_sandwich(Xs, ds, mesh))
    X, d = dense_problem(12, 5000, 7, spread=True)
    Xs, ds = shard_ops.place_row_sharded(mesh, X, d)
    out["plane_case_sandwich"] = _np(shard_ops.sharded_sandwich(Xs, ds, mesh))
    X, v = dense_problem(11, 1024, 5)
    Xs, vs = shard_ops.place_row_sharded(mesh, X, v)
    out["shard_map_tmv"] = _np(shard_ops.sharded_transpose_matvec(Xs, vs, mesh))
    codes, v = codes_problem(12, 4096, 17)
    vs, cs = shard_ops.place_row_sharded(mesh, v, codes)
    out["shard_map_segment_sum"] = _np(shard_ops.sharded_segment_sum(vs, cs, 17, mesh))

    # the mixed design's step
    dz = build_mixed_design(*MIXED_SHAPE, seed=1, device="cpu")
    y = mixed_problem()
    k = sum(MIXED_SHAPE[1:])
    out["mixed_step"] = _np(mixed_irls_step(
        shard_mixed_design(dz, mesh), shard_rows(y, mesh), shard_rows(np.ones(len(y)), mesh),
        torch.zeros(k, dtype=torch.float64), family="poisson", n_cg=6, mesh=mesh))

    # the user path: DeviceDesign.shard -> irls_step, every family, both precisions
    p = user_problem()
    design = DeviceDesign.from_matrix(user_split(p, tt, device="cpu"))
    sharded = design.shard(mesh, rows="dp", dense_cols="mp")
    out["user_ops"] = (
        _np(sharded.matvec(torch.linspace(-1, 1, design.shape[1], dtype=torch.float64))),
        _np(sharded.transpose_matvec(shard_rows(p["weights"], mesh))),
        _np(sharded.sandwich(shard_rows(p["weights"], mesh))),
    )
    out["user_rows"] = row_range(design.shape[0], mesh)
    ones = np.ones(design.shape[0])
    for family in FAMILIES:
        for inner in INNER:
            out[f"user_step_{family}_{inner}"] = _step(sharded, mesh, p["y"][family], ones,
                                                      family, inner)
    out["user_step_weighted"] = _step(sharded, mesh, p["y"]["poisson"], p["weights"],
                                      "poisson", "float64", l2=0.1)
    std = DeviceDesign.from_matrix(standardized(user_split(p, tt, device="cpu")))
    std_sharded = std.shard(mesh, dense_cols="mp")
    out["standardized_ops"] = (
        _np(std_sharded.transpose_matvec(shard_rows(p["weights"], mesh))),
        _np(std_sharded.matvec(torch.linspace(-1, 1, std.shape[1], dtype=torch.float64))),
        std_sharded.supports_sandwich,
    )
    for inner in INNER:
        out[f"standardized_step_{inner}"] = _step(std_sharded, mesh, p["y"]["poisson"], ones,
                                                  "poisson", inner)
    beta, n_iter = fit_glm(sharded, shard_rows(p["y"]["poisson"], mesh), family="poisson",
                           max_iter=20, tol=1e-8, n_cg=16, inner_precision="float64")
    out["fit_glm"] = (_np(beta), n_iter)
    beta, n_iter = fit_glm(sharded, shard_rows(p["y"]["gaussian"], mesh), family="gaussian",
                           l1=0.05, max_iter=3, tol=0.0)
    out["fit_glm_l1"] = (_np(beta), n_iter)

    # 1021 rows over dp = 4: slabs of 256, 255, 255, 255
    q = user_problem(UNEVEN_N, seed=5)
    uneven = DeviceDesign.from_matrix(user_split(q, tt, device="cpu")).shard(
        mesh, dense_cols="mp")
    out["uneven_rows"] = uneven.n_local
    out["uneven_step"] = _step(uneven, mesh, q["y"]["poisson"], np.ones(UNEVEN_N), "poisson",
                               "float64")

    # a budget that refuses the pair plan on rank 0 alone: every rank takes
    # the Hessian-vector route
    if torch.distributed.get_rank() == 0:
        _config.set_cache_budget_mb(0)
    try:
        budget = design.shard(mesh, dense_cols="mp")
        local = DeviceDesign.supports_sandwich.fget(budget)
    finally:
        _config.set_cache_budget_mb(None)
    out["budget_routes"] = (local, budget.supports_sandwich)
    out["budget_step"] = _step(budget, mesh, p["y"]["poisson"], ones, "poisson", "float64")

    # the two-level mesh: rows over ("dcn", "dp"), summed over dp, then dcn
    mesh2 = make_mesh_2level(dcn=2, dp=4, mp=1, device=device)
    codes, y = two_level_problem()
    cm = DeviceDesign.from_matrix(tt.CategoricalMatrix(codes, categories=np.arange(7),
                                                       device="cpu"))
    out["two_level_step"] = _step(cm.shard(mesh2, rows=("dcn", "dp")), mesh2, y,
                                  np.ones(len(y)), "poisson", "float64", rows=("dcn", "dp"))
    return out


def graph_step_cases(device) -> dict:
    """The user path's sharded step (both inner precisions) and fit, each
    with the explicit-Hessian CG solve as the card's CUDA graph and as the
    eager loop; and each way's ``_trace`` counters."""
    from tabmat_torch import _trace, glm

    mesh = make_mesh(WORLD, mp=MP, device=device)
    p = user_problem()
    design = DeviceDesign.from_matrix(user_split(p, tt, device="cpu"))
    sharded = design.shard(mesh, rows="dp", dense_cols="mp")
    ones = np.ones(design.shape[0])
    graph = glm._cg_solve_dense

    def eager(H, b, n_iter):
        return glm._cg_solve(lambda v: H @ v, b, n_iter)

    out = {"supports_sandwich": sharded.supports_sandwich}
    for label, solve in (("graph", graph), ("eager", eager)):
        glm._cg_solve_dense = solve
        _trace.enable()
        try:
            for inner in INNER:
                out[f"step_{inner}_{label}"] = _step(sharded, mesh, p["y"]["poisson"], ones,
                                                     "poisson", inner)
            beta, n_iter = fit_glm(sharded, shard_rows(p["y"]["poisson"], mesh),
                                   family="poisson", max_iter=20, tol=1e-8, n_cg=16,
                                   inner_precision="float64")
            out[f"fit_glm_{label}"] = (_np(beta), n_iter)
        finally:
            glm._cg_solve_dense = graph
            _trace.disable()
        out[f"counters_{label}"] = _trace.take()["counters"]
    return out


def fail_on_rank(device, rank: int) -> int:
    """Raise on ``rank``; the others return their rank."""
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return torch.distributed.get_rank()
