"""The cell ``sparse_wide_std.fit``: its generator, its reference against a
dense NumPy IRLS, ``spmv_roofline.std_fit``'s counts, a correct run on the
CPU, and the faults the comparison that decides ``correct`` has to catch,
each planted in the timed path underneath a whole run.

The fault runs keep the configuration's settings at 3,000 rows by 400
columns, where the reference's Hessian takes milliseconds on the CPU; the
correct run is ``_cpu_run``'s, at 20,000 rows by the configuration's 10,000
columns (about three minutes on the CPU, most of it the reference's
Hessians).
"""

import io
import json

import numpy as np
import pytest
import torch

import tabmat_torch
import tabmat_torch.glm
from _cpu_run import BENCH, SEED, cpu_run
from glmbench import spec
from glmbench.data import sparse_wide, sparse_wide_std_poisson
from glmbench.harness import main
from glmbench.metrics._sparse_roofline import op_counts
from glmbench.reference import irls as numpy_irls
from glmbench.reference.standardized_intercept import StandardizedInterceptDesign, irls
from tabmat_torch.models.base import MatrixBase
from tabmat_torch.parallel.design import DeviceDesign

CELL = "sparse_wide_std.fit"
CONFIG = spec.find(CELL)["config"]
H100 = "NVIDIA H100 80GB HBM3"
ROOFLINE = spec.metric_reader("spmv_roofline.std_fit")


def run(control=False, rows=3000, cols=400, seed=SEED):
    """(exit code, result line) of a whole run on the CPU at ``rows`` × ``cols``."""
    out = io.StringIO()
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "0.3", "--trace", "0"]
    rc = main(argv + (["--control"] if control else []), device="cpu",
              overrides={"rows": rows, "cols": cols}, out=out, bench=BENCH)
    return rc, json.loads(out.getvalue().splitlines()[-1])


def test_the_generator_repeats_and_its_response_has_the_stated_moments():
    config = dict(CONFIG, rows=4000)
    a, b = (sparse_wide_std_poisson.make(config, 2**31 + 11, 1)[0] for _ in range(2))
    assert (a["csc"] != b["csc"]).nnz == 0 and np.array_equal(a["y"], b["y"])
    # the design is sparse_wide's draw from the same seed, untouched by the response's
    X = sparse_wide.make(config, 2**31 + 11, 1)[0]["csc"]
    assert (a["csc"] != X).nnz == 0
    assert np.array_equal(a["weights"], np.ones(4000))
    other = sparse_wide_std_poisson.make(config, 2**31 + 12, 1)[0]
    assert not np.array_equal(a["y"], other["y"])
    # the linear predictor of the stated b: sd about 0.58 (100 entries a row of
    # variance 1/3 times 0.1²), and the counts' mean that of exp(eta)
    rng = np.random.default_rng(np.random.SeedSequence(2**31 + 11, spawn_key=(0, 0)))
    eta = -0.5 + X @ rng.normal(0.0, 0.1, X.shape[1])
    assert 0.52 < eta.std() < 0.64
    mu = np.exp(eta)
    assert abs(a["y"].mean() - mu.mean()) < 5 * np.sqrt(mu.mean() / 4000)
    assert np.all(a["y"] == np.round(a["y"])) and a["y"].min() >= 0


class DenseDesign:
    """``[1 | Z]`` densified with NumPy, for ``reference/irls.py``."""

    def __init__(self, A):
        self.X = A
        self.shape = A.shape

    def matvec(self, v):
        return self.X @ v

    def tmv(self, r):
        return self.X.T @ r

    def hessian(self, w):
        return (self.X * w[:, None]).T @ self.X


def test_the_reference_fit_is_a_dense_numpy_irls():
    config = dict(CONFIG, rows=1500, cols=120, density=0.05)
    data = sparse_wide_std_poisson.make(config, 5, 1)[0]
    ref = sparse_wide_std_poisson.reference_design(data, config)
    assert isinstance(ref, StandardizedInterceptDesign)
    A = data["csc"].toarray()
    mean = A.mean(axis=0)
    std = np.sqrt(((A - mean) ** 2).mean(axis=0))
    Z = np.hstack([np.ones((1500, 1)), (A - mean) / std])
    ps = sparse_wide_std_poisson.penalty_scale(config, 121)
    want, _ = numpy_irls.irls(DenseDesign(Z), data["y"], data["weights"], "poisson", l2=1.5, ps=ps)
    got, _ = irls(ref, data["y"], data["weights"], "poisson", l2=1.5, ps=ps)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # and the reference's own NumPy ops through the NumPy IRLS
    again, _ = numpy_irls.irls(ref, data["y"], data["weights"], "poisson", l2=1.5, ps=ps)
    assert np.abs(again - want).max() <= 1e-12 * np.abs(want).max()


def test_spmv_roofline_counts_by_hand():
    n, k, nnz = 40_000, 10_000, 4_000_000
    # float64: 12 bytes an entry, int32 pointers, the vector gathered and the one written
    assert ROOFLINE.call_bytes("matvec", n, k, nnz, 8) == 48_000_000 + 160_004 + 400_000
    assert ROOFLINE.call_bytes("tmv", n, k, nnz, 8) == 48_000_000 + 40_004 + 400_000
    for op in ("matvec", "tmv"):
        assert ROOFLINE.call_bytes(op, n, k, nnz, 8) == op_counts(op, n, k, nnz)[0]
    # float32: 8 bytes an entry, the vectors at 4 bytes
    assert ROOFLINE.call_bytes("matvec", n, k, nnz, 4) == 32_000_000 + 160_004 + 200_000
    assert ROOFLINE.call_bytes("tmv", n, k, nnz, 4) == 32_000_000 + 40_004 + 200_000
    assert ROOFLINE.least_seconds("spmv<double>", CONFIG, H100) == pytest.approx(
        48_500_004 / 3.35e12)
    assert ROOFLINE.least_seconds("spmv<float>", CONFIG, H100) == pytest.approx(
        32_300_004 / 3.35e12)
    assert ROOFLINE.least_seconds("spmv<float>", CONFIG, "some other card") is None


def test_spmv_roofline_reads_the_traced_calls_over_the_kernels_time():
    least = (ROOFLINE.least_seconds("spmv<double>", CONFIG, H100) * 4
             + ROOFLINE.least_seconds("spmv<float>", CONFIG, H100) * 100)
    records = [
        {"kind": "fit", "traced": True, "spmv_launches": {"spmv<double>": 2, "spmv<float>": 50}},
        {"kind": "fit", "traced": True, "spmv_launches": {"spmv<double>": 2, "spmv<float>": 50}},
        {"kind": "fit", "traced": False, "spmv_launches": {"spmv<double>": 2, "spmv<float>": 50}},
    ]
    device_us = 2.5 * least * 1e6
    trace = {"by_name": {
        "void (anonymous namespace)::spmv_tiles<float, 1, int>(float const*)": 0.8 * device_us,
        "void (anonymous namespace)::spmv_carries<double, 256, int>(int const*)": 0.2 * device_us,
        "void at::native::elementwise_kernel<128, 4>()": 10 * device_us,
    }}
    ctx = {"trace": trace, "records": records, "config": CONFIG, "device_name": H100}
    assert ROOFLINE.read(ctx) == pytest.approx(40.0)
    assert ROOFLINE.read(dict(ctx, trace=None)) is None
    assert ROOFLINE.read(dict(ctx, trace={"by_name": {}})) is None
    # a parent whose records carry no launch counts reads nothing, and raises nothing
    bare = [{k: v for k, v in r.items() if k != "spmv_launches"} for r in records]
    assert ROOFLINE.read(dict(ctx, records=bare)) is None


def test_a_small_run_on_the_cpu_is_correct():
    rc, result, _ = cpu_run(CELL, rows=20000)
    assert rc == 0 and result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "fit_s"}
    assert result["checks"]["beta_relerr"]["value"] <= 1e-9


def test_a_run_at_the_fault_tests_size_is_correct():
    rc, result = run()
    assert rc == 0 and result["correct"] is True, result["checks"]
    assert result["checks"]["beta_relerr"]["value"] <= 1e-12


def test_the_control_is_not_correct():
    rc, result = run(control=True)
    assert rc == 0 and result["correct"] is False


def test_a_fit_that_is_not_finite_is_not_correct(monkeypatch):
    fit = tabmat_torch.fit_glm

    def broken(*args, **kwargs):
        beta, n_iter = fit(*args, **kwargs)
        return torch.full_like(beta, float("nan")), n_iter

    monkeypatch.setattr(tabmat_torch, "fit_glm", broken)
    rc, result = run()
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["beta_relerr"]["value"] == float("inf")
    assert result["failed"] == result["attempted"]


def _shift_sum_dropped(tmv):
    def dropped(self, r):
        out = tmv(self, r)
        return out if self.shift is None else out - self.shift * torch.sum(r)
    return dropped


def _mult_on_one_side(matvec):
    def one_side(self, v):
        mult, self.mult = self.mult, None
        try:
            return matvec(self, v)
        finally:
            self.mult = mult
    return one_side


@pytest.mark.parametrize("fault", ["intercept_penalised", "mult_on_one_side",
                                   "weights_left_out_of_the_means"])
def test_a_planted_fault_is_caught(fault, monkeypatch):
    if fault == "intercept_penalised":
        step = tabmat_torch.glm.irls_step

        def penalised(X, y, w, beta, **kw):
            return step(X, y, w, beta, **dict(kw, penalty_scale=torch.ones_like(beta)))

        monkeypatch.setattr(tabmat_torch.glm, "irls_step", penalised)
    elif fault == "mult_on_one_side":
        monkeypatch.setattr(DeviceDesign, "matvec", _mult_on_one_side(DeviceDesign.matvec))
    else:
        # the weights (1/n, summing to one) replaced by ones: column sums
        means = MatrixBase._get_col_means
        monkeypatch.setattr(MatrixBase, "_get_col_means",
                            lambda self, weights: means(self, np.ones_like(weights)))
    rc, result = run()
    assert rc == 0 and result["correct"] is False, result["checks"]
    assert not result["checks"]["beta_relerr"]["value"] <= 1e-6


def test_a_dropped_shift_sum_term_leaves_the_fixed_point(monkeypatch):
    """``DeviceDesign.transpose_matvec`` without its ``shift · Σ r`` term
    gives the same β: the unpenalised intercept's score is ``Σ r`` itself,
    so every fixed point of the step has ``Σ r = 0`` and the term is 0
    there.  The fault changes the steps' path, not the fit, and no
    comparison of β can see it in this deployment."""
    monkeypatch.setattr(DeviceDesign, "transpose_matvec",
                        _shift_sum_dropped(DeviceDesign.transpose_matvec))
    rc, result = run()
    assert rc == 0 and result["correct"] is True
    assert result["checks"]["beta_relerr"]["value"] <= 1e-12
