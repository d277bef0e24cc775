"""The port's benchmark CLI (``tabmat_torch/bench/``) on the CPU.

The generators give the same designs as the JAX package's, bit for bit, and
the three ops agree on them; the CLI tests mirror
``tests/test_benchmark_cli.py`` through ``main([..., "--device", "cpu"])``.
"""

import json
import os
import tracemalloc

import jax  # noqa: F401  (both packages are imported by the parity tests)
import numpy as np
import pytest
import torch

import tabmat_tpu as tm
import tabmat_torch as tt
from tabmat_tpu.bench.generate import get_all_benchmark_matrices as tpu_designs
from tabmat_torch.bench import main as bench
from tabmat_torch.bench.generate import get_all_benchmark_matrices

CPU = torch.device("cpu")
DESIGNS = ("dense", "sparse", "sparse_narrow", "sparse_wide", "one_cat", "two_cat",
           "dense_cat", "dense_smallcat")
# the standardized variants of docs/benchmarks/run_round5.sh
STANDARDIZED = ("dense", "sparse", "two_cat", "dense_cat")


def _dense(x) -> np.ndarray:
    if isinstance(x, (tt.DiagonalResult, tm.DiagonalResult)):
        return np.asarray(x.diag)  # both packages give one_cat's as a diagonal
    return np.asarray(x)


def _agree(got, want, rtol=1e-12):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize(
    "name, standardized",
    [(name, False) for name in DESIGNS] + [(name, True) for name in STANDARDIZED],
)
def test_designs_match_the_jax_package(name, standardized):
    ref = tpu_designs(scale=0.0005)[name]()
    mat = get_all_benchmark_matrices(scale=0.0005, device=CPU)[name]()
    assert type(mat).__name__ == type(ref).__name__ and mat.shape == ref.shape
    if not standardized:
        np.testing.assert_array_equal(mat.toarray(), np.asarray(ref.toarray()))
    else:
        ref = tm.StandardizedMatrix(ref, np.zeros(ref.shape[1]))
        mat = tt.StandardizedMatrix(mat, np.zeros(mat.shape[1]))
    for op in bench.OPS:
        x = bench.op_inputs(mat.shape, op)
        got = bench.device_fn(mat, op, torch.as_tensor(x))()
        want = bench.device_fn(ref, op, x)()
        _agree(got, want)


def test_generators_tiny():
    designs = get_all_benchmark_matrices(scale=0.0001, device=CPU)
    for name in ("dense", "sparse", "two_cat"):
        mat = designs[name]()
        assert mat.shape[0] >= 16
        d = np.random.default_rng(0).random(mat.shape[0])
        mat.sandwich(d)


def _run(capsys, *args):
    rows = bench.main(list(args) + ["--device", "cpu"])
    out = capsys.readouterr().out
    printed = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert printed == rows
    return rows, out


def test_cli_smoke(capsys):
    rows, out = _run(capsys, "--matrix_name", "dense,sparse", "--scale", "0.0001",
                     "--n_iterations", "2", "--include_baseline")
    assert "tabmat_torch" in out
    assert "numpy/scipy" in out
    assert len(rows) == 12
    for row in rows:
        assert np.isfinite(row["time_s"]) and row["time_s"] > 0
        assert "hbm_cache_bytes" not in row  # the CPU has no device memory
        if row["library"] == "numpy/scipy":
            assert row["max_rel_err"] <= 1e-13


def test_cli_memory_and_standardized(capsys):
    rows, out = _run(capsys, "--matrix_name", "dense", "--scale", "0.0001",
                     "--n_iterations", "2", "--bench_memory", "--standardized")
    assert "peak_mem_bytes" in out
    assert [r["operation"] for r in rows] == list(bench.OPS)


def test_cli_csv_and_visualize(tmp_path, capsys):
    csv_path = str(tmp_path / "out.csv")
    _run(capsys, "--matrix_name", "dense,sparse", "--scale", "0.0001", "--n_iterations", "2",
         "--include_baseline", "--output", csv_path)
    from tabmat_torch.bench.visualize import load_results, plot_relative

    rows = load_results(csv_path)
    assert len(rows) == 12
    png = str(tmp_path / "chart.png")
    assert plot_relative(rows, png) == png
    assert os.path.getsize(png) > 10_000


def test_dense_baseline_is_a_numpy_product():
    """ROADMAP C: the JAX CLI's baseline of a DenseMatrix is a scipy CSR
    product (``tabmat_tpu/bench/main.py:144``); the port's is numpy's."""
    mat = get_all_benchmark_matrices(scale=0.0001, device=CPU)["dense"]()
    arr = bench.baseline_array(mat)
    assert type(arr) is np.ndarray
    A = mat.toarray()
    for op in bench.OPS:
        x = bench.op_inputs(mat.shape, op)
        res = bench.baseline_fn(arr, op, x)()
        assert type(res) is np.ndarray
    d = bench.op_inputs(mat.shape, "sandwich")
    np.testing.assert_array_equal(res, (A * d[:, None]).T @ A)


def test_baseline_of_a_split_design_follows_its_column_order():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((50, 3))
    cat = tt.CategoricalMatrix(rng.integers(0, 4, 50), device=CPU)
    mat = tt.SplitMatrix([tt.DenseMatrix(X, device=CPU), cat], [[0, 2, 5], [1, 3, 4, 6]])
    np.testing.assert_array_equal(bench.baseline_array(mat).toarray(), mat.toarray())


def test_max_rel_err_holds_a_diagonal_against_the_diagonal():
    from scipy import sparse as sps

    ref = sps.diags([2.0, 4.0]).tocsr()
    assert bench.max_rel_err(np.array([2.0, 4.0]), ref) == 0.0
    assert bench.max_rel_err(np.array([2.0, 5.0]), ref) == 0.25
    assert bench.max_rel_err(np.array([[2.0, 1.0], [0.0, 4.0]]), ref) == 0.25


def test_cli_without_a_device_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main(["--matrix_name", "dense", "--scale", "0.0001"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        get_all_benchmark_matrices(scale=0.0001)["dense"]()


def test_cli_rejects_unknown_ops_and_designs():
    with pytest.raises(SystemExit):
        bench.main(["--ops", "matvec,inverse", "--device", "cpu"])
    with pytest.raises(SystemExit):
        bench.main(["--matrix_name", "dense,desne", "--device", "cpu"])


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    _run(capsys, "--matrix_name", "dense", "--ops", "matvec", "--scale", "0.0001",
         "--n_iterations", "2", "--profile_dir", str(tmp_path))
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def _traced_peak(fn) -> int:
    """The most host bytes ``fn`` held above those it started with, from
    ``tracemalloc``'s own peak, which sees every transient allocation."""
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        fn()
        return tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()


def test_standardized_tmv_makes_no_row_index():
    """ROADMAP C: the JAX package's standardized transpose-matvec builds
    ``np.arange(n)`` for its rows (``tabmat_tpu/models/standardized.py:161``),
    the host peak of the JAX CLI's standardized tmv rows; the port's builds
    nothing of n elements on the host.  The peaks are tracemalloc's own: the
    CLI's 1 ms polling thread can miss a transient that is freed at once."""
    n = 200_000
    X = np.random.default_rng(0).standard_normal((n, 3))
    v = np.random.default_rng(1).standard_normal(n)
    mat = tt.StandardizedMatrix(tt.DenseMatrix(X, device=CPU), np.zeros(3))
    v_t = torch.as_tensor(v)
    assert _traced_peak(lambda: mat.transpose_matvec(v_t)) < n
    ref = tm.StandardizedMatrix(tm.DenseMatrix(X), np.zeros(3))
    assert _traced_peak(lambda: ref.transpose_matvec(v)) >= 4 * n
    np.testing.assert_allclose(mat.transpose_matvec(v_t).numpy(), X.T @ v, rtol=1e-12)
