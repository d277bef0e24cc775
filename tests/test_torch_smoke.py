"""The port stays free of JAX, and ``chip_smoke.py`` works at a tiny size.

``chip_smoke.py``'s phases take the device and the sizes as arguments, so
its main-path phase runs here on the CPU, where the sandwich takes its plain
version.  ``main()`` itself refuses to run without CUDA.
"""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages are imported by the parity tests)
import numpy as np
import pytest
import torch

import tabmat_tpu as tm

from tabmat_torch.ops.sandwich_kernel import sandwich_plain

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_import_leaves_jax_out():
    code = (
        "import sys, tabmat_torch, tabmat_torch.convert, tabmat_torch.parallel.design, "
        "tabmat_torch._build, tabmat_torch.constructors, tabmat_torch.formula, "
        "tabmat_torch.formula.engine, tabmat_torch.bench.main, tabmat_torch.bench.generate, "
        "tabmat_torch.bench.memory, tabmat_torch.bench.visualize, chip_smoke; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
        "assert 'tabmat_tpu' not in sys.modules"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]


def test_bench_cli_phase_on_cpu(tmp_path):
    """Phase 9 at a tiny scale: the CLI's twelve designs with their
    baselines, and the sparse design under a zero budget."""
    smoke = _chip_smoke()
    report = smoke.phase_bench_cli(torch.device("cpu"), scale=0.0005, out_dir=str(tmp_path),
                                   n_iterations=2)
    labels = list(smoke.CLI_KERNELS) + [f"std_{name}" for name in smoke.CLI_STANDARDIZED]
    assert list(report["rows"]) == labels + ["budget0_sparse"]
    for label in labels:
        rows = report["rows"][label]
        assert [r["library"] for r in rows] == ["tabmat_torch", "numpy/scipy"] * 3
        assert (tmp_path / f"{label}.csv").exists()
    assert all(v == 0 for counts in report["launches"].values() for v in counts.values())


def test_main_path_phase_on_cpu():
    report = _chip_smoke().phase_main_path(torch.device("cpu"), n=3000, k=6, fit_steps=3)
    assert report["fit_launches"] == 0  # the CPU takes the plain version
    assert set(report["betas"]) == {
        (f, p) for f in ("gaussian", "poisson") for p in ("float64", "float32")
    }
    for beta in report["betas"].values():
        assert beta.shape == (6,) and np.all(np.isfinite(beta))


def test_kernel_phase_on_cpu():
    smoke = _chip_smoke()
    # each sandwich kernel at a cut-down full shape and its first two widths
    cases = {name: (((500, 12 if "narrow" in name else 200 if "wide" in name else 40),),
                    widths[:2])
             for name, (_, widths) in smoke.SANDWICH_CASES.items()}
    max_abs = smoke.phase_kernels(torch.device("cpu"), cases, 97, [(500, 5), (97, 1)])
    assert max_abs == {name: 0.0 for name in (
        "sandwich<double>", "sandwich<float>", "sandwich_narrow<double>",
        "sandwich_narrow<float>", "sandwich_tri<float>", "sandwich_wide<float>",
        "sandwich_mma<double>", "sandwich_mma_tri<double>", "column_absmax")}
    # the kernels line lists seventeen instantiations (the segment sum's two
    # routes in both types among them), each timed in phase 8
    assert len(smoke.KERNELS) == 17
    assert set(smoke.SANDWICH_TIMES) | {"column_absmax"} <= set(smoke.KERNELS)


def test_kernel_phase_few_rows_on_cpu(capsys):
    """The f64 triangle kernel's row of phase 3: its few-row shapes (one
    row with a nonzero weight) and its widths, each against the plain
    version within the f64 limit."""
    smoke = _chip_smoke()
    fulls, widths = smoke.SANDWICH_CASES["sandwich_mma_tri<double>"]
    assert {rows for rows, _ in fulls} >= {1, 7, 40}
    cases = {"sandwich_mma_tri<double>": (tuple((rows, k) for rows, k in fulls if rows < 100),
                                          widths)}
    assert smoke.phase_kernels(torch.device("cpu"), cases, 97, [(97, 1)]) == {
        "sandwich_mma_tri<double>": 0.0, "column_absmax": 0.0}
    out = capsys.readouterr().out
    assert "FAIL" not in out and out.count("sandwich_mma_tri<double>") >= 9


def test_mma_phase_few_rows_on_cpu(capsys):
    """The tensor-core kernel's row of phase 3: its few-row shapes and its
    widths (odd ones and the 128-column tile's edges), each against the
    plain version within the f64 limit."""
    smoke = _chip_smoke()
    fulls, widths = smoke.SANDWICH_CASES["sandwich_mma<double>"]
    assert {rows for rows, _ in fulls} >= {1, 7, 40}
    assert set(widths) >= {129, 137, 160, 200, 255, 256, 257, 1000, 1024}
    cases = {"sandwich_mma<double>": (tuple((rows, k) for rows, k in fulls if rows < 100),
                                      widths)}
    assert smoke.phase_kernels(torch.device("cpu"), cases, 61, [(61, 1)]) == {
        "sandwich_mma<double>": 0.0, "column_absmax": 0.0}
    out = capsys.readouterr().out
    assert "FAIL" not in out and out.count("sandwich_mma<double>") >= 12


def test_dense_width_paths_on_cpu():
    """Paths (a) and (b), the narrow and wide dense designs, at cut-down rows."""
    smoke = _chip_smoke()
    for k in (smoke.NARROW_K, smoke.WIDE_K):
        report = smoke.phase_main_path(torch.device("cpu"), n=4000, k=k, fit_steps=3,
                                       label=f"[4] k={k}")
        assert report["fit_launches"] == 0
        for beta in report["betas"].values():
            assert beta.shape == (k,) and np.all(np.isfinite(beta))


def test_f32_wide_dense_path_on_cpu():
    """Phase 4d at cut-down rows: the dense path past the f32 triangle
    kernel's widths, through the public API against numpy."""
    smoke = _chip_smoke()
    report = smoke.phase_main_path(torch.device("cpu"), n=3000, k=smoke.F32_WIDE_K, fit_steps=2,
                                   label="[4d] cut down")
    assert report["fit_launches"] == 0
    for beta in report["betas"].values():
        assert beta.shape == (smoke.F32_WIDE_K,) and np.all(np.isfinite(beta))


def test_f32_matrix_phase_on_cpu(capsys):
    """Phase 4c at cut-down rows: a float32 DenseMatrix past the triangle
    kernel's widths, its sandwich against numpy in float64."""
    smoke = _chip_smoke()
    smoke.phase_f32_matrix(3000, smoke.F32_WIDE_K, device=torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count(" ok") == 2 and "FAIL" not in out


def test_sandwich_tables_name_the_routed_kernels():
    """The smoke's f32 main paths name the kernel the dispatch gives them,
    and every kernel is held, timed and listed."""
    from tabmat_torch.ops import sandwich_kernel as sk

    smoke = _chip_smoke()
    assert sk.route(smoke.K, torch.float32) in smoke.DENSE_KERNELS
    assert sk.route(smoke.WIDE_K, torch.float32) in smoke.WIDE_KERNELS
    assert sk.route(smoke.F32_WIDE_K, torch.float32) == "sandwich_wide<float>"
    assert sk.route(smoke.F32_WIDE_K, torch.float32) in smoke.F32_WIDE_KERNELS
    assert sk.route(smoke.F32_WIDE_K, torch.float64) in smoke.F32_WIDE_KERNELS
    for (k, dtype), want in smoke.ROUTES.items():
        assert sk.route(k, getattr(torch, dtype)) == want
    assert set(smoke.SANDWICH_CASES) == set(smoke.SANDWICH_TIMES) == set(sk.KERNEL_WRAPPERS)
    assert set(sk.launches) <= set(smoke.KERNELS)


def test_cat_kernel_phase_on_cpu(capsys):
    """Phase 3's gather and segment-sum cases at a small size: every plan
    (sentinels, the stacked plan, 10^6 segments cut down to n, one tile)
    at every column count, equal to the plain version on the CPU; the
    segment sum's four instantiations are named and listed."""
    from tabmat_torch.ops import segsum_kernel as ssk

    smoke = _chip_smoke()
    max_abs = smoke.phase_cat_kernels(torch.device("cpu"), 3000,
                                      seg_ws=(1, 7, 100, "stacked", 3000), levels=50,
                                      seg_ms=(1, 5, 9), edge_n=1001)
    assert max_abs == dict.fromkeys(("gather<double>", "gather<float>")
                                    + smoke.SEGSUM_KERNELS, 0.0)
    out = capsys.readouterr().out
    assert out.count("segsum<double> ") == out.count("segsum<float> ") == 2 * 6 * 3
    assert set(ssk.launches) == set(smoke.SEGSUM_KERNELS) <= set(smoke.KERNELS)
    assert set(smoke.SEGSUM_KERNELS) <= set(smoke.MIXED_KERNELS)


def test_segsum_bound_counts_each_byte_once():
    from tabmat_torch.ops.segments import build_plan

    smoke = _chip_smoke()
    plan = build_plan(np.arange(1000) % 7, 7, torch.device("cpu"))
    v = torch.zeros(1000, 5, dtype=torch.float64)
    n_bytes = 1000 * 4 + 1000 * 5 * 8 + 8 * 4 + 7 * 5 * 8
    assert smoke.segsum_bound(plan, v) == (n_bytes / smoke.HBM_BYTES_PER_S * 1e3, "bytes")


def test_numpy_irls_converges_to_least_squares():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((400, 3))
    y = X @ np.array([1.0, -2.0, 0.5]) + 0.01 * rng.standard_normal(400)
    beta = _chip_smoke()._numpy_irls(X, y, "gaussian", 2, 10, "float64")
    np.testing.assert_allclose(beta, np.linalg.lstsq(X, y, rcond=None)[0], atol=1e-10)


def test_numpy_irls_weights_match_weighted_least_squares():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((400, 3))
    y = X @ np.array([1.0, -2.0, 0.5]) + 0.1 * rng.standard_normal(400)
    w = rng.random(400) + 0.1
    beta = _chip_smoke()._numpy_irls(X, y, "gaussian", 2, 10, "float64", sample_weight=w)
    sw = np.sqrt(w)
    np.testing.assert_allclose(beta, np.linalg.lstsq(X * sw[:, None], y * sw, rcond=None)[0],
                               atol=1e-10)


def test_frame_path_phase_on_cpu():
    """Phase 7b at a few thousand rows: the formula fit in both precisions,
    predict, and from_pandas on phase 5's frame, with no kernel launched."""
    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    mixed = smoke.phase_mixed_path(3000, 5, 50, device=cpu)
    smoke.reset_launch_counts()
    report = smoke.phase_frame_path("cpu", mixed, n=4000, n_new=300, device=cpu)
    assert not any(smoke.launch_counts().values())  # the CPU takes the plain versions
    assert report["design"].shape == (4000, len(smoke.freq_names())) == (4000, 42)
    assert [b.kind for b in report["design"].blocks] == ["dense", "cat"]
    for beta in report["betas"].values():
        assert beta.shape == (42,) and np.all(np.isfinite(beta))


def test_freq_fit_is_insensitive_to_rounding():
    """With FREQ_N_CG iterations each inner solve converges, so the formula
    fit's beta moves far less than its limits when X moves by a rounding
    error; with phase 5's N_CG it would not (the comment at FREQ_N_CG)."""
    smoke = _chip_smoke()
    frame = smoke.freq_frame(20_000, np.random.default_rng(6))
    X = smoke.freq_numpy_design(frame)
    y, w = frame["ClaimNb"].to_numpy(np.float64), frame["Exposure"].to_numpy(np.float64)
    assert np.linalg.cond((X * w[:, None]).T @ X) > 1e6

    def moves(inner, n_cg, eps):
        fit = [smoke._numpy_irls(A, y, "poisson", smoke.FREQ_FIT_STEPS, n_cg, inner,
                                 sample_weight=w) for A in (X, X * (1 + eps))]
        return smoke._relerr(fit[1], fit[0])

    assert moves("float64", smoke.FREQ_N_CG, 1e-15) < smoke.BETA_TOL["float64"] / 100
    assert moves("float32", smoke.FREQ_N_CG, 1e-7) < smoke.BETA_TOL["float32"] / 100
    assert moves("float64", smoke.N_CG, 1e-15) > smoke.BETA_TOL["float64"]


def test_main_refuses_without_cuda(monkeypatch, capsys):
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_profile_tool_refuses_without_cuda(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "profile_irls_step", ROOT / "tools" / "profile_irls_step.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["profile_irls_step.py"])
    assert tool.main() != 0
    assert capsys.readouterr().out == ""


def test_time_segsum_refuses_without_cuda(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("time_segsum",
                                                  ROOT / "tools" / "time_segsum.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["time_segsum.py", "--parent-cu", "build/parent"])
    assert tool.main() != 0
    assert capsys.readouterr().out == ""


def _time_sandwich():
    spec = importlib.util.spec_from_file_location("time_sandwich",
                                                  ROOT / "tools" / "time_sandwich.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_time_sandwich_refuses_without_cuda(monkeypatch, capsys):
    tool = _time_sandwich()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["time_sandwich.py", "--sass"])
    assert tool.main() != 0
    assert capsys.readouterr().out == ""


def test_time_sandwich_reads_the_row_loop(monkeypatch):
    """``--sass``: the shortest backward loop with 64 FFMAs or more, by opcode."""
    tool = _time_sandwich()
    body = ["        /*0110*/                   LDS.128 R4, [R2] ;"]
    body += [f"        /*{0x120 + 16 * i:04x}*/                   FFMA R{8 + i}, R4, R5, R{8 + i} ;"
             for i in range(64)]
    body += ["        /*0520*/                   FMUL R6, R6, R7 ;",
             "        /*0530*/               @!P0 BRA 0x110 ;",
             "        /*0540*/                   BRA 0x100 ;"]
    sass = "\n".join(["Function : _ZN4anon11tri_partialILi7EEEvPKf", *body,
                      "Function : _ZN4anon10tri_reduceEPKf", "        /*0000*/ EXIT ;"])
    monkeypatch.setattr(tool._build, "nvcc_path", lambda: "cuda/bin/nvcc")
    monkeypatch.setattr(tool.subprocess, "run",
                        lambda *a, **k: type("Done", (), {"stdout": sass})())
    loops = tool.row_loops("lib.so")
    assert list(loops) == ["tri_partial<7>"]
    assert loops["tri_partial<7>"] == {"LDS": 1, "FFMA": 64, "FMUL": 1, "BRA": 1}


def test_time_sandwich_reads_the_kstep_loops(monkeypatch):
    """``--sass``: the innermost loops with a DMMA of each ``mma_tri_partial<C>``."""
    tool = _time_sandwich()
    body = ["        /*0100*/                   LDS.64 R4, [R2] ;",
            "        /*0110*/                   DMUL R6, R4, R8 ;",
            "        /*0120*/                   DMMA.8x8x4 R10, R4, R6, R10 ;",
            "        /*0130*/                   NOP ;",
            "        /*0140*/               @!P0 BRA 0x100 ;",
            "        /*0150*/                   LDS.64 R4, [R2] ;",
            "        /*0160*/                   DMMA.8x8x4 R10, R4, R6, R10 ;",
            "        /*0170*/               @!P1 BRA 0x150 ;",
            "        /*0180*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
            "        /*0190*/                   BRA 0x100 ;"]
    sass = "\n".join(["Function : _ZN4anon15mma_tri_partialILi7EEEvPKd", *body,
                      "Function : _ZN4anon11tri_partialILi7EEEvPKf", "        /*0000*/ EXIT ;"])
    monkeypatch.setattr(tool._build, "nvcc_path", lambda: "cuda/bin/nvcc")
    monkeypatch.setattr(tool.subprocess, "run",
                        lambda *a, **k: type("Done", (), {"stdout": sass})())
    loops = tool.kstep_loops("lib.so")
    assert list(loops) == ["mma_tri_partial<7>"]
    assert loops["mma_tri_partial<7>"] == [
        {"LDS": 1, "DMUL": 1, "DMMA": 1, "NOP": 1, "BRA": 1}, {"LDS": 1, "DMMA": 1, "BRA": 1}]
    assert tool.row_loops("lib.so") == {}  # no FFMA loop, and mma_tri_partial is not tri_partial


def test_time_sandwich_diagnose_cuts_match_the_source():
    """``--diagnose`` replaces lines of ``sandwich_mma_tri.cu`` that must be
    there once each."""
    tool = _time_sandwich()
    source = (ROOT / "tabmat_torch" / "csrc" / "sandwich_mma_tri.cu").read_text()
    for old, _ in tool.DIAGNOSE_CUTS.values():
        assert source.count(old) == 1


def test_time_sandwich_mma_cuts_match_the_source(monkeypatch):
    """``--diagnose-mma`` replaces lines of ``sandwich_mma.cu`` that must be
    there once each, and ``--blocks`` inserts its clocks at lines that must
    be; ``--sass`` reads ``mma_partial``'s k-step loops by name; the tool
    times the kernel at its five shapes."""
    tool = _time_sandwich()
    source = (ROOT / "tabmat_torch" / "csrc" / "sandwich_mma.cu").read_text()
    for old, _ in tool.MMA_CUTS.values():
        assert source.count(old) == 1
    for anchor, _ in tool.BLOCK_CLOCK:  # --blocks inserts after (or before) each once
        assert source.count(anchor) == 1
    assert tool.DIAGNOSES["sandwich_mma<double>"][0] is tool.MMA_CUTS
    assert {(n, k) for name, n, k in tool.CASES if name == "sandwich_mma<double>"} == {
        (400_000, 160), (400_000, 200), (1_000_000, 129), (200_000, 1000), (40_000, 10_000),
        (20_000, 10_000)}
    body = ["        /*0100*/                   LDS.128 R4, [R2] ;",
            "        /*0110*/                   DMUL R6, R4, R8 ;",
            "        /*0120*/                   DMMA.16x8x8 R10, R4, R6, R10 ;",
            "        /*0130*/               @!P0 BRA 0x100 ;"]
    sass = "\n".join(["Function : _ZN12_GLOBAL__N_111mma_partialEPKdS1_PdxiPKxi", *body])
    monkeypatch.setattr(tool._build, "nvcc_path", lambda: "cuda/bin/nvcc")
    monkeypatch.setattr(tool.subprocess, "run",
                        lambda *a, **k: type("Done", (), {"stdout": sass})())
    assert tool.kstep_loops("lib.so") == {
        "mma_partial": [{"LDS": 1, "DMUL": 1, "DMMA": 1, "BRA": 1}]}


def test_time_sandwich_wide_cuts_match_the_source():
    """``--diagnose-wide`` replaces lines of ``sandwich_wide.cu`` that must
    be there once each; the row loop of ``wide_partial`` is read by name;
    each diagnosis names a kernel of the port and takes its cuts."""
    tool = _time_sandwich()
    source = (ROOT / "tabmat_torch" / "csrc" / "sandwich_wide.cu").read_text()
    for old, _ in tool.WIDE_CUTS.values():
        assert source.count(old) == 1
    assert tool.DIAGNOSES["sandwich_wide<float>"][0] is tool.WIDE_CUTS
    assert tool.DIAGNOSES["sandwich_mma_tri<double>"][0] is tool.DIAGNOSE_CUTS
    assert set(tool.DIAGNOSES) <= set(tool.sk.KERNEL_WRAPPERS)
    assert {k for name, _, k in tool.CASES if name == "sandwich_wide<float>"} == {
        200, 177, 1000, 2048}


def test_time_sandwich_reads_the_wide_row_loop(monkeypatch):
    """``--sass``: ``wide_partial``'s row loop (64 FFMAs, four 16-byte loads)."""
    tool = _time_sandwich()
    body = [f"        /*{0x100 + 16 * i:04x}*/                   LDS.128 R{4 + i}, [R2] ;"
            for i in range(4)]
    body += [f"        /*{0x140 + 16 * i:04x}*/                   FFMA R{8 + i}, R4, R5, R{8 + i} ;"
             for i in range(64)]
    body += ["        /*0540*/               @!P0 BRA 0x100 ;"]
    sass = "\n".join(["Function : _ZN12_GLOBAL__N_112wide_partialEPKfS1_Pfxixi", *body])
    monkeypatch.setattr(tool._build, "nvcc_path", lambda: "cuda/bin/nvcc")
    monkeypatch.setattr(tool.subprocess, "run",
                        lambda *a, **k: type("Done", (), {"stdout": sass})())
    assert tool.row_loops("lib.so") == {"wide_partial": {"LDS": 4, "FFMA": 64, "BRA": 1}}


def test_script_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")


def test_check_raises_over_limit(capsys):
    smoke = _chip_smoke()
    smoke._check("x", 1e-15, 1e-13)
    with pytest.raises(AssertionError):
        smoke._check("x", 1e-3, 1e-13)
    with pytest.raises(AssertionError):
        smoke._check("x", float("nan"), 1e-13)


def tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    b = x.astype(np.float32).view(np.int32).astype(np.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.astype(np.int32).view(np.float32)


def test_f32_limit_rejects_tf32():
    """The card's f32 limit (chip_smoke.F32_TOL) passes full-f32 FFMA and
    fails a product whose inputs were rounded to TF32."""
    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(9)
    X = rng.standard_normal((50_000, 50)).astype(np.float32)
    d = rng.standard_normal(50_000).astype(np.float32)
    d[::5] = 0.0
    exact = (X.astype(np.float64) * d[:, None]).T @ X.astype(np.float64)
    f32 = sandwich_plain(torch.tensor(X), torch.tensor(d)).numpy()
    Xt, dt = tf32_round(X).astype(np.float64), tf32_round(d).astype(np.float64)
    tf32 = (Xt * dt[:, None]).T @ Xt
    assert chip_smoke._relerr(f32, exact) < chip_smoke.F32_TOL / 10
    assert chip_smoke._relerr(tf32, exact) > 5 * chip_smoke.F32_TOL
    assert chip_smoke._relerr(chip_smoke.tf32_round(torch.tensor(X)).numpy(), tf32_round(X)) == 0


def test_sparse_phases_on_cpu(monkeypatch):
    """The sparse phases at a small size: the sparse product against its
    plain version (equal on the CPU), the standalone SparseMatrix against
    scipy, ``sparse_wide``'s sandwich by row panels (its budgets cut down to
    the cut-down shape: three panels), and the sparse main path."""
    from tabmat_torch.models import sparse as port_sparse

    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    designs = smoke.sparse_designs({"sparse": (4000, 100), "sparse_narrow": (30_000, 3),
                                    "sparse_wide": (400, 10_000)})
    block = smoke.sparse_block(20_000)
    cases = smoke.spmv_cases(cpu, designs, block, levels=50)
    assert len(cases) == 9
    assert smoke.phase_spmv_kernels(cpu, cases) == {"spmv<double>": 0.0, "spmv<float>": 0.0}
    smoke.phase_sparse_standalone(designs, device=cpu)
    report = smoke.phase_mixed_path(20_000, 5, 50, device=cpu, sparse=block,
                                    fit_steps=smoke.SPARSE_FIT_STEPS)
    assert report["design"].supports_sandwich
    assert [b.kind for b in report["design"].blocks] == ["dense", "sparse", "cat"]
    for beta in report["betas"].values():
        assert beta.shape == (5 + 100 + 100,) and np.all(np.isfinite(beta))
    plan, a, values, scale = cases[-1][1:]
    assert smoke.spmv_bound(plan, a, values, scale)[1] == "bytes"
    wide = smoke.sparse_designs({"sparse_wide": (600, 1000)}, density=0.05)["sparse_wide"]
    monkeypatch.setattr(port_sparse, "PAIR_SANDWICH_MAX_PAIRS", 0)
    monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_COLS", 500)
    monkeypatch.setattr(port_sparse, "DENSE_SANDWICH_MAX_ELEMENTS", 250 * 1000)
    report = smoke.phase_sparse_wide(wide, device=cpu, slab=50)
    # the row panels against the reference's sandwich; the reference
    # differences a cumsum over its 1.5M within-row pairs here and is off
    # the exact product by the prefix's ulp (ROADMAP C), so 1e-10, as
    # tests/test_torch_sparse.py holds it at the reference's shapes
    ref = tm.SparseMatrix(wide)
    d = report["d"].numpy()
    rows, cols = np.arange(0, 600, 3), np.arange(0, 1000, 4)
    for kw in ({}, {"rows": rows}, {"cols": cols}, {"rows": rows, "cols": cols}):
        np.testing.assert_allclose(report["matrix"].sandwich(d, **kw), ref.sandwich(d, **kw),
                                   rtol=0, atol=1e-10)
