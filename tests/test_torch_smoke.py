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
        "tabmat_torch._build, chip_smoke; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
        "assert 'tabmat_tpu' not in sys.modules"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]


def test_main_path_phase_on_cpu():
    report = _chip_smoke().phase_main_path(torch.device("cpu"), n=3000, k=6, fit_steps=3)
    assert report["fit_launches"] == 0  # the CPU takes the plain version
    assert set(report["betas"]) == {
        (f, p) for f in ("gaussian", "poisson") for p in ("float64", "float32")
    }
    for beta in report["betas"].values():
        assert beta.shape == (6,) and np.all(np.isfinite(beta))


def test_kernel_phase_on_cpu():
    max_abs = _chip_smoke().phase_kernels(torch.device("cpu"), 500, 5, 97, (1, 7))
    assert max_abs == {"sandwich<double>": 0.0, "sandwich<float>": 0.0, "column_absmax": 0.0}


def test_numpy_irls_converges_to_least_squares():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((400, 3))
    y = X @ np.array([1.0, -2.0, 0.5]) + 0.01 * rng.standard_normal(400)
    beta = _chip_smoke()._numpy_irls(X, y, "gaussian", 2, 10, "float64")
    np.testing.assert_allclose(beta, np.linalg.lstsq(X, y, rcond=None)[0], atol=1e-10)


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


def test_sparse_phases_on_cpu():
    """The sparse phases at a small size: the sparse product against its
    plain version (equal on the CPU), the standalone SparseMatrix against
    scipy, ``sparse_wide``'s sandwich refused, and the sparse main path."""
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
