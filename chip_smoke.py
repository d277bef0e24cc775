#!/usr/bin/env python3
"""Drive tabmat_torch's dense GLM main path once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions,
   TF32 off;
2. build of the CUDA kernels from ``tabmat_torch/csrc`` (seconds, ptxas
   registers and spills);
3. each kernel against its plain PyTorch version on the card: the sandwich
   in f64 and f32 and the range prepass ``column_absmax``, at
   1,000,000 x 50 and at edge widths, with negative and zero weights; and a
   control that the f32 limit rejects a TF32-rounded product;
4. the main path at 1,000,000 x 50 float64: DenseMatrix sandwich, matvec and
   transpose_matvec with and without active sets, standardize and the
   standardized sandwich, then ``fit_glm`` on the DenseMatrix for gaussian and
   poisson in both inner precisions, each held against the same algorithm
   in numpy on the host.  The kernel launch counts are set to 0 just before
   this phase, and every kernel must have been launched in it;
5. times from CUDA events after warm-up: each kernel and its plain version
   at 1,000,000 x 50, and one ``irls_step``.

Any failed check raises, so the script exits 0 only when every check
passed.  The last three lines are the ``kernels`` JSON object, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  Without CUDA
it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N, K = 1_000_000, 50
EDGE_N = 100_003  # a multiple of no tile or stage size
EDGE_KS = (1, 7, 64, 128, 200)
FIT_STEPS = 4
N_CG = 16
# f64: the TPU kernels' own bar was relerr 5.2e-15 at this shape; 1e-13
# leaves room for a different summation order.  f32: full-f32 FFMA measured
# at most 2.0e-6 on the card; 2e-5 is ten times that, and a product of
# TF32-rounded inputs (4e-4 to 5e-4) fails it, which phase 3 checks.  The
# prepass takes the same products and maxima as its plain version: exact.
F64_TOL = 1e-13
F32_TOL = 2e-5
ABSMAX_TOL = 0.0
# beta against numpy after FIT_STEPS IRLS steps: f64 differs only by
# summation order; the f32 inner solve (f32 Hessian and CG) differs by f32
# rounding in another order.
BETA_TOL = {"float64": 1e-10, "float32": 1e-4}

KERNEL_SOURCE = "tabmat_torch/csrc/sandwich.cu"
REPLACES = {
    "sandwich<double>": "tabmat_tpu/ops/pallas_sandwich_v4.py:141",
    "sandwich<float>": "tabmat_tpu/ops/pallas_kernels.py:34",
    "column_absmax": "tabmat_tpu/ops/pallas_sandwich_v4.py:491",
}


def _relerr(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _check(name: str, value: float, limit: float) -> None:
    status = "ok" if value <= limit else "FAIL"
    print(f"  {name}: {value:.3e} (limit {limit:.0e}) {status}", flush=True)
    if not value <= limit:
        raise AssertionError(f"{name} = {value} exceeds {limit}")


def card_line() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_environment() -> str:
    from tabmat_torch import _build

    card = card_line()
    print(f"[1] card: {card}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"  nvcc: {nvcc}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"  torch.backends.cuda.matmul.allow_tf32 = {tf32}", flush=True)
    if tf32:
        raise AssertionError("TF32 matmul is on: the plain f32 version would not be full f32")
    return card


def phase_build() -> None:
    from tabmat_torch import _build

    t0 = time.perf_counter()
    _build.library("sandwich")
    info = _build.build_info["sandwich"]
    print(f"[2] build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds'] if info['seconds'] is not None else 'reused'} s) "
          f"-> {info['path']}")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    sys.stdout.flush()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32)


def phase_kernels(device, n: int, k: int, edge_n: int, edge_ks) -> dict:
    """Each kernel against its plain version; returns max|Δ| at (n, k) by kernel."""
    from tabmat_torch.ops import sandwich_kernel as sk

    print(f"[3] kernels vs plain on {device}", flush=True)
    gen = torch.Generator(device=device).manual_seed(3)
    max_abs = {}
    shapes = [(n, k)] + [(edge_n, kk) for kk in edge_ks]
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        name = f"sandwich<{'double' if dtype == torch.float64 else 'float'}>"
        for rows, cols in shapes:
            X = torch.randn(rows, cols, device=device, dtype=dtype, generator=gen)
            d = torch.randn(rows, device=device, dtype=dtype, generator=gen)
            d[::5] = 0.0  # zeros, as masked rows arrive
            S = sk.sandwich(X, d)
            P = sk.sandwich_plain(X, d)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                # the kernel mirrors its upper triangle
                if not torch.equal(S, S.T):
                    raise AssertionError(f"{name} {rows}x{cols} is not symmetric")
            err = float((S - P).abs().max())
            if (rows, cols) == (n, k):
                max_abs[name] = err
                if dtype == torch.float32:
                    # control: the f32 limit must reject TF32-rounded inputs
                    Xt, dt = tf32_round(X).double(), tf32_round(d).double()
                    exact = sk.sandwich_plain(X.double(), d.double())
                    ctl = _relerr(sk.sandwich_plain(Xt, dt).cpu(), exact.cpu())
                    print(f"  control: TF32-rounded inputs give relerr {ctl:.3e}, "
                          f"over the f32 limit {F32_TOL:.0e}: {ctl > F32_TOL}")
                    if not ctl > F32_TOL:
                        raise AssertionError("the f32 limit does not reject a TF32 product")
                    del Xt, dt, exact
            _check(f"{name} {rows}x{cols} relerr", err / float(P.abs().max()), tol)
    for rows, cols in shapes:
        X = torch.randn(rows, cols, device=device, dtype=torch.float32, generator=gen)
        d = torch.randn(rows, device=device, dtype=torch.float64, generator=gen)
        d[::5] = 0.0
        d[1] = 1e300  # beyond float32: the prepass reads f64 weights
        err = float((sk.column_absmax(X, d) - sk.column_absmax_plain(X, d)).abs().max())
        if (rows, cols) == (n, k):
            max_abs["column_absmax"] = err
        _check(f"column_absmax {rows}x{cols} max|diff|", err, ABSMAX_TOL)
    return max_abs


def _numpy_irls(X, y, family, steps, n_cg, inner):
    """The port's IRLS step (explicit Hessian, guarded CG) in numpy."""
    dt = np.float32 if inner == "float32" else np.float64
    Xi = X.astype(dt)
    tiny = np.finfo(dt).tiny
    beta = np.zeros(X.shape[1])
    for _ in range(steps):
        eta = X @ beta
        if family == "gaussian":
            mu, w = eta, np.ones_like(eta)
        else:
            mu = np.exp(eta)
            w = mu
        grad = X.T @ (y - mu)
        H = (Xi * w.astype(dt)[:, None]).T @ Xi
        b = grad.astype(dt)
        x, r, p, rs = np.zeros_like(b), b, b, b @ b
        for _ in range(n_cg):
            Ap = H @ p
            denom = p @ Ap
            alpha = rs / denom if denom > tiny else dt(0)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = r @ r
            p = r + (rs_new / rs if rs > tiny else dt(0)) * p
            rs = rs_new
        beta = beta + x.astype(np.float64)
    return beta


def phase_main_path(device, n: int, k: int, fit_steps: int = FIT_STEPS, seed: int = 0) -> dict:
    """The dense main path through the public API, checked against numpy."""
    import tabmat_torch as tt
    from tabmat_torch.ops import sandwich_kernel as sk

    print(f"[4] main path {n}x{k} float64 on {device}", flush=True)
    rng = np.random.default_rng(seed)
    X_np = rng.standard_normal((n, k))
    d_np = rng.random(n) - 0.25
    d_np[::11] = 0.0
    dm = tt.DenseMatrix(X_np, device=device)
    d = torch.as_tensor(d_np, device=device)

    _check("sandwich relerr", _relerr(dm.sandwich(d).cpu(), (X_np * d_np[:, None]).T @ X_np), F64_TOL)
    rows = np.sort(rng.choice(n, n // 2, replace=False))
    cols = np.array([k - 1, 0, k // 2])
    sub = X_np[rows][:, cols]
    _check("sandwich rows+cols relerr",
           _relerr(dm.sandwich(d_np, rows=rows, cols=cols), (sub * d_np[rows, None]).T @ sub), F64_TOL)
    v = rng.standard_normal(k)
    r = rng.standard_normal(n)
    _check("matvec relerr", _relerr(dm.matvec(v), X_np @ v), 1e-12)
    _check("matvec cols relerr", _relerr(dm.matvec(v, cols=cols), X_np[:, cols] @ v[cols]), 1e-12)
    _check("transpose_matvec relerr", _relerr(dm.transpose_matvec(r), X_np.T @ r), 1e-12)
    _check("transpose_matvec rows+cols relerr",
           _relerr(dm.transpose_matvec(r, rows=rows, cols=cols), sub.T @ r[rows]), 1e-12)

    weights = np.full(n, 1.0 / n)
    std, means, stds = dm.standardize(weights, True, True)
    B = (X_np - X_np.mean(0)) / X_np.std(0)
    _check("standardize means", _relerr(means, X_np.mean(0)), 1e-12)
    _check("standardized sandwich relerr",
           _relerr(std.sandwich(d_np), (B * d_np[:, None]).T @ B), 1e-12)
    del B

    beta_true = rng.standard_normal(k) * 0.05
    eta_true = X_np @ beta_true
    targets = {
        "gaussian": eta_true + 0.1 * rng.standard_normal(n),
        "poisson": rng.poisson(np.exp(eta_true)).astype(np.float64),
    }
    fit_launches = 0
    betas = {}
    for family, y in targets.items():
        for inner in ("float64", "float32"):
            before = sk.sandwich_launches
            beta, n_iter = tt.fit_glm(dm, y, family=family, max_iter=fit_steps, tol=0.0,
                                      n_cg=N_CG, inner_precision=inner)
            fit_launches += sk.sandwich_launches - before
            got = beta.cpu().numpy()
            if n_iter != fit_steps or not np.all(np.isfinite(got)):
                raise AssertionError(f"fit_glm {family}/{inner}: n_iter {n_iter}, beta {got}")
            ref = _numpy_irls(X_np, y, family, fit_steps, N_CG, inner)
            _check(f"fit_glm {family} inner={inner} beta vs numpy", _relerr(got, ref), BETA_TOL[inner])
            betas[(family, inner)] = got
    return {"fit_launches": fit_launches, "betas": betas}


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def phase_times(device, n: int, k: int, card: str) -> dict:
    """CUDA-event times; plain and kernel alternate (plain, kernel, kernel, plain)."""
    import tabmat_torch as tt
    from tabmat_torch.glm import irls_step
    from tabmat_torch.ops import sandwich_kernel as sk
    from tabmat_torch.parallel.design import DeviceDesign

    print(f"[5] times on {card}", flush=True)
    gen = torch.Generator(device=device).manual_seed(5)
    times = {}
    cases = (
        ("sandwich<double>", sk.sandwich, sk.sandwich_plain, torch.float64, torch.float64),
        ("sandwich<float>", sk.sandwich, sk.sandwich_plain, torch.float32, torch.float32),
        ("column_absmax", sk.column_absmax, sk.column_absmax_plain, torch.float32,
         torch.float64),
    )
    for name, kernel, plain, x_dtype, d_dtype in cases:
        X = torch.randn(n, k, device=device, dtype=x_dtype, generator=gen)
        d = torch.rand(n, device=device, dtype=d_dtype, generator=gen)
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = plain if which == "plain" else kernel
            runs[which].append(_time_ms(lambda: fn(X, d)))
        times[name] = {key: sum(v) / len(v) for key, v in runs.items()}
        print(f"  {name} {n}x{k}: kernel {runs['kernel']} ms, "
              f"plain {runs['plain']} ms ({card})")
        del X, d

    rng = np.random.default_rng(7)
    X_np = rng.standard_normal((n, k))
    design = DeviceDesign.from_matrix(tt.DenseMatrix(X_np, device=device))
    y = torch.as_tensor(X_np @ rng.standard_normal(k) + 0.1 * rng.standard_normal(n), device=device)
    w = torch.ones(n, dtype=torch.float64, device=device)
    b0 = torch.zeros(k, dtype=torch.float64, device=device)
    for inner in ("float32", "float64"):
        ms = _time_ms(lambda: irls_step(design, y, w, b0, family="gaussian", n_cg=N_CG,
                                        inner_precision=inner), reps=10)
        times[f"irls_step_{inner}"] = ms
        print(f"  irls_step gaussian inner={inner} n_cg={N_CG}: {ms:.4f} ms ({card})")
    sys.stdout.flush()
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from tabmat_torch.ops import sandwich_kernel as sk

    device = torch.device("cuda", 0)
    card = phase_environment()
    phase_build()
    max_abs = phase_kernels(device, N, K, EDGE_N, EDGE_KS)

    sk.reset_launch_counts()
    report = phase_main_path(device, N, K)
    launches = dict(sk.launches)
    print(f"  sandwich_launches during fit_glm: {report['fit_launches']}; "
          f"launches in the main path: {launches}")
    if report["fit_launches"] == 0 or 0 in launches.values():
        raise AssertionError("the main path did not launch every kernel")

    times = phase_times(device, N, K, card)
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max_abs[name],
            "ms": times[name]["kernel"],
            "plain_ms": times[name]["plain"],
        }
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
