#!/usr/bin/env python3
"""Drive tabmat_torch's GLM main paths once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions,
   TF32 off;
2. build of the CUDA kernels from ``tabmat_torch/csrc``, one ``nvcc`` per
   source (nine sources), all at once (seconds, ptxas registers and spills);
3. each kernel against its plain PyTorch version on the card: each of the
   sandwich kernels through its own wrapper (``sandwich<double>``, off the
   route, at 1,000,000 x 50 and ``sandwich<float>``, off the route too, at
   400,000 x 200, both at k in {1, 7, 50, 64, 100, 128, 200};
   ``sandwich_wide<float>`` at 400,000 x 200 and k in {177, 200, 255, 256,
   257, 1000, 1024}; ``sandwich_narrow<T>`` at
   4,000,000 x 10 and k in {1, 2, 5, 10, 31, 32}; ``sandwich_tri<float>``
   at 1,000,000 x 50, 400,000 x 160 and k in {33, 50, 64, 100, 160, 176};
   ``sandwich_mma_tri<double>`` at 1,000,000 x 50, at 1, 7 and 40 rows and
   k in {33, 50, 64, 100, 127, 128}; ``sandwich_mma<double>`` at 400,000 x
   160 and k in {129, 160, 200, 1000}),
   with negative and zero weights, exactly symmetric and bit-identical across
   two launches, and a control that the f32 limit rejects a TF32-rounded
   product; the width dispatch at 32/33 and 128/129 (f64) and 32/33 and
   176/177 (f32); the range prepass
   ``column_absmax``; the gather at 1,000,000 rows (codes with sentinels, a
   stack of two categoricals, and sorted bounds), exactly equal; the segment
   sum at W in {1, 7, 1000, 10^6} segments, 1-D and 5 columns, with
   sentinels and empty segments; the sparse segment product on the CSR and
   CSC layouts of the reference's three sparse shapes (400,000 x 100,
   3,000,000 x 3 and 40,000 x 10,000, all at 1%), the pair plan and the
   stacked (code, column) plan of the sparse main path and its sparse x
   dense cell (a per-row scale, 5 columns).  The sums are held within 1e-13
   (f64) and 2e-5 (f32) of each segment's sum of |term|, and bit-identical
   across two launches;
4. the dense main path at 1,000,000 x 50 float64: DenseMatrix sandwich,
   matvec and transpose_matvec with and without active sets, standardize and
   the standardized sandwich, then ``fit_glm`` for gaussian and poisson in
   both inner precisions, each held against the same algorithm in numpy;
   ``sandwich_mma_tri<double>`` in the f64 steps and ``sandwich_tri<float>``
   in the f32 steps, and neither tiled ``sandwich<T>``; the f64 sandwich's
   relative error against numpy on a line of its own;
4a. the same checks on the reference bench's ``dense`` design, 4,000,000 x
   10 (``tabmat_tpu/bench/generate.py:70``), built without ``device=``: the
   narrow sandwich kernel in f64 and f32 steps, and no tiled one;
4b. the same checks at 400,000 x 160, built without ``device=``, the widest
   design on which the JAX package runs its slice-pair kernel by default:
   the FP64 tensor-core kernel in f64 steps, ``sandwich_tri<float>`` in f32;
4c. a float32 DenseMatrix at 400,000 x 200, built without ``device=``, past
   the triangle kernel's widths: its sandwich with and without active sets
   through ``sandwich_wide<float>``, against numpy in float64;
4d. the checks of phase 4 at 400,000 x 200 float64, built without
   ``device=``: the FP64 tensor-core kernel in f64 steps,
   ``sandwich_wide<float>`` in the default f32 steps;
5. the mixed main path at 1,000,000 x (5 dense + 1000 + 1000 levels),
   built without ``device=``: DeviceDesign matvec, transpose_matvec and the
   explicit sandwich in f64 and f32 against scipy CSR, a float32
   CategoricalMatrix matvec, then ``fit_glm`` poisson in both inner
   precisions against the same explicit-Hessian + CG algorithm in
   numpy/scipy;
6. the standalone SparseMatrix at the three sparse shapes, built without
   ``device=``: matvec and transpose_matvec with active sets and ``out=``,
   and the sandwich (but ``sparse_wide``'s, which is 6c), against scipy;
6c. ``sparse_wide``'s sandwich, past the pair plan's and the densified
   matrix's budgets: two row panels through the FP64 tensor-core kernel,
   the full (10,000 x 10,000) S against the same panels through the plain
   version on the card, a 200-column slab and a rows + cols restriction
   against scipy on the host;
7. the sparse main path at 1,000,000 x (5 dense + 100 sparse at 1% + 1000 +
   1000 levels), built without ``device=``: as phase 5;
8. times from CUDA events after warm-up: each kernel, its plain version and
   the one PyTorch call that computes the same function (``torch.einsum``
   for the sandwiches, cuSPARSE through ``torch.sparse_csr_tensor`` for the
   sparse product), the sandwich kernels at 1M x 50, 1M x 5, 4M x 10,
   400k x 160, 400k x 200, 1M x 177, 200k x 1000 and ``sparse_wide``'s
   panels, and one
   ``irls_step`` on each path in each inner precision, with the kernel
   launches per step.

The launch counts are set to 0 just before each main-path phase (4 to 7)
and read just after; each path must launch its kernels (the narrow and
wide paths and the mixed and sparse paths' 5-column dense cell the width
dispatch's kernels, the sparse main path both sparse products), and no
path may launch ``sandwich<double>`` or ``sandwich<float>``.  Any failed
check raises, so the script exits 0 only when every check passed.  The last
three lines are the ``kernels`` JSON object (fifteen instantiations),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero and prints no result.
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
# path (a): the reference bench's dense design (tabmat_tpu/bench/generate.py:70)
NARROW_N, NARROW_K = 4_000_000, 10
# path (b): the widest design on which the JAX package runs its slice-pair
# kernel by default (128 < k <= 160 and n*k <= 2^26, ozaki.py:136-154)
WIDE_N, WIDE_K = 400_000, 160
# past the triangle kernel's widths: the 4c and 4d phases and the times of
# sandwich_wide<float> and sandwich<float>
F32_WIDE_K = 200
# sandwich kernel -> (its shapes, the first the full-size one of its row in
# the kernels line; the widths it is held at on EDGE_N rows); the tiled
# kernel takes any width, the wrappers launch it directly
SANDWICH_CASES = {
    "sandwich<double>": (((N, K),), (1, 7, 50, 64, 100, 128, 200)),
    "sandwich<float>": (((WIDE_N, F32_WIDE_K),), (1, 7, 50, 64, 100, 128, 200)),
    "sandwich_narrow<double>": (((NARROW_N, NARROW_K),), (1, 2, 5, 10, 31, 32)),
    "sandwich_narrow<float>": (((NARROW_N, NARROW_K),), (1, 2, 5, 10, 31, 32)),
    "sandwich_tri<float>": (((N, K), (WIDE_N, WIDE_K)), (33, 50, 64, 100, 160, 176)),
    "sandwich_wide<float>": (((WIDE_N, F32_WIDE_K),), (177, 200, 255, 256, 257, 1000, 1024)),
    "sandwich_mma_tri<double>": (((N, K), (1, K), (7, 128), (40, 100)),
                                 (33, 50, 64, 100, 127, 128)),
    "sandwich_mma<double>": (((WIDE_N, WIDE_K),), (129, 160, 200, 1000)),
}
# the width dispatch at its boundaries: (k, dtype name) -> kernel
ROUTES = {
    (32, "float64"): "sandwich_narrow<double>", (33, "float64"): "sandwich_mma_tri<double>",
    (128, "float64"): "sandwich_mma_tri<double>", (129, "float64"): "sandwich_mma<double>",
    (32, "float32"): "sandwich_narrow<float>", (33, "float32"): "sandwich_tri<float>",
    (176, "float32"): "sandwich_tri<float>", (177, "float32"): "sandwich_wide<float>",
}
SLAB = 200  # columns of sparse_wide's S held against scipy on the host
# the mixed design of bench.py:360-371: 5 dense columns and two 1000-level
# categoricals, so the cat x cat cell has 10^6 segments
MIX_KD, MIX_LEVELS = 5, 1000
SEG_WS = (1, 7, 1000, 1_000_000)
# the reference's sparse designs (tabmat_tpu/bench/generate.py:71-73), all
# at 1%, and the sparse block of the sparse main path (bench.py:282: 100
# columns at 1%) over that path's 1,000,000 rows
SPARSE_SHAPES = {"sparse": (400_000, 100), "sparse_narrow": (3_000_000, 3),
                 "sparse_wide": (40_000, 10_000)}
SPARSE_DENSITY = 0.01
SP_KS = 100
FIT_STEPS = 4
# the sparse main path's beta after 4 truncated-CG steps still moves by
# 6e-11 when X moves by 1e-15 (a numpy run on the CPU); after 6 steps by
# 5e-16, so its check against numpy runs 6 steps
SPARSE_FIT_STEPS = 6
N_CG = 16
# f64: the TPU kernels' own bar was relerr 5.2e-15 at this shape; 1e-13
# leaves room for a different summation order.  f32: full-f32 FFMA measured
# at most 2.0e-6 on the card; 2e-5 is ten times that, and a product of
# TF32-rounded inputs (4e-4 to 5e-4) fails it, which phase 3 checks.  The
# prepass takes the same products and maxima as its plain version: exact.
F64_TOL = 1e-13
TPU_F64_RELERR = 5.2e-15  # BENCH_r05.json at 1M x 50: a bar to print beside, not a limit
F32_TOL = 2e-5
ABSMAX_TOL = 0.0
# beta against numpy after FIT_STEPS IRLS steps: f64 differs only by
# summation order; the f32 inner solve (f32 Hessian and CG) differs by f32
# rounding in another order.
BETA_TOL = {"float64": 1e-10, "float32": 1e-4}
# matvec and tmv against scipy differ only by summation order
OP_TOL = 1e-12

# name -> (source, the Pallas kernel it replaces).  gather<T> also covers
# the window take (pallas_window_take.py:109, :130), segsum<T> both one-hot
# segment sums (pallas_segsum.py:97, pallas_segsum_bucketed.py:64);
# sandwich_mma_tri<double> also the unpacked v5 and v3 kernels
# (pallas_sandwich_v5.py:99, pallas_sandwich_v3.py:135), which
# sandwich<double> replaced until it left the route; sandwich_wide<float>
# the f32 kernel past 176, which sandwich<float> was until it left the
# route; sandwich_narrow<T> the
# packed modes of v4 and v5, sandwich_mma<double> also the unsliced pair
# kernel (pallas_pairs.py:29).
KERNELS = {
    "sandwich<double>": ("tabmat_torch/csrc/sandwich.cu", "tabmat_tpu/ops/pallas_sandwich_v4.py:141"),
    "sandwich<float>": ("tabmat_torch/csrc/sandwich.cu", "tabmat_tpu/ops/pallas_kernels.py:34"),
    "sandwich_narrow<double>": ("tabmat_torch/csrc/sandwich_narrow.cu",
                                "tabmat_tpu/ops/pallas_sandwich_v3.py:316"),
    "sandwich_narrow<float>": ("tabmat_torch/csrc/sandwich_narrow.cu",
                               "tabmat_tpu/ops/pallas_kernels.py:34"),
    "sandwich_tri<float>": ("tabmat_torch/csrc/sandwich_tri.cu",
                            "tabmat_tpu/ops/pallas_kernels.py:34"),
    "sandwich_wide<float>": ("tabmat_torch/csrc/sandwich_wide.cu",
                             "tabmat_tpu/ops/pallas_kernels.py:34"),
    "sandwich_mma<double>": ("tabmat_torch/csrc/sandwich_mma.cu",
                             "tabmat_tpu/ops/pallas_pairs.py:103"),
    "sandwich_mma_tri<double>": ("tabmat_torch/csrc/sandwich_mma_tri.cu",
                                 "tabmat_tpu/ops/pallas_sandwich_v4.py:141"),
    "column_absmax": ("tabmat_torch/csrc/sandwich.cu", "tabmat_tpu/ops/pallas_sandwich_v4.py:491"),
    "gather<double>": ("tabmat_torch/csrc/gather.cu", "tabmat_tpu/ops/pallas_gather.py:110"),
    "gather<float>": ("tabmat_torch/csrc/gather.cu", "tabmat_tpu/ops/pallas_gather.py:89"),
    "segsum<double>": ("tabmat_torch/csrc/segsum.cu", "tabmat_tpu/ops/pallas_segsum_bucketed.py:64"),
    "segsum<float>": ("tabmat_torch/csrc/segsum.cu", "tabmat_tpu/ops/pallas_segsum.py:97"),
    "spmv<double>": ("tabmat_torch/csrc/spmv.cu", "tabmat_tpu/ops/pallas_tmv_fused.py:179"),
    "spmv<float>": ("tabmat_torch/csrc/spmv.cu", "tabmat_tpu/ops/pallas_tmv_fused.py:179"),
}
DENSE_KERNELS = ("sandwich_mma_tri<double>", "sandwich_tri<float>", "column_absmax")
NARROW_KERNELS = ("sandwich_narrow<double>", "sandwich_narrow<float>", "column_absmax")
WIDE_KERNELS = ("sandwich_mma<double>", "sandwich_tri<float>", "column_absmax")
F32_WIDE_KERNELS = ("sandwich_mma<double>", "sandwich_wide<float>", "column_absmax")
SPARSE_KERNELS = ("spmv<double>", "spmv<float>")
# the mixed path's 5-column dense cell takes the narrow kernel
MIXED_KERNELS = NARROW_KERNELS + ("gather<double>", "gather<float>", "segsum<double>",
                                  "segsum<float>")

# the least time for a function: its bytes over the memory rate, or its
# operations over the peak rate for the type, whichever is larger (H100 SXM
# data sheet: 3.35 TB/s; 67 TFLOP/s in FP64 (tensor cores) and in FP32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12


def bound(n_bytes: float, n_ops: float):
    """``(bound_ms, bound_by)`` of a function that moves ``n_bytes`` and does
    ``n_ops`` operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _kernel_modules():
    from tabmat_torch.ops import gather_kernel, sandwich_kernel, segsum_kernel, spmv_kernel

    return sandwich_kernel, gather_kernel, segsum_kernel, spmv_kernel


def reset_launch_counts() -> None:
    for module in _kernel_modules():
        module.reset_launch_counts()


def launch_counts() -> dict:
    counts = {}
    for module in _kernel_modules():
        counts.update(module.launches)
    return counts


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
    names = _build.SOURCES
    _build.build_all(names)
    print(f"[2] build of {len(names)} sources in parallel: {time.perf_counter() - t0:.2f} s")
    for name in names:
        info = _build.build_info[name]
        seconds = info["seconds"] if info["seconds"] is not None else "reused"
        print(f"  {name}: nvcc {seconds} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("    " + line.strip())
    sys.stdout.flush()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32)


def _tf32_control(X, d) -> None:
    """The f32 limit must reject a product of TF32-rounded inputs."""
    from tabmat_torch.ops import sandwich_kernel as sk

    Xt, dt = tf32_round(X).double(), tf32_round(d).double()
    exact = sk.sandwich_plain(X.double(), d.double())
    ctl = _relerr(sk.sandwich_plain(Xt, dt).cpu(), exact.cpu())
    print(f"  control: TF32-rounded inputs give relerr {ctl:.3e}, "
          f"over the f32 limit {F32_TOL:.0e}: {ctl > F32_TOL}")
    if not ctl > F32_TOL:
        raise AssertionError("the f32 limit does not reject a TF32 product")


def phase_kernels(device, cases=None, edge_n: int = EDGE_N, absmax_shapes=None) -> dict:
    """Each sandwich kernel and the prepass against their plain versions, and
    the width dispatch at its boundaries; returns max|Δ| at each kernel's
    first full-size shape.  ``cases`` maps a sandwich kernel to its full-size
    shapes and its widths on ``edge_n`` rows (default ``SANDWICH_CASES``)."""
    from tabmat_torch.ops import sandwich_kernel as sk

    cases = SANDWICH_CASES if cases is None else cases
    if absmax_shapes is None:
        absmax_shapes = [(N, K)] + [(edge_n, kk) for kk in EDGE_KS]
    print(f"[3] kernels vs plain on {device}", flush=True)
    gen = torch.Generator(device=device).manual_seed(3)
    on_card = device.type == "cuda"
    max_abs = {}
    for name, (fulls, widths) in cases.items():
        dtype = torch.float64 if name.endswith("<double>") else torch.float32
        tol = F64_TOL if dtype == torch.float64 else F32_TOL
        wrapper = sk.KERNEL_WRAPPERS[name]
        for rows, cols in list(fulls) + [(edge_n, kk) for kk in widths]:
            X = torch.randn(rows, cols, device=device, dtype=dtype, generator=gen)
            d = torch.randn(rows, device=device, dtype=dtype, generator=gen)
            d[1::5] = 0.0  # zeros, as masked rows arrive
            before = sk.launches[name]
            S, again = wrapper(X, d), wrapper(X, d)
            P = sk.sandwich_plain(X, d)
            if on_card:
                torch.cuda.synchronize(device)
                if sk.launches[name] != before + 2:
                    raise AssertionError(f"{name} {rows}x{cols} launched no kernel")
                # the kernels mirror their upper triangle and sum in a fixed order
                if not torch.equal(S, S.T):
                    raise AssertionError(f"{name} {rows}x{cols} is not symmetric")
                if not torch.equal(S, again):
                    raise AssertionError(f"{name} {rows}x{cols}: two launches differ")
            err = float((S - P).abs().max())
            if (rows, cols) == fulls[0]:
                max_abs[name] = err
            if (rows, cols) in fulls and dtype == torch.float32:
                _tf32_control(X, d)
            _check(f"{name} {rows}x{cols} relerr (symmetric, repeats exactly)",
                   err / float(P.abs().max()), tol)
            del X, d, S, again, P
    for (k, dtype_name), want in ROUTES.items():
        dtype = getattr(torch, dtype_name)
        name = sk.route(k, dtype)
        X = torch.randn(edge_n, k, device=device, dtype=dtype, generator=gen)
        d = torch.rand(edge_n, device=device, dtype=dtype, generator=gen)
        before = dict(sk.launches)
        sk.sandwich(X, d)
        launched = [key for key in sk.launches if sk.launches[key] != before[key]]
        print(f"  route k={k} {dtype_name}: {name}, launched {launched}")
        if name != want or (on_card and launched != [want]):
            raise AssertionError(f"the dispatch at k={k} {dtype_name} took {name} "
                                 f"(launched {launched}), not {want}")
    for rows, cols in absmax_shapes:
        X = torch.randn(rows, cols, device=device, dtype=torch.float32, generator=gen)
        d = torch.randn(rows, device=device, dtype=torch.float64, generator=gen)
        d[::5] = 0.0
        d[1] = 1e300  # beyond float32: the prepass reads f64 weights
        err = float((sk.column_absmax(X, d) - sk.column_absmax_plain(X, d)).abs().max())
        if (rows, cols) == absmax_shapes[0]:
            max_abs["column_absmax"] = err
        _check(f"column_absmax {rows}x{cols} max|diff|", err, ABSMAX_TOL)
    return max_abs


def phase_cat_kernels(device, n: int, seg_ws=SEG_WS, levels: int = MIX_LEVELS) -> dict:
    """The gather and the segment sum against their plain versions; returns
    max|kernel - plain| by instantiation over all cases."""
    from tabmat_torch.ops import gather_kernel as gk
    from tabmat_torch.ops import segsum_kernel as ssk
    from tabmat_torch.ops.segments import build_plan

    print(f"[3] gather and segment sum vs plain on {device}", flush=True)
    rng = np.random.default_rng(11)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    max_abs = {name: 0.0 for name in ("gather<double>", "gather<float>",
                                      "segsum<double>", "segsum<float>")}
    # sentinels: -1 (missing), -2 (drop_first of a missing), past the end
    codes = rng.integers(-2, levels + 3, n).astype(np.int32)
    # two categoricals stacked as the design stacks them: the second offset
    # by the first's width, an invalid code turned into the pad code
    first, second = rng.integers(-1, levels, n), rng.integers(-1, levels, n)
    stacked = np.concatenate([np.where(first >= 0, first, 2 * levels),
                              np.where(second >= 0, second + levels, 2 * levels)])
    stacked = stacked.astype(np.int32)
    bounds = np.sort(rng.integers(0, n + 1, 10**6 + 1)).astype(np.int32)
    for dtype in (torch.float64, torch.float32):
        name = f"gather<{'double' if dtype == torch.float64 else 'float'}>"
        table = torch.as_tensor(rng.standard_normal(levels), dtype=dtype, device=device)
        table2 = torch.as_tensor(rng.standard_normal(2 * levels), dtype=dtype, device=device)
        src = torch.as_tensor(np.cumsum(rng.standard_normal(n + 1)), dtype=dtype, device=device)
        cases = (
            ("codes with sentinels", table, codes, n),
            ("2-cat stack", table2, stacked, n),
            ("sorted bounds (window take)", src, bounds, len(bounds)),
        )
        for label, tab, cod, rows in cases:
            cod = torch.as_tensor(cod, device=device)
            got = gk.gather(tab, cod, rows)
            want = gk.gather_plain(tab, cod, rows)
            sync()
            err = float((got - want).abs().max())
            max_abs[name] = max(max_abs[name], err)
            _check(f"{name} {label} max|diff|", err, 0.0)
    for W in seg_ws:
        keys = rng.integers(-1, W, n)
        if W > 2:
            keys[np.isin(keys, [0, W // 2])] = -1  # empty segments
        keys[: n // 3] = -1  # a run of sentinels
        plan = build_plan(keys, W, device)
        for m in (1, 5):
            shape = (n,) if m == 1 else (n, m)
            values = rng.standard_normal(shape) * np.exp(rng.uniform(-3, 3, shape))
            for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
                name = f"segsum<{'double' if dtype == torch.float64 else 'float'}>"
                v = torch.as_tensor(values, dtype=dtype, device=device)
                before = ssk.launches[name]
                first = ssk.segsum(v, plan)
                second = ssk.segsum(v, plan)
                if device.type == "cuda" and ssk.launches[name] != before + 2:
                    raise AssertionError(f"{name} W={W} m={m} launched no kernel")
                want = ssk.segsum_plain(v, plan.perm, plan.bounds)
                scale = ssk.segsum_plain(v.abs().double(), plan.perm, plan.bounds)
                sync()
                if not torch.equal(first, second):
                    raise AssertionError(f"{name} W={W} m={m}: two launches differ")
                diff = (first.double() - want.double()).abs()
                max_abs[name] = max(max_abs[name], float(diff.max()))
                rel = float((diff / scale.clamp_min(torch.finfo(torch.float64).tiny)).max())
                _check(f"{name} W={W} m={m} max|diff|/sum|v| (repeats exactly)", rel, tol)
    return max_abs


def sparse_designs(shapes=SPARSE_SHAPES, density: float = SPARSE_DENSITY) -> dict:
    """The reference's sparse designs as scipy CSC, from its seed
    (``tabmat_tpu/bench/generate.py:54-57``)."""
    from scipy import sparse as sps

    return {name: sps.random(n, k, density=density, random_state=7, format="csc")
            for name, (n, k) in shapes.items()}


def sparse_block(n: int, ks: int = SP_KS, density: float = SPARSE_DENSITY):
    """The sparse block of the sparse main path: ``bench.py:282``'s 100
    columns at 1%, from its seed, over ``n`` rows."""
    from scipy import sparse as sps

    return sps.random(n, ks, density=density, random_state=0, format="csc")


def spmv_cases(device, designs: dict, block, levels: int = MIX_LEVELS, kd: int = MIX_KD,
               seed: int = 13) -> list:
    """``(label, plan, a, values, scale)`` in f64 on ``device`` for each
    shape the sparse product takes: the CSR matvec and CSC tmv of each
    design, and the pair plan, the stacked (code, column) plan and the
    sparse x dense cell of the main path's sparse block."""
    import tabmat_torch as tt
    from tabmat_torch.ops import sparse_ops

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, device=device)

    cases = []
    for name, X in designs.items():
        n, k = X.shape
        m = tt.SparseMatrix(X, device=device)
        data, plan = m._csr_parts()
        cases.append((f"{name} {n}x{k} CSR matvec", plan, data, t(rng.standard_normal(k)), None))
        data, plan = m._csc_parts()
        cases.append((f"{name} {n}x{k} CSC tmv", plan, data, t(rng.standard_normal(n)), None))
    n, ks = block.shape
    m = tt.SparseMatrix(block, device=device)
    w = t(rng.random(n) + 0.05)
    prod, plan = m._pair_parts()
    cases.append((f"pair plan {n}x{ks}", plan, prod, w, None))
    codes = np.concatenate([rng.integers(0, levels, n), rng.integers(0, levels, n) + levels])
    a, plan, _ = sparse_ops.code_column_plan(codes, 2 * levels, n, block, device)
    cases.append((f"stacked sparse x cat plan {n}x{ks}, 2x{levels} levels", plan, a, w, None))
    data, plan = m._csc_parts()
    cases.append((f"sparse x dense cell {n}x{ks} x {kd}, scaled", plan, data,
                  t(rng.standard_normal((n, kd))), w))
    return cases


def phase_spmv_kernels(device, cases) -> dict:
    """The sparse segment product against its plain version; returns
    max|kernel - plain| by instantiation over all cases."""
    from tabmat_torch.ops import spmv_kernel as sk

    print(f"[3] sparse segment product vs plain on {device}", flush=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    max_abs = {name: 0.0 for name in SPARSE_KERNELS}
    for label, plan, a, values, scale in cases:
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            name = f"spmv<{'double' if dtype == torch.float64 else 'float'}>"
            A, V = a.to(dtype), values.to(dtype)
            S = None if scale is None else scale.to(dtype)
            before = sk.launches[name]
            first, second = sk.spmv(V, plan, A, S), sk.spmv(V, plan, A, S)
            if device.type == "cuda" and sk.launches[name] != before + 2:
                raise AssertionError(f"{name} {label} launched no kernel")
            want = sk.spmv_plain(V, plan.perm, plan.bounds, A, S)
            mag = sk.spmv_plain(V.abs().double(), plan.perm, plan.bounds, A.abs().double(),
                                None if S is None else S.abs().double())
            sync()
            if not torch.equal(first, second):
                raise AssertionError(f"{name} {label}: two launches differ")
            diff = (first.double() - want.double()).abs()
            max_abs[name] = max(max_abs[name], float(diff.max()))
            rel = float((diff / mag.clamp_min(torch.finfo(torch.float64).tiny)).max())
            _check(f"{name} {label} max|diff|/sum|term| (repeats exactly)", rel, tol)
    return max_abs


def phase_sparse_standalone(designs: dict, device=None, seed: int = 2) -> None:
    """The standalone SparseMatrix at the reference's sparse shapes against
    scipy; ``device=None`` builds without ``device=`` (the card)."""
    import tabmat_torch as tt
    from scipy import sparse as sps

    kw = {} if device is None else {"device": device}
    print(f"[6] standalone SparseMatrix, device={'default' if device is None else device}",
          flush=True)
    rng = np.random.default_rng(seed)
    for name, X in designs.items():
        n, k = X.shape
        m = tt.SparseMatrix(X, **kw)
        if device is None and m.device.type != "cuda":
            raise AssertionError(f"a SparseMatrix built without device= landed on {m.device}")
        Xr = X.tocsr()
        v, r, d = rng.standard_normal(k), rng.standard_normal(n), rng.random(n)
        rows = np.sort(rng.choice(n, n // 2, replace=False))
        cols = np.unique([k - 1, 0, k // 2])
        sub = Xr[rows][:, cols]
        _check(f"{name} {n}x{k} matvec relerr", _relerr(m.matvec(v), Xr @ v), OP_TOL)
        _check(f"{name} matvec cols relerr", _relerr(m.matvec(v, cols=cols), Xr[:, cols] @ v[cols]),
               OP_TOL)
        out = np.ones(n)
        m.matvec(v, out=out)
        _check(f"{name} matvec out= relerr", _relerr(out, 1 + Xr @ v), OP_TOL)
        r_t = torch.as_tensor(r, device=m.device)
        got = m.transpose_matvec(r_t)
        if got.device != m.device:
            raise AssertionError(f"a tensor transpose_matvec left the device: {got.device}")
        _check(f"{name} transpose_matvec relerr", _relerr(got.cpu(), X.T @ r), OP_TOL)
        out_t = torch.ones(k, dtype=torch.float64, device=m.device)
        m.transpose_matvec(r_t, rows=rows, cols=cols, out=out_t)
        want = np.ones(k)
        want[cols] += sub.T @ r[rows]
        _check(f"{name} transpose_matvec rows+cols out= relerr", _relerr(out_t.cpu(), want), OP_TOL)
        if name == "sparse_wide":
            continue  # its sandwich, past both budgets, is phase 6c
        H_ref = (X.T @ sps.csc_matrix(X.multiply(d[:, None]))).toarray()
        _check(f"{name} sandwich relerr vs scipy", _relerr(m.sandwich(d), H_ref), F64_TOL)
        sub_ref = (sub.T @ sps.csc_matrix(sub.multiply(d[rows, None]))).toarray()
        _check(f"{name} sandwich rows+cols relerr",
               _relerr(m.sandwich(d, rows=rows, cols=cols), sub_ref), F64_TOL)


def phase_sparse_wide(X, device=None, seed: int = 4, slab: int = SLAB) -> dict:
    """``sparse_wide``'s sandwich, past the pair plan's and the densified
    matrix's budgets: row panels through the width dispatch.  The full S
    against the same panels through the plain version on the device, a
    ``slab``-column slab and a rows + cols restriction against scipy on the
    host.  ``device=None`` builds without ``device=`` (the card)."""
    import tabmat_torch as tt
    from scipy import sparse as sps
    from tabmat_torch.models import sparse as port_sparse
    from tabmat_torch.ops import sparse_ops
    from tabmat_torch.ops.sandwich_kernel import sandwich_plain

    n, k = X.shape
    print(f"[6c] sparse_wide sandwich {n}x{k} ({X.nnz} nonzeros), "
          f"device={'default' if device is None else device}", flush=True)
    m = tt.SparseMatrix(X) if device is None else tt.SparseMatrix(X, device=device)
    if device is None and m.device.type != "cuda":
        raise AssertionError(f"a SparseMatrix built without device= landed on {m.device}")
    if m._pair_parts() is not None or m._dense_mirror() is not None:
        raise AssertionError("sparse_wide must be past the pair plan's and the densified "
                             "matrix's budgets")
    rng = np.random.default_rng(seed)
    d_np = rng.random(n) - 0.25
    d_np[::11] = 0.0
    d = torch.as_tensor(d_np, device=m.device)
    t0 = time.perf_counter()
    S = m.sandwich(d)
    sync = torch.cuda.synchronize if m.device.type == "cuda" else (lambda: None)
    sync()
    seconds = time.perf_counter() - t0
    data, plan = m._csr_parts()
    P = torch.zeros_like(S)
    panels = 0
    for start, stop, panel in sparse_ops.csr_row_panels(
        data, plan, m.array_csr.indptr, k, port_sparse.DENSE_SANDWICH_MAX_ELEMENTS
    ):
        P += sandwich_plain(panel, d[start:stop])
        panels += 1
        del panel
    print(f"  {panels} row panels of at most {port_sparse.DENSE_SANDWICH_MAX_ELEMENTS} "
          f"elements; the sandwich took {seconds:.3f} s on the host clock")
    if m.device.type == "cuda" and not torch.equal(S, S.T):
        raise AssertionError("sparse_wide's S is not exactly symmetric")
    _check("sparse_wide S relerr vs the same panels through the plain version",
           float((S - P).abs().max() / P.abs().max()), F64_TOL)
    del P
    Xr = X.tocsr()
    slab_ref = (Xr.T @ sps.csr_matrix(Xr[:, :slab].multiply(d_np[:, None]))).toarray()
    _check(f"sparse_wide S[:, :{slab}] relerr vs scipy", _relerr(S[:, :slab].cpu(), slab_ref),
           F64_TOL)
    rows = np.sort(rng.choice(n, n // 2, replace=False))
    cols = np.sort(rng.choice(k, 3 * slab // 2, replace=False))
    sub = Xr[rows][:, cols]
    sub_ref = (sub.T @ sps.csr_matrix(sub.multiply(d_np[rows, None]))).toarray()
    _check("sparse_wide sandwich rows+cols relerr vs scipy",
           _relerr(m.sandwich(d_np, rows=rows, cols=cols), sub_ref), F64_TOL)
    return {"matrix": m, "d": d}


def _numpy_irls(X, y, family, steps, n_cg, inner):
    """The port's IRLS step (explicit Hessian, guarded CG) in numpy, for a
    dense X or a scipy sparse one."""
    from scipy import sparse as sps

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
        if sps.issparse(Xi):
            H = (Xi.T @ sps.csr_matrix(Xi.multiply(w.astype(dt)[:, None]))).toarray()
        else:
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


def phase_main_path(device, n: int, k: int, fit_steps: int = FIT_STEPS, seed: int = 0,
                    label: str = "[4] main path") -> dict:
    """A dense path through the public API, checked against numpy;
    ``device=None`` builds without ``device=`` (the card)."""
    import tabmat_torch as tt
    from tabmat_torch.ops import sandwich_kernel as sk

    print(f"{label} {n}x{k} float64, device={'default' if device is None else device}",
          flush=True)
    rng = np.random.default_rng(seed)
    X_np = rng.standard_normal((n, k))
    d_np = rng.random(n) - 0.25
    d_np[::11] = 0.0
    dm = tt.DenseMatrix(X_np) if device is None else tt.DenseMatrix(X_np, device=device)
    if device is None and dm.device.type != "cuda":
        raise AssertionError(f"a DenseMatrix built without device= landed on {dm.device}")
    d = torch.as_tensor(d_np, device=dm.device)

    relerr = _relerr(dm.sandwich(d).cpu(), (X_np * d_np[:, None]).T @ X_np)
    print(f"  f64 sandwich relerr vs numpy at {n}x{k}: {relerr:.3e} (the TPU record "
          f"BENCH_r05.json: {TPU_F64_RELERR:.1e}; limit {F64_TOL:.0e})")
    _check("sandwich relerr", relerr, F64_TOL)
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


def phase_f32_matrix(n: int, k: int, device=None, seed: int = 9,
                     label: str = "[4c] float32 DenseMatrix") -> None:
    """A float32 DenseMatrix through the public API, its sandwich with and
    without active sets checked against numpy in float64; ``device=None``
    builds without ``device=`` (the card)."""
    import tabmat_torch as tt

    print(f"{label} {n}x{k}, device={'default' if device is None else device}", flush=True)
    rng = np.random.default_rng(seed)
    X_np = rng.standard_normal((n, k)).astype(np.float32)
    d_np = (rng.random(n) - 0.25).astype(np.float32)
    d_np[::11] = 0.0
    dm = tt.DenseMatrix(X_np) if device is None else tt.DenseMatrix(X_np, device=device)
    if dm.dtype != np.float32 or (device is None and dm.device.type != "cuda"):
        raise AssertionError(f"a float32 DenseMatrix became {dm.dtype} on {dm.device}")
    X64 = X_np.astype(np.float64)
    _check("sandwich relerr", _relerr(dm.sandwich(d_np), (X64 * d_np[:, None]).T @ X64), F32_TOL)
    rows = np.sort(rng.choice(n, n // 2, replace=False))
    cols = np.arange(k - 1, 9, -1)  # all but ten, reversed
    sub = X64[rows][:, cols]
    _check(f"sandwich rows+{len(cols)} cols relerr",
           _relerr(dm.sandwich(d_np, rows=rows, cols=cols), (sub * d_np[rows, None]).T @ sub),
           F32_TOL)


def phase_mixed_path(n: int, kd: int, levels: int, device=None, fit_steps: int = FIT_STEPS,
                     seed: int = 1, sparse=None) -> dict:
    """The mixed main path through the public API, checked against scipy CSR
    on the host (the design of ``bench.py:360-387``), or with the scipy
    matrix ``sparse`` as a sparse block after the dense one, the sparse main
    path.  ``device=None`` builds every matrix without ``device=``: the
    port's default, the card."""
    import tabmat_torch as tt
    from scipy import sparse as sps
    from tabmat_torch.parallel.design import DeviceDesign

    kw = {} if device is None else {"device": device}
    label = ("[5] mixed main path" if sparse is None
             else f"[7] sparse main path: + {sparse.shape[1]} sparse ({sparse.nnz} nonzeros)")
    print(f"{label} {n}x({kd} + {levels} + {levels}) float64, "
          f"device={'default' if device is None else device}", flush=True)
    rng = np.random.default_rng(seed)
    Xd = rng.standard_normal((n, kd))
    codes = [rng.integers(0, levels, n).astype(np.int32) for _ in range(2)]
    t0 = time.perf_counter()
    sparse_blocks = [] if sparse is None else [tt.SparseMatrix(sparse, **kw)]
    split = tt.SplitMatrix(
        [tt.DenseMatrix(Xd, **kw)] + sparse_blocks
        + [tt.CategoricalMatrix(c, categories=np.arange(levels), **kw) for c in codes]
    )
    design = DeviceDesign.from_matrix(split)
    dev = design.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    plan_seconds = time.perf_counter() - t0
    print(f"  design on {dev}; host plans (both categoricals, their "
          f"{levels * levels}-cell cross{'' if sparse is None else ', the sparse layouts, pair and (code, column) plans'}) "
          f"{plan_seconds:.3f} s")
    if device is None and dev.type != "cuda":
        raise AssertionError(f"a design built without device= landed on {dev}")
    if not design.supports_sandwich:
        raise AssertionError("the design must take the explicit sandwich")

    X = sps.hstack([sps.csr_matrix(Xd)] + [
        m.array_csr if isinstance(m, tt.SparseMatrix) else m.tocsr() for m in split.matrices[1:]
    ])
    X = sps.csr_matrix(X, dtype=np.float64)
    k = X.shape[1]

    def t(a):
        return torch.as_tensor(a, device=dev)

    v, r = rng.standard_normal(k), rng.standard_normal(n)
    w = rng.random(n) + 0.05
    _check("DeviceDesign matvec relerr", _relerr(design.matvec(t(v)).cpu(), X @ v), OP_TOL)
    _check("DeviceDesign transpose_matvec relerr",
           _relerr(design.transpose_matvec(t(r)).cpu(), X.T @ r), OP_TOL)
    H = design.sandwich(t(w)).cpu()
    # the kernels sum in a fixed order and mirror the dense cell (the CPU's
    # plain matmul need not be symmetric)
    if dev.type == "cuda" and not torch.equal(H, H.T):
        raise AssertionError("the f64 mixed sandwich is not exactly symmetric")
    H_ref = (X.T @ sps.csr_matrix(X.multiply(w[:, None]))).toarray()
    _check("explicit sandwich f64 relerr vs scipy", _relerr(H, H_ref), F64_TOL)
    w32 = w.astype(np.float32)
    X32 = sps.csr_matrix(X.astype(np.float32), dtype=np.float64)  # f32-rounded entries
    H32_ref = (X32.T @ sps.csr_matrix(X32.multiply(w32.astype(np.float64)[:, None]))).toarray()
    H32 = design.astype_float(torch.float32).sandwich(t(w32)).cpu()
    _check("explicit sandwich f32 relerr vs scipy", _relerr(H32, H32_ref), F32_TOL)
    del H, H_ref, H32, H32_ref, X32

    cat32 = tt.CategoricalMatrix(codes[0], categories=np.arange(levels), dtype=np.float32, **kw)
    v32 = rng.standard_normal(levels).astype(np.float32)
    got = cat32.matvec(t(v32)).cpu().numpy()
    _check("float32 CategoricalMatrix.matvec max|diff|", float(np.abs(got - v32[codes[0]]).max()), 0.0)

    k_sparse = 0 if sparse is None else sparse.shape[1]
    beta_true = np.r_[rng.standard_normal(kd) * 0.05, rng.standard_normal(k_sparse) * 0.1,
                      rng.standard_normal(2 * levels) * 0.1]
    y = rng.poisson(np.exp(X @ beta_true)).astype(np.float64)
    betas = {}
    for inner in ("float64", "float32"):
        beta, n_iter = tt.fit_glm(split, y, family="poisson", max_iter=fit_steps, tol=0.0,
                                  n_cg=N_CG, inner_precision=inner)
        got = beta.cpu().numpy()
        if n_iter != fit_steps or not np.all(np.isfinite(got)):
            raise AssertionError(f"{label} fit_glm {inner}: n_iter {n_iter}, beta {got[:8]}")
        ref = _numpy_irls(X, y, "poisson", fit_steps, N_CG, inner)
        _check(f"fit_glm poisson inner={inner} beta vs numpy/scipy", _relerr(got, ref),
               BETA_TOL[inner])
        betas[inner] = got
    return {"design": design, "y": t(y), "betas": betas, "plan_seconds": plan_seconds}


# cycles the stream sleeps before a held timing (about 5 ms at 2 GHz)
HOLD_CYCLES = 10_000_000


def _time_ms(fn, reps: int = 20, warmup: int = 3, hold: bool = True) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, from CUDA events.

    With ``hold`` the stream first sleeps on the card while the host queues
    all the calls, so that the events time the device work back to back and
    not the host's rate of launching it: a kernel of 0.01 ms takes longer to
    launch from Python than to run.  The sleep grows until the host has
    queued every call before it ends; a call that waits for the card (as
    ``bincount`` does, to size its output) never lets it, and is timed
    without the hold, with a note.  Without ``hold`` the time includes the
    host's launches, as a caller's step does.
    """
    for _ in range(warmup):
        fn()
    slept, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    cycles = HOLD_CYCLES
    for attempt in range(4):
        if attempt == 3:
            print("    (this call waits for the card: timed with its host launches)")
            hold = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slept.record()
        if hold:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        stop.synchronize()
        if not hold or queued_ms < slept.elapsed_time(start):
            return start.elapsed_time(stop) / reps
        cycles *= 4


def _compare(label: str, card: str, kernel, plain, library=None, reps: int = 20,
             warmup: int = 3) -> dict:
    """Mean CUDA-event ms of each side, run in turns: plain, kernel, library,
    library, kernel, plain."""
    fns = {"plain": plain, "kernel": kernel, "library": library}
    runs = {"plain": [], "kernel": [], "library": []}
    for which in ("plain", "kernel", "library", "library", "kernel", "plain"):
        if fns[which] is not None:
            runs[which].append(_time_ms(fns[which], reps=reps, warmup=warmup))
    means = {key: (sum(v) / len(v) if v else None) for key, v in runs.items()}
    print(f"  {label}: kernel {runs['kernel']} ms, plain {runs['plain']} ms, "
          f"library {runs['library'] or 'none'} ms ({card})")
    return means


def spmv_bound(plan, a, values, scale):
    """``(bound_ms, bound_by)`` of one sparse product: ``a``, the indices,
    the bounds, ``values`` and ``scale`` read once, the output written once;
    a multiply-add per element and column (and the scale's multiply)."""
    size = values.element_size()
    m = 1 if values.ndim == 1 else values.shape[1]
    E = plan.perm.numel()
    n_bytes = (E * (size + 4) + plan.bounds.numel() * 4 + values.numel() * size
               + (0 if scale is None else scale.numel() * size) + plan.num_segments * m * size)
    return bound(n_bytes, 2 * E * m + (0 if scale is None else E))


# the case whose times stand for spmv<T> in the kernels line: row 15's
# function, the CSC transpose-matvec of the reference's 400k x 100 design
ROW15_CASE = "sparse 400000x100 CSC tmv"


def sandwich_bound(n: int, k: int, size: int):
    """``(bound_ms, bound_by)`` of one dense sandwich: X, d and S moved once;
    the upper triangle's multiply-adds and the scaling by d."""
    return bound(n * k * size + n * size + k * k * size, n * k * (k + 1) + n * k)


# sandwich kernel -> the shapes phase 8 times it at; the first is its row
# in the kernels line (the 1M x 50 main path, path (a), path (b), the f32
# steps and matrix past the triangle kernel's widths)
SANDWICH_TIMES = {
    "sandwich<double>": ((N, K),),
    "sandwich<float>": ((WIDE_N, F32_WIDE_K),),
    "sandwich_wide<float>": ((WIDE_N, F32_WIDE_K), (1_000_000, 177), (200_000, 1000)),
    "sandwich_narrow<double>": ((NARROW_N, NARROW_K), (N, MIX_KD)),
    "sandwich_narrow<float>": ((NARROW_N, NARROW_K), (N, MIX_KD)),
    "sandwich_tri<float>": ((N, K), (WIDE_N, WIDE_K)),
    "sandwich_mma_tri<double>": ((N, K),),
    "sandwich_mma<double>": ((WIDE_N, WIDE_K),),
}


def phase_times(device, n: int, k: int, card: str, mixed: dict, sparse: dict,
                cases: list, wide: dict) -> dict:
    """Kernel, plain and library times with their bounds, and IRLS step times."""
    import tabmat_torch as tt
    from torch.nn import functional as F
    from tabmat_torch.glm import irls_step
    from tabmat_torch.models import sparse as port_sparse
    from tabmat_torch.ops import gather_kernel as gk
    from tabmat_torch.ops import sandwich_kernel as sk
    from tabmat_torch.ops import segsum_kernel as ssk
    from tabmat_torch.ops import sparse_ops
    from tabmat_torch.ops import spmv_kernel as spk
    from tabmat_torch.parallel.design import DeviceDesign

    print(f"[8] times on {card}", flush=True)
    gen = torch.Generator(device=device).manual_seed(5)
    times = {}
    for name, shapes in SANDWICH_TIMES.items():
        dtype = torch.float64 if name.endswith("<double>") else torch.float32
        wrapper = sk.KERNEL_WRAPPERS[name]
        for rows, cols in shapes:
            X = torch.randn(rows, cols, device=device, dtype=dtype, generator=gen)
            d = torch.rand(rows, device=device, dtype=dtype, generator=gen)
            t = _compare(f"{name} {rows}x{cols}", card, lambda: wrapper(X, d),
                         lambda: sk.sandwich_plain(X, d),
                         lambda: torch.einsum("ni,n,nj->ij", X, d, X))
            t["bound"] = sandwich_bound(rows, cols, X.element_size())
            print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]}")
            times[f"{name} {rows}x{cols}"] = t
            times.setdefault(name, t)
            del X, d
    X = torch.randn(n, k, device=device, dtype=torch.float32, generator=gen)
    d = torch.rand(n, device=device, dtype=torch.float64, generator=gen)
    t = _compare(f"column_absmax {n}x{k}", card, lambda: sk.column_absmax(X, d),
                 lambda: sk.column_absmax_plain(X, d))
    t["bound"] = bound(n * k * 4 + n * 8 + k * 8, 2 * n * k)
    times["column_absmax"] = t
    del X, d

    # sparse_wide's sandwich: its row panels, densified once, through the
    # tensor-core kernel into one S, against the same panels through the
    # plain version and einsum (each a few hundred ms: two repeats)
    m, dw = wide["matrix"], wide["d"]
    nw, kw = m.shape
    data, plan = m._csr_parts()
    panels = [(panel, dw[start:stop]) for start, stop, panel in sparse_ops.csr_row_panels(
        data, plan, m.array_csr.indptr, kw, port_sparse.DENSE_SANDWICH_MAX_ELEMENTS)]
    S = torch.zeros((kw, kw), dtype=torch.float64, device=device)

    def over_panels(fn):
        def run():
            for panel, dp in panels:
                fn(panel, dp)
        return run

    t = _compare(f"sandwich_mma<double> sparse_wide {nw}x{kw}, {len(panels)} panels", card,
                 over_panels(lambda A, dp: sk.sandwich_mma(A, dp, out=S)),
                 over_panels(lambda A, dp: S.add_(sk.sandwich_plain(A, dp))),
                 over_panels(lambda A, dp: S.add_(torch.einsum("ni,n,nj->ij", A, dp, A))),
                 reps=2, warmup=1)
    t["bound"] = sandwich_bound(nw, kw, 8)
    print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]} (the densified panels); "
          f"the sparse product itself needs {sparse_ops.pair_count(m.array_csr)} "
          f"multiply-adds and writes {kw * kw * 8} bytes of S")
    times[f"sandwich_mma<double> sparse_wide {nw}x{kw}"] = t
    del panels, S

    design, y = mixed["design"], mixed["y"]
    cat = design._block("cat")
    n_rows, width = cat.n, cat.width
    codes2 = cat.codes.long()
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        suffix = "double" if dtype == torch.float64 else "float"
        # gather<double>: the stacked matvec of the mixed step (C = 2);
        # gather<float>: a float32 CategoricalMatrix matvec (C = 1)
        if dtype == torch.float64:
            table = torch.randn(width, device=device, dtype=dtype, generator=gen)
            codes, C = cat.codes, 2
            padded = torch.cat([table, table.new_zeros(1)])[:, None]
            bags = codes2.view(2, n_rows).T.contiguous()
            library = lambda: F.embedding_bag(bags, padded, mode="sum")  # noqa: E731
        else:
            table = torch.randn(cat.widths[0], device=device, dtype=dtype, generator=gen)
            codes, C = cat.codes[:n_rows], 1
            single = codes.long()
            library = lambda: table[single]  # noqa: E731
        t = _compare(f"gather<{suffix}> {n_rows} rows, C={C}", card,
                     lambda: gk.gather(table, codes, n_rows),
                     lambda: gk.gather_plain(table, codes, n_rows), library)
        t["bound"] = bound(C * n_rows * 4 + n_rows * size + table.numel() * size,
                           (C - 1) * n_rows)
        times[f"gather<{suffix}>"] = t

        # segsum<T>: the stacked tmv / sandwich diagonal (W = 2000, m = 1);
        # then the cat x dense cells (m = 5) and the cat x cat cell (W = 10^6)
        plan = cat.plan
        r = torch.randn(n_rows, device=device, dtype=dtype, generator=gen)
        r2 = r.repeat(2)
        t = _compare(f"segsum<{suffix}> stacked W={width} m=1", card,
                     lambda: ssk.segsum(r, plan),
                     lambda: ssk.segsum_plain(r, plan.perm, plan.bounds),
                     lambda: torch.bincount(codes2, weights=r2, minlength=width + 1))
        E = plan.perm.shape[0]
        t["bound"] = bound(E * 4 + n_rows * size + (width + 1) * 4 + width * size, E)
        times[f"segsum<{suffix}>"] = t
        wX = torch.randn(n_rows, MIX_KD, device=device, dtype=dtype, generator=gen)
        wX2 = wX.repeat(2, 1)
        _compare(f"segsum<{suffix}> stacked W={width} m={MIX_KD}", card,
                 lambda: ssk.segsum(wX, plan),
                 lambda: ssk.segsum_plain(wX, plan.perm, plan.bounds),
                 lambda: torch.zeros(width + 1, MIX_KD, device=device, dtype=dtype)
                 .index_add_(0, codes2, wX2))
        xplan = cat.cross[(0, 1)]
        xcodes = (cat.codes[:n_rows].long() * cat.widths[1] + cat.codes[n_rows:].long()
                  - cat.widths[0])
        _compare(f"segsum<{suffix}> cross W={xplan.num_segments} m=1", card,
                 lambda: ssk.segsum(r, xplan),
                 lambda: ssk.segsum_plain(r, xplan.perm, xplan.bounds),
                 lambda: torch.bincount(xcodes, weights=r, minlength=xplan.num_segments))
        del wX, wX2, r, r2

    # spmv<T>: every shape of the sparse product; the library call is the
    # same layout as a CSR tensor times the values (cuSPARSE), where no
    # per-row scale makes it two calls
    for label, plan, a, values, scale in cases:
        for dtype in (torch.float64, torch.float32):
            name = f"spmv<{'double' if dtype == torch.float64 else 'float'}>"
            A, V = a.to(dtype), values.to(dtype)
            S = None if scale is None else scale.to(dtype)
            library = None
            if S is None:
                csr = torch.sparse_csr_tensor(plan.bounds, plan.perm, A,
                                              size=(plan.num_segments, plan.n_rows))
                library = lambda: csr @ V  # noqa: E731
            t = _compare(f"{name} {label}", card, lambda: spk.spmv(V, plan, A, S),
                         lambda: spk.spmv_plain(V, plan.perm, plan.bounds, A, S), library)
            t["bound"] = spmv_bound(plan, A, V, S)
            print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]}")
            times[f"{name} {label}"] = t
            if label == ROW15_CASE:
                times[name] = t
            del A, V, S

    rng = np.random.default_rng(7)
    steps = []
    for label, (rows, cols) in (("dense", (n, k)), ("dense narrow", (NARROW_N, NARROW_K)),
                                ("dense wide", (WIDE_N, WIDE_K)),
                                ("dense f32 wide", (WIDE_N, F32_WIDE_K))):
        X_np = rng.standard_normal((rows, cols))
        dense = DeviceDesign.from_matrix(tt.DenseMatrix(X_np))
        y_dense = torch.as_tensor(
            X_np @ rng.standard_normal(cols) + 0.1 * rng.standard_normal(rows), device=device)
        steps.append((f"{label} gaussian", dense, y_dense, "gaussian"))
        del X_np
    steps += [("mixed poisson", design, y, "poisson"),
              ("sparse poisson", sparse["design"], sparse["y"], "poisson")]
    for label, dd, yy, family in steps:
        w = torch.ones(dd.shape[0], dtype=torch.float64, device=device)
        b0 = torch.zeros(dd.shape[1], dtype=torch.float64, device=device)
        for inner in ("float32", "float64"):
            def step():
                return irls_step(dd, yy, w, b0, family=family, n_cg=N_CG, inner_precision=inner)

            ms = _time_ms(step, reps=10, hold=False)
            reset_launch_counts()
            step()
            torch.cuda.synchronize(device)
            per_step = {key: v for key, v in launch_counts().items() if v}
            times[f"irls_step {label} {inner}"] = {"ms": ms, "launches": per_step}
            print(f"  irls_step {label} {dd.shape[0]}x{dd.shape[1]} inner={inner} "
                  f"n_cg={N_CG}: {ms:.4f} ms; kernel launches per step {per_step} ({card})")
    sys.stdout.flush()
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = phase_environment()
    phase_build()
    max_abs = phase_kernels(device)
    max_abs.update(phase_cat_kernels(device, N))
    t0 = time.perf_counter()
    designs, block = sparse_designs(), sparse_block(N)
    print(f"  scipy made the sparse designs in {time.perf_counter() - t0:.1f} s", flush=True)
    cases = spmv_cases(device, designs, block)
    max_abs.update(phase_spmv_kernels(device, cases))

    main_launches = []

    def run_main_path(what, phase, *args, must_launch=(), must_not=(), **kwargs):
        reset_launch_counts()
        result = phase(*args, **kwargs)
        counts = launch_counts()
        print(f"  kernel launches in the {what}: {counts}", flush=True)
        missing = [name for name in must_launch if counts[name] == 0]
        if missing:
            raise AssertionError(f"the {what} did not launch {missing}")
        extra = [name for name in must_not if counts[name] != 0]
        if extra:
            raise AssertionError(f"the {what} launched {extra}")
        main_launches.append(counts)
        return result

    wider = ("sandwich<double>", "sandwich<float>", "sandwich_tri<float>",
             "sandwich_wide<float>", "sandwich_mma<double>", "sandwich_mma_tri<double>")
    run_main_path("dense main path", phase_main_path, device, N, K, must_launch=DENSE_KERNELS,
                  must_not=("sandwich<double>", "sandwich<float>"))
    run_main_path("narrow dense path", phase_main_path, None, NARROW_N, NARROW_K,
                  label="[4a] narrow dense path", must_launch=NARROW_KERNELS, must_not=wider)
    run_main_path("wide dense path", phase_main_path, None, WIDE_N, WIDE_K,
                  label="[4b] wide dense path", must_launch=WIDE_KERNELS,
                  must_not=("sandwich<double>", "sandwich<float>", "sandwich_mma_tri<double>"))
    run_main_path("float32 matrix path", phase_f32_matrix, WIDE_N, F32_WIDE_K,
                  must_launch=("sandwich_wide<float>",),
                  must_not=("sandwich<float>", "sandwich_tri<float>"))
    run_main_path("f32-wide dense path", phase_main_path, None, WIDE_N, F32_WIDE_K,
                  label="[4d] f32-wide dense path", must_launch=F32_WIDE_KERNELS,
                  must_not=("sandwich<double>", "sandwich<float>", "sandwich_tri<float>",
                            "sandwich_mma_tri<double>"))
    mixed = run_main_path("mixed main path", phase_mixed_path, N, MIX_KD, MIX_LEVELS,
                          must_launch=MIXED_KERNELS, must_not=wider)
    run_main_path("standalone sparse phase", phase_sparse_standalone, designs,
                  must_launch=SPARSE_KERNELS[:1])
    wide = run_main_path("sparse_wide sandwich", phase_sparse_wide, designs["sparse_wide"],
                         must_launch=("sandwich_mma<double>",))
    sparse = run_main_path("sparse main path", phase_mixed_path, N, MIX_KD, MIX_LEVELS,
                           sparse=block, fit_steps=SPARSE_FIT_STEPS,
                           must_launch=SPARSE_KERNELS + NARROW_KERNELS[:2])
    # the tiled kernels are off every route: phase 3 holds them, no path runs them
    for tiled in ("sandwich<double>", "sandwich<float>"):
        if any(counts[tiled] for counts in main_launches):
            raise AssertionError(f"a main path launched {tiled}, which no route names")

    times = phase_times(device, N, K, card, mixed, sparse, cases, wide)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        bound_ms, bound_by = times[name]["bound"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(counts[name] for counts in main_launches),
            "max_abs_err": max_abs[name],
            "ms": times[name]["kernel"],
            "plain_ms": times[name]["plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": times[name]["library"],
        })
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
