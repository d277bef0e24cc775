#!/usr/bin/env python3
"""Drive tabmat_torch's GLM main paths once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions,
   TF32 off;
2. build of the CUDA kernels from ``tabmat_torch/csrc``, one ``nvcc`` per
   source (eleven sources), all at once (seconds, ptxas registers and spills);
3. each kernel against its plain PyTorch version on the card: each of the
   sandwich kernels through its own wrapper (``sandwich_wide<float>`` at
   400,000 x 200 and k in {177, 200, 255, 256,
   257, 1000, 1024}; ``sandwich_narrow<T>`` at
   4,000,000 x 10 and k in {1, 2, 4, 5, 8, 9, 10, 11, 16, 17, 31, 32}
   (whole rows a thread to 10; past it FP64 tensor-core tiles in f64 and
   FFMA micro-tiles in f32; 100,003 rows end mid-stage); ``sandwich_tri<float>``
   at 1,000,000 x 50, 400,000 x 160 and k in {33, 50, 64, 100, 160, 176};
   ``sandwich_mma_tri<double>`` at 1,000,000 x 50, at 1, 7 and 40 rows and
   k in {33, 50, 64, 100, 127, 128}; ``sandwich_mma<double>`` at 400,000 x
   160, at 1, 7 and 40 rows and k in {129, 137, 160, 200, 255, 256, 257,
   1000, 1024}, odd widths and the 128-column tile's edges),
   with negative and zero weights, exactly symmetric and bit-identical across
   two launches, and a control that the f32 limit rejects a TF32-rounded
   product; the width dispatch at 32/33 and 128/129 (f64) and 32/33 and
   176/177 (f32); the range prepass
   ``column_absmax``; the gather at 1,000,000 rows (codes with sentinels, a
   stack of two categoricals, and sorted bounds) and at its edges (1, 7, 33
   and 100,003 rows at 1 to 3 planes, 5 and 9 planes, codes views at
   offsets of 1 to 3, all-sentinel codes, an empty table, a 100,000-entry
   table, -0.0 with inf and NaN behind the sentinels), bit for bit and
   across two launches; the segment
   sum at 1,000,000 and 100,003 rows, W in {1, 7, 1000, the stacked plan of
   two 1000-level categoricals (2000), 10^6} segments and a plan whose rows
   all fall in one row tile, m in {1, 5, 8, 9, 50} columns, with sentinels
   and empty segments, through both of its routes (``segsum<T>`` and
   ``segsum_slots<T>``); the sparse segment product on the CSR and
   CSC layouts of the reference's three sparse shapes (400,000 x 100,
   3,000,000 x 3 and 40,000 x 10,000, all at 1%), the pair plan and the
   stacked (code, column) plan of the sparse main path and its sparse x
   dense cell (a per-row scale, 5 columns), each case through both bound
   widths (``spmv<T>`` on int32 bounds, ``spmv<T,int64>`` on the same
   layout with int64 bounds, bit for bit the same), and a 400,000 x 100
   ``SparseMatrix`` built with ``sparse_ops.INT32_MAX`` lowered below its
   nonzeros (int64 CSR, CSC and pair plan; its ops against scipy).  The sums
   are held within 1e-13 (f64) and 2e-5 (f32) of each segment's sum of
   |term|, and bit-identical across two launches;
4. the dense main path at 1,000,000 x 50 float64: DenseMatrix sandwich,
   matvec and transpose_matvec with and without active sets, standardize and
   the standardized sandwich, then ``fit_glm`` for gaussian and poisson in
   both inner precisions, each held against the same algorithm in numpy;
   ``sandwich_mma_tri<double>`` in the f64 steps and ``sandwich_tri<float>``
   in the f32 steps; the f64 sandwich's
   relative error against numpy on a line of its own;
4a. the same checks on the reference bench's ``dense`` design, 4,000,000 x
   10 (``tabmat_tpu/bench/generate.py:70``), built without ``device=``: the
   narrow sandwich kernel in f64 and f32 steps;
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
   matrix's budgets: the sparse Gram kernel (``sparse_gram<double>``, one
   launch, no panel), the full (10,000 x 10,000) S against its plain
   version on the card, exactly symmetric and bit for bit across two
   sandwiches, ``sparse_gram<float>`` on the same design in float32 against
   its plain version, a 200-column slab and a rows + cols restriction
   against scipy on the host;
7. the sparse main path at 1,000,000 x (5 dense + 100 sparse at 1% + 1000 +
   1000 levels), built without ``device=``: as phase 5;
7b. the dataframe and formula path, built without ``device=``: a frame of
   freMTPL2freq's shape (678,013 rows made with numpy; categoricals with
   declared level orders that are not sorted), the design of
   ``FREQ_FORMULA`` (42 columns: 7 dense, three kept categoricals) equal to
   its numpy encoding and with the JAX package's column names, its matvec,
   transpose_matvec and sandwich against scipy CSR, a Poisson
   ``GeneralizedLinearRegressor`` with ``formula=`` and the exposure as
   sample weights in both inner precisions against the same algorithm in
   numpy, ``predict`` on 10,000 new rows against numpy; then
   ``from_pandas`` on phase 5's frame, its design's sandwich and matvec
   against phase 5's hand-built one; the host seconds of ``from_formula``
   and ``from_pandas``;
8. times from CUDA events after warm-up: each kernel, its plain version and
   the one PyTorch call that computes the same function (``torch.einsum``
   for the sandwiches, cuSPARSE through ``torch.sparse_csr_tensor`` for the
   sparse product (``spmv<T,int64>`` on the 400,000 x 100 CSC tmv's layout
   with int64 bounds, beside cuSPARSE with int64 indices), ``bincount``
   and ``index_add_`` for the segment sum at the mixed step's three shapes, ``table[codes]``, ``embedding_bag`` and
   ``src[idx]`` for the gather, also at the window take's sorted indices),
   the sandwich kernels at 1M x 50, 1M x 5, 4M x 10,
   400k x 160, 400k x 200, 1M x 177, 1M x 129, 200k x 1000 (f32 and f64),
   ``sparse_gram<T>`` at ``sparse_wide``, ``std_expand<T>`` (the
   standardized sandwich's expansion) in place on that S, against its plain
   version and bit for bit equal to it, and one
   ``irls_step`` on each path (7b's formula design among them) in each
   inner precision, with the kernel launches per step;
9. the benchmark CLI, ``tabmat_torch.bench.main.main(argv)`` in process
   with the arguments a user types and no ``--device``: each of the
   reference's eight designs at ``--scale 1.0`` (dense 4M x 10, sparse
   400k x 100, sparse_narrow 3M x 3, sparse_wide 40k x 10k, one_cat 1M x
   100k, two_cat 1M x (1k + 1k), dense_cat and dense_smallcat 3M x (5 + 1k
   + 1k) and (5 + 10 + 1k)) with ``--include_baseline --bench_memory
   --output build/bench_cli/<design>.csv``, then ``--standardized`` on
   dense, sparse, two_cat and dense_cat: every op timed, each device result
   within 1e-13 (sandwich) or 1e-12 (matvec, transpose-matvec) of its
   numpy/scipy baseline on the same inputs, the device memory columns
   present, each design's kernels launched (``CLI_KERNELS``); then the
   sparse design under a zero device-cache budget: no pair plan, no
   mirror, nothing charged, under 1% of the mirror's bytes kept, the same
   sandwich; and the ledger's charge of the unbudgeted pair plan equal to
   its tensors' bytes and within the CLI's ``hbm_cache_bytes``.  The CLI's
   own JSON rows go to ``build/bench_cli/<design>.jsonl``; the phase prints
   each design's table;
10. the multi-device path (``tabmat_torch.parallel``) on phase 7's design:
   10a, one NCCL rank in this process (``make_mesh(1)``):
   ``DeviceDesign.shard`` -> ``irls_step`` in both inner precisions and 4
   steps of ``fit_glm``, each bit for bit the single device's (a one-rank
   all-reduce is a copy), and the step's ms beside the single device's;
   10b, eight ranks sharing the card over gloo with CUDA tensors (NCCL
   refuses two ranks on one device), the mesh of
   ``__graft_entry__.dryrun_multichip`` (dp = 4 x mp = 2): the user path
   with the dense columns over ``mp`` in both inner precisions, the same
   step on a two-level mesh (dcn = 2 x dp = 2 x mp = 2, rows over
   ``("dcn", "dp")``), ``sharded_sandwich`` at 1,000,000 x 50 (its relerr
   against numpy on a line of its own), ``sharded_transpose_matvec``,
   ``sharded_segment_sum`` (W = 1000) and ``mixed_irls_step`` on
   ``build_mixed_design(1_000_000, 5, 100, 1000, density=0.01)``, each
   held against the single device within the dryrun's bounds (rtol 1e-8,
   atol 1e-10; the float32 inner step 1e-4), every rank holding the same
   bits and launching the sparse path's kernels; the ranks' step times
   are printed as host-staged (gloo moves a card's tensor through the
   host), no speed figure;
11. a sparse design past 2^31 - 1 nonzeros (``wide_nnz_matrix``: 2^26 x
   1,000 float64, 28 to 38 nonzeros a row, 2,214,592,521 in all), built
   without ``device=``: ``SparseMatrix`` with int64 bounds, its matvec and
   transpose_matvec (each one ``spmv<double,int64>``) against scipy, its
   sandwich (row panels through ``sandwich_mma<double>``) against the sum
   of its two row halves' (int32 layouts, built after the whole matrix's
   are freed), and a gaussian ``irls_step`` of ``DeviceDesign.from_matrix``
   (the Hessian-vector path, ``n_cg=4``) in both inner precisions against
   the same step in numpy/scipy; each host step's seconds, the layouts'
   device bytes, ``spmv<double,int64>``'s times at this size beside
   cuSPARSE with int64 indices.

The launch counts are set to 0 just before each main-path phase (4 to 7b,
each design of 9, 10a, each rank of 10b, and 11) and read just after; each path must launch its
kernels (the narrow and wide paths and the mixed and sparse paths' 5-column
dense cell the width dispatch's kernels, the sparse main path both sparse
products, phase 11 ``spmv<T,int64>`` and no ``spmv<T>``).  Any failed
check raises, so the script exits 0 only when every check passed.  The last
three lines are the ``kernels`` JSON object (nineteen instantiations),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero and prints no result.
"""

import contextlib
import gc
import json
import os
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
# sandwich_wide<float>
F32_WIDE_K = 200
# the narrow kernel's widths where its plan changes: 16-, 8-byte and single
# row loads of a thread's whole rows (k <= 10), then 2 to 4 column blocks of
# 8 (f64 tensor-core tiles) or 3 to 8 micro-tiles of 4 a side (f32)
NARROW_EDGE_KS = (1, 2, 4, 5, 8, 9, 10, 11, 16, 17, 31, 32)
# sandwich kernel -> (its shapes, the first the full-size one of its row in
# the kernels line; the widths it is held at on EDGE_N rows)
SANDWICH_CASES = {
    "sandwich_narrow<double>": (((NARROW_N, NARROW_K),), NARROW_EDGE_KS),
    "sandwich_narrow<float>": (((NARROW_N, NARROW_K),), NARROW_EDGE_KS),
    "sandwich_tri<float>": (((N, K), (WIDE_N, WIDE_K)), (33, 50, 64, 100, 160, 176)),
    "sandwich_wide<float>": (((WIDE_N, F32_WIDE_K),), (177, 200, 255, 256, 257, 1000, 1024)),
    "sandwich_mma_tri<double>": (((N, K), (1, K), (7, 128), (40, 100)),
                                 (33, 50, 64, 100, 127, 128)),
    "sandwich_mma<double>": (((WIDE_N, WIDE_K), (1, 129), (7, 257), (40, 1000)),
                             (129, 137, 160, 200, 255, 256, 257, 1000, 1024)),
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
# the segment sum's plans ("stacked": two MIX_LEVELS categoricals stacked,
# the mixed design's tmv plan) and column counts (the cat x dense cells'
# dense width, 8 and 9 at the column group's edge, a wide active set)
SEG_WS = (1, 7, 1000, "stacked", 1_000_000)
SEG_MS = (1, 5, 8, 9, 50)
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
# the dataframe and formula path: freMTPL2freq, the French motor claims
# table of R's CASdatasets (678,013 policies; glum's tutorial data), made
# with numpy in its shape; each categorical's levels in a declared order
# that is not sorted, and 10,000 new rows for predict
FREQ_N, FREQ_NEW_N = 678_013, 10_000
FREQ_FORMULA = ("ClaimNb ~ VehPower + VehAge + DrivAge + BonusMalus + C(Area) + C(VehBrand)"
                " + C(VehGas) + C(Region) + np.log(Density)")
FREQ_LEVELS = {
    "Area": ["C", "A", "E", "B", "F", "D"],
    "VehBrand": ["B12", "B1", "B2", "B3", "B4", "B5", "B6", "B10", "B11", "B13", "B14"],
    "VehGas": ["Regular", "Diesel"],
    "Region": ["R82", "R11", "R21", "R22", "R23", "R24", "R25", "R26", "R31", "R41", "R42",
               "R43", "R52", "R53", "R54", "R72", "R73", "R74", "R83", "R91", "R93"],
}
# the formula design's columns are not scaled (BonusMalus to 230 beside
# one-hot columns): its Hessian's condition number is above 1e6, and 16
# CG iterations leave each inner solve far from converged, so that beta
# moves by more than BETA_TOL when X moves by 1e-15.  With 100 iterations
# each solve converges, and beta moves by less than a hundredth of
# BETA_TOL, in f64 when X moves by 1e-15 and in f32 when it moves by 1e-7
# (tests/test_torch_smoke.py::test_freq_fit_is_insensitive_to_rounding,
# numpy at 20,000 rows), so the fit is held against numpy with these
FREQ_FIT_STEPS, FREQ_N_CG = 6, 100
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
# (pallas_sandwich_v5.py:99, pallas_sandwich_v3.py:135); sandwich_wide<float>
# the f32 kernel past 176; sandwich_narrow<T> the
# packed modes of v4 and v5, sandwich_mma<double> also the unsliced pair
# kernel (pallas_pairs.py:29); sparse_gram<T> the sliced pair kernel on the
# sandwich of a SparseMatrix past the pair plan's and the densified matrix's
# budgets, which sandwich_mma<double> took on densified row panels before.
KERNELS = {
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
    "segsum_slots<double>": ("tabmat_torch/csrc/segsum.cu",
                             "tabmat_tpu/ops/pallas_segsum_bucketed.py:64"),
    "segsum_slots<float>": ("tabmat_torch/csrc/segsum.cu", "tabmat_tpu/ops/pallas_segsum.py:97"),
    "spmv<double>": ("tabmat_torch/csrc/spmv.cu", "tabmat_tpu/ops/pallas_tmv_fused.py:179"),
    "spmv<float>": ("tabmat_torch/csrc/spmv.cu", "tabmat_tpu/ops/pallas_tmv_fused.py:179"),
    "spmv<double,int64>": ("tabmat_torch/csrc/spmv.cu",
                           "tabmat_tpu/ops/pallas_tmv_fused.py:179"),
    "spmv<float,int64>": ("tabmat_torch/csrc/spmv.cu", "tabmat_tpu/ops/pallas_tmv_fused.py:179"),
    "sparse_gram<double>": ("tabmat_torch/csrc/sparse_gram.cu",
                            "tabmat_tpu/ops/pallas_pairs.py:103"),
    "sparse_gram<float>": ("tabmat_torch/csrc/sparse_gram.cu",
                           "tabmat_tpu/ops/pallas_pairs.py:103"),
}
DENSE_KERNELS = ("sandwich_mma_tri<double>", "sandwich_tri<float>", "column_absmax")
NARROW_KERNELS = ("sandwich_narrow<double>", "sandwich_narrow<float>", "column_absmax")
WIDE_KERNELS = ("sandwich_mma<double>", "sandwich_tri<float>", "column_absmax")
F32_WIDE_KERNELS = ("sandwich_mma<double>", "sandwich_wide<float>", "column_absmax")
SPARSE_KERNELS = ("spmv<double>", "spmv<float>")
# the same on layouts of more than 2^31 - 1 elements (int64 bounds)
WIDE_SPARSE_KERNELS = ("spmv<double,int64>", "spmv<float,int64>")
# the segment sum's two routes: the stacked plan's tmv, diagonal and cat x
# dense cells take the tiles route, the 10^6-cell cat x cat plan the slots
SEGSUM_KERNELS = ("segsum<double>", "segsum<float>", "segsum_slots<double>",
                  "segsum_slots<float>")
# the mixed path's 5-column dense cell takes the narrow kernel
MIXED_KERNELS = NARROW_KERNELS + ("gather<double>", "gather<float>") + SEGSUM_KERNELS
# the formula design's 7 dense columns take the narrow kernel, its three
# categoricals the gather and the segment sum's tiles route (its cat x cat
# cells have 50 to 200 segments); from_pandas's design, phase 5's, adds the
# slots route of its 10^6-cell cat x cat cell (f64 only: it takes no f32 step)
FRAME_KERNELS = NARROW_KERNELS + ("gather<double>", "segsum<double>", "segsum<float>",
                                  "segsum_slots<double>")

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
    from tabmat_torch.ops import (gather_kernel, sandwich_kernel, segsum_kernel,
                                  sparse_gram_kernel, spmv_kernel)

    return sandwich_kernel, gather_kernel, segsum_kernel, spmv_kernel, sparse_gram_kernel


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


def segsum_plan(rng, n: int, W, device, levels: int = MIX_LEVELS):
    """A plan of phase 3's segment sums on n rows: W segments with a third
    of the rows sentinels and two segments empty; ``"stacked"``, the stacked
    plan of two ``levels``-level categoricals (2 * levels segments), as the
    mixed design builds it; ``"one_tile"``, ``levels`` segments over rows
    that all fall in the kernel's first row tile, whatever its rows."""
    from tabmat_torch.ops import segsum_kernel as ssk
    from tabmat_torch.ops.segments import build_plan, stack

    if W == "stacked":
        return stack([build_plan(rng.integers(-1, levels, n), levels, device) for _ in range(2)])
    if W == "one_tile":
        keys = rng.integers(0, levels, n)
        keys[ssk.MIN_TILE_ROWS:] = -1
        return build_plan(keys, levels, device)
    keys = rng.integers(-1, W, n)
    if W > 2:
        keys[np.isin(keys, [0, W // 2])] = -1  # empty segments
    keys[: n // 3] = -1  # a run of sentinels
    return build_plan(keys, W, device)


# the gather's edge cases: rows that leave every n % 4 (a thread takes runs
# of 4 rows in f32, 2 in f64), at 1 to 3 stacked planes; codes views at
# these offsets (the planes then start off their runs' alignment, each by
# its own amount)
GATHER_EDGE_NS = (1, 7, 33, EDGE_N)
# past 3 planes the kernel takes them a plane at a time
GATHER_WIDE_CS = (4, 5, 6, 7, 8, 9)
GATHER_OFFSETS = (1, 2, 3)
ONE_CAT_LEVELS = 100_000  # the reference bench's one_cat table


def gather_cases(rng, device, dtype, n: int, levels: int = MIX_LEVELS) -> list:
    """``(label, table, codes, rows)`` of phase 3's gather: codes with
    sentinels (-1, -2, past the end) on ``n`` rows, a stack of two
    categoricals as the design stacks them, sorted bounds (the window take),
    then the edges: every ``GATHER_EDGE_NS`` at C = 1, 2, 3, and
    ``GATHER_WIDE_CS`` planes; codes views at
    ``GATHER_OFFSETS``; all-sentinel codes; an empty table; a
    ``ONE_CAT_LEVELS`` table; and a table holding inf and NaN where only
    sentinels would reach them (a clamped or multiplied-by-0 sentinel would
    read them) and -0.0 where codes do."""
    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    def codes(rows, width, C=1):
        return t(rng.integers(-2, width + 3, C * rows), torch.int32)

    table = t(rng.standard_normal(levels))
    first, second = rng.integers(-1, levels, n), rng.integers(-1, levels, n)
    stacked = np.concatenate([np.where(first >= 0, first, 2 * levels),
                              np.where(second >= 0, second + levels, 2 * levels)])
    bounds = np.sort(rng.integers(0, n + 1, 10**6 + 1))
    cases = [
        ("codes with sentinels", table, codes(n, levels), n),
        ("2-cat stack", t(rng.standard_normal(2 * levels)), t(stacked, torch.int32), n),
        ("sorted bounds (window take)", t(np.cumsum(rng.standard_normal(n + 1))),
         t(bounds, torch.int32), len(bounds)),
    ]
    for rows in GATHER_EDGE_NS:
        for C in (1, 2, 3):
            cases.append((f"{rows} rows C={C}", table, codes(rows, levels, C), rows))
    for C in GATHER_WIDE_CS:
        cases.append((f"{EDGE_N} rows C={C}", table, codes(EDGE_N, levels, C), EDGE_N))
    for off in GATHER_OFFSETS:
        for rows, C in ((EDGE_N - 3, 2), (EDGE_N, 3)):
            view = codes(C * rows + off, levels)[off:]
            cases.append((f"codes view at offset {off}, {rows} rows C={C}", table, view, rows))
    sentinels = rng.choice(np.array([-1, -2, levels, levels + 7]), 2 * EDGE_N)
    cases.append(("all-sentinel codes C=2", table, t(sentinels, torch.int32), EDGE_N))
    cases.append(("empty table C=2", table[:0], codes(EDGE_N, 0, 2), EDGE_N))
    cases.append((f"{ONE_CAT_LEVELS}-entry table", t(rng.standard_normal(ONE_CAT_LEVELS)),
                  codes(n, ONE_CAT_LEVELS), n))
    special = rng.standard_normal(levels)
    special[[0, 1, levels - 1]] = (np.inf, -0.0, np.nan)
    for C in (1, 2):
        inner = rng.integers(1, levels - 1, C * EDGE_N)
        inner[rng.random(C * EDGE_N) < 0.3] = 1  # -0.0
        pick = rng.random(C * EDGE_N)
        inner[pick < 0.2] = rng.choice(np.array([-1, -2, levels, levels + 5]),
                                       int((pick < 0.2).sum()))
        cases.append((f"-0.0, inf and NaN table C={C}", t(special), t(inner, torch.int32),
                      EDGE_N))
    return cases


def phase_cat_kernels(device, n: int, seg_ws=SEG_WS, levels: int = MIX_LEVELS,
                      seg_ms=SEG_MS, edge_n: int = EDGE_N) -> dict:
    """The gather and the segment sum against their plain versions; returns
    max|kernel - plain| by instantiation over all cases.  The gather is held
    bit for bit (-0.0 included) to its plain version and to itself across
    two launches on every case of :func:`gather_cases`.  The segment sum
    runs on n and ``edge_n`` rows at each of ``seg_ws`` (and a one-tile
    plan) and each of ``seg_ms`` columns; each case is attributed to the
    route it launched (on the CPU, to ``segsum<T>``)."""
    from tabmat_torch.ops import gather_kernel as gk
    from tabmat_torch.ops import segsum_kernel as ssk

    print(f"[3] gather and segment sum vs plain on {device}", flush=True)
    rng = np.random.default_rng(11)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    max_abs = {name: 0.0 for name in ("gather<double>", "gather<float>") + SEGSUM_KERNELS}
    for dtype, bits in ((torch.float64, torch.int64), (torch.float32, torch.int32)):
        name = f"gather<{'double' if dtype == torch.float64 else 'float'}>"
        for label, tab, cod, rows in gather_cases(rng, device, dtype, n, levels):
            before = gk.launches[name]
            got, again = gk.gather(tab, cod, rows), gk.gather(tab, cod, rows)
            if on_card and gk.launches[name] != before + 2:
                raise AssertionError(f"{name} {label}: {gk.launches[name] - before} launches")
            want = gk.gather_plain(tab, cod, rows)
            sync()
            if not torch.equal(got.view(bits), want.view(bits)):
                raise AssertionError(f"{name} {label}: not bit for bit the plain version")
            if not torch.equal(got.view(bits), again.view(bits)):
                raise AssertionError(f"{name} {label}: two launches differ")
            err = float((got - want).abs().max())
            max_abs[name] = max(max_abs[name], err)
            _check(f"{name} {label} max|diff| (bit for bit, repeats)", err, 0.0)
    gen = torch.Generator(device=device).manual_seed(11)
    for rows in (n, edge_n):
        for W in tuple(seg_ws) + ("one_tile",):
            plan = segsum_plan(rng, rows, W, device, levels)
            for m in seg_ms:
                shape = (rows,) if m == 1 else (rows, m)
                values = (torch.randn(shape, dtype=torch.float64, device=device, generator=gen)
                          * torch.empty(shape, dtype=torch.float64, device=device)
                          .uniform_(-3, 3, generator=gen).exp())
                for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
                    T = "double" if dtype == torch.float64 else "float"
                    v = values.to(dtype)
                    before = dict(ssk.launches)
                    first = ssk.segsum(v, plan)
                    second = ssk.segsum(v, plan)
                    rose = [k for k in before if ssk.launches[k] != before[k]]
                    if on_card and (len(rose) != 1 or ssk.launches[rose[0]] != before[rose[0]] + 2):
                        raise AssertionError(f"segsum<{T}> W={W} m={m}: launches {rose}")
                    name = rose[0] if on_card else f"segsum<{T}>"
                    want = ssk.segsum_plain(v, plan.perm, plan.bounds)
                    scale = ssk.segsum_plain(v.abs().double(), plan.perm, plan.bounds)
                    sync()
                    if not torch.equal(first, second):
                        raise AssertionError(f"{name} W={W} m={m}: two launches differ")
                    diff = (first.double() - want.double()).abs()
                    max_abs[name] = max(max_abs[name], float(diff.max()))
                    rel = float((diff / scale.clamp_min(torch.finfo(torch.float64).tiny)).max())
                    _check(f"{name} {rows} rows W={W} m={m} max|diff|/sum|v| (repeats exactly)",
                           rel, tol)
                    del v, first, second, want, scale, diff
                del values
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


def spmv_name(dtype, bounds_dtype) -> str:
    """The ``spmv`` instantiation for values of ``dtype`` and bounds of
    ``bounds_dtype``."""
    base = "double" if dtype == torch.float64 else "float"
    return f"spmv<{base}>" if bounds_dtype == torch.int32 else f"spmv<{base},int64>"


def phase_spmv_kernels(device, cases) -> dict:
    """The sparse segment product against its plain version, each case
    through the int32-bounds and the int64-bounds instantiation (the plan's
    bounds and a copy of them in the other width), which must agree bit for
    bit; returns max|kernel - plain| by instantiation over all cases."""
    from tabmat_torch.ops import spmv_kernel as sk
    from tabmat_torch.ops.segments import SegmentPlan

    print(f"[3] sparse segment product vs plain on {device}, int32 and int64 bounds",
          flush=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    max_abs = {name: 0.0 for name in SPARSE_KERNELS + WIDE_SPARSE_KERNELS}
    for label, plan, a, values, scale in cases:
        other = torch.int64 if plan.bounds.dtype == torch.int32 else torch.int32
        twins = {plan.bounds.dtype: plan,
                 other: SegmentPlan(plan.perm, plan.bounds.to(other), plan.n_rows)}
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            A, V = a.to(dtype), values.to(dtype)
            S = None if scale is None else scale.to(dtype)
            got = {}
            for width, p in sorted(twins.items(), key=lambda item: item[0].itemsize):
                name = spmv_name(dtype, width)
                before = sk.launches[name]
                first, second = sk.spmv(V, p, A, S), sk.spmv(V, p, A, S)
                if device.type == "cuda" and sk.launches[name] != before + 2:
                    raise AssertionError(f"{name} {label} launched no kernel")
                want = sk.spmv_plain(V, p.perm, p.bounds, A, S)
                mag = sk.spmv_plain(V.abs().double(), p.perm, p.bounds, A.abs().double(),
                                    None if S is None else S.abs().double())
                sync()
                if not torch.equal(first, second):
                    raise AssertionError(f"{name} {label}: two launches differ")
                diff = (first.double() - want.double()).abs()
                max_abs[name] = max(max_abs[name], float(diff.max()))
                rel = float((diff / mag.clamp_min(torch.finfo(torch.float64).tiny)).max())
                _check(f"{name} {label} max|diff|/sum|term| (repeats exactly)", rel, tol)
                got[width] = first
            if not torch.equal(got[torch.int32], got[torch.int64]):
                raise AssertionError(f"{label} {dtype}: the int64 bounds' result is not bit for "
                                     "bit the int32 bounds' one")
    return max_abs


def phase_forced_int64(device, X, seed: int = 17) -> list:
    """A SparseMatrix of ``X`` built with ``sparse_ops.INT32_MAX`` set below
    its nonzeros for the length of this check: its CSR, CSC and pair plans
    take int64 bounds, and its matvec, transpose-matvec and sandwich, through
    ``spmv<double,int64>``, match scipy.  Returns its three layouts as spmv
    cases for :func:`phase_spmv_kernels`."""
    import tabmat_torch as tt
    from scipy import sparse as sps
    from tabmat_torch.ops import sparse_ops
    from tabmat_torch.ops import spmv_kernel as sk

    n, k = X.shape
    limit = sparse_ops.INT32_MAX
    sparse_ops.INT32_MAX = X.nnz // 2
    try:
        print(f"[3] a {n}x{k} SparseMatrix ({X.nnz} nonzeros) with INT32_MAX lowered to "
              f"{sparse_ops.INT32_MAX}", flush=True)
        m = tt.SparseMatrix(X, device=device)
        layouts = {"CSR": m._csr_parts(), "CSC": m._csc_parts(), "pair plan": m._pair_parts()}
        for what, (_, plan) in layouts.items():
            if plan.bounds.dtype != torch.int64 or plan.perm.dtype != torch.int32:
                raise AssertionError(f"the forced {what} has bounds {plan.bounds.dtype} and "
                                     f"indices {plan.perm.dtype}")
        rng = np.random.default_rng(seed)
        v, r, d = rng.standard_normal(k), rng.standard_normal(n), rng.random(n)
        before = dict(sk.launches)
        Xr = X.tocsr()
        _check("forced int64 matvec relerr vs scipy", _relerr(m.matvec(v), Xr @ v), OP_TOL)
        _check("forced int64 transpose_matvec relerr vs scipy",
               _relerr(m.transpose_matvec(r), Xr.T @ r), OP_TOL)
        H_ref = (X.T @ sps.csc_matrix(X.multiply(d[:, None]))).toarray()
        _check("forced int64 sandwich relerr vs scipy", _relerr(m.sandwich(d), H_ref), F64_TOL)
        launched = {name: sk.launches[name] - before[name] for name in before}
        if device.type == "cuda" and (launched["spmv<double,int64>"] != 3
                                      or launched["spmv<double>"] != 0):
            raise AssertionError(f"the forced matrix launched {launched}")
    finally:
        sparse_ops.INT32_MAX = limit
    operands = {"CSR": v, "CSC": r, "pair plan": d}
    return [(f"forced int64 {n}x{k} {what}", plan, a,
             torch.as_tensor(operands[what], device=device), None)
            for what, (a, plan) in layouts.items()]


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
    matrix's budgets: the sparse Gram kernel over the CSR and CSC layouts.
    The full S against the kernel's plain version on the device, exactly
    symmetric and bit for bit across two sandwiches (on the card), the
    float32 kernel on the same design against its plain version, a
    ``slab``-column slab and a rows + cols restriction against scipy on the
    host.  ``device=None`` builds without ``device=`` (the card).  Returns
    the matrix, ``d`` and max|kernel - plain| by instantiation."""
    import tabmat_torch as tt
    from scipy import sparse as sps
    from tabmat_torch.ops import sparse_gram_kernel as gk

    n, k = X.shape
    print(f"[6c] sparse_wide sandwich {n}x{k} ({X.nnz} nonzeros), "
          f"device={'default' if device is None else device}", flush=True)
    m = tt.SparseMatrix(X) if device is None else tt.SparseMatrix(X, device=device)
    if device is None and m.device.type != "cuda":
        raise AssertionError(f"a SparseMatrix built without device= landed on {m.device}")
    if m._pair_parts() is not None or m._dense_mirror() is not None:
        raise AssertionError("sparse_wide must be past the pair plan's and the densified "
                             "matrix's budgets")
    if not m._gram_serves(m.array_csr):
        raise AssertionError("sparse_wide's sandwich must take the sparse Gram kernel")
    rng = np.random.default_rng(seed)
    d_np = rng.random(n) - 0.25
    d_np[::11] = 0.0
    d = torch.as_tensor(d_np, device=m.device)
    on_card = m.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    S = m.sandwich(d)
    sync()
    seconds = time.perf_counter() - t0
    print(f"  the first sandwich (its kernel tables built) took {seconds:.3f} s on the host "
          "clock")
    if on_card and not (torch.equal(S, S.T) and torch.equal(S, m.sandwich(d))):
        raise AssertionError("sparse_wide's S is not exactly symmetric, or two sandwiches differ")
    data, plan = m._csr_parts()
    P = gk.sparse_gram_plain(data, plan.perm, plan.bounds, d, k)
    max_abs = {"sparse_gram<double>": float((S - P).abs().max())}
    _check("sparse_wide S relerr vs the plain version",
           max_abs["sparse_gram<double>"] / float(P.abs().max()), F64_TOL)
    del P
    # the float32 instantiation on the same design
    csc_data, csc_plan = m._csc_parts()
    data32, d32 = data.float(), d.float()
    S32 = gk.sparse_gram(data32, plan, csc_data.float(), csc_plan, d32)
    again = gk.sparse_gram(data32, plan, csc_data.float(), csc_plan, d32)
    if on_card and not (torch.equal(S32, S32.T) and torch.equal(S32, again)):
        raise AssertionError("sparse_gram<float>'s S is not exactly symmetric, or two "
                             "launches differ")
    P32 = gk.sparse_gram_plain(data32, plan.perm, plan.bounds, d32, k)
    max_abs["sparse_gram<float>"] = float((S32 - P32).abs().max())
    _check("sparse_wide float32 S relerr vs the plain version",
           max_abs["sparse_gram<float>"] / float(P32.abs().max()), F32_TOL)
    del S32, again, P32, data32, d32
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
    return {"matrix": m, "d": d, "max_abs": max_abs}


def _numpy_irls(X, y, family, steps, n_cg, inner, sample_weight=None):
    """The port's IRLS step (explicit Hessian, guarded CG) in numpy, for a
    dense X or a scipy sparse one."""
    from scipy import sparse as sps

    dt = np.float32 if inner == "float32" else np.float64
    Xi = X.astype(dt)
    tiny = np.finfo(dt).tiny
    sw = np.ones(X.shape[0]) if sample_weight is None else sample_weight
    beta = np.zeros(X.shape[1])
    for _ in range(steps):
        eta = X @ beta
        if family == "gaussian":
            mu, w = eta, sw
        else:
            mu = np.exp(eta)
            w = mu * sw
        grad = X.T @ (sw * (y - mu))
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
    return {"design": design, "y": t(y), "betas": betas, "plan_seconds": plan_seconds,
            "Xd": Xd, "codes": codes, "levels": levels}


def freq_frame(n: int, rng):
    """A frame of freMTPL2freq's shape (``FREQ_LEVELS``), made with numpy:
    the exposure, the numeric columns in their ranges, the categoricals
    with their declared level orders, and Poisson claim counts."""
    import pandas as pd

    exposure = np.where(rng.random(n) < 0.3, 1.0, rng.uniform(0.0027, 1.0, n))
    frame = pd.DataFrame({
        "Exposure": exposure,
        "VehPower": rng.integers(4, 16, n),
        "VehAge": np.minimum(rng.geometric(0.12, n) - 1, 100),
        "DrivAge": np.clip(np.rint(rng.normal(45.0, 14.0, n)), 18, 100).astype(np.int64),
        "BonusMalus": np.minimum(49 + rng.geometric(0.08, n), 230),
        "Density": np.clip(np.rint(np.exp(rng.normal(6.0, 2.0, n))), 1, 27_000).astype(np.int64),
    })
    eta = (-3.0 + 0.02 * (frame["VehPower"] - 6) - 0.01 * frame["VehAge"]
           - 0.004 * (frame["DrivAge"] - 45) + 0.015 * (frame["BonusMalus"] - 50)
           + 0.05 * np.log(frame["Density"])).to_numpy()
    for name, levels in FREQ_LEVELS.items():
        p = rng.random(len(levels)) + 0.2
        codes = rng.choice(len(levels), n, p=p / p.sum())
        frame[name] = pd.Categorical.from_codes(codes, categories=levels)
        eta = eta + (rng.standard_normal(len(levels)) * 0.2)[codes]
    frame["ClaimNb"] = rng.poisson(exposure * np.exp(eta))
    return frame


def freq_names() -> list:
    """The design's column names by the JAX package's naming rule: the
    intercept, then the terms in formula order (``C(x)[level]`` for each
    level but the first declared one), ``np.log(Density)`` last."""
    return (["Intercept", "VehPower", "VehAge", "DrivAge", "BonusMalus"]
            + [f"C({name})[{level}]" for name, levels in FREQ_LEVELS.items()
               for level in levels[1:]]
            + ["np.log(Density)"])


def freq_numpy_design(frame) -> np.ndarray:
    """``freq_names()``'s columns made with numpy from the frame's columns."""
    cols = [np.ones(len(frame))]
    cols += [frame[name].to_numpy(np.float64)
             for name in ("VehPower", "VehAge", "DrivAge", "BonusMalus")]
    for name, levels in FREQ_LEVELS.items():
        codes = frame[name].cat.codes.to_numpy()
        cols += [(codes == j).astype(np.float64) for j in range(1, len(levels))]
    cols.append(np.log(frame["Density"].to_numpy(np.float64)))
    return np.column_stack(cols)


def phase_frame_path(card: str, mixed: dict, n: int = FREQ_N, n_new: int = FREQ_NEW_N,
                     device=None, fit_steps: int = FREQ_FIT_STEPS, seed: int = 6) -> dict:
    """The dataframe and formula path through the public API: a Poisson
    ``GeneralizedLinearRegressor`` with ``formula=`` on a freMTPL2-shaped
    frame, and ``from_pandas`` on phase 5's frame, each checked against
    numpy and scipy, or against phase 5's hand-built design.
    ``device=None`` builds every matrix without ``device=``: the card."""
    import pandas as pd
    import tabmat_torch as tt
    from scipy import sparse as sps
    from tabmat_torch.parallel.design import DeviceDesign

    kw = {} if device is None else {"device": device}
    print(f"[7b] dataframe and formula path: {n} rows of a freMTPL2-shaped frame, "
          f"device={'default' if device is None else device}", flush=True)
    rng = np.random.default_rng(seed)
    frame = freq_frame(n, rng)
    y = frame["ClaimNb"].to_numpy(np.float64)
    exposure = frame["Exposure"].to_numpy(np.float64, copy=True)
    t0 = time.perf_counter()
    Xf = tt.from_formula(FREQ_FORMULA, frame, include_intercept=True, ensure_full_rank=True, **kw)
    formula_seconds = time.perf_counter() - t0
    print(f"  from_formula {n} rows -> {Xf.shape[1]} columns "
          f"({[type(m).__name__ for m in Xf.matrices]}): {formula_seconds:.3f} s on the host "
          f"({card})")
    if device is None and Xf.device.type != "cuda":
        raise AssertionError(f"a formula design built without device= landed on {Xf.device}")
    if Xf.column_names != freq_names():
        raise AssertionError(f"column names {Xf.column_names} are not {freq_names()}")
    X_np = freq_numpy_design(frame)
    if not np.array_equal(Xf.toarray(), X_np):
        raise AssertionError("the formula design is not the numpy encoding of the frame")

    design = DeviceDesign.from_matrix(Xf)
    dev = design.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    X = sps.csr_matrix(X_np)
    k = X.shape[1]
    v, r = rng.standard_normal(k), rng.standard_normal(n)
    _check("formula design matvec relerr vs scipy", _relerr(design.matvec(t(v)).cpu(), X @ v),
           OP_TOL)
    _check("formula design transpose_matvec relerr vs scipy",
           _relerr(design.transpose_matvec(t(r)).cpu(), X.T @ r), OP_TOL)
    H_ref = (X.T @ sps.csr_matrix(X.multiply(exposure[:, None]))).toarray()
    _check("formula design sandwich f64 relerr vs scipy",
           _relerr(design.sandwich(t(exposure)).cpu(), H_ref), F64_TOL)
    w32 = exposure.astype(np.float32)
    X32 = sps.csr_matrix(X.astype(np.float32), dtype=np.float64)
    H32_ref = (X32.T @ sps.csr_matrix(X32.multiply(w32.astype(np.float64)[:, None]))).toarray()
    _check("formula design sandwich f32 relerr vs scipy",
           _relerr(design.astype_float(torch.float32).sandwich(t(w32)).cpu(), H32_ref), F32_TOL)
    del X, X32, H_ref, H32_ref

    new = freq_frame(n_new, np.random.default_rng(seed + 1))
    X_new = freq_numpy_design(new)
    betas = {}
    for inner in ("float64", "float32"):
        est = tt.GeneralizedLinearRegressor(family="poisson", formula=FREQ_FORMULA,
                                            max_iter=fit_steps, tol=0.0, n_cg=FREQ_N_CG,
                                            inner_precision=inner, **kw)
        est.fit(frame, sample_weight=exposure)
        got = np.r_[est.intercept_, est.coef_]
        if est.n_iter_ != fit_steps or not np.all(np.isfinite(got)):
            raise AssertionError(f"formula fit {inner}: n_iter {est.n_iter_}, beta {got}")
        ref = _numpy_irls(X_np, y, "poisson", fit_steps, FREQ_N_CG, inner,
                          sample_weight=exposure)
        _check(f"formula fit poisson inner={inner} beta vs numpy", _relerr(got, ref),
               BETA_TOL[inner])
        _check(f"predict on {n_new} new rows relerr vs numpy",
               _relerr(est.predict(new), np.exp(X_new @ got)), OP_TOL)
        betas[inner] = got

    # from_pandas on phase 5's frame: one dense block and two categoricals,
    # the same design as phase 5's hand-built one
    Xd, codes = mixed["Xd"], mixed["codes"]
    levels = np.arange(mixed["levels"])
    pdf = pd.DataFrame({f"x{j}": Xd[:, j] for j in range(Xd.shape[1])})
    for j, c in enumerate(codes):
        pdf[f"c{j}"] = pd.Categorical.from_codes(c, categories=levels)
    t0 = time.perf_counter()
    Xp = tt.from_pandas(pdf, **kw)
    pandas_seconds = time.perf_counter() - t0
    print(f"  from_pandas {len(pdf)} rows x ({Xd.shape[1]} + {len(levels)} + {len(levels)}): "
          f"{pandas_seconds:.3f} s on the host ({card})")
    kinds = sorted(type(m).__name__ for m in Xp.matrices)
    if kinds != ["CategoricalMatrix", "CategoricalMatrix", "DenseMatrix"]:
        raise AssertionError(f"from_pandas gave the blocks {kinds}")
    pd_design, hand = DeviceDesign.from_matrix(Xp), mixed["design"]
    w = t(rng.random(len(pdf)) + 0.05)
    _check("from_pandas design f64 sandwich relerr vs phase 5's design",
           _relerr(pd_design.sandwich(w).cpu(), hand.sandwich(w).cpu()), F64_TOL)
    v = t(rng.standard_normal(hand.shape[1]))
    _check("from_pandas design matvec relerr vs phase 5's design",
           _relerr(pd_design.matvec(v).cpu(), hand.matvec(v).cpu()), F64_TOL)
    return {"design": design, "y": t(y), "weights": t(exposure), "betas": betas,
            "formula_seconds": formula_seconds, "pandas_seconds": pandas_seconds}


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
    the bounds (4 or 8 bytes each), ``values`` and ``scale`` read once, the
    output written once; a multiply-add per element and column (and the
    scale's multiply)."""
    size = values.element_size()
    m = 1 if values.ndim == 1 else values.shape[1]
    E = plan.perm.numel()
    n_bytes = (E * (size + plan.perm.element_size())
               + plan.bounds.numel() * plan.bounds.element_size() + values.numel() * size
               + (0 if scale is None else scale.numel() * size) + plan.num_segments * m * size)
    return bound(n_bytes, 2 * E * m + (0 if scale is None else E))


def gather_bound(n: int, C: int, table_len: int, size: int):
    """``(bound_ms, bound_by)`` of one gather: C int32 codes a row and the
    table read once, one value a row written; C - 1 adds a row."""
    return bound(C * n * 4 + table_len * size + n * size, (C - 1) * n)


def segsum_bound(plan, values):
    """``(bound_ms, bound_by)`` of one segment sum: the plan's perm and
    bounds and ``values`` read once, the (W, m) output written once; an add
    per element and column."""
    size = values.element_size()
    m = 1 if values.ndim == 1 else values.shape[1]
    E, W = plan.perm.numel(), plan.num_segments
    return bound(E * 4 + values.numel() * size + (W + 1) * 4 + W * m * size, E * m)


# the case whose times stand for spmv<T> in the kernels line: row 15's
# function, the CSC transpose-matvec of the reference's 400k x 100 design
ROW15_CASE = "sparse 400000x100 CSC tmv"


def sandwich_bound(n: int, k: int, size: int):
    """``(bound_ms, bound_by)`` of one dense sandwich: X, d and S moved once;
    the upper triangle's multiply-adds and the scaling by d."""
    return bound(n * k * size + n * size + k * k * size, n * k * (k + 1) + n * k)


def sparse_gram_bound(n: int, k: int, nnz: int, pairs: int, size: int):
    """``(bound_ms, bound_by)`` of one sparse Gram matrix: the CSR (values,
    int32 columns and pointers) and d read once, the (k, k) S written once;
    a multiply-add a within-row pair and the scaling by d (``pairs`` is
    ``Σ_r nnz_r²``), as ``glmbench/metrics/_sparse_roofline.py`` counts."""
    return bound(nnz * (size + 4) + (n + 1) * 4 + n * size + k * k * size, pairs + nnz)


# sandwich kernel -> the shapes phase 8 times it at; the first is its row
# in the kernels line (the 1M x 50 main path, path (a), path (b), the f32
# steps and matrix past the triangle kernel's widths; the tensor-core
# kernel at the f64 steps of 4b and 4d, the route's edge and a wide design)
SANDWICH_TIMES = {
    "sandwich_wide<float>": ((WIDE_N, F32_WIDE_K), (1_000_000, 177), (200_000, 1000)),
    "sandwich_narrow<double>": ((NARROW_N, NARROW_K), (N, MIX_KD)),
    "sandwich_narrow<float>": ((NARROW_N, NARROW_K), (N, MIX_KD)),
    "sandwich_tri<float>": ((N, K), (WIDE_N, WIDE_K)),
    # 1M x 100 and 1M x 128: where PERF.md holds the v3 and v5 rows
    "sandwich_mma_tri<double>": ((N, K), (N, 100), (N, 128)),
    "sandwich_mma<double>": ((WIDE_N, WIDE_K), (WIDE_N, F32_WIDE_K), (1_000_000, 129),
                             (200_000, 1000)),
}


def sparse_wide_times(card: str, wide: dict) -> dict:
    """``sparse_wide``'s sandwich (phase 6c's matrix and ``d``): the sparse
    Gram kernel in both types against its plain version on the card."""
    from tabmat_torch.ops import sparse_gram_kernel as gk
    from tabmat_torch.ops import sparse_ops

    times = {}
    m, dw = wide["matrix"], wide["d"]
    nw, kw = m.shape
    data, plan = m._csr_parts()
    csc_data, csc_plan = m._csc_parts()
    pairs = sparse_ops.pair_count(m.array_csr)
    for dtype in (torch.float64, torch.float32):
        name = f"sparse_gram<{'double' if dtype == torch.float64 else 'float'}>"
        a, b, dd = data.to(dtype), csc_data.to(dtype), dw.to(dtype)
        t = _compare(f"{name} sparse_wide {nw}x{kw}", card,
                     lambda: gk.sparse_gram(a, plan, b, csc_plan, dd),
                     lambda: gk.sparse_gram_plain(a, plan.perm, plan.bounds, dd, kw),
                     reps=5, warmup=1)
        t["bound"] = sparse_gram_bound(nw, kw, a.numel(), pairs, a.element_size())
        print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]}; the kernel at "
              f"{t['bound'][0] / t['kernel']:.4f} of it; {pairs / (t['kernel'] * 1e-3):.4e} "
              "pairs a second")
        times[name] = t
        del a, b, dd
    return times


def std_expand_bound(k: int, size: int):
    """``(bound_ms, bound_by)`` of the standardized sandwich's expansion: T
    read and written once, the three k-vectors and the weights' sum read
    once; nine operations an entry."""
    return bound(2 * k * k * size + 3 * k * size + size, 9 * k * k)


def std_expand_times(card: str, wide: dict) -> dict:
    """The standardized sandwich's expansion at ``sparse_wide``'s width in
    both types: ``std_expand<T>`` in place on the Gram kernel's S (phase
    6c's matrix and ``d``), bit for bit its plain version, then both timed."""
    from tabmat_torch.ops import std_expand_kernel as ek

    times = {}
    m, dw = wide["matrix"], wide["d"]
    k = m.shape[1]
    S = m.sandwich(dw)
    gen = torch.Generator(device=S.device).manual_seed(28)
    for dtype in (torch.float64, torch.float32):
        name = f"std_expand<{'double' if dtype == torch.float64 else 'float'}>"
        T = S.to(dtype)
        t, s = (torch.randn(k, device=S.device, dtype=dtype, generator=gen) for _ in range(2))
        # multipliers near 1: the timed calls rescale T in place again and again
        mult = 0.9 + 0.2 * torch.rand(k, device=S.device, dtype=dtype, generator=gen)
        sigma = dw.to(dtype).sum()
        want = ek.std_expand_plain(T.clone(), t, s, mult, sigma)
        if not torch.equal(ek.std_expand(T.clone(), t, s, mult, sigma), want):
            raise AssertionError(f"{name} differs from its plain version at k = {k}")
        del want
        tm = _compare(f"{name} sparse_wide k={k}", card,
                      lambda: ek.std_expand(T, t, s, mult, sigma),
                      lambda: ek.std_expand_plain(T, t, s, mult, sigma), reps=10, warmup=2)
        tm["bound"] = std_expand_bound(k, T.element_size())
        moved = 2 * k * k * T.element_size()
        print(f"    bound {tm['bound'][0]:.6f} ms by {tm['bound'][1]}; the kernel at "
              f"{tm['bound'][0] / tm['kernel']:.4f} of it; {moved / (tm['kernel'] * 1e-3):.4e} "
              "bytes a second of T read and written")
        times[name] = tm
        del T
    return times


def phase_times(device, n: int, k: int, card: str, mixed: dict, sparse: dict,
                cases: list, wide: dict, frames: dict) -> dict:
    """Kernel, plain and library times with their bounds, and IRLS step times."""
    import tabmat_torch as tt
    from torch.nn import functional as F
    from tabmat_torch.glm import irls_step
    from tabmat_torch.ops import gather_kernel as gk
    from tabmat_torch.ops import sandwich_kernel as sk
    from tabmat_torch.ops import segsum_kernel as ssk
    from tabmat_torch.ops import spmv_kernel as spk
    from tabmat_torch.ops.segments import SegmentPlan
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
            print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]}; the kernel at "
                  f"{t['bound'][0] / t['kernel']:.3f} of it")
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

    times.update(sparse_wide_times(card, wide))
    times.update(std_expand_times(card, wide))

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
        t["bound"] = gather_bound(n_rows, C, table.numel(), size)
        print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]}")
        times[f"gather<{suffix}>"] = t
        # the window take (PERF.md rows 11-12): phase 3's sorted bounds,
        # 10^6 + 1 of them into n_rows + 1 values, against src[idx]
        src = torch.randn(n_rows + 1, device=device, dtype=dtype, generator=gen)
        idx = torch.sort(torch.randint(0, n_rows + 1, (10**6 + 1,), device=device,
                                       generator=gen)).values.to(torch.int32)
        idx_long = idx.long()
        t = _compare(f"gather<{suffix}> window take, {idx.numel()} sorted indices", card,
                     lambda: gk.gather(src, idx), lambda: gk.gather_plain(src, idx, idx.numel()),
                     lambda: src[idx_long])
        t["bound"] = gather_bound(idx.numel(), 1, src.numel(), size)
        print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]}")
        times[f"gather<{suffix}> window take"] = t
        del src, idx, idx_long

        # the segment sum at the mixed step's three shapes: the stacked tmv
        # and sandwich diagonal (W = 2000, m = 1) and cat x dense cells
        # (m = 5) through segsum<T>, the cat x cat cell (W = 10^6) through
        # segsum_slots<T>; the first and the last stand in the kernels line
        plan = cat.plan
        r = torch.randn(n_rows, device=device, dtype=dtype, generator=gen)
        r2 = r.repeat(2)
        wX = torch.randn(n_rows, MIX_KD, device=device, dtype=dtype, generator=gen)
        wX2 = wX.repeat(2, 1)
        xplan = cat.cross[(0, 1)]
        xcodes = (cat.codes[:n_rows].long() * cat.widths[1] + cat.codes[n_rows:].long()
                  - cat.widths[0])
        shapes = (
            (f"segsum<{suffix}>", f"stacked W={width} m=1", plan, r,
             lambda: torch.bincount(codes2, weights=r2, minlength=width + 1)),
            (f"segsum<{suffix}> m={MIX_KD}", f"stacked W={width} m={MIX_KD}", plan, wX,
             lambda: torch.zeros(width + 1, MIX_KD, device=device, dtype=dtype)
             .index_add_(0, codes2, wX2)),
            (f"segsum_slots<{suffix}>", f"cross W={xplan.num_segments} m=1", xplan, r,
             lambda: torch.bincount(xcodes, weights=r, minlength=xplan.num_segments)),
        )
        for key, label, p, v, library in shapes:
            t = _compare(f"segsum {suffix} {label}", card, lambda: ssk.segsum(v, p),
                         lambda: ssk.segsum_plain(v, p.perm, p.bounds), library)
            t["bound"] = segsum_bound(p, v)
            print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]}")
            times[key] = t
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
                # spmv<T,int64> on the same layout with its bounds as int64,
                # cuSPARSE with int64 indices beside it
                wide = SegmentPlan(plan.perm, plan.bounds.long(), plan.n_rows)
                csr64 = torch.sparse_csr_tensor(wide.bounds, wide.perm.long(), A,
                                                size=(wide.num_segments, wide.n_rows))
                t = _compare(f"{spmv_name(dtype, torch.int64)} {label}", card,
                             lambda: spk.spmv(V, wide, A),
                             lambda: spk.spmv_plain(V, wide.perm, wide.bounds, A),
                             lambda: csr64 @ V)
                t["bound"] = spmv_bound(wide, A, V, None)
                print(f"    bound {t['bound'][0]:.6f} ms by {t['bound'][1]}")
                times[spmv_name(dtype, torch.int64)] = t
                del wide, csr64
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
        steps.append((f"{label} gaussian", dense, y_dense, "gaussian", None))
        del X_np
    steps += [("mixed poisson", design, y, "poisson", None),
              ("sparse poisson", sparse["design"], sparse["y"], "poisson", None),
              ("formula poisson", frames["design"], frames["y"], "poisson", frames["weights"])]
    for label, dd, yy, family, w in steps:
        if w is None:
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


# phase 9: the benchmark CLI (python -m tabmat_torch.bench.main) at the
# reference's design sizes, each design's kernels in its three f64 ops:
# the dense block's width dispatch (4M x 10, 3M x 5: the narrow kernel),
# the sparse products (the pair sandwich too), sparse_wide's panels through
# the FP64 tensor cores, the categoricals' gather and segment sums (W =
# 2000 stacked, the 10^6-cell cat x cat plan of two_cat and dense_cat)
CLI_KERNELS = {
    "dense": ("sandwich_narrow<double>",),
    "sparse": ("spmv<double>",),
    "sparse_narrow": ("spmv<double>",),
    "sparse_wide": ("spmv<double>", "sparse_gram<double>"),
    "one_cat": ("gather<double>", "segsum_slots<double>"),
    "two_cat": ("gather<double>", "segsum<double>", "segsum_slots<double>"),
    "dense_cat": ("sandwich_narrow<double>", "gather<double>", "segsum<double>",
                  "segsum_slots<double>"),
    "dense_smallcat": ("sandwich_narrow<double>", "gather<double>", "segsum<double>"),
}
# the standardized variants of docs/benchmarks/run_round5.sh
CLI_STANDARDIZED = ("dense", "sparse", "two_cat", "dense_cat")
# each op's device result against its numpy/scipy baseline on the same inputs
CLI_TOL = {"sandwich": F64_TOL, "matvec": OP_TOL, "transpose-matvec": OP_TOL}
CLI_ITERATIONS = 20
# under a zero budget the sparse sandwich keeps less than this share of the
# densified mirror's bytes on the card
BUDGET_CACHE_SHARE = 0.01


def _cli_table(label: str, rows: list) -> str:
    """One design's rows as a table: the device time beside the baseline's."""
    lines = [f"  {label}: op, ms, numpy/scipy ms, ratio, max_rel_err, cache MB, "
             "total MB, peak MB, host peak KB"]
    device_rows = {r["operation"]: r for r in rows if r["library"] == "tabmat_torch"}
    base_rows = {r["operation"]: r for r in rows if r["library"] == "numpy/scipy"}

    def mb(row, key):
        return "-" if row.get(key) is None else f"{row[key] / 2**20:.3f}"

    for op, r in device_rows.items():
        b = base_rows[op]
        host = r.get("peak_mem_bytes")
        lines.append(
            f"    {op}: {r['time_s'] * 1e3:.4f}, {b['time_s'] * 1e3:.4f}, "
            f"{b['time_s'] / r['time_s']:.2f}x, {b['max_rel_err']:.2e}, "
            f"{mb(r, 'hbm_cache_bytes')}, {mb(r, 'hbm_total_bytes')}, {mb(r, 'hbm_peak_bytes')}, "
            f"{'-' if host is None else f'{host / 1024:.1f}'}")
    return "\n".join(lines)


def _run_cli(argv: list, log_path: str) -> list:
    """``tabmat_torch.bench.main.main(argv)``, its printed rows into
    ``log_path`` (the contract's JSON lines stay the only ones here)."""
    from tabmat_torch.bench import main as bench

    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        return bench.main(argv)


def _check_cli_rows(label: str, rows: list, on_card: bool) -> None:
    ops = [r["operation"] for r in rows if r["library"] == "tabmat_torch"]
    if sorted(ops) != sorted(CLI_TOL):
        raise AssertionError(f"{label}: the CLI timed {ops}")
    for r in rows:
        if not (np.isfinite(r["time_s"]) and r["time_s"] > 0):
            raise AssertionError(f"{label} {r['operation']} {r['library']}: time_s {r['time_s']}")
        if r["library"] == "numpy/scipy":
            _check(f"{label} {r['operation']} relerr against numpy/scipy", r["max_rel_err"],
                   CLI_TOL[r["operation"]])
        elif on_card:
            for key in ("hbm_cache_bytes", "hbm_total_bytes", "hbm_peak_bytes"):
                if not r.get(key, -1) >= 0:
                    raise AssertionError(f"{label} {r['operation']}: {key} = {r.get(key)}")


def phase_bench_cli(device=None, scale: float = 1.0, out_dir: str = "build/bench_cli",
                    n_iterations: int = CLI_ITERATIONS, card: str = "") -> dict:
    """The benchmark CLI in process, as a user runs it: each of the eight
    designs with ``--include_baseline --bench_memory --output``, then the
    four standardized variants, then the sparse design under a zero
    device-cache budget.  ``device=None`` gives no ``--device``: the card.

    Returns ``{"rows": label -> rows, "launches": label -> counts}``."""
    from tabmat_torch import _config
    from tabmat_torch.bench import main as bench
    from tabmat_torch.bench.generate import get_all_benchmark_matrices
    from tabmat_torch.utils import tensor_bytes

    t0 = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    os.makedirs(out_dir, exist_ok=True)
    print(f"[9] the benchmark CLI at --scale {scale} ({card}); device bytes in use at the start: "
          f"{torch.cuda.memory_allocated() if on_card else 0}", flush=True)
    dev_args = [] if device is None else ["--device", str(device)]
    common = ["--scale", str(scale), "--n_iterations", str(n_iterations)] + dev_args
    report = {"rows": {}, "launches": {}}
    runs = [(name, False) for name in CLI_KERNELS] + [(name, True) for name in CLI_STANDARDIZED]
    for name, standardized in runs:
        label = ("std_" if standardized else "") + name
        argv = ["--matrix_name", name, "--include_baseline", "--bench_memory",
                "--output", os.path.join(out_dir, f"{label}.csv")] + common
        if standardized:
            argv.append("--standardized")
        reset_launch_counts()
        rows = _run_cli(argv, os.path.join(out_dir, f"{label}.jsonl"))
        counts = launch_counts()
        print(_cli_table(label, rows), flush=True)
        print(f"    kernel launches: {({k: v for k, v in counts.items() if v})}", flush=True)
        _check_cli_rows(label, rows, on_card)
        missing = [k for k in CLI_KERNELS[name] if counts[k] == 0]
        if on_card and missing:
            raise AssertionError(f"the CLI's {label} did not launch {missing}")
        report["rows"][label], report["launches"][label] = rows, counts
    peaks = {label: next(r.get("peak_mem_bytes") for r in report["rows"][label]
                         if r["operation"] == "transpose-matvec")
             for label in (f"std_{name}" for name in CLI_STANDARDIZED)}
    print(f"  host peak of the standardized transpose-matvecs (bytes): {peaks}", flush=True)

    # the budget: the sparse design under a zero budget keeps neither the
    # pair plan nor the densified mirror, and takes the sparse Gram kernel
    # with its tables built a call at a time
    sparse_rows = report["rows"]["sparse"]
    make_sparse = get_all_benchmark_matrices(scale=scale, device=device)["sparse"]
    _config.set_cache_budget_mb(0)
    try:
        reset_launch_counts()
        rows = _run_cli(["--matrix_name", "sparse"] + common,
                        os.path.join(out_dir, "budget0_sparse.jsonl"))
        budgeted = make_sparse()
        d = torch.as_tensor(bench.op_inputs(budgeted.shape, "sandwich"), device=budgeted.device)
        S0 = budgeted.sandwich(d)
        counts = launch_counts()
        print(f"  zero budget, sparse: (op, time_s, hbm_cache_bytes) "
              f"{[(r['operation'], r['time_s'], r.get('hbm_cache_bytes')) for r in rows]}; "
              f"kernel launches {({k: v for k, v in counts.items() if v})}", flush=True)
        report["rows"]["budget0_sparse"], report["launches"]["budget0_sparse"] = rows, counts
        if budgeted._pair != () or budgeted._dense is not None:
            raise AssertionError("the zero-budget sparse design kept a pair plan or a mirror")
        if _config.cache_spent_bytes() != 0:
            raise AssertionError(f"the zero budget spent {_config.cache_spent_bytes()} bytes")
        mirror = 8 * budgeted.shape[0] * budgeted.shape[1]
        if on_card:
            cache = next(r["hbm_cache_bytes"] for r in rows if r["operation"] == "sandwich")
            print(f"  zero budget: the sandwich keeps {cache} bytes on the card, the mirror "
                  f"would take {mirror}", flush=True)
            if not cache < BUDGET_CACHE_SHARE * mirror:
                raise AssertionError(f"the zero-budget sandwich keeps {cache} bytes")
            if counts["sparse_gram<double>"] == 0:
                raise AssertionError("the zero-budget sandwich did not launch "
                                     "sparse_gram<double>")
    finally:
        _config.set_cache_budget_mb(None)
    # a budget that refuses nothing records the charge of what the sandwich built
    _config.set_cache_budget_mb(1 << 30)
    try:
        free = make_sparse()
        S1 = free.sandwich(d)
        charge = _config.cache_spent_bytes()
        prod, plan = free._pair
        built = tensor_bytes((prod, plan.perm, plan.bounds))
        cache = next(r.get("hbm_cache_bytes") for r in sparse_rows
                     if r["operation"] == "sandwich")
        print(f"  sparse: the ledger's charge {charge} bytes, the pair plan's tensors {built}, "
              f"the CLI's sandwich hbm_cache_bytes {cache}", flush=True)
        if charge != built or free._dense is not None:
            raise AssertionError(f"the charge {charge} is not the pair plan's {built} bytes")
        if on_card and not charge <= cache:
            raise AssertionError(f"the charge {charge} exceeds the sandwich's cache {cache}")
        del free, prod, plan
    finally:
        _config.set_cache_budget_mb(None)
        _config._cache_refund(_config.cache_spent_bytes())
    _check("zero-budget sparse sandwich against the unbudgeted one", _relerr(
        S0.cpu().numpy(), S1.cpu().numpy()), F64_TOL)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)
    return report


# phase 10: the multi-device path (tabmat_torch.parallel) on the one card.
# 10a: one NCCL rank in this process; 10b: the mesh of
# __graft_entry__.dryrun_multichip (dp = 4 x mp = 2, MULTICHIP_r05.json),
# eight ranks sharing the card over gloo with CUDA tensors (NCCL refuses two
# ranks on one device), each rank launching the kernels on its rows
MULTI_WORLD, MULTI_MP = 8, 2
MULTI_2LEVEL = (2, 2, 2)  # dcn, dp, mp
MULTI_SANDWICH = (N, K)
MULTI_SEG_W = 1000
MULTI_MIXED = (N, MIX_KD, SP_KS, MIX_LEVELS)
MULTI_FIT_STEPS = 4
# the CG iterations of __graft_entry__.dryrun_multichip's steps, which its
# bounds hold.  Past about ten, CG on these designs has lost the
# orthogonality of its directions and moves beta by amounts that rounding
# decides: with n_cg=16 a Hessian summed over 4 row shards instead of 1
# moves the step past those bounds (PERF.md)
MULTI_N_CG = 6
# the sparse main path's kernels (phase 7), on every rank's rows
MULTI_KERNELS = SPARSE_KERNELS + NARROW_KERNELS + ("gather<double>",) + SEGSUM_KERNELS
# __graft_entry__.py:124, 144, 212: a float64 result against the single
# device's; the float32 inner solve's step as tests/test_torch_glm.py holds it
MULTI_STEP_TOL = {"rtol": 1e-8, "atol": 1e-10}
MULTI_F32_TOL = 1e-4


def sparse_path_split(inputs: dict, device):
    """Phase 7's design (5 dense columns, the sparse block, two categoricals)
    from ``multichip_inputs``' arrays, its matrices on ``device``."""
    import tabmat_torch as tt

    from scipy import sparse as sps

    levels = inputs["levels"]
    data, indices, indptr = (t.numpy() for t in inputs["block"])
    block = sps.csc_matrix((data, indices, indptr), shape=(len(inputs["y"]), len(indptr) - 1))
    return tt.SplitMatrix(
        [tt.DenseMatrix(inputs["Xd"].numpy(), device=device),
         tt.SparseMatrix(block, device=device)]
        + [tt.CategoricalMatrix(c.numpy(), categories=np.arange(levels), device=device)
           for c in inputs["codes"]])


def multichip_inputs(block, n: int, kd: int, levels: int, sandwich_shape: tuple, seg_w: int,
                     mixed_shape: tuple, seed: int = 1) -> dict:
    """Phase 10's host data, from seeds: phase 7's design with a Poisson
    target, the sharded sandwich's X and d, the segment sum's codes, and the
    mixed design (``build_mixed_design``) with its target.  CPU tensors, the
    sparse block's too, so that the spawned ranks share them instead of
    copying (a pickled scipy matrix of 10^6 nonzeros slowed eight ranks'
    start more than all their work)."""
    from tabmat_torch.parallel.distributed import build_mixed_design

    rng = np.random.default_rng(seed)
    t = torch.as_tensor
    inputs = {"levels": levels, "block": tuple(t(a) for a in (block.data, block.indices,
                                                              block.indptr)),
              "Xd": t(rng.standard_normal((n, kd))),
              "codes": [t(rng.integers(0, levels, n).astype(np.int32)) for _ in range(2)]}
    rng = np.random.default_rng(seed + 10)
    inputs["y"] = t(rng.poisson(1.0, n).astype(np.float64))
    ns, ks = sandwich_shape
    inputs["X"], inputs["d"] = t(rng.standard_normal((ns, ks))), t(rng.random(ns))
    inputs["v"] = t(rng.standard_normal(ns))
    inputs["seg_codes"] = t(rng.integers(0, seg_w, ns).astype(np.int32))
    inputs["seg_w"] = seg_w
    inputs["mixed"] = build_mixed_design(*mixed_shape, seed=0, density=SPARSE_DENSITY,
                                         device="cpu")
    inputs["mixed_y"] = t(rng.poisson(1.0, mixed_shape[0]).astype(np.float64))
    return inputs


def multichip_rank(device, inputs: dict, two_level: tuple, mp: int) -> dict:
    """One rank of phase 10b: the user path (``DeviceDesign.shard`` with the
    dense columns over ``mp``, ``irls_step`` in both inner precisions), the
    same step on a two-level mesh, ``sharded_sandwich``,
    ``sharded_transpose_matvec``, ``sharded_segment_sum`` and
    ``mixed_irls_step`` on the rank's rows.  Returns the rank's results,
    its kernel launches and its host-staged step time."""
    import torch.distributed as dist
    from tabmat_torch.glm import irls_step
    from tabmat_torch.parallel import shard_ops
    from tabmat_torch.parallel.design import DeviceDesign
    from tabmat_torch.parallel.distributed import mixed_irls_step, shard_mixed_design
    from tabmat_torch.parallel.mesh import (all_reduce, make_mesh, make_mesh_2level,
                                            mesh_device, shard_rows)

    t0 = time.perf_counter()
    mesh = make_mesh(dist.get_world_size(), mp=mp, device=device)
    mesh2 = make_mesh_2level(*two_level, device=device)
    dev = mesh_device(mesh)
    source = DeviceDesign.from_matrix(sparse_path_split(inputs, "cpu"))
    out = {"rank": dist.get_rank(), "device": str(dev), "setup_s": time.perf_counter() - t0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(design, m, rows, inner):
        y = shard_rows(inputs["y"], m, rows)
        w = torch.ones_like(y)
        b0 = torch.zeros(design.shape[1], dtype=torch.float64, device=dev)
        return irls_step(design, y, w, b0, family="poisson", n_cg=MULTI_N_CG,
                         inner_precision=inner)

    t0 = time.perf_counter()
    reset_launch_counts()
    design = source.shard(mesh, dense_cols="mp")
    out["n_local"] = design.n_local
    for inner in ("float64", "float32"):
        out[f"step_{inner}"] = step(design, mesh, "dp", inner).cpu().numpy()
    two = source.shard(mesh2, rows=("dcn", "dp"), dense_cols="mp")
    out["step_two_level"] = step(two, mesh2, ("dcn", "dp"), "float64").cpu().numpy()
    Xs, ds, vs, cs = shard_ops.place_row_sharded(mesh, inputs["X"], inputs["d"], inputs["v"],
                                                 inputs["seg_codes"])
    out["sandwich"] = shard_ops.sharded_sandwich(Xs, ds, mesh).cpu().numpy()
    out["tmv"] = shard_ops.sharded_transpose_matvec(Xs, vs, mesh).cpu().numpy()
    out["segment_sum"] = shard_ops.sharded_segment_sum(vs, cs, inputs["seg_w"],
                                                       mesh).cpu().numpy()
    dz = shard_mixed_design(inputs["mixed"], mesh)
    y = shard_rows(inputs["mixed_y"], mesh)
    k = dz.dense.shape[1] + dz.sp_csc_bounds.shape[0] - 1 + dz.cat_bounds.shape[0] - 1
    out["mixed_step"] = mixed_irls_step(dz, y, torch.ones_like(y),
                                        torch.zeros(k, dtype=torch.float64, device=dev),
                                        n_cg=MULTI_N_CG, mesh=mesh).cpu().numpy()
    sync()
    out["launches"] = launch_counts()
    out["path_s"] = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(design, mesh, "dp", "float64")
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = float(np.median(times))
    # the step's two largest collectives alone: the dense columns' gather
    # within the mp group and the (k, k) Hessian's all-reduce over dp
    dense = next(b for b in design.blocks if b.kind == "dense")
    H = torch.zeros((design.shape[1],) * 2, dtype=torch.float64, device=dev)
    for key, fn in (("gather", dense.full), ("hessian_all_reduce",
                                             lambda: all_reduce(H, mesh, "dp"))):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        sync()
        out[f"{key}_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    out["gather_bytes"] = dense.X.shape[0] * dense.width * dense.X.element_size()
    out["hessian_bytes"] = H.numel() * H.element_size()
    return out


def _check_step(label: str, got, ref, inner: str = "float64") -> None:
    """A sharded result against the single device's."""
    got, ref = np.asarray(got), np.asarray(ref)
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: non-finite values")
    if inner == "float64":
        # np.testing.assert_allclose's test: |diff| <= atol + rtol |ref|
        excess = np.abs(got - ref) - MULTI_STEP_TOL["rtol"] * np.abs(ref)
        _check(f"{label}: max |diff| {float(np.abs(got - ref).max()):.3e}; its excess over "
               f"rtol 1e-8", max(float(excess.max()), 0.0), MULTI_STEP_TOL["atol"])
    else:
        _check(f"{label} relerr", _relerr(got, ref), MULTI_F32_TOL)


def phase_multichip(card: str, block, n: int = N, levels: int = MIX_LEVELS, device=None,
                    world: int = MULTI_WORLD, mp: int = MULTI_MP,
                    two_level: tuple = MULTI_2LEVEL, sandwich_shape: tuple = MULTI_SANDWICH,
                    seg_w: int = MULTI_SEG_W, mixed_shape: tuple = MULTI_MIXED,
                    one_rank_backend: str = "nccl", ranks_backend: str = "gloo") -> dict:
    """Phase 10: the multi-device path.  ``device=None`` is the card (10a on
    NCCL, 10b's ranks on gloo, all on card 0); ``device="cpu"`` with
    ``one_rank_backend="gloo"`` runs it on the CPU.  With
    ``ranks_backend="nccl"`` 10b's ranks take a card each
    (``tools/multichip_cards.py``).

    The steps take the dryrun's 6 CG iterations (``MULTI_N_CG``).

    Returns ``{"launches": [10a's counts, rank 0's counts]}``."""
    import tempfile

    import torch.distributed as dist
    from tabmat_torch.glm import fit_glm, irls_step
    from tabmat_torch.ops import dense_ops
    from tabmat_torch.ops.segments import build_plan
    from tabmat_torch.parallel import launch
    from tabmat_torch.parallel.design import DeviceDesign
    from tabmat_torch.parallel.distributed import FIELDS, MixedDesign, mixed_irls_step
    from tabmat_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    kd, fit_steps, n_cg = MIX_KD, MULTI_FIT_STEPS, MULTI_N_CG
    inputs = multichip_inputs(block, n, kd, levels, sandwich_shape, seg_w, mixed_shape)
    print(f"[10] the multi-device path ({card}): the sparse path's {n}x({kd} + "
          f"{block.shape[1]} sparse + {levels} + {levels}) design; host inputs "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # 10a: one rank, the real GPU backend; a one-rank all-reduce is a copy,
    # so the sharded results are the single device's bit for bit
    whole = DeviceDesign.from_matrix(sparse_path_split(inputs, dev))
    y = inputs["y"].to(dev)
    w = torch.ones_like(y)
    b0 = torch.zeros(whole.shape[1], dtype=torch.float64, device=dev)
    single = {inner: irls_step(whole, y, w, b0, family="poisson", n_cg=n_cg,
                               inner_precision=inner) for inner in ("float64", "float32")}
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    if on_card:
        torch.cuda.set_device(dev)
    dist.init_process_group(one_rank_backend, init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, device=device)
        source = DeviceDesign.from_matrix(sparse_path_split(inputs, "cpu"))
        reset_launch_counts()
        sharded = source.shard(mesh)
        steps = {inner: irls_step(sharded, y, w, b0, family="poisson", n_cg=n_cg,
                                  inner_precision=inner) for inner in ("float64", "float32")}
        fits = {inner: fit_glm(sharded, y, family="poisson", max_iter=fit_steps, tol=0.0,
                               n_cg=n_cg, inner_precision=inner)[0]
                for inner in ("float64", "float32")}
        sync()
        counts_a = launch_counts()
        print(f"  [10a] one {dist.get_backend()} rank: kernel launches {counts_a}", flush=True)
        for inner in ("float64", "float32"):
            ref_fit = fit_glm(whole, y, family="poisson", max_iter=fit_steps, tol=0.0, n_cg=n_cg,
                              inner_precision=inner)[0]
            for label, got, ref in ((f"irls_step {inner}", steps[inner], single[inner]),
                                    (f"{fit_steps} fit_glm steps {inner}", fits[inner], ref_fit)):
                same = torch.equal(got, ref)
                print(f"  [10a] sharded {label} bit for bit the single device's: {same}",
                      flush=True)
                if not same:
                    raise AssertionError(f"10a: the one-rank {label} differs from the single "
                                         f"device's by {float((got - ref).abs().max())}")
        if on_card:
            for inner in ("float64", "float32"):
                ms = {label: _time_ms(lambda d=d: irls_step(d, y, w, b0, family="poisson",
                                                            n_cg=n_cg, inner_precision=inner),
                                      reps=5, warmup=1, hold=False)
                      for label, d in (("sharded", sharded), ("single device", whole))}
                print(f"  [10a] irls_step inner={inner} {whole.shape[0]}x{whole.shape[1]}: "
                      f"one-rank sharded {ms['sharded']:.4f} ms, single device "
                      f"{ms['single device']:.4f} ms ({card})", flush=True)
    finally:
        dist.destroy_process_group()
    del sharded, source

    # 10b: a world of ranks, each on its rows of the card
    t0 = time.perf_counter()
    rank_device = None if device is None else str(device)
    ranks = launch.run(multichip_rank, world, ranks_backend, rank_device, inputs, two_level, mp,
                       timeout=600)
    staged = on_card and ranks_backend == "gloo"
    kind = f"{ranks_backend} ranks" + (" sharing the card" if staged else "")
    print(f"  [10b] {world} {kind} (dp={world // mp} x mp={mp}; two-level "
          f"dcn x dp x mp = {two_level}) ran in {time.perf_counter() - t0:.1f} s; rows a rank "
          f"{[r['n_local'] for r in ranks]}; setup s {[round(r['setup_s'], 2) for r in ranks]}; "
          f"path s {[round(r['path_s'], 2) for r in ranks]}", flush=True)
    for r in ranks:
        missing = [name for name in MULTI_KERNELS if r["launches"][name] == 0]
        if on_card and missing:
            raise AssertionError(f"10b: rank {r['rank']} did not launch {missing}")
        for key in ("step_float64", "step_float32", "step_two_level", "sandwich", "tmv",
                    "segment_sum", "mixed_step"):
            if not np.array_equal(r[key], ranks[0][key]):
                raise AssertionError(f"10b: rank {r['rank']}'s {key} differs from rank 0's")
    r0 = ranks[0]
    print(f"  [10b] rank 0's kernel launches {r0['launches']}; every rank launched "
          f"{list(MULTI_KERNELS) if on_card else '(CPU: the plain versions)'}", flush=True)
    note = (" host-staged (a gloo all-reduce of a card's tensor goes through the host: no "
            "speed figure)" if staged else "")
    print(f"  [10b] f64 step on {world} {kind}, median of 5, ms a rank{note}: "
          f"{[round(r['step_ms'], 1) for r in ranks]}; ranks on {sorted({r['device'] for r in ranks})} "
          f"({card})", flush=True)
    print(f"  [10b] collectives alone{', host-staged' if staged else ''}, ms a rank: "
          f"the dense columns' gather "
          f"within mp ({r0['gather_bytes']} bytes a rank) "
          f"{[round(r['gather_ms'], 2) for r in ranks]}; the Hessian's all-reduce over dp "
          f"({r0['hessian_bytes']} bytes) {[round(r['hessian_all_reduce_ms'], 2) for r in ranks]}"
          f" ({card})", flush=True)
    for inner in ("float64", "float32"):
        _check_step(f"10b user path irls_step {inner} vs single device", r0[f"step_{inner}"],
                    single[inner].cpu(), inner)
    _check_step("10b two-level mesh irls_step float64 vs single device", r0["step_two_level"],
                single["float64"].cpu())
    X, d, v = (inputs[key].to(dev) for key in ("X", "d", "v"))
    _check_step("10b sharded_sandwich vs single device", r0["sandwich"],
                dense_ops.sandwich(X, d).cpu())
    X_np, d_np = inputs["X"].numpy(), inputs["d"].numpy()
    relerr = _relerr(r0["sandwich"], (X_np * d_np[:, None]).T @ X_np)
    print(f"  [10b] sharded_sandwich f64 relerr vs numpy at {X_np.shape[0]}x{X_np.shape[1]} "
          f"over {world // mp} row shards: {relerr:.3e} (limit {F64_TOL:.0e})", flush=True)
    _check("10b sharded_sandwich relerr vs numpy", relerr, F64_TOL)
    _check_step("10b sharded_transpose_matvec vs single device", r0["tmv"], (X.T @ v).cpu())
    plan = build_plan(inputs["seg_codes"].numpy(), seg_w, dev)
    _check_step(f"10b sharded_segment_sum W={seg_w} vs single device", r0["segment_sum"],
                plan.sum(v).cpu())
    del X, d, v, plan
    dz = MixedDesign(**{name: getattr(inputs["mixed"], name).to(dev) for name in FIELDS})
    ym = inputs["mixed_y"].to(dev)
    k = r0["mixed_step"].shape[0]
    ref = mixed_irls_step(dz, ym, torch.ones_like(ym),
                          torch.zeros(k, dtype=torch.float64, device=dev), n_cg=n_cg)
    _check_step(f"10b mixed_irls_step {tuple(mixed_shape)} vs single device", r0["mixed_step"],
                ref.cpu())
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": [counts_a, r0["launches"]]}


# phase 11: a sparse design past 2^31 - 1 nonzeros, the size of a GLM with
# hashed or one-hot sparse features (67M rows at 33 nonzeros a row): 2^26
# rows x 1,000 columns in float64, 28 to 38 nonzeros a row (mean 33), so
# that segments cross the merge tiles' edges at varied offsets.  Row r's
# j-th column is 26 j + (r mod 26), below 1,000 for every j < 38, so the
# CSC is written column by column with no sort.  2^26 rows give
# 2,214,592,521 nonzeros (wide_nnz_lengths): the elements of the last ~2M
# rows lie past the int32 range.
WIDE_NNZ_N, WIDE_NNZ_K = 1 << 26, 1000
WIDE_NNZ_LENGTHS = (28, 38)
WIDE_NNZ_STRIDE = 26
WIDE_NNZ_N_CG = 4
# the f64 and f32 Hessian-vector steps, and the sandwich's row panels
WIDE_NNZ_KERNELS = WIDE_SPARSE_KERNELS + ("sandwich_mma<double>",)
WIDE_NNZ_REPS = 5


def wide_nnz_lengths(n: int, lengths=WIDE_NNZ_LENGTHS, seed: int = 11) -> np.ndarray:
    """Phase 11's row lengths: ``hi - (π(r) mod (hi - lo + 1))`` for a
    permutation π of the rows made from ``seed``, so each length from ``lo``
    to ``hi`` falls on n / 11 rows (at 2^26 rows: 33 n + 9 nonzeros)."""
    lo, hi = lengths
    return (hi - np.random.default_rng(seed).permutation(n) % (hi - lo + 1)).astype(np.int8)


def wide_nnz_matrix(n: int, k: int = WIDE_NNZ_K, lengths=WIDE_NNZ_LENGTHS,
                    stride: int = WIDE_NNZ_STRIDE, seed: int = 11, threads: int = 8):
    """Phase 11's scipy CSC matrix, made with numpy from ``seed``: row r
    holds ``wide_nnz_lengths`` nonzeros, its j-th in column
    ``stride * j + r % stride``; standard normal values, filled by
    ``threads`` generators at once."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy import sparse as sps

    lo, hi = lengths
    if stride * hi > k:
        raise ValueError(f"{stride} x {hi} columns do not fit in {k}")
    L = wide_nnz_lengths(n, lengths, seed)
    data_seqs = np.random.SeedSequence(seed).spawn(threads)
    # column stride * j + s holds the rows r = s (mod stride) with L[r] > j
    counts = np.zeros(k, dtype=np.int64)
    for s in range(stride):
        at_least = np.bincount(L[s::stride], minlength=hi + 1)[::-1].cumsum()[::-1]
        counts[s : stride * hi : stride] = at_least[1 : hi + 1]
    indptr = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], dtype=np.int64)
    for s in range(stride):
        rows, Ls = np.arange(s, n, stride, dtype=np.int64), L[s::stride]
        for j in range(hi):
            c = s + stride * j
            indices[indptr[c] : indptr[c + 1]] = rows if j < lo else rows[Ls > j]
    data = np.empty(len(indices))
    cuts = np.linspace(0, len(data), threads + 1).astype(np.int64)

    def fill(i):
        np.random.default_rng(data_seqs[i]).standard_normal(out=data[cuts[i] : cuts[i + 1]])

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(fill, range(threads)))
    return sps.csc_matrix((data, indices, indptr), shape=(n, k))


def _host_gaussian_step(Xr, y, sw, beta, n_cg: int):
    """The port's gaussian ``irls_step`` on a design without the explicit
    sandwich, in numpy with scipy's products: the gradient and a fixed-
    iteration CG on ``H p = Xᵀ(sw ⊙ X p)``, guarded as ``glm._cg_solve``.
    ``Xr`` is a scipy CSR matrix."""
    tiny = np.finfo(np.float64).tiny
    Xt = Xr.T
    grad = Xt @ (sw * (y - Xr @ beta))
    x, res, p, rs = np.zeros_like(grad), grad, grad, grad @ grad
    for _ in range(n_cg):
        Ap = Xt @ (sw * (Xr @ p))
        denom = p @ Ap
        alpha = rs / denom if denom > tiny else 0.0
        x = x + alpha * p
        res = res - alpha * Ap
        rs_new = res @ res
        p = res + (rs_new / rs if rs > tiny else 0.0) * p
        rs = rs_new
    return beta + x


class _Steps:
    """Prints each step's seconds on the host clock."""

    def __init__(self):
        self.last = time.perf_counter()

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        print(f"  {what}: {now - self.last:.2f} s", flush=True)
        self.last = now


def _launched(before: dict) -> dict:
    return {name: count - before[name] for name, count in launch_counts().items()
            if count != before[name]}


def phase_wide_nnz(n: int = WIDE_NNZ_N, device=None, seed: int = 12,
                   n_cg: int = WIDE_NNZ_N_CG) -> dict:
    """Phase 11: :func:`wide_nnz_matrix` through ``SparseMatrix`` and
    ``DeviceDesign`` with int64 bounds.  matvec and transpose-matvec against
    scipy; the sandwich (row panels through ``sandwich_mma<double>``), held
    against its two row halves in :func:`phase_wide_nnz_times`; a gaussian
    ``irls_step`` (the Hessian-vector path) in both inner precisions against
    :func:`_host_gaussian_step`.  ``device=None`` builds without ``device=``
    (the card).  Returns what the times and the halves need."""
    import tabmat_torch as tt
    from tabmat_torch.glm import irls_step
    from tabmat_torch.parallel.design import DeviceDesign

    kw = {} if device is None else {"device": device}
    print(f"[11] a sparse design past 2^31 - 1 nonzeros: {n}x{WIDE_NNZ_K} float64, "
          f"device={'default' if device is None else device}", flush=True)
    step = _Steps()
    X = wide_nnz_matrix(n)
    past = X.nnz - (2**31 - 1)
    step(f"numpy made the CSC, {X.nnz} nonzeros ({past} past 2^31 - 1), indices "
         f"{X.indices.dtype}")
    if n == WIDE_NNZ_N and past <= 0:
        raise AssertionError(f"phase 11's design has only {X.nnz} nonzeros")
    m = tt.SparseMatrix(X, **kw)
    step("SparseMatrix(csc)")
    if device is None and m.device.type != "cuda":
        raise AssertionError(f"a SparseMatrix built without device= landed on {m.device}")
    on_card = m.device.type == "cuda"
    Xr = m.array_csr
    step("scipy's CSR twin (tocsr)")
    rng = np.random.default_rng(seed)
    v, r = rng.standard_normal(WIDE_NNZ_K), rng.standard_normal(n)
    got = {}
    for op, fn in (("matvec", lambda: m.matvec(v)), ("transpose_matvec",
                                                      lambda: m.transpose_matvec(r))):
        before = launch_counts()
        got[op] = fn()
        launched = _launched(before)
        step(f"{op} (its layout's upload included), launches {launched}")
        if on_card and launched != {"spmv<double,int64>": 1}:
            raise AssertionError(f"{op} launched {launched}, not one spmv<double,int64>")
    for what, (data, plan) in (("CSR", m._csr_parts()), ("CSC", m._csc_parts())):
        print(f"  {what} layout: data {data.dtype} {data.nbytes} bytes, indices "
              f"{plan.perm.dtype} {plan.perm.nbytes} bytes, bounds {plan.bounds.dtype} "
              f"{plan.bounds.nbytes} bytes on {data.device}")
        if plan.bounds.dtype != torch.int64 or plan.perm.dtype != torch.int32:
            raise AssertionError(f"the {what} layout's bounds are {plan.bounds.dtype} and its "
                                 f"indices {plan.perm.dtype}")
    want = {"matvec": Xr @ v}
    step("scipy matvec")
    want["transpose_matvec"] = Xr.T @ r
    step("scipy transpose-matvec")
    for op in got:
        _check(f"[11] {op} relerr vs scipy", _relerr(got[op], want[op]), OP_TOL)
    del got, want

    d = rng.random(n) - 0.25
    d[::11] = 0.0
    before = launch_counts()
    S = m.sandwich(d)
    launched = _launched(before)
    step(f"sandwich by row panels, launches {launched}")
    if on_card and (launched.get("sandwich_mma<double>", 0) == 0
                    or any(name.startswith("spmv") for name in launched)):
        raise AssertionError(f"the sandwich launched {launched}")

    design = DeviceDesign.from_matrix(m)
    step("DeviceDesign.from_matrix")
    if design.supports_sandwich:
        raise AssertionError("the design must take the Hessian-vector path")
    dev = design.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    beta_true = torch.as_tensor(rng.standard_normal(WIDE_NNZ_K) * 0.1, device=dev)
    y = design.matvec(beta_true) + 0.1 * torch.randn(n, dtype=torch.float64, device=dev,
                                                     generator=gen)
    sw = torch.rand(n, dtype=torch.float64, device=dev, generator=gen) + 0.5
    b0 = torch.as_tensor(rng.standard_normal(WIDE_NNZ_K) * 0.01, device=dev)
    betas, step_launches = {}, {}
    for inner in ("float64", "float32"):
        before = launch_counts()
        beta = irls_step(design, y, sw, b0, family="gaussian", n_cg=n_cg,
                         inner_precision=inner)
        betas[inner] = beta.cpu().numpy()
        step_launches[inner] = _launched(before)
        step(f"irls_step gaussian n_cg={n_cg} inner={inner}, launches {step_launches[inner]}")
        if not np.all(np.isfinite(betas[inner])):
            raise AssertionError(f"the {inner} step gave {betas[inner][:8]}")
    del design
    ref = _host_gaussian_step(Xr, y.cpu().numpy(), sw.cpu().numpy(), b0.cpu().numpy(), n_cg)
    step(f"the host replica ({2 + 2 * n_cg} scipy products)")
    for inner, beta in betas.items():
        _check(f"[11] irls_step inner={inner} beta relerr vs the host replica",
               _relerr(beta, ref), BETA_TOL[inner])
    return {"matrix": m, "csc": X, "csr": Xr, "S": S, "d": d, "step_launches": step_launches}


def phase_wide_nnz_times(card: str, state: dict, reps: int = WIDE_NNZ_REPS) -> dict:
    """Phase 11's times and its sandwich's halves, after its main path's
    launches were read: ``spmv<double,int64>`` on the CSR matvec and the CSC
    transpose-matvec with their bounds, then the sandwich against the sum
    of the sandwiches of the two row halves, each a layout of fewer than
    2^31 elements (int32 bounds), built after the whole matrix's layouts
    and host CSC are freed.  cuSPARSE is not timed here: at this size it
    raises (``tools/time_spmv.py --wide-nnz`` tries it).  Empties
    ``state``."""
    from scipy import sparse as sps
    from tabmat_torch.models import sparse as port_sparse
    from tabmat_torch.ops import dense_ops, sparse_ops
    from tabmat_torch.ops import spmv_kernel as spk

    m, Xr = state["matrix"], state["csr"]
    n, k = m.shape
    on_card = m.device.type == "cuda"
    step = _Steps()
    times = {}
    gen = torch.Generator(device=m.device).manual_seed(3)
    operands = {"CSR matvec": torch.randn(k, dtype=torch.float64, device=m.device,
                                          generator=gen),
                "CSC transpose-matvec": torch.randn(n, dtype=torch.float64, device=m.device,
                                                    generator=gen)}
    layouts = {"CSR matvec": m._csr_parts(), "CSC transpose-matvec": m._csc_parts()}
    for label, (data, plan) in layouts.items():
        x = operands[label]
        bound_ms, bound_by = spmv_bound(plan, data, x, None)
        ms = _time_ms(lambda: spk.spmv(x, plan, data), reps=reps) if on_card else None
        times[label] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"  [11] spmv<double,int64> {label} {n}x{k}, {plan.perm.numel()} nonzeros: "
              f"{ms} ms, bound {bound_ms:.6f} ms by {bound_by} ({card})", flush=True)
    step("the full-size times")
    device = m.device
    del layouts, data, plan, x, operands
    state["matrix"] = state["csc"] = m = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    d = torch.as_tensor(state["d"], device=device)
    halves = torch.zeros((k, k), dtype=torch.float64, device=d.device)
    for lo, hi in ((0, n // 2), (n // 2, n)):
        a, b = int(Xr.indptr[lo]), int(Xr.indptr[hi])
        half = sps.csr_matrix((Xr.data[a:b], Xr.indices[a:b], Xr.indptr[lo : hi + 1] - a),
                              shape=(hi - lo, k))
        data, plan = sparse_ops.compressed_layout(half, k, d.device)
        if plan.bounds.dtype != torch.int32:
            raise AssertionError(f"a half of {half.nnz} nonzeros took {plan.bounds.dtype} bounds")
        for start, stop, panel in sparse_ops.csr_row_panels(
                data, plan, half.indptr, k, port_sparse.DENSE_SANDWICH_MAX_ELEMENTS):
            dense_ops.sandwich(panel, d[lo + start : lo + stop].contiguous(), out=halves)
        del half, data, plan, panel
    step("the two halves' sandwiches (int32 layouts)")
    _check("[11] sandwich relerr vs the sum of its two row halves' sandwiches",
           _relerr(state["S"], halves.cpu()), F64_TOL)
    state.clear()
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
    forced = phase_forced_int64(device, designs["sparse"])
    max_abs.update(phase_spmv_kernels(device, cases + forced))
    del forced

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

    wider = ("sandwich_tri<float>", "sandwich_wide<float>", "sandwich_mma<double>",
             "sandwich_mma_tri<double>")
    run_main_path("dense main path", phase_main_path, device, N, K, must_launch=DENSE_KERNELS)
    run_main_path("narrow dense path", phase_main_path, None, NARROW_N, NARROW_K,
                  label="[4a] narrow dense path", must_launch=NARROW_KERNELS, must_not=wider)
    run_main_path("wide dense path", phase_main_path, None, WIDE_N, WIDE_K,
                  label="[4b] wide dense path", must_launch=WIDE_KERNELS,
                  must_not=("sandwich_mma_tri<double>",))
    run_main_path("float32 matrix path", phase_f32_matrix, WIDE_N, F32_WIDE_K,
                  must_launch=("sandwich_wide<float>",),
                  must_not=("sandwich_tri<float>",))
    run_main_path("f32-wide dense path", phase_main_path, None, WIDE_N, F32_WIDE_K,
                  label="[4d] f32-wide dense path", must_launch=F32_WIDE_KERNELS,
                  must_not=("sandwich_tri<float>", "sandwich_mma_tri<double>"))
    mixed = run_main_path("mixed main path", phase_mixed_path, N, MIX_KD, MIX_LEVELS,
                          must_launch=MIXED_KERNELS, must_not=wider)
    run_main_path("standalone sparse phase", phase_sparse_standalone, designs,
                  must_launch=SPARSE_KERNELS[:1])
    wide = run_main_path("sparse_wide sandwich", phase_sparse_wide, designs["sparse_wide"],
                         must_launch=("sparse_gram<double>",),
                         must_not=("sandwich_mma<double>",))
    max_abs.update(wide["max_abs"])
    sparse = run_main_path("sparse main path", phase_mixed_path, N, MIX_KD, MIX_LEVELS,
                           sparse=block, fit_steps=SPARSE_FIT_STEPS,
                           must_launch=SPARSE_KERNELS + NARROW_KERNELS[:2] + SEGSUM_KERNELS)
    frames = run_main_path("dataframe and formula path", phase_frame_path, card, mixed,
                           must_launch=FRAME_KERNELS, must_not=wider)

    times = phase_times(device, N, K, card, mixed, sparse, cases, wide, frames)
    # phase 9 reads the card's memory: free the earlier phases' tensors first
    del mixed, sparse, cases, wide, frames, designs
    gc.collect()
    torch.cuda.empty_cache()
    cli = phase_bench_cli(card=card)
    main_launches.extend(cli["launches"].values())
    gc.collect()
    torch.cuda.empty_cache()
    multi = phase_multichip(card, block)
    main_launches.extend(multi["launches"])
    del multi
    gc.collect()
    torch.cuda.empty_cache()
    wide_nnz = run_main_path("sparse design past 2^31 - 1 nonzeros", phase_wide_nnz,
                             must_launch=WIDE_NNZ_KERNELS, must_not=SPARSE_KERNELS)
    phase_wide_nnz_times(card, wide_nnz)
    del wide_nnz
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
