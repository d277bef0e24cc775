#!/usr/bin/env python3
"""Time the sandwich kernels alone on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/time_sandwich.py [--reps 20] [--parent-cu PATH]
                                   [--parent-narrow-cu PATH] [--sass]
                                   [--diagnose | --diagnose-wide |
                                    --diagnose-mma | --diagnose-narrow |
                                    --blocks]

It builds ``csrc/sandwich_narrow.cu``, ``csrc/sandwich_tri.cu``,
``csrc/sandwich_wide.cu``, ``csrc/sandwich_mma.cu`` and
``csrc/sandwich_mma_tri.cu`` and prints what ``ptxas`` reported for each
of their kernels (registers, shared memory, spills), and the first-pass
blocks an SM holds at once of the narrow, triangle and wide kernels.  Then,
for each case of ``CASES``, it holds the kernel against ``sandwich_plain``
(relative error max|S - P| / max|P| within ``chip_smoke.F64_TOL`` or
``chip_smoke.F32_TOL``, two launches equal bit for bit, S exactly
symmetric; d has zeros and negatives) and times it against
``torch.einsum("ni,n,nj->ij")``.  The f64 cases:
``sandwich_mma_tri<double>`` at the main path's 1M x 50 and at k = 33, 64,
100, 128 on 1M rows; ``sandwich_narrow<double>`` at 4M x 10, 1M x 5
(``NARROW_SHAPES``), 1M x 16 and 1M x 32; ``sandwich_mma<double>`` at
400k x 160, 400k x 200, 1M x 129
(beside ``sandwich_mma_tri<double>`` at 1M x 128), 200k x 1000,
40k x 10,000 (``sparse_wide``'s shape, dense) and 20k x 10,000 (one of the
two row panels its sandwich runs as), these two at two repeats a turn.  The f32 cases:
``sandwich_tri<float>`` at 1M x 50 and 400k x 160 and at k = 33, 64, 100,
176 on 1M rows; ``sandwich_wide<float>`` at 400k x 200, 1M x 177,
200k x 1000 and 50k x 2048; ``sandwich_narrow<float>`` at the same four as
in f64.  Times are CUDA events over ``--reps`` calls held back to back
(``chip_smoke._time_ms``), in turns kernel, einsum, einsum, kernel, or
with a parent kernel kernel, parent, einsum, einsum, parent, kernel.

``--parent-cu PATH`` names a ``sandwich_tri.cu``, ``sandwich_wide.cu``,
``sandwich_mma_tri.cu`` or ``sandwich_mma.cu`` of another commit (git is not
needed here: write it beforehand with ``git show <commit>:tabmat_torch/
csrc/sandwich_wide.cu``), with this tree's C interface.  It is built with
the same flags into ``build/time_sandwich/``, launched with this tree's
row plan (``sandwich_kernel.first_pass_args``) and held and timed in the
same turns beside this tree's kernel of that source at each of its cases.

``--parent-narrow-cu PATH`` does the same for a ``sandwich_narrow.cu`` of
another commit, beside ``sandwich_narrow<T>`` at each of its cases, with
that design's own row split and second launch (``narrow_kernel``).

``--sass`` disassembles the libraries with the toolkit's ``cuobjdump`` and
prints, for each instantiation of ``sandwich_tri.cu``'s first pass and for
``sandwich_wide.cu``'s, the instructions of its row loop (the shortest loop
that holds 64 FFMAs or more) by opcode, and for each instantiation of ``sandwich_mma_tri.cu``'s
first pass and for ``sandwich_mma.cu``'s each k-step loop (the innermost
loops that hold a DMMA: one for each warp of a triangle group; the stage
loop of the full and the masked warp tiles) by opcode, DMMA, LDS and DMUL
first.

``--diagnose`` builds two copies of ``sandwich_mma_tri.cu`` with half of
its work taken out (``DIAGNOSE_CUTS``: "copies only" drops the k-steps,
"MMAs only" drops the refills of the stages after the first two, so the
MMAs run on stale rows) and, at 1M x 50 and 1M x 128, times the kernel,
both copies and ``X.sum()`` (a plain read of X) in turns; then it runs the
kernel and each copy back to back for two seconds while ``nvidia-smi``
samples the SM clock and the power draw every 100 ms, and prints their
median and least.  It prints this instead of the cases.

``--diagnose-mma`` does the same for ``sandwich_mma.cu`` at 400k x 160,
1M x 129 and 200k x 1000 with eight copies (``MMA_CUTS``): "copies only",
"MMAs only", "full warp tiles" (every busy warp computes all 16 of its
tiles), "no barrier" (the stage loop's barrier dropped: times only),
"copies before the products" (the refill issued first), "k-steps in a
loop" (not unrolled), "two stages of 48 rows" and "four stages of 24
rows" (the same shared memory, one or three stages in flight).

``--diagnose-wide`` does the same for ``sandwich_wide.cu`` at the four
shapes of its cases, with three copies (``WIDE_CUTS``): "copies only" (the
products dropped), "FFMAs only" (the refills after the first two stages
dropped) and "FFMAs without loads" (the row loop reads the same two rows at
every turn, so its shared loads leave the loop).

``--diagnose-narrow`` takes a ``sandwich_narrow.cu`` apart (this tree's, or
``--parent-narrow-cu``'s) at ``NARROW_DIAGNOSE_SHAPES`` in both dtypes:
"copies only" (no sums), "FFMAs only" (no refills past the first stages),
"no second pass" (no ticket and no sum of the splits, or no second launch)
beside the kernel and ``X.sum()`` in turns, and a copy that records each
block's phases on the card's clock (``NARROW_CLOCK``): for each phase the
median and the most over the blocks.  It prints this instead of the cases.

``--blocks`` builds a copy of ``sandwich_mma.cu`` whose blocks record their
start and end on the card's clock (``BLOCK_CLOCK``) and prints, at the
shapes of ``--diagnose-mma``, each unit's splits, stages and block times
(the data ``sandwich_kernel.MMA_STAGE_COST`` was fitted to).  It prints
this instead of the cases.

Each case prints one JSON line: ``ms``, ``einsum_ms`` and ``parent_ms``
(means of the two turns, and each turn), ``bound_ms``
(``chip_smoke.sandwich_bound``), the error, and whether the launches repeat
and S is symmetric.  The first line is the card's name and power limit.
Exits 1 without a card or when a case fails a check.
"""

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tabmat_torch import _build  # noqa: E402
from tabmat_torch.ops import sandwich_kernel as sk  # noqa: E402

SOURCES = ("sandwich_narrow", "sandwich_tri", "sandwich_wide", "sandwich_mma", "sandwich_mma_tri")
WIDE_SHAPES = ((chip_smoke.WIDE_N, chip_smoke.F32_WIDE_K), (1_000_000, 177), (200_000, 1000),
               (50_000, 2048))
MAIN_SHAPES = ((chip_smoke.N, chip_smoke.K), (chip_smoke.WIDE_N, chip_smoke.WIDE_K))
# sandwich_mma<double>: the f64 steps of the wide dense paths (4b, 4d), the
# route's edge, a wide design, sparse_wide's densified shape and one of the
# two row panels its sandwich runs as
SPARSE_WIDE = chip_smoke.SPARSE_SHAPES["sparse_wide"]
MMA_SHAPES = ((chip_smoke.WIDE_N, chip_smoke.WIDE_K), (chip_smoke.WIDE_N, chip_smoke.F32_WIDE_K),
              (1_000_000, 129), (200_000, 1000), SPARSE_WIDE, (SPARSE_WIDE[0] // 2, SPARSE_WIDE[1]))
# sandwich_narrow<T>: the narrow dense path (4M x 10) and the mixed and
# sparse designs' 5-column dense cell (1M x 5)
NARROW_SHAPES = ((chip_smoke.NARROW_N, chip_smoke.NARROW_K), (chip_smoke.N, chip_smoke.MIX_KD))
# and past its whole-row widths: the f64 tensor-core tiles and f32 micro-tiles
NARROW_WIDE_SHAPES = ((1_000_000, 16), (1_000_000, 32))
# (kernel, n, k)
CASES = (
    [("sandwich_mma_tri<double>", chip_smoke.N, chip_smoke.K)]
    + [("sandwich_mma_tri<double>", 1_000_000, k) for k in (33, 64, 100, 128)]
    + [("sandwich_narrow<double>", n, k) for n, k in NARROW_SHAPES + NARROW_WIDE_SHAPES]
    + [("sandwich_mma<double>", n, k) for n, k in MMA_SHAPES]
    + [("sandwich_tri<float>", n, k) for n, k in MAIN_SHAPES]
    + [("sandwich_tri<float>", 1_000_000, k) for k in (33, 64, 100, 176)]
    + [("sandwich_wide<float>", n, k) for n, k in WIDE_SHAPES]
    + [("sandwich_narrow<float>", n, k) for n, k in NARROW_SHAPES + NARROW_WIDE_SHAPES]
)
NARROW_DIAGNOSE_SHAPES = NARROW_SHAPES + NARROW_WIDE_SHAPES
# the cases the parent's sandwich_narrow.cu is timed beside
PARENT_NARROW_CASES = {(f"sandwich_narrow<{t}>", n, k) for t in ("double", "float")
                       for n, k in NARROW_SHAPES + NARROW_WIDE_SHAPES}
# cases of a few hundred ms a call: two repeats a turn
SLOW_CASES = {("sandwich_mma<double>", n, k) for n, k in MMA_SHAPES[-2:]}


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "Compiling entry function" in line or "Used" in line or "spill" in line]


def _functions(so: str):
    """``(mangled name, [(address, opcode, operands)])`` for each function of
    the library ``so`` (from ``cuobjdump -sass``)."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    for function in sass.split("Function : ")[1:]:
        code = [re.match(r"\s+/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)\S*(.*)", line)
                for line in function.splitlines()]
        yield function.split("\n", 1)[0], [(int(m.group(1), 16), m.group(2), m.group(3))
                                            for m in code if m]


def _loops(code) -> list:
    """``(first, last, Counter of opcodes)`` of each backward branch's loop."""
    loops = []
    for addr, op, rest in code:
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target is None or int(target.group(1), 16) >= addr:
            continue
        first = int(target.group(1), 16)
        loops.append((first, addr, Counter(o for a, o, _ in code if first <= a <= addr)))
    return loops


def row_loops(so: str) -> dict:
    """``{instantiation: Counter of opcodes}`` of the row loop of each
    ``tri_partial<NT>``, and of ``wide_partial``, in the library ``so``."""
    loops = {}
    for head, code in _functions(so):
        name = re.search(r"tri_partialILi(\d+)E", head)
        if "wide_partial" in head:
            label = "wide_partial"
        elif name is not None and "mma_tri" not in head:
            label = f"tri_partial<{name.group(1)}>"
        else:
            continue
        best = None
        for _, _, body in _loops(code):
            if body["FFMA"] >= 64 and (best is None or sum(body.values()) < sum(best.values())):
                best = body
        if best is not None:
            loops[label] = best
    return loops


def kstep_loops(so: str) -> dict:
    """``{instantiation: [Counter of opcodes]}`` of the k-step loops of each
    ``mma_tri_partial<C>`` and of ``mma_partial`` in the library ``so``: the
    loops that hold a DMMA and hold no smaller loop that does."""
    found = {}
    for head, code in _functions(so):
        name = re.search(r"mma_tri_partialILi(\d+)E", head)
        if name is not None:
            label = f"mma_tri_partial<{name.group(1)}>"
        elif "mma_partial" in head:
            label = "mma_partial"
        else:
            continue
        with_dmma = [loop for loop in _loops(code) if loop[2]["DMMA"]]
        found[label] = [
            body for first, last, body in with_dmma
            if not any(first <= f2 and l2 <= last and (f2, l2) != (first, last)
                       for f2, l2, _ in with_dmma)]
    return found


def _library_of(source: str, name: str, label: str) -> ctypes.CDLL:
    """``source`` (the text of a ``.cu`` file) built with this tree's flags
    and headers into ``build/time_sandwich/<hash>/lib<name>.so`` and loaded."""
    digest = hashlib.sha256(source.encode()).hexdigest()[:16]
    so = ROOT / "build" / "time_sandwich" / digest / f"lib{name}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        cu = so.with_suffix(".cu")
        cu.write_text(source)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
               str(cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{proc.stderr}")
        print(f"{label} built")
        for line in ptxas_lines(proc.stdout + proc.stderr):
            print(f"  {line}")
    lib = ctypes.CDLL(str(so))
    # the row argument is a count or (this tree's sandwich_mma.cu) a
    # table's address: 64 bits either way
    for symbol in ("tabmat_sandwich_tri_f32", "tabmat_sandwich_mma_tri_f64",
                   "tabmat_sandwich_mma_f64"):
        if hasattr(lib, symbol):
            getattr(lib, symbol).argtypes = sk._SANDWICH_ARGTYPES
    if hasattr(lib, "tabmat_sandwich_wide_f32"):
        lib.tabmat_sandwich_wide_f32.argtypes = sk._WIDE_ARGTYPES
    for symbol in ("tabmat_sandwich_tri_blocks_per_sm", "tabmat_sandwich_mma_tri_blocks_per_sm",
                   "tabmat_sandwich_wide_blocks_per_sm", "tabmat_sandwich_mma_blocks_per_sm"):
        if hasattr(lib, symbol):
            getattr(lib, symbol).argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


def parent_kernel(cu: Path):
    """``(kernel, sandwich(X, d))`` through another commit's
    ``csrc/<source>.cu`` (``source`` its file name: the source of one
    kernel of this tree's, not ``sandwich_narrow``), built here with this
    tree's flags and headers and launched as this tree launches its own
    kernel of that source (``sandwich_kernel.first_pass_args``)."""
    source = cu.stem
    kernels = [name for name, (src, _) in sk._KERNELS.items()
               if src == source and name in sk.KERNEL_WRAPPERS]
    if len(kernels) != 1:
        raise SystemExit(f"--parent-cu takes sandwich_tri.cu, sandwich_wide.cu, "
                         f"sandwich_mma_tri.cu or sandwich_mma.cu, not {cu.name}")
    kernel = kernels[0]
    lib = _library_of(cu.read_text(), f"parent_{source}", f"parent {cu}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    count = ctypes.c_int(0)
    if getattr(lib, f"tabmat_{source}_blocks_per_sm")(int(kernel.endswith("<double>")),
                                                       ctypes.byref(count)) != 0:
        raise RuntimeError("the parent's occupancy query failed")
    fn = getattr(lib, sk._KERNELS[kernel][1])

    def run(X, d):
        n, k = X.shape
        splits, size, rows = sk.first_pass_args(source, n, k, n_sm, max(1, count.value),
                                                X.device)
        out = torch.empty((k, k), dtype=X.dtype, device=X.device)
        partial = torch.empty((splits, size), dtype=X.dtype, device=X.device)
        err = fn(X.data_ptr(), d.data_ptr(), out.data_ptr(), partial.data_ptr(), n, k, splits,
                 rows, 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's sandwich failed: CUDA error {err}")
        return out

    return kernel, run


# --diagnose: sandwich_mma_tri.cu with one half of its work taken out, by
# replacing one line of its source (which must occur once)
DIAGNOSE_CUTS = {
    "copies only": ("    ksteps_for<C>(w, acc, buf, grp, (rows_of(st) + KSTEP - 1) / KSTEP, g, t);\n",
                    "    (void)buf;\n"),
    "MMAs only": ("    if (st + STAGES - 1 < stages) issue(st + STAGES - 1);\n", ""),
}
DIAGNOSE_SHAPES = ((1_000_000, 50), (1_000_000, 128))
# --diagnose-wide: the same for sandwich_wide.cu
WIDE_CUTS = {
    "copies only": ("    if (active) stage_products(acc, a_slot(st), b_slot(st), rows_of(st), "
                    "a_first, a_second, j0);\n", ""),
    "FFMAs only": ("    if (st + STAGES - 1 < stages) issue(st + STAGES - 1);\n", ""),
    # the row loop without its shared loads: every turn reads the stage's
    # first two rows, which the compiler then loads once a stage
    "FFMAs without loads": ("    xa += 2 * TILE;\n    xa2 += 2 * TILE;\n    xb += 2 * TILE;\n"
                            "    xb2 += 2 * TILE;\n", ""),
}
# --diagnose-mma: the same for sandwich_mma.cu
MMA_CUTS = {
    "copies only": ("    stage_products_for(pattern, acc, a_slot(st) + a_off,\n"
                    "                       (on_diag_pair ? a_slot(st) : b_slot(st)) + b_off, "
                    "w_slot(st) + t);\n", ""),
    "MMAs only": ("    if (st + STAGES - 1 < stages) issue(st + STAGES - 1);\n", ""),
    # every busy warp computes all 16 tiles of its warp tile (the extra ones
    # are never written)
    "full warp tiles": ("      pattern = patterns[j];\n", "      pattern = FULL_TILES;\n"),
    # the loop's barrier dropped (the stages race: times only)
    "no barrier": ("    __syncthreads();\n    stage_products_for(", "    stage_products_for("),
    # a stage's refill issued before its products, not after
    "copies before the products": (
        "    stage_products_for(pattern, acc, a_slot(st) + a_off,\n"
        "                       (on_diag_pair ? a_slot(st) : b_slot(st)) + b_off, w_slot(st) + t);\n"
        "    // the refill after the products, so that they start on the stage first\n"
        "    if (st + STAGES - 1 < stages) issue(st + STAGES - 1);\n    commit();\n",
        "    if (st + STAGES - 1 < stages) issue(st + STAGES - 1);\n    commit();\n"
        "    stage_products_for(pattern, acc, a_slot(st) + a_off,\n"
        "                       (on_diag_pair ? a_slot(st) : b_slot(st)) + b_off, w_slot(st) + t);\n"),
    # the k-steps of a stage in a loop, not unrolled: a quarter of the code
    "k-steps in a loop": ("#pragma unroll\n  for (int ks = 0; ks < ROWS / KSTEP; ++ks) {\n",
                          "#pragma unroll 1\n  for (int ks = 0; ks < ROWS / KSTEP; ++ks) {\n"),
    # the same shared memory in two stages of 48 rows: one in flight
    "two stages of 48 rows": ("constexpr int ROWS = 32;               // rows of X a stage\n"
                              "constexpr int STAGES = 3;\n",
                              "constexpr int ROWS = 48;\nconstexpr int STAGES = 2;\n"),
    # the same shared memory in four stages of 24 rows: three in flight
    "four stages of 24 rows": ("constexpr int ROWS = 32;               // rows of X a stage\n"
                               "constexpr int STAGES = 3;\n",
                               "constexpr int ROWS = 24;\nconstexpr int STAGES = 4;\n"),
}
MMA_DIAGNOSE_SHAPES = ((chip_smoke.WIDE_N, chip_smoke.WIDE_K), (1_000_000, 129), (200_000, 1000))
# the kernel each diagnosis takes apart -> (its cuts, its shapes)
DIAGNOSES = {
    "sandwich_mma_tri<double>": (DIAGNOSE_CUTS, DIAGNOSE_SHAPES),
    "sandwich_wide<float>": (WIDE_CUTS, WIDE_SHAPES),
    "sandwich_mma<double>": (MMA_CUTS, MMA_DIAGNOSE_SHAPES),
}


def cut_kernel(name: str, label: str):
    """Kernel ``name`` (a key of ``DIAGNOSES``) through a copy of its source
    with the line of its cut ``label`` replaced (a cut's result is wrong by
    design: it times half of the work)."""
    source, symbol = sk._KERNELS[name]
    old, new = DIAGNOSES[name][0][label]
    text = (_build.CSRC / f"{source}.cu").read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"the line cut for {label!r} is not in {source}.cu once")
    lib = _library_of(text.replace(old, new), f"cut_{source}", f"{source}.cu, {label}")
    blocks = ctypes.c_int(0)
    is_f64 = int(name.endswith("<double>"))
    if getattr(lib, f"tabmat_{source}_blocks_per_sm")(is_f64, ctypes.byref(blocks)) != 0:
        raise RuntimeError("the occupancy query failed")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def run(X, d):
        n, k = X.shape
        splits, size, rows = sk.first_pass_args(source, n, k, n_sm, max(1, blocks.value),
                                                X.device)
        out = torch.empty((k, k), dtype=X.dtype, device=X.device)
        partial = torch.empty((splits, size), dtype=X.dtype, device=X.device)
        err = getattr(lib, symbol)(X.data_ptr(), d.data_ptr(), out.data_ptr(),
                                   partial.data_ptr(), n, k, splits, rows, 0,
                                   torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{label} failed: CUDA error {err}")
        return out

    return run


# --blocks: sandwich_mma.cu with each block's start and end on the card's
# clock (globaltimer, ns) recorded by thread 0, read back after the launch:
# (the line after which it goes, what goes there)
BLOCK_CLOCK = (
    ("__global__ void __launch_bounds__(THREADS, 1)\nmma_partial(",
     "__device__ long long block_clock[1 << 18];\n__device__ __forceinline__ long long now_ns() {\n"
     "  long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
    ("  double* smem = reinterpret_cast<double*>(smem_raw);\n", "  const long long t_start = now_ns();\n"),
    ("  wait_copies<0>();\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) {\n    block_clock[4 * L] = t_start;\n"
     "    block_clock[4 * L + 1] = now_ns();\n"
     "    block_clock[4 * L + 2] = (long long)ti << 16 | tj | (with_diag ? 1 << 15 : 0);\n"
     "    block_clock[4 * L + 3] = stages;\n  }\n"),
    ("const char* tabmat_cuda_error_string",
     "int read_block_clock(long long* host, long long count) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, block_clock, count * sizeof(long long));\n}\n\n"),
)


def block_times(device, card: str) -> None:
    """``--blocks``: one launch of ``sandwich_mma.cu``, its blocks timed on
    the card's clock, at each shape of ``MMA_DIAGNOSE_SHAPES``; one JSON line
    for each of the first eight units (``sandwich_kernel.mma_units``):
    splits, stages of its longest split, its blocks' least and most µs and
    ns a stage; the span of the launch."""
    text = (_build.CSRC / "sandwich_mma.cu").read_text()
    for anchor, extra in BLOCK_CLOCK:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{anchor!r} is not in sandwich_mma.cu once")
        at = text.index(anchor) + (len(anchor) if not anchor.startswith(("__global__", "const char"))
                                   else 0)
        text = text[:at] + extra + text[at:]
    lib = _library_of(text, "clocked_sandwich_mma", "sandwich_mma.cu, clocked")
    lib.read_block_clock.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    count = ctypes.c_int(0)
    if lib.tabmat_sandwich_mma_blocks_per_sm(1, ctypes.byref(count)) != 0:
        raise RuntimeError("the occupancy query failed")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(9)
    for n, k in MMA_DIAGNOSE_SHAPES:
        X = torch.randn(n, k, device=device, dtype=torch.float64, generator=gen)
        d = torch.rand(n, device=device, dtype=torch.float64, generator=gen)
        splits, size, table = sk.first_pass_args("sandwich_mma", n, k, n_sm, max(1, count.value),
                                                 device)
        out = torch.empty((k, k), dtype=X.dtype, device=device)
        partial = torch.empty((splits, size), dtype=X.dtype, device=device)
        for _ in range(3):  # the last launch's clocks are kept
            err = lib.tabmat_sandwich_mma_f64(X.data_ptr(), d.data_ptr(), out.data_ptr(),
                                              partial.data_ptr(), n, k, splits, table, 0,
                                              torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"the clocked kernel failed: CUDA error {err}")
        torch.cuda.synchronize()
        _, entries = sk.mma_blocks(n, k, n_sm, max(1, count.value))
        clock = torch.zeros(4 * entries[0], dtype=torch.int64)
        if lib.read_block_clock(clock.data_ptr(), clock.numel()) != 0:
            raise RuntimeError("reading the block clocks failed")
        clock = clock.view(-1, 4)
        t0 = int(clock[:, 0].min())
        print(json.dumps({"blocks": "sandwich_mma<double>", "n": n, "k": k,
                          "span_us": (int(clock[:, 1].max()) - t0) / 1e3, "card": card}))
        costs = sk.mma_pair_costs(k)
        splits_of = sk.mma_plan(n, k, n_sm, max(1, count.value))[1]
        for u, (ti, tj, diag_too) in enumerate(sk.mma_units(k)[:8]):
            mine = clock[clock[:, 2] == (ti << 16 | tj | (1 << 15 if diag_too else 0))]
            us = (mine[:, 1] - mine[:, 0]).double() / 1e3
            stages = int(mine[:, 3].max())
            print(json.dumps({"unit": [ti, tj, diag_too], "cost": costs[u], "splits": splits_of[u],
                              "stages": stages, "us_least": float(us.min()),
                              "us_most": float(us.max()),
                              "ns_a_stage": 1e3 * float(us.max()) / max(stages, 1)}))
        del X, d, partial


# --diagnose-narrow: a sandwich_narrow.cu with a part of its work taken out,
# and one with each block's phases on the card's clock (globaltimer, ns,
# recorded by thread 0: start, loop, copy issue and waits, sums, tail
# start, its entries written, its ticket taken, end; the parent's block
# ends where it writes its entries).  One table for each design, told apart
# by its anchors: the parent's (two cp.async stages, a second launch) and
# this tree's.
PARENT_NARROW_CUTS = {
    "copies only": ("    if (g < groups) {\n      for (int r = g; r < rows; r += groups) {\n",
                    "    if (false) {\n      for (int r = g; r < rows; r += groups) {\n"),
    # the refills after the first two stages dropped: sums on stale rows
    "FFMAs only": ("      stage_rows(smem + ((st + 1) % STAGES) * STAGE_ELEMS, X, d,\n",
                   "      if (st + 1 < STAGES)\n"
                   "      stage_rows(smem + ((st + 1) % STAGES) * STAGE_ELEMS, X, d,\n"),
    "no second pass": (
        "  narrow_reduce<T><<<blocks, threads, 0, s>>>(partial, out, k, splits, accumulate);\n", ""),
}
CLOCK_WORDS = 8
CLOCK_HELPERS = (f"__device__ long long phase_clock[{CLOCK_WORDS} * 8192];\n"
                 "__device__ __forceinline__ long long now_ns() {\n  long long t;\n"
                 "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n\n")
CLOCK_READER = ("int read_phase_clock(long long* host, long long count) {\n"
                "  return (int)cudaMemcpyFromSymbol(host, phase_clock, count * sizeof(long long));\n"
                "}\n\n")


def clock_record(finished: str, ticketed: str) -> str:
    return (f"  if (threadIdx.x == 0) {{\n    long long* c = phase_clock + {CLOCK_WORDS} * blockIdx.x;\n"
            "    c[0] = t_start;\n    c[1] = t_loop;\n    c[2] = t_wait;\n    c[3] = t_sum;\n"
            f"    c[4] = t_tail;\n    c[5] = {finished};\n    c[6] = {ticketed};\n"
            "    c[7] = now_ns();\n  }\n")
# (old, new) replacements, each old text once in the source
PARENT_NARROW_CLOCK = (
    ("template <typename T>\n__global__ void __launch_bounds__(THREADS)\nnarrow_partial(",
     CLOCK_HELPERS + "template <typename T>\n__global__ void __launch_bounds__(THREADS)\n"
     "narrow_partial("),
    ("  T* smem = reinterpret_cast<T*>(smem_raw);\n",
     "  T* smem = reinterpret_cast<T*>(smem_raw);\n  const long long t_start = now_ns();\n"
     "  long long t_wait = 0, t_sum = 0, t_mark = 0;\n"),
    ("  for (long long st = 0; st < stages; ++st) {\n",
     "  const long long t_loop = now_ns();\n  for (long long st = 0; st < stages; ++st) {\n"
     "    t_mark = now_ns();\n"),
    ("    __syncthreads();\n    const int rows = rows_of(st);\n",
     "    __syncthreads();\n    const int rows = rows_of(st);\n    t_wait += now_ns() - t_mark;\n"
     "    t_mark = now_ns();\n"),
    ("    __syncthreads();\n  }\n\n  // the row groups' sums",
     "    __syncthreads();\n    t_sum += now_ns() - t_mark;\n  }\n  const long long t_tail = now_ns();\n\n"
     "  // the row groups' sums"),
    ("    if (i <= j && j < k) out[i * k + j] = s;\n  }\n}\n",
     "    if (i <= j && j < k) out[i * k + j] = s;\n  }\n" + clock_record("now_ns()", "now_ns()")
     + "}\n"),
    ("const char* tabmat_cuda_error_string", CLOCK_READER + "const char* tabmat_cuda_error_string"),
)
NARROW_CUTS = {
    "copies only": ("    sums.sum(xs, xs + xe, rows_of(st), k);\n", "    (void)xs;\n"),
    # the refills after the first NS - 1 stages dropped (their mbarriers
    # still arrive): sums on stale rows
    "FFMAs only": ("    if (st + NS - 1 < stages) issue(st + NS - 1);\n",
                   "    if (st + NS - 1 < stages && tid == 0) arrive_expect(bar((st + NS - 1) % NS), 0);\n"),
    # no ticket and no last block's sum of the splits
    "no second pass": ("  if (tid == 0) s_ticket = (int)take_ticket(ticket);\n",
                       "  if (tid == 0) s_ticket = -S;\n"),
}
NARROW_CLOCK = (
    ("template <typename T, class Sums>\n__device__ __forceinline__ void narrow_block(",
     CLOCK_HELPERS + "template <typename T, class Sums>\n__device__ __forceinline__ void narrow_block("),
    ("  T* smem = reinterpret_cast<T*>(smem_raw);\n",
     "  T* smem = reinterpret_cast<T*>(smem_raw);\n  const long long t_start = now_ns();\n"
     "  long long t_wait = 0, t_sum = 0, t_mark = 0;\n"),
    ("  for (int st = 0; st < stages; ++st) {\n",
     "  const long long t_loop = now_ns();\n  for (int st = 0; st < stages; ++st) {\n"
     "    t_mark = now_ns();\n"),
    ("    mbar_wait(bar(st % NS), (unsigned)((st / NS) & 1));\n",
     "    mbar_wait(bar(st % NS), (unsigned)((st / NS) & 1));\n    t_wait += now_ns() - t_mark;\n"
     "    t_mark = now_ns();\n"),
    ("    sums.sum(xs, xs + xe, rows_of(st), k);\n    __syncthreads();\n  }\n",
     "    sums.sum(xs, xs + xe, rows_of(st), k);\n    __syncthreads();\n"
     "    t_sum += now_ns() - t_mark;\n  }\n  const long long t_tail = now_ns();\n"),
    ("  sums.finish(smem, partial + (long long)blockIdx.x * E, k);\n",
     "  sums.finish(smem, partial + (long long)blockIdx.x * E, k);\n"
     "  const long long t_finish = now_ns();\n"),
    # every block's phases once it knows whether it sums splits; a folding
    # block's end again after its share
    ("  if (share < 0) return;\n",
     "  const long long t_ticket = now_ns();\n" + clock_record("t_finish", "t_ticket")
     + "  if (share < 0) return;\n"),
    ("  if (tid == 0 && (folds == 1 || (int)take_ticket(ticket) == S + folds - 1)) *ticket = 0;\n",
     "  if (tid == 0 && (folds == 1 || (int)take_ticket(ticket) == S + folds - 1)) *ticket = 0;\n"
     f"  if (tid == 0) phase_clock[{CLOCK_WORDS} * blockIdx.x + 7] = now_ns();\n"),
    ("const char* tabmat_cuda_error_string", CLOCK_READER + "const char* tabmat_cuda_error_string"),
)
NARROW_DESIGNS = {"parent": (PARENT_NARROW_CUTS, PARENT_NARROW_CLOCK),
                  "kernel": (NARROW_CUTS, NARROW_CLOCK)}


def _replaced(text: str, edits, what: str) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: {old[:60]!r} is not in the source once")
        text = text.replace(old, new)
    return text


def narrow_design(text: str) -> str:
    """The key of ``NARROW_DESIGNS`` whose anchors all occur once in ``text``."""
    for key, (cuts, clock) in NARROW_DESIGNS.items():
        anchors = [old for old, _ in cuts.values()] + [old for old, _ in clock]
        if all(text.count(old) == 1 for old in anchors):
            return key
    raise RuntimeError("the narrow source matches no design of NARROW_DESIGNS")


def narrow_kernel(text: str, name: str, label: str, design: str = None):
    """``(run, lib)``: ``run(X, d)`` is the sandwich through ``text``, a
    ``sandwich_narrow.cu`` built here with this tree's flags into
    ``build/time_sandwich/``, with its design's row plan: the parent's
    (``sandwich_kernel._split_rows`` over one wave, a second launch) or this
    tree's (``sandwich_kernel.first_pass_args``, a ticket counter); a cut
    or clocked copy names its design."""
    design = design or narrow_design(text)
    lib = _library_of(text, name, label)
    lib.tabmat_sandwich_narrow_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_void_p]
    argtypes = sk._SANDWICH_ARGTYPES if design == "parent" else sk._NARROW_ARGTYPES
    lib.tabmat_sandwich_narrow_f64.argtypes = argtypes
    lib.tabmat_sandwich_narrow_f32.argtypes = argtypes
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = {}
    for is_f64 in (0, 1):
        count = ctypes.c_int(0)
        if lib.tabmat_sandwich_narrow_blocks_per_sm(is_f64, ctypes.byref(count)) != 0:
            raise RuntimeError(f"the occupancy query of {label} failed")
        blocks[is_f64] = max(1, count.value)
    tickets = {}  # stream -> this library's own ticket counter

    def run(X, d):
        n, k = X.shape
        is_f64 = int(X.dtype == torch.float64)
        fn = lib.tabmat_sandwich_narrow_f64 if is_f64 else lib.tabmat_sandwich_narrow_f32
        out = torch.empty((k, k), dtype=X.dtype, device=X.device)
        stream = torch.cuda.current_stream().cuda_stream
        if design == "parent":
            splits, rows = sk._split_rows(n, n_sm * blocks[is_f64], sk.ROWS)
            partial = torch.empty((splits, k * k), dtype=X.dtype, device=X.device)
            err = fn(X.data_ptr(), d.data_ptr(), out.data_ptr(), partial.data_ptr(), n, k,
                     splits, rows, 0, stream)
        else:
            splits, size, rows = sk.first_pass_args("sandwich_narrow", n, k, n_sm,
                                                    blocks[is_f64], X.device)
            partial = torch.empty((splits, size), dtype=X.dtype, device=X.device)
            if stream not in tickets:
                tickets[stream] = torch.zeros(1, dtype=torch.int32, device=X.device)
            err = fn(X.data_ptr(), d.data_ptr(), out.data_ptr(), partial.data_ptr(),
                     tickets[stream].data_ptr(), n, k, splits, rows, 0, stream)
        if err != 0:
            raise RuntimeError(f"{label} failed: CUDA error {err}")
        return out

    return run, lib


def diagnose_narrow(device, reps: int, card: str, parent_cu) -> None:
    """``--diagnose-narrow``: the narrow kernel (``--parent-narrow-cu``'s
    when given, else this tree's) beside its cuts and ``X.sum()`` at
    ``NARROW_DIAGNOSE_SHAPES`` in both dtypes, in turns; then one launch with its
    blocks' phases on the card's clock: for each phase the median and the
    most over the blocks, in µs, and the launch's span."""
    text = (parent_cu.read_text() if parent_cu is not None
            else (_build.CSRC / "sandwich_narrow.cu").read_text())
    design = narrow_design(text)
    cuts_table, clock = NARROW_DESIGNS[design]
    variants = {"kernel": text, "clocked": _replaced(text, clock, "clock")}
    variants.update({label: _replaced(text, [edit], label) for label, edit in cuts_table.items()})
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:  # one nvcc each, at once
        built = dict(zip(variants, pool.map(
            lambda item: narrow_kernel(item[1], "narrow", f"{design} sandwich_narrow.cu, {item[0]}",
                                       design), variants.items())))
    kernel = built.pop("kernel")[0]
    clocked, clock_lib = built.pop("clocked")
    cuts = {label: run for label, (run, _) in built.items()}
    clock_lib.read_phase_clock.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    gen = torch.Generator(device=device).manual_seed(9)
    for dtype in (torch.float64, torch.float32):
        for n, k in NARROW_DIAGNOSE_SHAPES:
            X = torch.randn(n, k, device=device, dtype=dtype, generator=gen)
            d = torch.randn(n, device=device, dtype=dtype, generator=gen)
            calls = {"kernel": lambda: kernel(X, d), "X.sum()": lambda: X.sum()}
            calls.update({label: (lambda fn=fn: fn(X, d)) for label, fn in cuts.items()})
            turns = {which: [] for which in calls}
            for which in list(calls) + list(calls)[::-1]:
                turns[which].append(chip_smoke._time_ms(calls[which], reps=reps))
            bound_ms, bound_by = chip_smoke.sandwich_bound(n, k, X.element_size())
            for _ in range(3):  # the last launch's clocks are kept
                clocked(X, d)
            torch.cuda.synchronize()
            clock_buf = torch.zeros(CLOCK_WORDS * 8192, dtype=torch.int64)
            if clock_lib.read_phase_clock(clock_buf.data_ptr(), clock_buf.numel()) != 0:
                raise RuntimeError("reading the phase clocks failed")
            c = clock_buf.view(-1, CLOCK_WORDS)
            c = c[c[:, 7] > 0].double()
            spans = {"set-up": c[:, 1] - c[:, 0], "copy issue and waits": c[:, 2],
                     "sums": c[:, 3], "tail": c[:, 7] - c[:, 4],
                     "entries written": c[:, 5] - c[:, 4], "ticket": c[:, 6] - c[:, 5],
                     "sum of the splits": c[:, 7] - c[:, 6]}
            phases = {p: {"median_us": float(v.median()) / 1e3, "most_us": float(v.max()) / 1e3}
                      for p, v in spans.items()}
            print(json.dumps({
                "diagnose": f"sandwich_narrow<{'double' if dtype == torch.float64 else 'float'}>",
                "design": design, "n": n, "k": k,
                "ms": {w: sum(v) / len(v) for w, v in turns.items()}, "turns_ms": turns,
                "bound_ms": bound_ms, "bound_by": bound_by, "blocks": int(c.shape[0]),
                "phases": phases, "span_us": float(c[:, 7].max() - c[:, 0].min()) / 1e3,
                "first_block_start_to_last_loop_us": float(c[:, 1].max() - c[:, 0].min()) / 1e3,
                "card": card}), flush=True)
            del X, d


def _sustained(fn, seconds: float = 2.0) -> dict:
    """ms per call of ``fn`` run back to back for ``seconds``, with the SM
    clock (MHz) and power draw (W) that ``nvidia-smi`` samples meanwhile."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        calls, t0 = 0, time.perf_counter()
        start.record()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            calls += 50
            torch.cuda.synchronize()
        stop.record()
        stop.synchronize()
    finally:
        smi.terminate()
        samples = smi.communicate()[0].strip().splitlines()
    rows = [[float(v) for v in line.split(",")] for line in samples[3:]]  # past the ramp
    clocks, power = sorted(r[0] for r in rows), sorted(r[1] for r in rows)
    return {"ms": start.elapsed_time(stop) / calls, "sm_clock_mhz_median": clocks[len(clocks) // 2],
            "sm_clock_mhz_least": clocks[0], "power_w_median": power[len(power) // 2],
            "power_w_most": power[-1], "samples": len(rows)}


def diagnose(device, reps: int, card: str, name: str) -> None:
    """Kernel ``name`` beside its halves and a plain read of X, in turns and
    sustained (``--diagnose``, ``--diagnose-wide``)."""
    cut_table, shapes = DIAGNOSES[name]
    cuts = {label: cut_kernel(name, label) for label in cut_table}
    dtype = torch.float64 if name.endswith("<double>") else torch.float32
    kernel = sk.KERNEL_WRAPPERS[name]
    gen = torch.Generator(device=device).manual_seed(9)
    for n, k in shapes:
        X = torch.randn(n, k, device=device, dtype=dtype, generator=gen)
        d = torch.randn(n, device=device, dtype=dtype, generator=gen)
        calls = {"kernel": lambda: kernel(X, d), "X.sum()": lambda: X.sum()}
        calls.update({label: (lambda fn=fn: fn(X, d)) for label, fn in cuts.items()})
        turns = {which: [] for which in calls}
        for which in list(calls) + list(calls)[::-1]:
            turns[which].append(chip_smoke._time_ms(calls[which], reps=reps))
        bound_ms, bound_by = chip_smoke.sandwich_bound(n, k, X.element_size())
        print(json.dumps({"diagnose": name, "n": n, "k": k,
                          "ms": {w: sum(v) / len(v) for w, v in turns.items()},
                          "turns_ms": turns, "bound_ms": bound_ms, "bound_by": bound_by,
                          "card": card}), flush=True)
        for which in ("kernel", *cuts):
            print(json.dumps({"sustained": which, "n": n, "k": k, **_sustained(calls[which]),
                              "card": card}), flush=True)
        del X, d


def _checked(fn, X, d, tol):
    """``(relative error, repeats, symmetric, ok)`` of ``fn`` against the
    plain version."""
    S, again = fn(X, d), fn(X, d)
    P = sk.sandwich_plain(X, d)
    torch.cuda.synchronize()
    rel = float((S - P).abs().max() / P.abs().max())
    repeats, symmetric = torch.equal(S, again), torch.equal(S, S.T)
    return rel, repeats, symmetric, repeats and symmetric and rel <= tol


def held(label, fn, X, d, reps, card, parent=None) -> bool:
    """Check ``fn`` (and ``parent``) against the plain version, time them
    against einsum in turns, print one JSON line; True when every check holds."""
    n, k = X.shape
    tol = chip_smoke.F64_TOL if X.dtype == torch.float64 else chip_smoke.F32_TOL
    rel, repeats, symmetric, ok = _checked(fn, X, d, tol)
    calls = {"kernel": lambda: fn(X, d), "einsum": lambda: torch.einsum("ni,n,nj->ij", X, d, X)}
    order = ["kernel", "einsum", "einsum", "kernel"]
    line = {}
    if parent is not None:
        p_rel, p_repeats, p_symmetric, p_ok = _checked(parent, X, d, tol)
        ok &= p_ok
        line.update(parent_rel_err=p_rel, parent_repeats=p_repeats, parent_symmetric=p_symmetric)
        calls["parent"] = lambda: parent(X, d)
        order = ["kernel", "parent", "einsum", "einsum", "parent", "kernel"]
    turns = {which: [] for which in calls}
    for which in order:
        turns[which].append(chip_smoke._time_ms(calls[which], reps=reps))
    means = {which: sum(v) / len(v) for which, v in turns.items()}
    bound_ms, bound_by = chip_smoke.sandwich_bound(n, k, X.element_size())
    print(json.dumps({
        "kernel": label, "n": n, "k": k, "ms": means["kernel"], "einsum_ms": means["einsum"],
        "parent_ms": means.get("parent"), "ms_over_einsum": means["kernel"] / means["einsum"],
        "turns_ms": turns, "bound_ms": bound_ms, "bound_by": bound_by, "rel_err": rel,
        "tol": tol, "repeats": repeats, "symmetric": symmetric, **line, "ok": ok, "card": card,
    }), flush=True)
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--parent-cu", type=Path, default=None)
    parser.add_argument("--parent-narrow-cu", type=Path, default=None)
    parser.add_argument("--sass", action="store_true")
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--diagnose", action="store_true")
    which.add_argument("--diagnose-wide", action="store_true")
    which.add_argument("--diagnose-mma", action="store_true")
    which.add_argument("--blocks", action="store_true")
    which.add_argument("--diagnose-narrow", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_sandwich: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    sources = () if args.diagnose_narrow else SOURCES  # it builds its own copies
    _build.build_all(sources)
    for name in sources:
        info = _build.build_info[name]
        print(f"{name}.cu built in {info['seconds']} s (None: reused)")
        for line in ptxas_lines(info["log"]):
            print(f"  {line}")
    for name, is_f64 in (("sandwich_narrow", 1), ("sandwich_narrow", 0), ("sandwich_tri", 0),
                         ("sandwich_wide", 0), ("sandwich_mma_tri", 1), ("sandwich_mma", 1)):
        if name not in sources:
            continue
        blocks = ctypes.c_int(0)
        err = getattr(sk._library(name), f"tabmat_{name}_blocks_per_sm")(is_f64,
                                                                         ctypes.byref(blocks))
        print(f"{name}.cu: {blocks.value} resident first-pass blocks per SM "
              f"({'f64' if is_f64 else 'f32'}; error {err})")
    if args.diagnose_narrow:
        diagnose_narrow(device, args.reps, card, args.parent_narrow_cu)
        return 0
    if args.sass:
        loops = {**row_loops(_build.build_info["sandwich_tri"]["path"]),
                 **row_loops(_build.build_info["sandwich_wide"]["path"])}
        for name, ops in loops.items():
            total = sum(ops.values())
            print(f"{name} row loop: {total} instructions, {ops['FFMA']} FFMA "
                  f"({ops['FFMA'] / total:.3f}), {ops['LDS']} LDS, {ops['FMUL']} FMUL; "
                  f"{dict(ops.most_common())}")
        for name, loops in {**kstep_loops(_build.build_info["sandwich_mma_tri"]["path"]),
                            **kstep_loops(_build.build_info["sandwich_mma"]["path"])}.items():
            for ops in loops:
                print(f"{name} k-step loop: {sum(ops.values())} instructions, {ops['DMMA']} DMMA, "
                      f"{ops['LDS']} LDS, {ops['DMUL']} DMUL; {dict(ops.most_common())}")
    if args.blocks:
        block_times(device, card)
        return 0
    if args.diagnose or args.diagnose_wide or args.diagnose_mma:
        diagnose(device, args.reps, card,
                 "sandwich_wide<float>" if args.diagnose_wide else
                 "sandwich_mma<double>" if args.diagnose_mma else "sandwich_mma_tri<double>")
        return 0
    parent_name, parent = (None, None) if args.parent_cu is None else parent_kernel(args.parent_cu)
    parent_narrow = (None if args.parent_narrow_cu is None else
                     narrow_kernel(args.parent_narrow_cu.read_text(), "parent_narrow",
                                   f"parent {args.parent_narrow_cu}")[0])
    gen = torch.Generator(device=device).manual_seed(8)
    ok = True
    for name, n, k in CASES:
        dtype = torch.float64 if name.endswith("<double>") else torch.float32
        X = torch.randn(n, k, device=device, dtype=dtype, generator=gen)
        d = torch.randn(n, device=device, dtype=dtype, generator=gen)
        d[::5] = 0.0
        yardstick = (parent if name == parent_name else
                     parent_narrow if (name, n, k) in PARENT_NARROW_CASES else None)
        reps = 2 if (name, n, k) in SLOW_CASES else args.reps
        ok &= held(name, sk.KERNEL_WRAPPERS[name], X, d, reps, card, yardstick)
        del X, d
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
