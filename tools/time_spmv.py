#!/usr/bin/env python3
"""Time the sparse segment product ``spmv<T>`` alone on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/time_spmv.py [--reps 20] [--cache build/spmv_designs] [--parent-cu DIR]
    python3 tools/time_spmv.py --wide-nnz [--reps 5]

It builds ``csrc/spmv.cu`` and prints what ``ptxas`` reported for each of
its kernels (registers, shared memory).  Then, for each of the nine shapes
that ``chip_smoke.py`` runs the kernel at (``chip_smoke.spmv_cases``: the
CSR matvec and CSC transpose-matvec of the reference's three sparse designs,
the pair plan, the stacked (code, column) plan and the scaled sparse x dense
cell of the sparse main path) and for f64 and f32, it holds the kernel
against its plain version (max |kernel - plain| / sum |term|, and two
launches equal bit for bit), holds the int64-bounds instantiation
(``spmv<T,int64>``, the same layout with its bounds as int64) bit for bit
against it, and times both against cuSPARSE
(``torch.sparse_csr_tensor(...) @ values``, where no per-row scale makes it
two calls).  ``--parent-cu DIR`` builds ``DIR/spmv.cu`` (another commit's,
with ``DIR/spmv_kernel.py`` as its wrapper where that file exists) with the
same flags into ``build/spmv_parent/``, holds it bit for bit against the
kernel and times it in the same turns.  Times are CUDA events over
``--reps`` calls held back to back (``chip_smoke._time_ms``), in turns
parent, kernel, int64, cuSPARSE, then the reverse.

``--wide-nnz`` instead takes ``chip_smoke.py`` phase 11's CSC (2^26 x
1,000, 2,214,592,521 nonzeros, int64 bounds on the card): it times
``spmv<double,int64>``'s transpose-matvec, then cuSPARSE's on the same
layout with int64 indices, or prints the error cuSPARSE raises.

Each shape prints one JSON line: ``ms``, ``int64_ms``, ``parent_ms`` and
``cusparse_ms`` (means of the two turns, and each turn), ``bound_ms``
(``chip_smoke.spmv_bound`` of the int32 layout), the error and whether the
launches repeat.  The first line is the card's name and power limit.
``--cache`` keeps the scipy designs (about 40 s to make) as ``.npz`` files,
so a second run in the same place loads them.  Exits 1 without a card or
when a shape exceeds its tolerance, does not repeat or differs between
instantiations.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tabmat_torch import _build  # noqa: E402
from tabmat_torch.ops import sparse_ops  # noqa: E402
from tabmat_torch.ops import spmv_kernel as spk  # noqa: E402
from tabmat_torch.ops.segments import SegmentPlan  # noqa: E402


def designs(cache):
    """The reference's sparse designs and the main path's sparse block, made
    from their seeds or loaded from ``cache``."""
    from scipy import sparse as sps

    names = list(chip_smoke.SPARSE_SHAPES) + ["block"]
    if cache is not None and all((cache / f"{n}.npz").exists() for n in names):
        loaded = {n: sps.load_npz(cache / f"{n}.npz").tocsc() for n in names}
        return {n: loaded[n] for n in names[:-1]}, loaded["block"]
    made = chip_smoke.sparse_designs()
    block = chip_smoke.sparse_block(chip_smoke.N)
    if cache is not None:
        cache.mkdir(parents=True, exist_ok=True)
        for n, X in {**made, "block": block}.items():
            sps.save_npz(cache / f"{n}.npz", X)
    return made, block


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "Compiling entry function" in line or "Used" in line]


def parent_spmv(parent_cu: Path):
    """``spmv`` of another commit: ``parent_cu/spmv.cu`` built with
    ``_build``'s flags, behind ``parent_cu/spmv_kernel.py`` where it exists
    (else this commit's wrapper), its C functions typed by that wrapper."""
    out = ROOT / "build" / "spmv_parent" / "libspmv.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(parent_cu / "spmv.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {parent_cu / 'spmv.cu'}:\n{proc.stderr}")
    print(f"{parent_cu / 'spmv.cu'} built in {time.perf_counter() - t0:.1f} s; ptxas:")
    for line in ptxas_lines(proc.stdout + proc.stderr):
        print(f"  {line}")
    theirs = parent_cu / "spmv_kernel.py"
    path = theirs if theirs.exists() else ROOT / "tabmat_torch" / "ops" / "spmv_kernel.py"
    spec = importlib.util.spec_from_file_location("tabmat_torch.ops._parent_spmv", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    lib = ctypes.CDLL(str(out))
    signatures = {symbol: module._ARGTYPES for symbol in module._SYMBOLS.values()}
    for symbol, argtypes in {**signatures, **module._TABLE_SIGNATURES}.items():
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int
    lib.tabmat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tabmat_cuda_error_string.restype = ctypes.c_char_p
    module._lib = lib
    return module.spmv


def wide_nnz(card: str, reps: int) -> int:
    """``spmv<double,int64>`` and cuSPARSE on phase 11's CSC transpose-matvec."""
    t0 = time.perf_counter()
    X = chip_smoke.wide_nnz_matrix(chip_smoke.WIDE_NNZ_N)
    device = torch.device("cuda", 0)
    data, plan = sparse_ops.compressed_layout(X, X.shape[0], device)
    n, k = X.shape
    del X
    print(f"phase 11's CSC ({plan.perm.numel()} nonzeros, bounds {plan.bounds.dtype}) on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    r = torch.randn(n, dtype=torch.float64, device=device,
                    generator=torch.Generator(device=device).manual_seed(3))
    ms = chip_smoke._time_ms(lambda: spk.spmv(r, plan, data), reps=reps)
    bound_ms, bound_by = chip_smoke.spmv_bound(plan, data, r, None)
    A = torch.sparse_csr_tensor(plan.bounds, plan.perm.long(), data, size=(k, n))
    try:
        library_ms, error = chip_smoke._time_ms(lambda: A @ r, reps=reps), None
    except RuntimeError as e:
        library_ms, error = None, str(e).strip().splitlines()[0]
    print(json.dumps({
        "shape": f"phase 11 {n}x{k} CSC transpose-matvec",
        "dtype": "float64",
        "nonzeros": plan.perm.numel(),
        "ms": ms,
        "cusparse_ms": library_ms,
        "cusparse_error": error,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "card": card,
    }), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--cache", type=Path, default=None)
    parser.add_argument("--parent-cu", type=Path, default=None)
    parser.add_argument("--wide-nnz", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_spmv: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.library("spmv")
    info = _build.build_info["spmv"]
    print(f"spmv.cu built in {info['seconds']} s (None: reused)")
    for line in ptxas_lines(info["log"]):
        print(f"  {line}")
    if args.wide_nnz:
        return wide_nnz(card, args.reps)
    parent = None if args.parent_cu is None else parent_spmv(args.parent_cu)
    t0 = time.perf_counter()
    made, block = designs(args.cache)
    print(f"designs ready in {time.perf_counter() - t0:.1f} s", flush=True)
    ok = True
    for label, plan, a, values, scale in chip_smoke.spmv_cases(device, made, block):
        for dtype, tol in ((torch.float64, chip_smoke.F64_TOL),
                           (torch.float32, chip_smoke.F32_TOL)):
            A, V = a.to(dtype), values.to(dtype)
            S = None if scale is None else scale.to(dtype)
            wide = SegmentPlan(plan.perm, plan.bounds.long(), plan.n_rows)
            calls = {"kernel": lambda: spk.spmv(V, plan, A, S),
                     "int64": lambda: spk.spmv(V, wide, A, S)}
            if parent is not None:
                own = SegmentPlan(plan.perm, plan.bounds, plan.n_rows)  # its own tile table
                calls["parent"] = lambda: parent(V, own, A, S)
            if S is None:
                csr = torch.sparse_csr_tensor(plan.bounds, plan.perm, A,
                                              size=(plan.num_segments, plan.n_rows))
                calls["cusparse"] = lambda: csr @ V
            first, second = calls["kernel"](), calls["kernel"]()
            want = spk.spmv_plain(V, plan.perm, plan.bounds, A, S)
            mag = spk.spmv_plain(V.abs().double(), plan.perm, plan.bounds, A.abs().double(),
                                 None if S is None else S.abs().double())
            same = {key: torch.equal(calls[key](), first) for key in ("int64", "parent")
                    if key in calls}
            torch.cuda.synchronize()
            rel = float(((first.double() - want.double()).abs()
                         / mag.clamp_min(torch.finfo(torch.float64).tiny)).max())
            repeats = torch.equal(first, second)
            ok &= repeats and rel <= tol and all(same.values())
            order = [key for key in ("parent", "kernel", "int64", "cusparse") if key in calls]
            turns = {key: [] for key in order}
            for which in order + order[::-1]:
                turns[which].append(chip_smoke._time_ms(calls[which], reps=args.reps))
            mean = {key: sum(t) / len(t) for key, t in turns.items()}
            bound_ms, bound_by = chip_smoke.spmv_bound(plan, A, V, S)
            print(json.dumps({
                "shape": label,
                "dtype": str(dtype).replace("torch.", ""),
                "ms": mean["kernel"],
                "int64_ms": mean["int64"],
                "parent_ms": mean.get("parent"),
                "cusparse_ms": mean.get("cusparse"),
                "turns_ms": turns,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "rel_err": rel,
                "tol": tol,
                "repeats": repeats,
                "bit_for_bit_the_kernel": same,
                "card": card,
            }), flush=True)
            del A, V, S, first, second, want, mag, calls, wide
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
