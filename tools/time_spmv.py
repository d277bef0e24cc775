#!/usr/bin/env python3
"""Time the sparse segment product ``spmv<T>`` alone on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/time_spmv.py [--reps 20] [--cache build/spmv_designs]

It builds ``csrc/spmv.cu`` and prints what ``ptxas`` reported for each of
its kernels (registers, shared memory).  Then, for each of the nine shapes
that ``chip_smoke.py`` runs the kernel at (``chip_smoke.spmv_cases``: the
CSR matvec and CSC transpose-matvec of the reference's three sparse designs,
the pair plan, the stacked (code, column) plan and the scaled sparse x dense
cell of the sparse main path) and for f64 and f32, it holds the kernel
against its plain version (max |kernel - plain| / sum |term|, and two
launches equal bit for bit) and times it against cuSPARSE
(``torch.sparse_csr_tensor(...) @ values``, where no per-row scale makes it
two calls).  Times are CUDA events over ``--reps`` calls held back to back
(``chip_smoke._time_ms``), in turns kernel, cuSPARSE, cuSPARSE, kernel.

Each shape prints one JSON line: ``ms`` and ``cusparse_ms`` (means of the
two turns, and each turn), ``bound_ms`` (``chip_smoke.spmv_bound``), the
error and whether the launches repeat.  The first line is the card's name
and power limit.  ``--cache`` keeps the scipy designs (about 40 s to make)
as ``.npz`` files, so a second run in the same place loads them.  Exits 1
without a card or when a shape exceeds its tolerance or does not repeat.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tabmat_torch import _build  # noqa: E402
from tabmat_torch.ops import spmv_kernel as spk  # noqa: E402


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--cache", type=Path, default=None)
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
    t0 = time.perf_counter()
    made, block = designs(args.cache)
    print(f"designs ready in {time.perf_counter() - t0:.1f} s", flush=True)
    ok = True
    for label, plan, a, values, scale in chip_smoke.spmv_cases(device, made, block):
        for dtype, tol in ((torch.float64, chip_smoke.F64_TOL),
                           (torch.float32, chip_smoke.F32_TOL)):
            A, V = a.to(dtype), values.to(dtype)
            S = None if scale is None else scale.to(dtype)
            first, second = spk.spmv(V, plan, A, S), spk.spmv(V, plan, A, S)
            want = spk.spmv_plain(V, plan.perm, plan.bounds, A, S)
            mag = spk.spmv_plain(V.abs().double(), plan.perm, plan.bounds, A.abs().double(),
                                 None if S is None else S.abs().double())
            torch.cuda.synchronize()
            rel = float(((first.double() - want.double()).abs()
                         / mag.clamp_min(torch.finfo(torch.float64).tiny)).max())
            repeats = torch.equal(first, second)
            ok &= repeats and rel <= tol
            library = None
            if S is None:
                csr = torch.sparse_csr_tensor(plan.bounds, plan.perm, A,
                                              size=(plan.num_segments, plan.n_rows))
                library = lambda: csr @ V  # noqa: E731
            turns = {"kernel": [], "cusparse": []}
            for which in ("kernel", "cusparse", "cusparse", "kernel"):
                fn = (lambda: spk.spmv(V, plan, A, S)) if which == "kernel" else library
                if fn is not None:
                    turns[which].append(chip_smoke._time_ms(fn, reps=args.reps))
            bound_ms, bound_by = chip_smoke.spmv_bound(plan, A, V, S)
            print(json.dumps({
                "shape": label,
                "dtype": str(dtype).replace("torch.", ""),
                "ms": sum(turns["kernel"]) / 2,
                "cusparse_ms": sum(turns["cusparse"]) / 2 if turns["cusparse"] else None,
                "turns_ms": turns,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "rel_err": rel,
                "tol": tol,
                "repeats": repeats,
                "card": card,
            }), flush=True)
            del A, V, S, first, second, want, mag
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
