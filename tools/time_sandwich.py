#!/usr/bin/env python3
"""Time the float32 sandwich kernels alone on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/time_sandwich.py [--reps 20] [--parent-cu PATH] [--sass]

It builds ``csrc/sandwich.cu``, ``csrc/sandwich_narrow.cu`` and
``csrc/sandwich_tri.cu`` and prints what ``ptxas`` reported for each of
their kernels (registers, shared memory, spills).  Then, for each case of
``CASES`` (``sandwich_tri<float>`` at the main path's 1M x 50 and 400k x
160 and at k = 33, 64, 100, 176 on 1M rows; ``sandwich<float>`` at the same
two main-path shapes, at k = 177 and at k = 1000; ``sandwich_narrow<float>``
at 4M x 10 as a control), it holds the kernel against ``sandwich_plain``
(relative error max|S - P| / max|P| within ``chip_smoke.F32_TOL``, two
launches equal bit for bit, S exactly symmetric; d has zeros and negatives)
and times it against ``torch.einsum("ni,n,nj->ij")``.  Times are CUDA events
over ``--reps`` calls held back to back (``chip_smoke._time_ms``), in turns
kernel, einsum, einsum, kernel.

``--parent-cu PATH`` names a ``sandwich.cu`` of another commit (git is not
needed here: write it beforehand with ``git show <commit>:tabmat_torch/
csrc/sandwich.cu``).  It is built with the same flags into
``build/time_sandwich/`` and its ``tabmat_sandwich_f32`` is held and timed
at the two main-path shapes in the same turns, with the row split of
``sandwich_kernel.launch_plan``.

``--sass`` disassembles ``sandwich_tri.cu``'s library with the toolkit's
``cuobjdump`` and prints, for each instantiation of its first pass, the
instructions of its row loop (the shortest loop that holds 64 FFMAs or
more) by opcode: the share of FFMAs in it is the most of the card's FP32
issue rate the loop can reach.

Each case prints one JSON line: ``ms`` and ``einsum_ms`` (means of the two
turns, and each turn), ``bound_ms`` (``chip_smoke.sandwich_bound``), the
error, and whether the launches repeat and S is symmetric.  The first line
is the card's name and power limit.  Exits 1 without a card or when a case
fails a check.
"""

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tabmat_torch import _build  # noqa: E402
from tabmat_torch.ops import sandwich_kernel as sk  # noqa: E402

SOURCES = ("sandwich", "sandwich_narrow", "sandwich_tri")
MAIN_SHAPES = ((chip_smoke.N, chip_smoke.K), (chip_smoke.WIDE_N, chip_smoke.WIDE_K))
# (kernel, n, k)
CASES = (
    [("sandwich_tri<float>", n, k) for n, k in MAIN_SHAPES]
    + [("sandwich_tri<float>", 1_000_000, k) for k in (33, 64, 100, 176)]
    + [("sandwich<float>", n, k) for n, k in MAIN_SHAPES]
    + [("sandwich<float>", 1_000_000, 177), ("sandwich<float>", 200_000, 1000)]
    + [("sandwich_narrow<float>", chip_smoke.NARROW_N, chip_smoke.NARROW_K)]
)


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "Compiling entry function" in line or "Used" in line or "spill" in line]


def row_loops(so: str) -> dict:
    """``{instantiation: Counter of opcodes}`` of the row loop of each
    ``tri_partial<NT>`` in the library ``so`` (from ``cuobjdump -sass``)."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    loops = {}
    for function in sass.split("Function : ")[1:]:
        name = re.search(r"tri_partialILi(\d+)E", function.split("\n", 1)[0])
        if name is None:
            continue
        code = [re.match(r"\s+/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)\S*(.*)", line)
                for line in function.splitlines()]
        code = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in code if m]
        best = None
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target is None or int(target.group(1), 16) >= addr:
                continue
            body = Counter(o for a, o, _ in code if int(target.group(1), 16) <= a <= addr)
            if body["FFMA"] >= 64 and (best is None or sum(body.values()) < sum(best.values())):
                best = body
        if best is not None:
            loops[f"tri_partial<{name.group(1)}>"] = best
    return loops


def parent_kernel(cu: Path):
    """``sandwich(X, d)`` through the ``tabmat_sandwich_f32`` of another
    commit's ``sandwich.cu``, built here with this tree's flags and headers."""
    src = cu.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    so = ROOT / "build" / "time_sandwich" / digest / "libparent_sandwich.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
               str(cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
        print(f"parent {cu} built")
        for line in ptxas_lines(proc.stdout + proc.stderr):
            print(f"  {line}")
    lib = ctypes.CDLL(str(so))
    lib.tabmat_sandwich_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.tabmat_sandwich_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_void_p]
    blocks = ctypes.c_int(0)
    if lib.tabmat_sandwich_blocks_per_sm(0, ctypes.byref(blocks)) != 0:
        raise RuntimeError("the parent's occupancy query failed")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def run(X, d):
        n, k = X.shape
        splits, rows_per_split = sk.launch_plan(n, k, n_sm, max(1, blocks.value))
        out = torch.empty((k, k), dtype=X.dtype, device=X.device)
        partial = torch.empty((splits, k, k), dtype=X.dtype, device=X.device)
        err = lib.tabmat_sandwich_f32(
            X.data_ptr(), d.data_ptr(), out.data_ptr(), partial.data_ptr(), n, k, splits,
            rows_per_split, 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's sandwich<float> failed: CUDA error {err}")
        return out

    return run


def held(label, fn, X, d, reps, card) -> bool:
    """Check ``fn`` against the plain version, time it against einsum, print
    one JSON line; True when every check holds."""
    n, k = X.shape
    S, again = fn(X, d), fn(X, d)
    P = sk.sandwich_plain(X, d)
    torch.cuda.synchronize()
    rel = float((S - P).abs().max() / P.abs().max())
    repeats, symmetric = torch.equal(S, again), torch.equal(S, S.T)
    ok = repeats and symmetric and rel <= chip_smoke.F32_TOL
    del S, again, P
    turns = {"kernel": [], "einsum": []}
    for which in ("kernel", "einsum", "einsum", "kernel"):
        call = ((lambda: fn(X, d)) if which == "kernel"
                else (lambda: torch.einsum("ni,n,nj->ij", X, d, X)))
        turns[which].append(chip_smoke._time_ms(call, reps=reps))
    bound_ms, bound_by = chip_smoke.sandwich_bound(n, k, X.element_size())
    ms, einsum_ms = sum(turns["kernel"]) / 2, sum(turns["einsum"]) / 2
    print(json.dumps({
        "kernel": label, "n": n, "k": k, "ms": ms, "einsum_ms": einsum_ms,
        "ms_over_einsum": ms / einsum_ms, "turns_ms": turns, "bound_ms": bound_ms,
        "bound_by": bound_by, "rel_err": rel, "tol": chip_smoke.F32_TOL,
        "repeats": repeats, "symmetric": symmetric, "ok": ok, "card": card,
    }), flush=True)
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--parent-cu", type=Path, default=None)
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_sandwich: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all(SOURCES)
    for name in SOURCES:
        info = _build.build_info[name]
        print(f"{name}.cu built in {info['seconds']} s (None: reused)")
        for line in ptxas_lines(info["log"]):
            print(f"  {line}")
    if args.sass:
        for name, ops in row_loops(_build.build_info["sandwich_tri"]["path"]).items():
            total = sum(ops.values())
            print(f"{name} row loop: {total} instructions, {ops['FFMA']} FFMA "
                  f"({ops['FFMA'] / total:.3f}); {dict(ops.most_common())}")
    parent = None if args.parent_cu is None else parent_kernel(args.parent_cu)
    gen = torch.Generator(device=device).manual_seed(8)
    ok = True
    for name, n, k in CASES:
        X = torch.randn(n, k, device=device, dtype=torch.float32, generator=gen)
        d = torch.randn(n, device=device, dtype=torch.float32, generator=gen)
        d[::5] = 0.0
        ok &= held(name, sk.KERNEL_WRAPPERS[name], X, d, args.reps, card)
        if parent is not None and name == "sandwich<float>" and (n, k) in MAIN_SHAPES:
            ok &= held("parent sandwich<float>", parent, X, d, args.reps, card)
        del X, d
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
