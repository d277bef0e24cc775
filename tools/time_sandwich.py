#!/usr/bin/env python3
"""Time the sandwich kernels alone on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/time_sandwich.py [--reps 20] [--parent-cu PATH] [--sass]
                                   [--diagnose | --diagnose-wide]

It builds ``csrc/sandwich.cu``, ``csrc/sandwich_narrow.cu``,
``csrc/sandwich_tri.cu``, ``csrc/sandwich_wide.cu``, ``csrc/sandwich_mma.cu``
and ``csrc/sandwich_mma_tri.cu`` and prints what ``ptxas`` reported for each
of their kernels (registers, shared memory, spills), and the first-pass
blocks an SM holds at once of the triangle and wide kernels.  Then, for each case of
``CASES``, it holds the kernel against ``sandwich_plain`` (relative error
max|S - P| / max|P| within ``chip_smoke.F64_TOL`` or ``chip_smoke.F32_TOL``,
two launches equal bit for bit, S exactly symmetric; d has zeros and
negatives) and times it against ``torch.einsum("ni,n,nj->ij")``.  The f64
cases: ``sandwich_mma_tri<double>`` at the main path's 1M x 50 and at
k = 33, 64, 100, 128 on 1M rows; ``sandwich_narrow<double>`` at 4M x 10 and
``sandwich_mma<double>`` at 400k x 160 as controls.  The f32 cases:
``sandwich_tri<float>`` at 1M x 50 and 400k x 160 and at k = 33, 64, 100,
176 on 1M rows; ``sandwich<float>`` at the same two shapes;
``sandwich_wide<float>`` at 400k x 200, 1M x 177, 200k x 1000 and 50k x 2048,
each beside ``sandwich<float>`` (``sandwich_tiled``, the f32 kernel past 176
before ``sandwich_wide.cu``, its source unchanged) as its parent;
``sandwich_narrow<float>`` at 4M x 10.  Times are CUDA events over
``--reps`` calls held back to back (``chip_smoke._time_ms``), in turns
kernel, parent, einsum, einsum, parent, kernel.

``--parent-cu PATH`` names a ``sandwich.cu`` of another commit (git is not
needed here: write it beforehand with ``git show <commit>:tabmat_torch/
csrc/sandwich.cu``).  It is built with the same flags into
``build/time_sandwich/`` and held and timed in the same turns: its
``tabmat_sandwich_f64`` beside ``sandwich_mma_tri<double>`` at 1M x 50 and
1M x 100, its ``tabmat_sandwich_f32`` beside ``sandwich<float>`` at 1M x 50
and 400k x 160, each with the row split of ``sandwich_kernel.launch_plan``.

``--sass`` disassembles the libraries with the toolkit's ``cuobjdump`` and
prints, for each instantiation of ``sandwich_tri.cu``'s first pass and for
``sandwich_wide.cu``'s, the instructions of its row loop (the shortest loop
that holds 64 FFMAs or more) by opcode, and for each instantiation of ``sandwich_mma_tri.cu``'s
first pass each k-step loop (the innermost loops that hold a DMMA: one for
each warp of a triangle group) by opcode, DMMA, LDS and DMUL first.

``--diagnose`` builds two copies of ``sandwich_mma_tri.cu`` with half of
its work taken out (``DIAGNOSE_CUTS``: "copies only" drops the k-steps,
"MMAs only" drops the refills of the stages after the first two, so the
MMAs run on stale rows) and, at 1M x 50 and 1M x 128, times the kernel,
both copies and ``X.sum()`` (a plain read of X) in turns; then it runs the
kernel and each copy back to back for two seconds while ``nvidia-smi``
samples the SM clock and the power draw every 100 ms, and prints their
median and least.  It prints this instead of the cases.

``--diagnose-wide`` does the same for ``sandwich_wide.cu`` at the four
shapes of its cases, with three copies (``WIDE_CUTS``): "copies only" (the
products dropped), "FFMAs only" (the refills after the first two stages
dropped) and "FFMAs without loads" (the row loop reads the same two rows at
every turn, so its shared loads leave the loop).

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
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tabmat_torch import _build  # noqa: E402
from tabmat_torch.ops import sandwich_kernel as sk  # noqa: E402

SOURCES = ("sandwich", "sandwich_narrow", "sandwich_tri", "sandwich_wide", "sandwich_mma",
           "sandwich_mma_tri")
WIDE_SHAPES = ((chip_smoke.WIDE_N, chip_smoke.F32_WIDE_K), (1_000_000, 177), (200_000, 1000),
               (50_000, 2048))
MAIN_SHAPES = ((chip_smoke.N, chip_smoke.K), (chip_smoke.WIDE_N, chip_smoke.WIDE_K))
# (kernel, n, k)
CASES = (
    [("sandwich_mma_tri<double>", chip_smoke.N, chip_smoke.K)]
    + [("sandwich_mma_tri<double>", 1_000_000, k) for k in (33, 64, 100, 128)]
    + [("sandwich_narrow<double>", chip_smoke.NARROW_N, chip_smoke.NARROW_K),
       ("sandwich_mma<double>", chip_smoke.WIDE_N, chip_smoke.WIDE_K)]
    + [("sandwich_tri<float>", n, k) for n, k in MAIN_SHAPES]
    + [("sandwich_tri<float>", 1_000_000, k) for k in (33, 64, 100, 176)]
    + [("sandwich<float>", n, k) for n, k in MAIN_SHAPES]
    + [("sandwich_wide<float>", n, k) for n, k in WIDE_SHAPES]
    + [("sandwich_narrow<float>", chip_smoke.NARROW_N, chip_smoke.NARROW_K)]
)
# the cases the parent's sandwich.cu is timed beside (the wide kernel's
# cases always beside this tree's sandwich<float>)
PARENT_CASES = {("sandwich_mma_tri<double>", 1_000_000, 50),
                ("sandwich_mma_tri<double>", 1_000_000, 100)}
PARENT_CASES |= {("sandwich<float>", n, k) for n, k in MAIN_SHAPES}


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
    ``mma_tri_partial<C>`` in the library ``so``: the loops that hold a DMMA
    and hold no smaller loop that does."""
    found = {}
    for head, code in _functions(so):
        name = re.search(r"mma_tri_partialILi(\d+)E", head)
        if name is None:
            continue
        with_dmma = [loop for loop in _loops(code) if loop[2]["DMMA"]]
        found[f"mma_tri_partial<{name.group(1)}>"] = [
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
    for symbol in ("tabmat_sandwich_f64", "tabmat_sandwich_f32", "tabmat_sandwich_mma_tri_f64"):
        if hasattr(lib, symbol):
            getattr(lib, symbol).argtypes = sk._SANDWICH_ARGTYPES
    if hasattr(lib, "tabmat_sandwich_wide_f32"):
        lib.tabmat_sandwich_wide_f32.argtypes = sk._WIDE_ARGTYPES
    for symbol in ("tabmat_sandwich_blocks_per_sm", "tabmat_sandwich_mma_tri_blocks_per_sm",
                   "tabmat_sandwich_wide_blocks_per_sm"):
        if hasattr(lib, symbol):
            getattr(lib, symbol).argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


def parent_kernel(cu: Path):
    """``sandwich(X, d)`` through the ``tabmat_sandwich_f64`` or
    ``tabmat_sandwich_f32`` (by X's dtype) of another commit's
    ``sandwich.cu``, built here with this tree's flags and headers."""
    lib = _library_of(cu.read_text(), "parent_sandwich", f"parent {cu}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = {}
    for is_f64 in (0, 1):
        count = ctypes.c_int(0)
        if lib.tabmat_sandwich_blocks_per_sm(is_f64, ctypes.byref(count)) != 0:
            raise RuntimeError("the parent's occupancy query failed")
        blocks[is_f64] = max(1, count.value)

    def run(X, d):
        n, k = X.shape
        is_f64 = int(X.dtype == torch.float64)
        splits, rows_per_split = sk.launch_plan(n, k, n_sm, blocks[is_f64])
        out = torch.empty((k, k), dtype=X.dtype, device=X.device)
        partial = torch.empty((splits, k, k), dtype=X.dtype, device=X.device)
        fn = lib.tabmat_sandwich_f64 if is_f64 else lib.tabmat_sandwich_f32
        err = fn(X.data_ptr(), d.data_ptr(), out.data_ptr(), partial.data_ptr(), n, k, splits,
                 rows_per_split, 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's sandwich failed: CUDA error {err}")
        return out

    return run


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
# the kernel each diagnosis takes apart -> (its cuts, its shapes)
DIAGNOSES = {
    "sandwich_mma_tri<double>": (DIAGNOSE_CUTS, DIAGNOSE_SHAPES),
    "sandwich_wide<float>": (WIDE_CUTS, WIDE_SHAPES),
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
    parser.add_argument("--sass", action="store_true")
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--diagnose", action="store_true")
    which.add_argument("--diagnose-wide", action="store_true")
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
    for name, is_f64 in (("sandwich_tri", 0), ("sandwich_wide", 0), ("sandwich_mma_tri", 1)):
        blocks = ctypes.c_int(0)
        err = getattr(sk._library(name), f"tabmat_{name}_blocks_per_sm")(is_f64,
                                                                         ctypes.byref(blocks))
        print(f"{name}.cu: {blocks.value} resident first-pass blocks per SM (error {err})")
    if args.sass:
        loops = {**row_loops(_build.build_info["sandwich_tri"]["path"]),
                 **row_loops(_build.build_info["sandwich_wide"]["path"])}
        for name, ops in loops.items():
            total = sum(ops.values())
            print(f"{name} row loop: {total} instructions, {ops['FFMA']} FFMA "
                  f"({ops['FFMA'] / total:.3f}), {ops['LDS']} LDS, {ops['FMUL']} FMUL; "
                  f"{dict(ops.most_common())}")
        for name, loops in kstep_loops(_build.build_info["sandwich_mma_tri"]["path"]).items():
            for ops in loops:
                print(f"{name} k-step loop: {sum(ops.values())} instructions, {ops['DMMA']} DMMA, "
                      f"{ops['LDS']} LDS, {ops['DMUL']} DMUL; {dict(ops.most_common())}")
    if args.diagnose or args.diagnose_wide:
        diagnose(device, args.reps, card,
                 "sandwich_wide<float>" if args.diagnose_wide else "sandwich_mma_tri<double>")
        return 0
    parent = None if args.parent_cu is None else parent_kernel(args.parent_cu)
    gen = torch.Generator(device=device).manual_seed(8)
    ok = True
    for name, n, k in CASES:
        dtype = torch.float64 if name.endswith("<double>") else torch.float32
        X = torch.randn(n, k, device=device, dtype=dtype, generator=gen)
        d = torch.randn(n, device=device, dtype=dtype, generator=gen)
        d[::5] = 0.0
        yardstick = sk.sandwich_tiled if name == "sandwich_wide<float>" else (
            parent if (name, n, k) in PARENT_CASES else None)
        ok &= held(name, sk.KERNEL_WRAPPERS[name], X, d, args.reps, card, yardstick)
        del X, d
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
