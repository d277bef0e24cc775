#!/usr/bin/env python3
"""Time the segment sum ``segsum<T>`` alone on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/time_segsum.py [--reps 20] [--parent-cu DIR] [--R 1024]
        [--blocks-per-sm 2]

It builds ``csrc/segsum.cu`` and prints what ``ptxas`` reported for each of
its kernels (registers, shared memory, spills) and the pass-1 blocks
resident on an SM at each shape.  Then, at the mixed IRLS step's three
shapes on 1,000,000 rows (two 1000-level categoricals, as ``bench.py:360``
builds them: the stacked plan, W = 2000, at m = 1 and at m = 5, and the
10^6-cell cat x cat plan at m = 1) and in f64 and f32, it times the kernel,
the parent kernel (``--parent-cu``) and the library call (``bincount`` at
m = 1, ``index_add_`` at m = 5, as ``chip_smoke.py`` phase 8 uses them) in
turns (parent, kernel, library, library, kernel, parent), each ``--reps``
calls held back to back (``chip_smoke._time_ms``, CUDA events).

``--parent-cu DIR`` names a directory holding another commit's
``segsum.cu`` and ``segment_walk.cuh`` (the chunk walk, with its C interface
``tabmat_segsum_f64(values, perm, bounds, spanning, W, E, m, n_span, out,
part_lo, part_hi, stream)``), for example written with
``git show <commit>:tabmat_torch/csrc/segsum.cu``; it is built with the
same flags into ``build/segsum_parent/``.  ``--R`` and ``--blocks-per-sm``
set the rows a tile (``segsum_kernel.TILE_ROWS``, the first tried) and the
tiles route's blocks an SM (``BLOCKS_PER_SM``) for this run.

Each shape prints one JSON line: the route, ``ms``, ``parent_ms`` and
``library_ms`` (means of their two turns, and each turn), ``unheld_ms``
(the kernel's and the parent's calls issued without holding the stream, so
with their host launches), ``bound_ms``
(``chip_smoke.segsum_bound``), the kernel's relative error against
``segsum_plain`` (max |kernel - plain| / sum |v| of each segment), whether
two launches repeat bit for bit, and the device launches of one call and
each kernel's device time (a ``torch.profiler`` trace of 20 calls).  The first line is the card's name and power
limit.  Exits 1 without a card or when a shape exceeds its tolerance,
does not repeat or makes more than two launches a call.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tabmat_torch import _build  # noqa: E402
from tabmat_torch.ops import segsum_kernel as ssk  # noqa: E402
from tabmat_torch.ops.segments import build_plan, stack  # noqa: E402

N, LEVELS, KD = 1_000_000, 1000, 5
PARENT_CHUNK = 16  # sorted elements a thread in the parent's chunk walk


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "Compiling entry function" in line or "Used" in line or "spill" in line]


def parent_library(directory: Path):
    """The parent's ``segsum.cu`` built with ``_build``'s flags, typed."""
    out = ROOT / "build" / "segsum_parent" / "libsegsum_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(directory / "segsum.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    for symbol in ("tabmat_segsum_f64", "tabmat_segsum_f32"):
        fn = getattr(lib, symbol)
        fn.argtypes = [P, P, P, P, I, ctypes.c_longlong, I, I, P, P, P, P]
        fn.restype = I
    print("parent segsum.cu built; ptxas:")
    for line in ptxas_lines(proc.stdout + proc.stderr):
        print(f"  {line}")
    return lib


def parent_call(lib, values, plan):
    """A callable running the parent's two-pass chunk walk on ``plan``."""
    m = 1 if values.ndim == 1 else values.shape[1]
    W, E = plan.num_segments, plan.perm.shape[0]
    start, end = plan.bounds[:-1].long(), plan.bounds[1:].long()
    spans = (end > start) & (start // PARENT_CHUNK != (end - 1) // PARENT_CHUNK)
    spanning = torch.nonzero(spans).flatten().to(torch.int32)
    chunks = -(-E // PARENT_CHUNK)
    fn = lib.tabmat_segsum_f64 if values.dtype == torch.float64 else lib.tabmat_segsum_f32
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.empty((W,) + tuple(values.shape[1:]), dtype=values.dtype,
                          device=values.device)
        parts = torch.empty((2, chunks, m), dtype=values.dtype, device=values.device)
        err = fn(values.data_ptr(), plan.perm.data_ptr(), plan.bounds.data_ptr(),
                 spanning.data_ptr(), W, E, m, spanning.shape[0], out.data_ptr(),
                 parts[0].data_ptr(), parts[1].data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"parent segsum failed: CUDA error {err}")
        return out

    return run


def layout_mb(plan, route) -> dict:
    """Rows a tile and MB of each device table of the route's row-tile
    layout of ``plan`` (the last built)."""
    kind = "slots" if route and route[0].startswith("segsum_slots") else "tiles"
    keys = [k for k in plan.tables if isinstance(k, tuple) and k[:2] == ("segsum", kind)]
    layout = plan.tables[keys[-1]]
    return {"R": layout["R"], **{key: t.numel() * t.element_size() / 1e6
                                 for key, t in layout.items() if torch.is_tensor(t)}}


def device_profile(fn, calls: int = 20):
    """Kernels one call of ``fn`` puts on the card, and each kernel's device
    microseconds a call, from a profiler trace of ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per_call = sum(e.count for e in rows) / calls
    return per_call, {_kernel_name(e.key): e.self_device_time_total / calls for e in rows}


def _kernel_name(key: str) -> str:
    """``segsum_tiles<double, 1, false>`` of a demangled kernel signature."""
    name = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:60]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--parent-cu", type=Path, default=None)
    parser.add_argument("--R", type=int, default=ssk.TILE_ROWS)
    parser.add_argument("--blocks-per-sm", type=int, default=ssk.BLOCKS_PER_SM)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_segsum: no CUDA card", file=sys.stderr)
        return 1
    ssk.TILE_ROWS, ssk.BLOCKS_PER_SM = args.R, args.blocks_per_sm
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.library("segsum")
    info = _build.build_info["segsum"]
    print(f"segsum.cu built in {info['seconds']} s (None: reused)")
    for line in ptxas_lines(info["log"]):
        print(f"  {line}")
    parent = parent_library(args.parent_cu) if args.parent_cu is not None else None

    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, LEVELS, N) for _ in range(2))
    stacked = stack([build_plan(a, LEVELS, device), build_plan(b, LEVELS, device)])
    cross = build_plan(a * LEVELS + b, LEVELS * LEVELS, device)
    codes2 = torch.as_tensor(np.concatenate([a, b + LEVELS]), device=device)
    xcodes = torch.as_tensor(a * LEVELS + b, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    ok = True
    for dtype, tol in ((torch.float64, chip_smoke.F64_TOL), (torch.float32, chip_smoke.F32_TOL)):
        r = torch.randn(N, dtype=dtype, device=device, generator=gen)
        wX = torch.randn(N, KD, dtype=dtype, device=device, generator=gen)
        r2, wX2 = r.repeat(2), wX.repeat(2, 1)
        W2 = 2 * LEVELS
        shapes = (
            ("stacked W=2000 m=1", stacked, r,
             lambda: torch.bincount(codes2, weights=r2, minlength=W2)),
            (f"stacked W=2000 m={KD}", stacked, wX,
             lambda: torch.zeros(W2, KD, dtype=dtype, device=device).index_add_(0, codes2, wX2)),
            ("cross W=10^6 m=1", cross, r,
             lambda: torch.bincount(xcodes, weights=r, minlength=LEVELS * LEVELS)),
        )
        for label, plan, v, library in shapes:
            before = dict(ssk.launches)
            first, second = ssk.segsum(v, plan), ssk.segsum(v, plan)
            route = [k for k in before if ssk.launches[k] != before[k]]
            want = ssk.segsum_plain(v, plan.perm, plan.bounds)
            mag = ssk.segsum_plain(v.abs().double(), plan.perm, plan.bounds)
            torch.cuda.synchronize()
            rel = float(((first.double() - want.double()).abs()
                         / mag.clamp_min(torch.finfo(torch.float64).tiny)).max())
            repeats = torch.equal(first, second)
            kernel = lambda: ssk.segsum(v, plan)  # noqa: E731
            n_launch, kernel_us = device_profile(kernel)
            ok &= repeats and rel <= tol and n_launch <= 2
            fns = {"kernel": kernel, "library": library}
            parent_rel = None
            if parent is not None:
                fns["parent"] = parent_call(parent, v, plan)
                got = fns["parent"]()
                torch.cuda.synchronize()
                parent_rel = float(((got.double() - want.double()).abs()
                                    / mag.clamp_min(torch.finfo(torch.float64).tiny)).max())
            turns = {key: [] for key in fns}
            for which in ("parent", "kernel", "library", "library", "kernel", "parent"):
                if which in fns:
                    turns[which].append(chip_smoke._time_ms(fns[which], reps=args.reps))
            mean = {key: sum(t) / len(t) for key, t in turns.items()}
            # the same calls issued by the host without the hold: what a
            # caller's step sees, host launches included
            unheld = {key: chip_smoke._time_ms(fn, reps=args.reps, hold=False)
                      for key, fn in fns.items() if key != "library"}
            bound_ms, bound_by = chip_smoke.segsum_bound(plan, v)
            m = 1 if v.ndim == 1 else v.shape[1]
            print(json.dumps({
                "shape": label,
                "dtype": str(dtype).replace("torch.", ""),
                "route": route,
                "blocks_per_sm": args.blocks_per_sm,
                "layout_mb": layout_mb(plan, route),
                "ms": mean["kernel"],
                "parent_ms": mean.get("parent"),
                "library_ms": mean["library"],
                "turns_ms": turns,
                "unheld_ms": unheld,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "kernel_over_bound": mean["kernel"] / bound_ms,
                "rel_err": rel,
                "parent_rel_err": parent_rel,
                "tol": tol,
                "repeats": repeats,
                "device_launches_a_call": n_launch,
                "kernel_us_a_call": kernel_us,
                "m": m,
                "card": card,
            }), flush=True)
            del first, second, want, mag
    print(json.dumps({"resident_blocks_per_sm": {str(k): v for k, v in ssk._resident.items()},
                      "tiles_route_cap": args.blocks_per_sm}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
