#!/usr/bin/env python3
"""Time the table gather ``gather<T>`` alone on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/time_gather.py [--reps 20] [--parent-cu DIR]

It prints the card's name and power limit, builds ``csrc/gather.cu`` and
prints what ``ptxas`` reported for each of its kernels.  ``--parent-cu DIR``
names a directory holding another commit's ``gather.cu`` (its C interface
``tabmat_gather_f64(table, table_len, codes, n, C, out, stream)``) and,
where present, that commit's ``ops/gather_kernel.py`` beside it, for
example written with ``git show <commit>:tabmat_torch/csrc/gather.cu``; it
is built with the same flags into ``build/gather_parent/`` and called
through its own wrapper (else through this one), so that ``unheld_ms``
compares the two wrappers' host time too.

The shapes (``SHAPES``): 1M rows at C = 1 in f32 over a 1,000-entry table
(``PERF.md`` row 9); 1M rows at C = 2 in f64 over two stacked 1000-level
categoricals and their pad code (row 10: the mixed step's cat block); the
formula step's three categoricals, 678,013 rows at C = 3 over 6 + 11 + 22
entries; the reference bench's ``dense_cat`` cat block, 3M rows at C = 2
(``tabmat_tpu/bench/generate.py:76``); its ``one_cat``, 1M rows over
100,000 entries; 16M rows at C = 1 in f32 (128 MB, past the 50 MB L2); and
the window take (rows 11-12), 10^6 + 1 sorted indices into 1M + 1 values
(``chip_smoke.py`` phase 3's), in both types.  Codes are made on the card
from a seed, with 1% sentinels.

For each shape it checks every build bit for bit against ``gather_plain``
and against itself across two launches, then times in turns (parent,
kernel, library, library, kernel, parent), each ``--reps`` calls held back
to back (``chip_smoke._time_ms``: warm, the codes in L2 where they fit):
``ms``, ``parent_ms`` and ``library_ms`` (``table[codes]`` at C = 1, ``embedding_bag`` at C > 1, over
the table with a zero appended and int64 codes whose sentinels point at
it, made beforehand); at C = 1 also ``copy_ms``, PyTorch's copy of the n
int32 codes into n values, the same bytes without the table.  ``unheld_ms``: the same calls issued without
the hold, host launches included.  ``cold_ms``: each call after a write of
128 MB (``bitwise_not_`` of a buffer), so its data comes from device
memory, from CUDA events around each call with the stream held while the
host queues them, and ``profiler_us``: each kernel's device microseconds a
call from a ``torch.profiler`` trace of the same calls, warm and cold.  The
cold figure is the one to hold against ``bound_ms``
(``chip_smoke.gather_bound``).  One JSON line a shape.  Exits 1 without a
card or when a build is not exact or does not repeat.
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
from tabmat_torch.ops import gather_kernel as gk  # noqa: E402

M = 1_000_000
# (label, rows, type, the planes' table widths; or "window" for the window take)
SHAPES = (
    ("1M C=1 f32 table 1000", M, torch.float32, (1000,)),
    ("1M C=2 f64 tables 1000+1000 (mixed step)", M, torch.float64, (1000, 1000)),
    ("formula 678013 C=3 f64 tables 6+11+22", 678_013, torch.float64, (6, 11, 22)),
    ("dense_cat 3M C=2 f64 tables 1000+1000", 3 * M, torch.float64, (1000, 1000)),
    ("one_cat 1M C=1 f64 table 100000", M, torch.float64, (100_000,)),
    ("16M C=1 f32 table 1000", 16 * M, torch.float32, (1000,)),
    ("window take f32 1000001 sorted into 1000001", M + 1, torch.float32, "window"),
    ("window take f64 1000001 sorted into 1000001", M + 1, torch.float64, "window"),
)
FLUSH_BYTES = 128 * 2**20  # written between cold calls: more than the 50 MB L2
SENTINELS = 0.01


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "Compiling entry function" in line or "Used" in line or "spill" in line]


def build(source: Path, out_dir: str) -> ctypes.CDLL:
    """``source`` built with ``_build``'s flags into ``build/<out_dir>/``,
    its C functions typed as ``gather_kernel`` types them."""
    out = ROOT / "build" / out_dir / "libgather.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    print(f"{source} built in {time.perf_counter() - t0:.1f} s; ptxas:")
    for line in ptxas_lines(proc.stdout + proc.stderr):
        print(f"  {line}")
    lib = ctypes.CDLL(str(out))
    for symbol in gk._SYMBOLS.values():
        getattr(lib, symbol).argtypes = gk._ARGTYPES
        getattr(lib, symbol).restype = ctypes.c_int
    lib.tabmat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tabmat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def wrapper(path: Path, name: str, lib):
    """A fresh instance of the wrapper module at ``path``, bound to ``lib``."""
    spec = importlib.util.spec_from_file_location(f"tabmat_torch.ops.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._lib = lib
    return module


def make_inputs(rows, dtype, widths, gen, device):
    """``(table, codes, rows, library)`` of one shape."""
    if widths == "window":
        src = torch.randn(M + 1, dtype=dtype, device=device, generator=gen)
        idx = torch.sort(torch.randint(0, M + 1, (rows,), device=device, generator=gen)).values
        idx32, idx64 = idx.to(torch.int32), idx
        return src, idx32, rows, lambda: src[idx64]
    width = sum(widths)
    table = torch.randn(width, dtype=dtype, device=device, generator=gen)
    planes, off = [], 0
    for w in widths:  # each plane offset by the widths before it, as the design stacks them
        c = torch.randint(0, w, (rows,), device=device, generator=gen) + off
        missing = torch.rand(rows, device=device, generator=gen) < SENTINELS
        planes.append(torch.where(missing, -1 if len(widths) == 1 else width, c))
        off += w
    codes = torch.cat(planes).to(torch.int32)
    # the library's codes: a sentinel turned into the index of a zero
    # appended to the table, in int64, made here and not timed
    padded = torch.cat([table, table.new_zeros(1)])
    pad = torch.where((codes >= 0) & (codes < width), codes, width).long()
    if len(widths) == 1:
        return table, codes, rows, lambda: padded[pad]
    from torch.nn import functional as F

    bags = pad.view(len(widths), rows).T.contiguous()
    return table, codes, rows, lambda: F.embedding_bag(bags, padded[:, None], mode="sum")


def cold_ms(fn, flush, reps: int) -> float:
    """Mean device ms of ``fn`` with ``flush`` before each call, from CUDA
    events around each call, the stream held while the host queues them."""
    fn()
    cycles = chip_smoke.HOLD_CYCLES
    while True:
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        slept, start = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        for a, b in pairs:
            flush()
            a.record()
            fn()
            b.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms < slept.elapsed_time(start):
            return sum(a.elapsed_time(b) for a, b in pairs) / reps
        cycles *= 4


def profiler_us(fn, flush=None, calls: int = 20) -> dict:
    """Device microseconds a call of each kernel ``fn`` launches, from a
    ``torch.profiler`` trace of ``calls`` calls (``flush`` before each, its
    kernel left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "bitwise_not" not in e.key:
            key = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            out[key.split("(")[0][:70]] = e.self_device_time_total / calls
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--parent-cu", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_gather: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    gk._library()
    info = _build.build_info["gather"]
    print(f"gather.cu built in {info['seconds']} s (None: reused); ptxas:")
    for line in ptxas_lines(info["log"]):
        print(f"  {line}")
    impls = {"kernel": gk.gather}
    if args.parent_cu is not None:
        lib = build(args.parent_cu / "gather.cu", "gather_parent")
        theirs = args.parent_cu / "gather_kernel.py"
        here = ROOT / "tabmat_torch" / "ops" / "gather_kernel.py"
        impls["parent"] = wrapper(theirs if theirs.exists() else here, "_parent_gather", lib).gather
    flush_buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=device)
    flush = flush_buf.bitwise_not_
    gen = torch.Generator(device=device).manual_seed(3)
    ok = True
    for label, rows, dtype, widths in SHAPES:
        table, codes, n, library = make_inputs(rows, dtype, widths, gen, device)
        C = codes.numel() // n
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        want = gk.gather_plain(table, codes, n).view(bits)
        exact, repeats = {}, {}
        for key, fn in impls.items():
            first, second = fn(table, codes, n), fn(table, codes, n)
            torch.cuda.synchronize()
            exact[key] = torch.equal(first.view(bits), want)
            repeats[key] = torch.equal(first.view(bits), second.view(bits))
            ok &= exact[key] and repeats[key]
        calls = {key: (lambda fn=fn: fn(table, codes, n)) for key, fn in impls.items()}
        calls["library"] = library
        if C == 1:  # the same bytes (n codes in, n values out) through PyTorch's copy kernel
            dst = torch.empty(n, dtype=dtype, device=device)
            calls["copy"] = lambda: dst.copy_(codes)
        order = ["parent", "kernel", "library", "copy"]
        turns = {key: [] for key in calls}
        for which in order + order[::-1]:
            if which in calls:
                turns[which].append(chip_smoke._time_ms(calls[which], reps=args.reps))
        mean = {key: sum(t) / len(t) for key, t in turns.items()}
        unheld = {key: chip_smoke._time_ms(fn, reps=args.reps, hold=False)
                  for key, fn in calls.items() if key not in ("library", "copy")}
        cold = {key: cold_ms(fn, flush, args.reps) for key, fn in calls.items()}
        prof = {key: {"warm": profiler_us(fn), "cold": profiler_us(fn, flush)}
                for key, fn in calls.items()}
        bound_ms, bound_by = chip_smoke.gather_bound(n, C, table.numel(), table.element_size())
        print(json.dumps({
            "shape": label,
            "dtype": str(dtype).replace("torch.", ""),
            "rows": n,
            "C": C,
            "table_len": table.numel(),
            "ms": mean["kernel"],
            "parent_ms": mean.get("parent"),
            "library_ms": mean["library"],
            "copy_ms": mean.get("copy"),
            "turns_ms": turns,
            "unheld_ms": unheld,
            "cold_ms": cold,
            "profiler_us": prof,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_over_ms": bound_ms / mean["kernel"],
            "bound_over_cold_ms": bound_ms / cold["kernel"],
            "exact": exact,
            "repeats": repeats,
            "card": card,
        }), flush=True)
        del table, codes, want, calls, library
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
