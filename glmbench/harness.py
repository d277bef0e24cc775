"""One run of one cell: set up, warm up, measure for ``--seconds``, check
the window's outputs against the plain reference, print one JSON line.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs the
first requests of the window (the mix's ``trace_requests``) under
``torch.profiler``, then the rest of the window untraced, and reports the
per-layer metrics with the device's busy time and a breakdown.
"""

import argparse
import contextlib
import json
import sys
import time

import numpy as np

from glmbench import spec as specs
from glmbench.metrics import _trace

# modules that may not be loaded in the process that prints a result,
# compared by whole top-level name (the program's name begins with the
# JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tabmat_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="glmbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the program's float32 path in place of its float64 one: "
                        "the control whose readings have to fail the check")
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


class Run:
    """What a loop is given: the cell's pieces, the device, the spans."""

    def __init__(self, found, args, device, overrides=None):
        import torch

        import tabmat_torch

        self.torch, self.tt = torch, tabmat_torch
        self.mix = found["mix"]
        self.config = dict(found["config"], **(overrides or {}))
        self.data = specs.data_module(self.config)
        self.seed, self.device = args.seed, device
        self.dtype = np.float32 if args.control else np.float64
        self.spans = {}
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        """Times the block on the host clock; inside the traced window also
        a ``record_function`` range, ``glmbench/<name>``."""
        ranged = (self.torch.profiler.record_function(_trace.SPAN_PREFIX + name)
                  if self.tracing else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ranged:
            yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


def _profile(run, loop, records, count: int):
    """Run ``count`` requests under the profiler; the trace's summary."""
    torch = run.torch
    from torch.profiler import ProfilerActivity, profile

    run.sync()
    run.tracing = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            rec = loop.request(len(records))
            rec["traced"] = True
            records.append(rec)
        torch.cuda.synchronize(run.device)
    run.tracing = False
    return _trace.from_profiler(prof)


def window(run, loop, seconds: float, trace: bool):
    """The measured window: requests back to back (one client, a closed
    loop) until ``seconds`` have passed, then the one in progress finishes.
    Traced, the first requests run under the profiler and the window's
    seconds are those of the untraced rest.  Returns (records, window
    seconds, trace summary or None)."""
    records, summary, traced_s = [], None, 0.0
    if trace:
        t0 = time.perf_counter()
        summary = _profile(run, loop, records, int(run.mix["trace_requests"]))
        traced_s = time.perf_counter() - t0  # the requests and the trace's reduction
    t0 = time.perf_counter()
    while True:  # at least one request untraced
        rec = loop.request(len(records))
        rec["traced"] = False
        records.append(rec)
        if time.perf_counter() - t0 >= seconds - traced_s:
            return records, time.perf_counter() - t0, summary


def main(argv=None, t_start=None, device=None, overrides=None, out=None, bench=None) -> int:
    """Run a cell; the result is the last line on ``out`` (standard output).

    ``device``, ``overrides`` (keys of the configuration) and ``bench`` (in
    place of ``BENCHMARK.json``) are for tests, which drive a run on the CPU
    at a small size: a run of the benchmark passes none of them, and then
    needs as many CUDA cards as the cell asks for.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    out = sys.stdout if out is None else out
    args = parse_args(argv)
    found = specs.find(args.workload, bench=bench)
    import torch

    if device is None:
        chips = found["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"glmbench: the cell needs {chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    if args.trace and device.type != "cuda":
        print("glmbench: --trace 1 needs the card's trace", file=sys.stderr)
        return 2
    run = Run(found, args, device, overrides)
    loop = specs.loop_module(run.mix).Loop(run)
    loop.setup()
    loop.request(-1)  # the warm request, of the cell's own shapes
    run.sync()
    run.spans.clear()
    setup_s = time.perf_counter() - t_start

    records, window_s, summary = window(run, loop, args.seconds, bool(args.trace))
    if device.type == "cuda":
        memory_peak = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
    else:
        memory_peak, kind = 0, "cpu"
    found_modules = forbidden_modules()
    if found_modules:
        print(f"glmbench: the run loaded {found_modules}; the benchmark runs tabmat_torch "
              "alone", file=sys.stderr)
        return 3

    loop.free()
    checks = loop.check(records, np.random.default_rng([args.seed, 7]))
    correct = bool(checks) and all(value <= limit for _, value, limit in checks)

    ctx = {"records": records, "window_s": window_s, "setup_s": setup_s, "spans": run.spans,
           "trace": summary, "config": run.config, "device_name": kind}
    metrics = {}
    for metric in found["per_layer" if args.trace else "end_to_end"]:
        value = specs.metric_reader(metric["name"]).read(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
                   "count": 1 if device.type == "cuda" else 0,
                   "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": sum(1 for r in records if r["failed"]),
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_us"] * 1e-6
        device_info["window_s"] = summary["window_us"] * 1e-6
        result["breakdown"] = _trace.breakdown(summary)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(f"glmbench: {args.workload} seed {args.seed}: {len(records)} requests in "
          f"{window_s:.3f} s, set-up {setup_s:.3f} s", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
