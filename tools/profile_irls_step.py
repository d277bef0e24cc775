#!/usr/bin/env python3
"""Where one ``irls_step`` spends its time on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/profile_irls_step.py [--n 1000000] [--k 50] [--repeats 3]

For each repeat and each ``inner_precision`` (gaussian, ``n_cg=16``, a
``DeviceDesign`` over a float64 ``DenseMatrix``) it prints one JSON line:

- ``host_ms``: host-clock step times with a synchronise after each step
  (median, min, max over 20 steps);
- ``event_ms``: CUDA-event time per step over 20 steps issued back to back,
  and ``idle_share_events`` (1 - kernel time / ``event_ms``), the idle share
  without the profiler's own host cost;
- from a ``torch.profiler`` trace of 10 steps: ``kernel_ms`` (device time of
  all kernels per step), ``idle_share`` (1 - kernel time / traced wall
  time), ``launches`` (``cudaLaunchKernel`` calls per step), ``launch_host_ms``
  (their host time per step) and the five kernels with the most device time.

The first line is the card's name and power limit.  The full profiler table
of the last trace goes to ``chiprun_out/profile_irls_step.txt``.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import tabmat_torch as tt  # noqa: E402
from tabmat_torch.glm import irls_step  # noqa: E402
from tabmat_torch.parallel.design import DeviceDesign  # noqa: E402

N_CG = 16


def profile(step, steps: int = 10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    # rows of device activity (kernels, copies); the host ops that launched
    # them report the same time again, so they are left out
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps)
               for e in rows if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(ms for _, ms in kernels)
    launch = [e for e in rows if e.key == "cudaLaunchKernel"]
    return {
        "kernel_ms": kernel_ms,
        "idle_share": 1.0 - kernel_ms * steps / wall_ms,
        "traced_wall_ms": wall_ms / steps,
        "launches": sum(e.count for e in launch) / steps,
        "launch_host_ms": sum(e.self_cpu_time_total for e in launch) / 1e3 / steps,
        "top": sorted(kernels, key=lambda kv: -kv[1])[:5],
    }, prof


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--k", type=int, default=50)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_irls_step: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    device = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((args.n, args.k))
    design = DeviceDesign.from_matrix(tt.DenseMatrix(X, device=device))
    y = torch.as_tensor(X @ rng.standard_normal(args.k) + 0.1 * rng.standard_normal(args.n),
                        device=device)
    w = torch.ones(args.n, dtype=torch.float64, device=device)
    b0 = torch.zeros(args.k, dtype=torch.float64, device=device)

    prof = None
    for rep in range(args.repeats):
        for inner in ("float64", "float32"):
            def step():
                return irls_step(design, y, w, b0, family="gaussian", n_cg=N_CG,
                                 inner_precision=inner)

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            host = []
            for _ in range(20):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                step()
            stop.record()
            stop.synchronize()
            event_ms = start.elapsed_time(stop) / 20
            trace, prof = profile(step)
            print(json.dumps({
                "repeat": rep, "inner": inner, "n": args.n, "k": args.k, "n_cg": N_CG,
                "host_ms": {"median": statistics.median(host), "min": min(host), "max": max(host)},
                "event_ms": event_ms,
                "idle_share_events": 1.0 - trace["kernel_ms"] / event_ms,
                **trace,
                "card": card,
            }), flush=True)
    out = ROOT / "chiprun_out" / "profile_irls_step.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
