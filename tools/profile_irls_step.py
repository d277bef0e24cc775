#!/usr/bin/env python3
"""Where one ``irls_step`` spends its time on a CUDA card.

Run from the repository root on a machine with a card:

    python3 tools/profile_irls_step.py
        [--design dense|dense_narrow|dense_wide|mixed|sparse|formula] [--n N] [--k K]
        [--levels 1000] [--repeats 3]

``--design dense`` (the default) steps a gaussian GLM on a ``DeviceDesign``
over an (n, k) float64 ``DenseMatrix``, 1,000,000 x 50 by default.
``--design dense_narrow`` is the same at the reference bench's dense design,
4,000,000 x 10 (``tabmat_tpu/bench/generate.py:70``; the narrow sandwich
kernel), and ``--design dense_wide`` at 400,000 x 160 (the FP64 tensor-core
kernel in f64 steps); ``--n`` and ``--k`` override those sizes.  ``--design mixed`` steps a poisson
GLM on the mixed design of ``bench.py:360-371``: a ``SplitMatrix`` of an
(n, 5) ``DenseMatrix`` and two categoricals of ``--levels`` levels each
(1,000,000 x 2005 by default).  ``--design sparse`` adds ``bench.py:282``'s
sparse block, 100 columns at 1% (``scipy.sparse.random``, seed 0), after
the dense one (1,000,000 x 2105 by default).  ``--design formula`` steps a
poisson GLM, the exposure as sample weights, on ``chip_smoke.py``'s
formula design: ``from_formula`` of its freMTPL2-shaped frame (678,013 x
42 by default: 7 dense columns and three categoricals).  All use ``n_cg=16``.  For each repeat and
each ``inner_precision`` it prints one JSON line:

- ``host_ms``: host-clock step times with a synchronise after each step
  (median, min, max over 20 steps);
- ``event_ms``: CUDA-event time per step over 20 steps issued back to back,
  and ``idle_share_events`` (1 - kernel time / ``event_ms``), the idle share
  without the profiler's own host cost;
- from a ``torch.profiler`` trace of 10 steps: ``kernel_ms`` (device time of
  all kernels per step), ``idle_share`` (1 - kernel time / traced wall
  time), ``launches`` (``cudaLaunchKernel`` calls per step), ``launch_host_ms``
  (their host time per step) and the twelve kernels with the most device
  time (names cut to 120 characters);
- ``tabmat_kernel_ms``: device ms per step of each hand-written kernel,
  its instantiations together;
- ``tabmat_launches``: launches per step of each hand-written kernel, from
  the wrappers' own counts.

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
# design -> its default (n, k); the mixed and sparse designs take --levels
SIZES = {"dense": (1_000_000, 50), "dense_narrow": (4_000_000, 10), "dense_wide": (400_000, 160),
         "mixed": (1_000_000, 5), "sparse": (1_000_000, 5), "formula": (678_013, 42)}


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
        "top": [(name[:120], ms) for name, ms in sorted(kernels, key=lambda kv: -kv[1])[:12]],
        "tabmat_kernel_ms": tabmat_kernel_ms(kernels),
    }, prof


def tabmat_kernel_ms(kernels) -> dict:
    """Device ms per step of each hand-written kernel (``segsum_tiles``,
    ``segsum_join_blocks``, ...), all instantiations together: the kernels
    of ``tabmat_torch/csrc`` live in an anonymous namespace or in
    ``tabmat::``."""
    out = {}
    for key, ms in kernels:
        found = [(key.find(space), space) for space in ("(anonymous namespace)::", "tabmat::")
                 if space in key]
        if found:
            space = min(found)[1]
            name = key.split(space, 1)[1].split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + ms
    return out


def _kernel_modules():
    from tabmat_torch.ops import gather_kernel, sandwich_kernel, segsum_kernel, spmv_kernel

    return sandwich_kernel, gather_kernel, segsum_kernel, spmv_kernel


def tabmat_launches(step) -> dict:
    """Launches of each hand-written kernel in one ``step()``."""
    for module in _kernel_modules():
        module.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    counts = {}
    for module in _kernel_modules():
        counts.update({name: c for name, c in module.launches.items() if c})
    return counts


def design_and_target(kind: str, n: int, k: int, levels: int, device):
    """``(design, y, family, sample weights)`` for the dense, mixed, sparse or
    formula design, from a seed; the weights are None for all but the formula
    design's."""
    rng = np.random.default_rng(7)
    if kind.startswith("dense"):
        X = rng.standard_normal((n, k))
        design = DeviceDesign.from_matrix(tt.DenseMatrix(X, device=device))
        y = X @ rng.standard_normal(k) + 0.1 * rng.standard_normal(n)
        return design, torch.as_tensor(y, device=device), "gaussian", None
    if kind == "formula":
        from chip_smoke import FREQ_FORMULA, freq_frame

        frame = freq_frame(n, rng)
        design = DeviceDesign.from_matrix(tt.from_formula(
            FREQ_FORMULA, frame, include_intercept=True, ensure_full_rank=True, device=device))
        return (design, torch.tensor(frame["ClaimNb"].to_numpy(np.float64), device=device),
                "poisson", torch.tensor(frame["Exposure"].to_numpy(np.float64), device=device))
    Xd = rng.standard_normal((n, 5))
    codes = [rng.integers(0, levels, n) for _ in range(2)]
    sparse = []
    if kind == "sparse":
        from scipy import sparse as sps

        sparse = [sps.random(n, 100, density=0.01, random_state=0, format="csc")]
    split = tt.SplitMatrix(
        [tt.DenseMatrix(Xd, device=device)]
        + [tt.SparseMatrix(Xs, device=device) for Xs in sparse]
        + [tt.CategoricalMatrix(c, categories=np.arange(levels), device=device) for c in codes]
    )
    design = DeviceDesign.from_matrix(split)
    eta = Xd @ (rng.standard_normal(5) * 0.05)
    for Xs in sparse:
        eta += Xs @ (rng.standard_normal(Xs.shape[1]) * 0.1)
    for c in codes:
        eta += (rng.standard_normal(levels) * 0.1)[c]
    y = rng.poisson(np.exp(eta)).astype(np.float64)
    return design, torch.as_tensor(y, device=device), "poisson", None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--design", choices=tuple(SIZES), default="dense")
    parser.add_argument("--n", type=int, default=None, help="rows (default by design)")
    parser.add_argument("--k", type=int, default=None,
                        help="the dense designs' width (default by design)")
    parser.add_argument("--levels", type=int, default=1000,
                        help="levels of each categorical of the mixed design")
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
    n_default, k_default = SIZES[args.design]
    design, y, family, w = design_and_target(args.design, args.n or n_default,
                                             args.k or k_default, args.levels, device)
    n, k = design.shape
    if w is None:
        w = torch.ones(n, dtype=torch.float64, device=device)
    b0 = torch.zeros(k, dtype=torch.float64, device=device)

    prof = None
    for rep in range(args.repeats):
        for inner in ("float64", "float32"):
            def step():
                return irls_step(design, y, w, b0, family=family, n_cg=N_CG,
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
                "repeat": rep, "design": args.design, "family": family, "inner": inner,
                "n": n, "k": k, "n_cg": N_CG,
                "host_ms": {"median": statistics.median(host), "min": min(host), "max": max(host)},
                "event_ms": event_ms,
                "idle_share_events": 1.0 - trace["kernel_ms"] / event_ms,
                **trace,
                "tabmat_launches": tabmat_launches(step),
                "card": card,
            }), flush=True)
    out = ROOT / "chiprun_out" / "profile_irls_step.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
