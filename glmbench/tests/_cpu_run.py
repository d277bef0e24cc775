"""Drive a whole run of a cell on the CPU at a small size, for the tests:
the harness's look for a card is skipped (``device="cpu"``)."""

import copy
import io
import json

from glmbench.harness import main
from glmbench.spec import benchmark, find

SEED = 3_000_000_019  # past 32 signed bits, as a run's seed may be
# rows at which a configuration runs here, by the configuration's name
SMALL_ROWS = {"fremtpl2_poisson": 6000}
DEFAULT_ROWS = 20000

# cells whose mix, configuration and metrics stay in the benchmark's folder
# for a later entry in BENCHMARK.json (PERF.md, Open questions): the tests
# run them as they run the benchmark's own cells
LATER_CELLS = [
    {"name": "fremtpl2.path", "config": "fremtpl2_poisson", "traffic": "path", "chips": 1,
     "why": "an l2 path on one freMTPL2 design"},
    {"name": "dense_cat.path", "config": "tabmat_dense_cat", "traffic": "path", "chips": 1,
     "why": "an l2 path on one dense_cat design"},
]


def bench() -> dict:
    """BENCHMARK.json with the later cells, which report ``fit_s`` and
    ``fit_s_p95`` and the per-layer metrics that move ``fit_s``."""
    out = copy.deepcopy(benchmark())
    names = [cell["name"] for cell in LATER_CELLS]
    out["workloads"] += copy.deepcopy(LATER_CELLS)
    for metric in out["end_to_end"] + out["per_layer"]:
        if "fit_s" in (metric["name"], metric.get("moves")) and metric.get("workloads"):
            metric["workloads"] += names
    out["end_to_end"].append({"name": "fit_s_p95", "unit": "s", "better": "lower", "bound": 0.25,
                              "source": "host_clock", "workloads": names})
    return out


BENCH = bench()
CELLS = [cell["name"] for cell in BENCH["workloads"]]


def cpu_run(workload: str, seconds: float = 0.3, control: bool = False, seed: int = SEED,
            rows: int = None):
    """(exit code, the result line as a dict, every line printed)."""
    out = io.StringIO()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", "0"] + (["--control"] if control else [])
    config = find(workload, bench=BENCH)["cell"]["config"]
    rows = rows or SMALL_ROWS.get(config, DEFAULT_ROWS)
    rc = main(argv, device="cpu", overrides={"rows": rows}, out=out, bench=BENCH)
    lines = out.getvalue().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), lines
