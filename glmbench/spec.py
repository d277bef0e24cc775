"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cell, its
configuration file and its traffic mix; the mix names its loop, the
configuration its data generator; each metric has a reader of its own.

Nothing here imports the program.
"""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_module(path: Path, prefix: str):
    """Import the file ``path`` as a module of its own (metric names hold
    dots, so their readers are loaded by path, not by import)."""
    name = f"glmbench_{prefix}_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(workload: str, root: Path = ROOT, here: Path = HERE, bench: dict = None) -> dict:
    """The cell ``workload``: its entry, configuration, mix, and the metrics
    it reports with ``--trace 0`` (``end_to_end``) and ``--trace 1``
    (``per_layer``)."""
    bench = benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())

    def reported(metric: dict, end_to_end: bool) -> bool:
        cells_of = metric.get("workloads")
        if cells_of is not None:
            return workload in cells_of
        if end_to_end:
            return True
        # without a list, a per-layer metric goes wherever its end-to-end one does
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return moved.get("workloads") is None or workload in moved["workloads"]

    return {
        "cell": cell,
        "config": config,
        "mix": mix,
        "end_to_end": [m for m in bench["end_to_end"] if reported(m, True)],
        "per_layer": [m for m in bench["per_layer"] if reported(m, False)],
    }


def loop_module(mix: dict, here: Path = HERE):
    return load_module(here / "loops" / f"{mix['loop']}.py", "loop")


def data_module(config: dict, here: Path = HERE):
    return load_module(here / "data" / f"{config['generator']}.py", "data")


def metric_reader(name: str, here: Path = HERE):
    """The reader of metric ``name``: ``metrics/<name>.py``, or else the
    reader of the quantity it splits by cell, ``metrics/<stem>.py`` for the
    name's part before its first dot (``device_idle`` reads
    ``device_idle.fit`` and ``device_idle.ops``)."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        path = here / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "metric")
