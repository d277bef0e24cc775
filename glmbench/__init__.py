"""glmbench: the benchmark of ``tabmat_torch`` on one CUDA card.

Run one cell from the repository root:

    python3 glmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``glmbench/configs/``, its traffic mix in
``glmbench/traffic/<mix>.json``, the loop the mix names in
``glmbench/loops/``, the data generator the configuration names in
``glmbench/data/`` and each metric's reader in ``glmbench/metrics/``.
The plain NumPy reference that decides ``correct`` is ``glmbench/reference/``.
"""
