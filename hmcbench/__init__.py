"""The benchmark of dynamichmc_tpu_torch: one cell run once per process.

``python3 hmcbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Configurations, cells and
per-layer metric readers are files of their own (``configs/``,
``workloads/``, ``metrics/``), found by the names in ``BENCHMARK.json``;
``reference/`` is the yardstick (plain torch and numpy, nothing of the
port), ``targets/`` builds the port's model from the reference's data.
"""
