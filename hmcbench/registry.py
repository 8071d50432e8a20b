"""Finding a run's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. Each cell is ``hmcbench/workloads/<cell>.json``, each
configuration ``hmcbench/configs/<config>.json``, each metric's reader
``hmcbench/metrics/<metric>.py`` (a function ``read(run)`` that returns a
number, or None where it finds nothing to read), and each model kind (a
configuration's ``model``) a module in ``hmcbench/reference/`` and one in
``hmcbench/targets/``. Adding a cell, a configuration or a metric adds
files and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not NAME.fullmatch(name or ""):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Registry:
    """The benchmark's files under ``root`` (a checkout)."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "hmcbench")
        self.benchmark = _load_json(os.path.join(root, "BENCHMARK.json"))

    def cell_entry(self, cell: str) -> dict:
        """The cell's entry of ``BENCHMARK.json``'s ``workloads``."""
        for entry in self.benchmark["workloads"]:
            if entry["name"] == cell:
                return entry
        raise KeyError(f"BENCHMARK.json lists no workload {cell!r}")

    def workload(self, cell: str) -> dict:
        return _load_json(os.path.join(self.dir, "workloads",
                                       _checked(cell) + ".json"))

    def config(self, name: str) -> dict:
        return _load_json(os.path.join(self.dir, "configs",
                                       _checked(name) + ".json"))

    def metrics(self, cell: str, traced: bool) -> list:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        untraced (those with a ``workloads`` list, in those cells only), its
        per-layer metrics traced (each names its cells in ``workloads``)."""
        if not traced:
            return [m for m in self.benchmark["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        return [m for m in self.benchmark["per_layer"]
                if cell in m["workloads"]]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = os.path.join(self.dir, "metrics", _checked(metric) + ".py")
        module_name = "hmcbench_metric_" + re.sub(r"\W", "_", metric)
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def reference(model: str):
    """The reference module of a model kind (plain torch, no port)."""
    return importlib.import_module(f"hmcbench.reference.{_checked(model)}")


def target(model: str):
    """The module that builds the port's model of a model kind."""
    return importlib.import_module(f"hmcbench.targets.{_checked(model)}")
