"""The benchmark's own tests: ``python -m pytest -q hmcbench/tests`` from
the root of a checkout (on the CPU; the tests marked ``gpu`` need a card:
``python -m pytest -q -m gpu hmcbench/tests``)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = {"gauss100_dense.fleet16k": "gauss100_dense.tiny",
         "logreg_1000x25.fleet16k": "logreg_1000x25.tiny"}
SHORT_WARMUP = {"init_steps": 20, "middle_steps": 20, "doubling_stages": 1,
                "terminating_steps": 20}
# The twins' limit on the fold: at 16 chains x 16 draws after a
# 60-transition warmup the metric comes from 320 unconverged draws, so
# sound twins read metric_fold up to about 53 (the Gaussian, sds 0.01..1)
# and 0.3 (the logistic regression); the identity metric reads 10,000 and
# 176. The cells' own limits are set on the card at their own size.
TINY_LIMITS = {"gaussian": {"metric_fold": 500},
               "logistic_regression": {"metric_fold": 10}}
TINY_REFERENCE_DRAWS = 1 << 15


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tiny_root(dest: str) -> str:
    """A checkout's benchmark files under ``dest`` with, beside each cell, a
    CPU-sized twin: the same configuration and route with a short warmup
    (configs/<config>.tiny.json), 16 chains and 16 draws."""
    bench_dir = os.path.join(dest, "hmcbench")
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(ROOT, "hmcbench", sub),
                        os.path.join(bench_dir, sub))
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    for cell, tiny in CELLS.items():
        work = _load(os.path.join(bench_dir, "workloads", cell + ".json"))
        config = _load(os.path.join(bench_dir, "configs",
                                    work["config"] + ".json"))
        config.update(name=config["name"] + ".tiny", warmup=SHORT_WARMUP)
        if "reference_draws" in config:
            config["reference_draws"] = TINY_REFERENCE_DRAWS
        _dump(config, os.path.join(bench_dir, "configs",
                                   config["name"] + ".json"))
        work.update(name=tiny, config=config["name"], chains=16, draws=16,
                    check_draws=64,
                    limits=dict(work["limits"], **TINY_LIMITS[config["model"]]))
        _dump(work, os.path.join(bench_dir, "workloads", tiny + ".json"))
        entry = dict(bench_entry(bench, cell), name=tiny,
                     config=config["name"])
        bench["workloads"].append(entry)
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if cell in metric.get("workloads", []):
                metric["workloads"].append(tiny)
    _dump(bench, os.path.join(dest, "BENCHMARK.json"))
    return dest


def bench_entry(bench, cell):
    return next(w for w in bench["workloads"] if w["name"] == cell)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny_root")))


@pytest.fixture
def cuda():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
