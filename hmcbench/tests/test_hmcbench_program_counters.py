"""The readers of the port's own counters and spans (``warmup_mfu``,
``warmup_transition_host_us``, ``k1_transition_share``,
``host_reads_per_transition``): their arithmetic on a synthetic traced
record, None where the port has no such counter (as before it had them),
and each reading a traced call of a CPU-sized cell."""

import pytest

from conftest import CELLS, ROOT

from hmcbench import harness, registry
from hmcbench.reference import peaks
from hmcbench.trace import TraceRecord
from hmcbench.window import CallRecord, RunRecord

METRICS = ("warmup_mfu", "warmup_transition_host_us", "k1_transition_share",
           "host_reads_per_transition")
COUNTERS = {"tree_transition": 900 + 512 - 2,
            "tree_transition_declined": {"dtype": 0, "statistic": 0,
                                         "per_chain_metric": 2, "shape": 0},
            "transitions_warmup": 900, "transitions_draws": 512,
            "host_reads": {"init_check": 1, "search_loop": 9,
                           "search_check": 2},
            "warmup_steps": 2_700_000,
            "spans": {"dhmc.transition": {
                "warmup": {"count": 900, "ns": 900 * 1_250_000},
                "draws": {"count": 512, "ns": 512 * 2_000_000}}}}


def _run(launches, warmup_s=1.2, cell="gauss100_dense.fleet16k"):
    reg = registry.Registry(ROOT)
    work = reg.workload(cell)
    cfg = reg.config(work["config"])
    trace = TraceRecord(device=[], host=[], window_s=2.0, draws_start_s=1.2)
    call = CallRecord(wall_s=2.0, n_draws=1000, min_ess=1500.0,
                      draw_steps=15_000, launches=launches, warmup_s=warmup_s)
    return reg, RunRecord(cell=work, config=cfg,
                          reference=registry.reference(cfg["model"]),
                          setup_s=3.0, calls=[call], trace=trace)


def test_the_readers_arithmetic():
    reg, run = _run(dict(COUNTERS))
    read = {m: reg.reader(m)(run) for m in METRICS}
    leaf = 8 * 100**2 + 30 * 100
    assert read["warmup_mfu"] == pytest.approx(
        100 * 2_700_000 * leaf / 1.2 / peaks.FP32_FLOP_PER_S)
    assert read["warmup_transition_host_us"] == pytest.approx(1250.0)
    assert read["k1_transition_share"] == pytest.approx(100 * 1410 / 1412)
    assert read["host_reads_per_transition"] == pytest.approx(12 / 1412)
    assert {m["name"] for m in reg.metrics("logreg_1000x25.fleet16k", True)
            } >= set(METRICS)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("absent", ["all", "untraced", "no_transitions"])
def test_a_reader_returns_none_without_its_counters(metric, absent):
    """``all``: the port before it had the counters (its launch counts
    only); ``untraced``: the span aggregate and the steps, kept only under
    a profiler, missing; ``no_transitions``: nothing ran."""
    launches = {"tree_transition": 1412, "tree_transition_warp": 1412}
    if absent == "untraced":
        launches = {k: v for k, v in COUNTERS.items()
                    if k not in ("spans", "warmup_steps")}
    elif absent == "no_transitions":
        launches = dict(COUNTERS, transitions_warmup=0, transitions_draws=0,
                        spans={"dhmc.transition": {
                            "warmup": {"count": 0, "ns": 0}}})
        del launches["warmup_steps"]
    reg, run = _run(launches)
    value = reg.reader(metric)(run)
    if absent == "untraced" and metric in ("k1_transition_share",
                                           "host_reads_per_transition"):
        assert value is not None  # always-on counters
    else:
        assert value is None


def test_warmup_mfu_needs_the_traced_warmup_wall():
    reg, run = _run(dict(COUNTERS), warmup_s=None)
    assert reg.reader("warmup_mfu")(run) is None


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_each_reader_reads_a_traced_call_on_the_cpu(tiny_root, cell):
    """One traced call of the CPU twin: the plain versions stand in for
    the kernel, so no transition launches it (``k1_transition_share`` 0)
    and the plain driver's loops read the device (reads per transition
    above 1); every other reading is a positive number."""
    c = harness.Cell(cell, "cpu", tiny_root)
    record, _samples, trace = c.call(3, 0, traced=True)
    assert not record.failed, record.failure
    run = RunRecord(cell=c.workload, config=c.config, reference=c.reference,
                    setup_s=1.0, calls=[record], trace=trace)
    read = {m: c.reg.reader(m)(run) for m in METRICS}
    assert read["k1_transition_share"] == 0.0
    assert read["host_reads_per_transition"] > 1.0
    assert read["warmup_mfu"] > 0.0
    assert read["warmup_transition_host_us"] > 0.0
    counts = record.launches
    assert (counts["transitions_warmup"], counts["transitions_draws"]) == (
        60, 16)
    assert counts["warmup_steps"] >= 60 * 16
