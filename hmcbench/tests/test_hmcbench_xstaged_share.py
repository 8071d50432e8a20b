"""The reader of ``k1_xstaged_share``: its arithmetic on synthetic launch
counts, None where the port has no such counter (as before it had one) or
launched no tree kernel, and a traced call of the logistic regression's
CPU twin, where the plain version stands in for the kernel."""

import pytest

from conftest import ROOT

from hmcbench import harness, registry
from hmcbench.trace import TraceRecord
from hmcbench.window import CallRecord, RunRecord

METRIC = "k1_xstaged_share"
CELL = "logreg_1000x25.fleet16k"


def _run(launches):
    reg = registry.Registry(ROOT)
    work = reg.workload(CELL)
    cfg = reg.config(work["config"])
    trace = TraceRecord(device=[], host=[], window_s=2.0, draws_start_s=1.2)
    call = CallRecord(wall_s=2.0, n_draws=1000, min_ess=1500.0,
                      draw_steps=15_000, launches=launches, warmup_s=1.2)
    return reg, RunRecord(cell=work, config=cfg,
                          reference=registry.reference(cfg["model"]),
                          setup_s=3.0, calls=[call], trace=trace)


@pytest.mark.parametrize("launches,share", [
    # every launch staged, as at the logistic regression's 1000 x 25
    ({"tree_transition": 1412, "tree_transition_warp": 0,
      "tree_transition_xstaged": 1412}, 100.0),
    # none: the CTA variant (an X that does not fit) or the warp variant
    ({"tree_transition": 1412, "tree_transition_warp": 0,
      "tree_transition_xstaged": 0}, 0.0),
    ({"tree_transition": 1412, "tree_transition_warp": 1412,
      "tree_transition_xstaged": 0}, 0.0),
    ({"tree_transition": 1000, "tree_transition_warp": 0,
      "tree_transition_xstaged": 250}, 25.0),
    # the port before the counter: its other launch counts only
    ({"tree_transition": 1412, "tree_transition_warp": 0}, None),
    # no tree-kernel launch: nothing to share out
    ({"tree_transition": 0, "tree_transition_warp": 0,
      "tree_transition_xstaged": 0}, None),
])
def test_the_share_of_staged_launches(launches, share):
    reg, run = _run(launches)
    value = reg.reader(METRIC)(run)
    assert value == (None if share is None else pytest.approx(share))


def test_the_metric_is_listed_for_the_logreg_cell_alone():
    reg = registry.Registry(ROOT)
    assert METRIC in {m["name"] for m in reg.metrics(CELL, True)}
    assert METRIC not in {m["name"] for m in
                          reg.metrics("gauss100_dense.fleet16k", True)}


def test_a_traced_cpu_call_reads_no_share(tiny_root):
    """On the CPU the plain version stands in for the kernel: no launch,
    so no share (the metric is left out of the line)."""
    c = harness.Cell("logreg_1000x25.tiny", "cpu", tiny_root)
    record, _samples, trace = c.call(3, 0, traced=True)
    assert not record.failed, record.failure
    assert record.launches["tree_transition_xstaged"] == 0
    run = RunRecord(cell=c.workload, config=c.config, reference=c.reference,
                    setup_s=1.0, calls=[record], trace=trace)
    assert c.reg.reader(METRIC)(run) is None
