"""The reader of ``k3_tiled_share``: its arithmetic on synthetic launch
counts, None where the port has no such counter (as before it had one) or
launched no fused logreg leaf, and a traced call of the hierarchical
logistic regression's CPU twin, where the plain version stands in for the
kernel. No cell lists the metric yet: BENCHMARK.json gains its entry with
the change to test_hmcbench_logreg_hier.py that lets the hierarchical
cell report more than its three traced metrics."""

import pytest

from conftest import ROOT

from hmcbench import harness, registry
from hmcbench.trace import TraceRecord
from hmcbench.window import CallRecord, RunRecord
from test_hmcbench_logreg_hier import TWIN, hier_root, one_reference  # noqa: F401

METRIC = "k3_tiled_share"
CELL = "logreg_hier_1000x302.fused16k"


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
    # every launch tiled, as at the hierarchical cell's K = 302
    ({"logreg_fused_leaf": 10676, "logreg_fused_leaf_hier": 10676,
      "logreg_fused_leaf_tiled": 10676}, 100.0),
    # none: K past the tiled kernel's widest
    ({"logreg_fused_leaf": 10676, "logreg_fused_leaf_hier": 10676,
      "logreg_fused_leaf_tiled": 0}, 0.0),
    ({"logreg_fused_leaf": 1000, "logreg_fused_leaf_tiled": 250}, 25.0),
    # the port before the counter: its other launch counts only
    ({"logreg_fused_leaf": 10676, "logreg_fused_leaf_hier": 10676}, None),
    # no fused leaf launched: nothing to share out
    ({"logreg_fused_leaf": 0, "logreg_fused_leaf_tiled": 0}, None),
    ({"tree_transition": 1412, "tree_transition_warp": 1412}, None),
])
def test_the_share_of_tiled_launches(launches, share):
    reg, run = _run(launches)
    value = reg.reader(METRIC)(run)
    assert value == (None if share is None else pytest.approx(share))


def test_a_traced_cpu_call_reads_no_share(hier_root):  # noqa: F811
    """On the CPU the plain version stands in for the kernel: no launch,
    so no share (the metric is left out of the line)."""
    c = harness.Cell(TWIN, "cpu", hier_root)
    record, _samples, trace = c.call(3, 0, traced=True)
    assert not record.failed, record.failure
    assert record.launches["logreg_fused_leaf_tiled"] == 0
    run = RunRecord(cell=c.workload, config=c.config, reference=c.reference,
                    setup_s=1.0, calls=[record], trace=trace)
    assert c.reg.reader(METRIC)(run) is None
