"""The program's spans and counters (profiling.py, ``ops.launch_counts()``)
on the CPU, through run_chains on a few chains of a Gaussian and a
logistic regression, each through the tree kernel's hook (its plain
version here): nothing is kept or opened without a profiler, the draws do
not change under one, and each counter counts what it names."""

import json
import os

import pytest
import torch

from dynamichmc_tpu_torch import profiling, run_chains
from dynamichmc_tpu_torch.hamiltonian import EvaluatedPoint
from dynamichmc_tpu_torch.metric import diagonal_metric, identity_metric
from dynamichmc_tpu_torch.models import logistic_regression, mvnormal
from dynamichmc_tpu_torch.nuts import NUTS
from dynamichmc_tpu_torch.ops import launch_counts, reset_launch_counts
from dynamichmc_tpu_torch.ops import tree_kernel
from dynamichmc_tpu_torch.parallel.chains import init_chain_states
from dynamichmc_tpu_torch.warmup import default_warmup_stages, run_warmup

F32 = torch.float32
CHAINS, DRAWS = 4, 12
STAGES = default_warmup_stages(init_steps=20, middle_steps=20,
                               doubling_stages=1, terminating_steps=20,
                               metric_kind="diagonal", pooled=True)
WARMUP_TRANSITIONS = 60


def _gaussian():
    sds = torch.linspace(0.5, 1.5, 3, dtype=torch.float64)
    return mvnormal(torch.zeros(3), torch.diag(sds ** 2), dtype=F32,
                    device="cpu", tree_kernel=True)


def _logreg():
    return logistic_regression(40, 3, dtype=F32, device="cpu",
                               tree_kernel=True)


MODELS = {"gaussian": _gaussian, "logreg": _logreg}


def _run(ld, seed=0, stages=STAGES, **kw):
    reset_launch_counts()
    res = run_chains(torch.Generator().manual_seed(seed), ld, CHAINS, DRAWS,
                     tune="reference", warmup_stages=stages,
                     algorithm=NUTS(max_depth=4), dtype=F32, **kw)
    return res, launch_counts()


def _raise(*args, **kwargs):
    raise AssertionError("record_function opened")


@pytest.fixture(params=sorted(MODELS))
def ld(request):
    return MODELS[request.param]()


def test_without_a_profiler_nothing_is_opened_or_kept(ld, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert not torch.autograd._profiler_enabled()
    _res, counts = _run(ld)
    assert not {"spans", "warmup_steps", "draw_steps"} & set(counts)
    assert profiling._record.kept == {} and profiling._record.spans == {}
    assert counts["transitions_draws"] == DRAWS


def test_the_draws_are_bitwise_the_same_under_a_profiler(ld, monkeypatch):
    """Under the harness's kind of profiler the spans only aggregate: no
    record_function opens outside ``profiling.trace``."""
    plain, _ = _run(ld, seed=5)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with torch.profiler.profile():
        traced, counts = _run(ld, seed=5)
    for name in ("positions", "logdensities", "eps"):
        assert torch.equal(getattr(plain, name), getattr(traced, name)), name
    assert torch.equal(plain.metric.m_inv, traced.metric.m_inv)
    assert torch.equal(plain.tree_statistics.steps,
                       traced.tree_statistics.steps)
    assert counts["spans"]["dhmc.transition"]["warmup"]["count"] == (
        WARMUP_TRANSITIONS)
    assert counts["spans"]["dhmc.transition"]["draws"]["count"] == DRAWS


@pytest.mark.parametrize("stages", [STAGES, default_warmup_stages(
    init_steps=25, middle_steps=20, doubling_stages=2, terminating_steps=30)],
    ids=["pooled", "per_chain"])
def test_the_transitions_are_the_stages_and_the_draws(stages):
    _res, counts = _run(_gaussian(), stages=stages)
    assert counts["transitions_warmup"] == sum(
        s.N for s in stages if hasattr(s, "N"))
    assert counts["transitions_draws"] == DRAWS


def test_warmup_steps_are_the_fold_s_collected_steps(ld):
    with torch.profiler.profile():
        _res, counts = _run(ld, seed=3)
    generator = torch.Generator().manual_seed(3)
    states = init_chain_states(generator, ld, CHAINS, dtype=F32,
                               broadcast_metric=False)
    history, _state = run_warmup(generator, ld, NUTS(max_depth=4), STAGES,
                                 states, collect_stats=True)
    steps = sum(int(results["tree_statistics"].steps.sum())
                for _stage, results, _ in history
                if "tree_statistics" in results)
    assert counts["warmup_steps"] == steps > WARMUP_TRANSITIONS * CHAINS


def test_draw_steps_are_the_result_s_steps(ld):
    with torch.profiler.profile():
        res, counts = _run(ld, seed=4)
    assert counts["draw_steps"] == int(res.tree_statistics.steps.sum())


class _Custom:
    """A custom turn statistic: its leaf and combine are never called."""

    def leaf(self, metric, z):
        raise AssertionError

    combine = leaf


def _hook_inputs(reason):
    """(ld, algorithm, metric, Q) that the hook declines for ``reason``."""
    ld, K = _gaussian(), 3
    dtype, metric = F32, identity_metric(K, dtype=F32)
    algorithm = NUTS(max_depth=4)
    if reason == "dtype":
        dtype = torch.float64
    elif reason == "statistic":
        algorithm = NUTS(max_depth=4, turn_statistic_configuration=_Custom())
    elif reason == "per_chain_metric":
        metric = diagonal_metric(torch.ones((CHAINS, K), dtype=F32))
    else:  # shape: chains of another dimension than the kernel's model
        K = 4
    Q = EvaluatedPoint(q=torch.zeros((CHAINS, K), dtype=dtype),
                       logdensity=torch.zeros(CHAINS, dtype=dtype),
                       grad=torch.zeros((CHAINS, K), dtype=dtype))
    return ld, algorithm, metric, Q


@pytest.mark.parametrize("reason", tree_kernel.DECLINE_REASONS)
def test_each_decline_is_counted_once_per_declined_transition(reason):
    ld, algorithm, metric, Q = _hook_inputs(reason)
    reset_launch_counts()
    for _ in range(3):
        assert ld.tree_transition_fn(torch.Generator().manual_seed(0),
                                     algorithm, metric, Q, 0.1) is None
    declined = launch_counts()["tree_transition_declined"]
    assert declined == {r: 3 if r == reason else 0
                        for r in tree_kernel.DECLINE_REASONS}


def test_a_per_chain_metric_declines_every_transition():
    stages = default_warmup_stages(init_steps=20, middle_steps=20,
                                   doubling_stages=1, terminating_steps=20)
    _res, counts = _run(_gaussian(), stages=stages)
    declined = counts["tree_transition_declined"]
    assert declined["per_chain_metric"] == (counts["transitions_warmup"]
                                            + counts["transitions_draws"])
    assert sum(declined.values()) == declined["per_chain_metric"]


def test_host_reads_name_the_search_and_the_initial_check(ld):
    _res, counts = _run(ld)
    reads = counts["host_reads"]
    assert reads["init_check"] == 1
    assert reads["search_loop"] >= 1
    assert reads["search_check"] == 2
    assert "stepsize_message" not in reads  # a silent run logs nothing
    _res, counts = _run(ld, log=lambda line: None)
    assert counts["host_reads"]["stepsize_message"] == 1
    assert counts["host_reads"]["sampling_log"] == 1  # one chunk


PARENTS = {
    "dhmc.init": {"dhmc.run_chains"},
    "dhmc.warmup": {"dhmc.run_chains"},
    "dhmc.search": {"dhmc.warmup"},
    "dhmc.stage": {"dhmc.warmup"},
    "dhmc.estimate": {"dhmc.stage"},
    "dhmc.transition": {"dhmc.stage", "dhmc.draws"},
    "dhmc.adapt": {"dhmc.transition"},
    "dhmc.noise": {"dhmc.transition"},
    "dhmc.kernel": {"dhmc.transition"},
    "dhmc.draws": {"dhmc.run_chains"},
    "dhmc.sink": {"dhmc.draws"},
}


def _nesting(path):
    """(name, parent name) of every dhmc.* span on the trace's host
    timeline, the call spans' ordinal dropped."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("dhmc.")]
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    stack, pairs = [], []
    for e in events:
        while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
            stack.pop()
        name = e["name"].split("#")[0]
        pairs.append((name, stack[-1]["name"].split("#")[0] if stack
                      else None))
        stack.append(e)
    return events, pairs


def test_the_trace_holds_the_spans_nested(ld, tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        _res, counts = _run(ld)
    (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    events, pairs = _nesting(path)
    calls = [e["name"] for e in events
             if e["name"].startswith("dhmc.run_chains#")]
    assert len(calls) == 1
    assert set(PARENTS) | {"dhmc.run_chains"} == {name for name, _ in pairs}
    for name, parent in pairs:
        if name == "dhmc.run_chains":
            assert parent is None
        else:
            assert parent in PARENTS[name], (name, parent)
    n_transitions = sum(name == "dhmc.transition" for name, _ in pairs)
    assert n_transitions == WARMUP_TRANSITIONS + DRAWS == (
        counts["transitions_warmup"] + counts["transitions_draws"])
    assert sum(name == "dhmc.kernel" for name, _ in pairs) == n_transitions
    spans = counts["spans"]
    assert spans["dhmc.run_chains"] == {"call": {
        "count": 1, "ns": spans["dhmc.run_chains"]["call"]["ns"]}}
    assert set(spans["dhmc.stage"]) == {"warmup"}
    assert spans["dhmc.sink"]["draws"]["count"] == 1
