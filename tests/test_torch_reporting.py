"""The port's progress reporters (reporting.py) against the JAX package's,
and their wiring into the entry points.

- ``LogProgressReport`` writes the JAX reporter's text for the same call
  sequence, under one monkeypatched clock for both modules.
- A step reporter is told of every transition: each warmup block's steps
  0..N-1, then each draw's, for one metric kind and for two.
- ``NoProgressReport`` is silent; ``default_reporter`` is silent off a tty
  and logs each block on one; reporters never change the draws.
These test logging, not sampling: a 2-d model and a tiny schedule.
"""

import logging
import sys
import time

import pytest
import torch

from dynamichmc_tpu.reporting import LogProgressReport as JLogProgressReport
from dynamichmc_tpu_torch import (
    InitialStepsizeSearch,
    TuningNUTS,
    from_logdensity_fn,
    mcmc_keep_warmup,
    mcmc_with_warmup,
    run_chains,
)
from dynamichmc_tpu_torch.reporting import (
    LogProgressReport,
    NoProgressReport,
    TqdmProgressReport,
    default_reporter,
    stage_log,
)

F64 = torch.float64
LD = from_logdensity_fn(2, lambda q: -0.5 * (q**2).sum(-1))
STAGES = (InitialStepsizeSearch(), TuningNUTS(N=20, metric_kind="diagonal"))
# two metric kinds: the stage fold
FOLD_STAGES = (InitialStepsizeSearch(), TuningNUTS(N=20, metric_kind="diagonal"),
               TuningNUTS(N=25, metric_kind="dense"))
LOGGER = "dynamichmc_tpu_torch"


def _drive(reporter, eps_of, clock):
    """One call sequence: a message, a 20-step stage with throttled steps
    (clock ticks of 0.3 s, one jump of 5 s), then a 6-step stage."""
    reporter.report_message("found initial stepsize", eps=eps_of(0.15625))
    stage = reporter.make_stage_reporter(20, currently_warmup=True,
                                         tuning="stepsize and diagonal metric")
    for i in range(20):
        clock[0] += 5.0 if i == 13 else 0.3
        stage.report_step(i, eps=eps_of(0.1 + 0.01 * i))
    stage = reporter.make_stage_reporter(6, currently_warmup=False)
    for i in range(6):
        clock[0] += 0.25
        stage.report_step(i)


def test_log_lines_match_jax(caplog, monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    texts = {}
    for name, cls, logger, eps_of in (
            ("jax", JLogProgressReport, "dynamichmc_tpu", float),
            ("port", LogProgressReport, LOGGER,
             lambda e: torch.tensor(e, dtype=F64))):
        clock[0] = 1000.0
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger):
            _drive(cls(chain_id=3, step_interval=4, time_interval_s=2.5),
                   eps_of, clock)
        texts[name] = [r.getMessage() for r in caplog.records
                       if r.name == logger]
    assert texts["port"] == texts["jax"]
    assert len(texts["port"]) > 8
    assert any("step=13" in t for t in texts["port"])  # the time throttle
    assert any("eps=0.15625" in t for t in texts["port"])


class RecordingReporter:
    """A step reporter that records every call."""

    def __init__(self):
        self.steps, self.stages, self.messages = [], [], []

    def report_message(self, message, **meta):
        self.messages.append(message)

    def make_stage_reporter(self, total_steps, currently_warmup, **meta):
        self.stages.append((total_steps, currently_warmup))
        return self

    def report_step(self, step, **meta):
        self.steps.append(step)

    @property
    def wants_step_callbacks(self):
        return True


@pytest.mark.parametrize("entry,stages", [
    ("with_warmup", STAGES), ("with_warmup", FOLD_STAGES),
    ("keep_warmup", STAGES)])
def test_recording_reporter_receives_every_step(entry, stages):
    rep = RecordingReporter()
    call = mcmc_with_warmup if entry == "with_warmup" else mcmc_keep_warmup
    call(torch.Generator().manual_seed(5), LD, 16, warmup_stages=stages,
         dtype=F64, reporter=rep)
    blocks = [s.N for s in stages[1:]]
    assert rep.stages == [(n, True) for n in blocks] + [(16, False)]
    assert rep.steps == [j for n in blocks + [16] for j in range(n)]
    assert rep.messages[0].startswith("found initial stepsize eps=")


@pytest.mark.parametrize("stages", [STAGES, FOLD_STAGES])
def test_reporters_do_not_change_the_draws(stages):
    base = mcmc_with_warmup(torch.Generator().manual_seed(2), LD, 12,
                            warmup_stages=stages, dtype=F64)
    for reporter in (LogProgressReport(step_interval=3), TqdmProgressReport(),
                     RecordingReporter(), NoProgressReport()):
        res = mcmc_with_warmup(torch.Generator().manual_seed(2), LD, 12,
                               warmup_stages=stages, dtype=F64,
                               reporter=reporter)
        assert torch.equal(res.positions, base.positions)
        assert torch.equal(res.eps, base.eps)


def test_no_progress_report_silent(caplog):
    with caplog.at_level(logging.INFO, logger=LOGGER):
        mcmc_with_warmup(torch.Generator().manual_seed(0), LD, 20,
                         dtype=F64, warmup_stages=STAGES,
                         reporter=NoProgressReport())
        mcmc_keep_warmup(torch.Generator().manual_seed(0), LD, 5,
                         dtype=F64, warmup_stages=FOLD_STAGES,
                         reporter=NoProgressReport())
    assert not caplog.records


@pytest.mark.parametrize("stages", [STAGES, FOLD_STAGES])
def test_log_progress_report_emits(caplog, stages):
    reporter = LogProgressReport(chain_id=7, step_interval=5)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        mcmc_with_warmup(torch.Generator().manual_seed(1), LD, 16,
                         dtype=F64, warmup_stages=stages, reporter=reporter)
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "Starting MCMC total_steps=20 chain_id=7" in text
    assert "MCMC progress step=15" in text
    assert "found initial stepsize" in text


def test_tqdm_reporter_runs():
    mcmc_with_warmup(torch.Generator().manual_seed(2), LD, 10, dtype=F64,
                     warmup_stages=FOLD_STAGES, reporter=TqdmProgressReport())


def test_default_reporter_noninteractive(caplog):
    # test runners are not a tty: a silent default (reporting.jl:184-190)
    assert isinstance(default_reporter(), NoProgressReport)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        mcmc_with_warmup(torch.Generator().manual_seed(3), LD, 5, dtype=F64,
                         warmup_stages=STAGES)
    assert not caplog.records


def test_default_interactive_reporter_logs_each_block(caplog, monkeypatch):
    """On a tty the default reporter logs the search and each block, not
    each transition."""
    monkeypatch.setattr(sys.stdout, "isatty", lambda: True)
    assert isinstance(default_reporter(), LogProgressReport)
    for stages, word in ((STAGES, "warmup stage 2/2"),
                         (FOLD_STAGES, "warmup stage 3/3")):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=LOGGER):
            mcmc_with_warmup(torch.Generator().manual_seed(3), LD, 20,
                             dtype=F64, warmup_stages=stages)
        text = "\n".join(r.getMessage() for r in caplog.records)
        assert word in text and "found initial stepsize" in text
        assert "MCMC progress" not in text


def test_stage_log_silent_for_no_progress():
    assert stage_log(None) is None
    assert stage_log(NoProgressReport()) is None
    assert callable(stage_log(LogProgressReport()))


def test_run_chains_reports_through_its_reporter(caplog):
    rep = RecordingReporter()
    for stages in (STAGES, FOLD_STAGES):
        run_chains(torch.Generator().manual_seed(4), LD, 3, 4, dtype=F64,
                   warmup_stages=stages, reporter=rep)
    assert rep.messages[0].startswith("found initial stepsizes eps in [")
    assert "warmup stage 2/2 done (20 steps)" in rep.messages
    assert "warmup stage 3/3 done (25 steps)" in rep.messages
    assert rep.steps == []  # run_chains reports blocks, not transitions
    with caplog.at_level(logging.INFO, logger=LOGGER):
        run_chains(torch.Generator().manual_seed(4), LD, 3, 4, dtype=F64,
                   warmup_stages=FOLD_STAGES, reporter=NoProgressReport())
    assert not caplog.records
