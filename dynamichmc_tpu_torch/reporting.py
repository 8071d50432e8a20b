"""Progress reporting (port of ``dynamichmc_tpu.reporting``).

The reference's strategy pattern (reporting.jl): ``NoProgressReport``,
``LogProgressReport`` and ``TqdmProgressReport``. The port runs every
transition eagerly, so a step reporter's ``report_step`` is called once
per NUTS transition, the reference's own cadence (reporting.jl:62-136). A
*step* is a NUTS transition, not a leapfrog step (reporting.jl:30).

A reporter never draws a random number, and reads a tensor from the device
only when it writes a line: ``LogProgressReport`` formats its metadata
(for example a 0-d ``eps`` tensor) only when its throttle fires.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time
from typing import Optional

logger = logging.getLogger("dynamichmc_tpu_torch")


def _format_value(v):
    """A tensor of one element prints as its Python number (read from the
    device here, at formatting time); anything else as itself."""
    if hasattr(v, "numel") and hasattr(v, "item") and v.numel() == 1:
        return v.item()
    return v


class NoProgressReport:
    """Silent default (reporting.jl:14); also the default in
    non-interactive sessions (reporting.jl:184-190)."""

    def report_message(self, message: str, **meta):
        pass

    def make_stage_reporter(self, total_steps: int, currently_warmup: bool,
                            **meta):
        return self

    def report_step(self, step: int, **meta):
        pass

    @property
    def wants_step_callbacks(self) -> bool:
        return False


@dataclasses.dataclass
class LogProgressReport:
    """Throttled logging reporter (reporting.jl:62-136): reports at most
    every ``step_interval`` steps or ``time_interval_s`` seconds, with the
    seconds per step and an estimate of the seconds left."""

    chain_id: Optional[object] = None
    step_interval: int = 100
    time_interval_s: float = 1000.0

    def __post_init__(self):
        self._total_steps = 0
        self._last_step = -1
        self._last_time = time.monotonic()

    def _meta_str(self, meta):
        items = dict(meta)
        if self.chain_id is not None:
            items = {"chain_id": self.chain_id, **items}
        return " ".join(f"{k}={_format_value(v)}" for k, v in items.items())

    def report_message(self, message: str, **meta):
        logger.info("%s %s", message, self._meta_str(meta))

    def make_stage_reporter(self, total_steps: int, currently_warmup: bool,
                            **meta):
        r = LogProgressReport(
            chain_id=self.chain_id,
            step_interval=self.step_interval,
            time_interval_s=self.time_interval_s,
        )
        r._total_steps = total_steps
        r._last_step = -1
        r._last_time = time.monotonic()
        logger.info(
            "Starting MCMC total_steps=%d %s", total_steps, self._meta_str(meta)
        )
        return r

    def report_step(self, step: int, **meta):
        now = time.monotonic()
        d_steps = step - self._last_step
        d_time = now - self._last_time
        if (
            self._last_step < 0
            or d_steps >= self.step_interval
            or d_time >= self.time_interval_s
        ):
            sec_per_step = d_time / max(d_steps, 1)
            eta = (self._total_steps - step) * sec_per_step
            logger.info(
                "MCMC progress step=%d seconds_per_step=%.2g "
                "estimated_seconds_left=%.2g %s",
                step,
                sec_per_step,
                eta,
                self._meta_str(meta),
            )
            self._last_step = step
            self._last_time = now

    @property
    def wants_step_callbacks(self) -> bool:
        return True


@dataclasses.dataclass
class TqdmProgressReport:
    """Progress-bar reporter (the reference's ProgressMeterReport,
    reporting.jl:148-176), through tqdm where it is installed; without
    tqdm it shows no bar."""

    def report_message(self, message: str, **meta):
        pass

    def make_stage_reporter(self, total_steps: int, currently_warmup: bool,
                            **meta):
        try:
            from tqdm import tqdm  # type: ignore

            bar = tqdm(
                total=total_steps,
                desc="Warmup" if currently_warmup else "MCMC",
                leave=False,
            )
        except ImportError:  # tqdm absent: no bar
            bar = None
        r = TqdmProgressReport()
        r._bar = bar
        r._count = 0
        return r

    def report_step(self, step: int, **meta):
        bar = getattr(self, "_bar", None)
        if bar is None:
            return
        # ``step`` is the 0-based step index; the bar counts completed
        # steps and closes at 100% (it would otherwise linger until
        # garbage collection and garble the next stage's bar)
        done = step + 1
        count = getattr(self, "_count", 0)
        if done > count:
            bar.update(done - count)
            self._count = done
        if bar.total is not None and self._count >= bar.total:
            bar.close()

    @property
    def wants_step_callbacks(self) -> bool:
        return True


def default_reporter():
    """Interactive sessions log, non-interactive ones are silent
    (reporting.jl:184-190)."""
    if sys.stdout.isatty():
        return LogProgressReport()
    return NoProgressReport()


def stage_log(reporter):
    """The engine's block-boundary ``log`` hook for a reporter: ``None``
    for a silent reporter (no message is formatted, nothing is read from
    the device), else its ``report_message``."""
    if reporter is None or isinstance(reporter, NoProgressReport):
        return None
    return reporter.report_message
